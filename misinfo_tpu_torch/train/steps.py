"""Training steps of every reference trainer plus the joint full-detector
step.

Counterpart of ``misinfo_tpu/train/steps.py``. Each step is a function
``(params, opt_state, batch, gen) → (params, opt_state, metrics)`` that
runs autograd through the port's plain model code: gradients are taken
for the optimizer's trainable leaves only (a frozen leaf gets no
gradient, which JAX's masked chain discards anyway), and the update is
applied to the tree in place — JAX's steps donate params and optimizer
state. ``gen`` is a ``torch.Generator`` on the tree's device that draws
the dropout masks (``None`` turns EfficientNet's and the fusion MLP's
dropout off, as ``rng=None`` does in JAX). Metrics stay device tensors
until the harness reads them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from misinfo_tpu_torch.models.clip import (
    clip_image_features, clip_text_features)
from misinfo_tpu_torch.models.detector import DetectorConfig
from misinfo_tpu_torch.models.efficientnet import (
    effnet_apply, effnet_train_apply, merge_bn_updates)
from misinfo_tpu_torch.models.fusion import fusion_apply
from misinfo_tpu_torch.models.roberta import (
    dual_head_logits, head_apply, roberta_encode)
from misinfo_tpu_torch.ops.common import Policy, l2_normalize
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.train.losses import (
    binary_accuracy, clip_contrastive_loss, cross_entropy,
    weighted_accuracy, weighted_cross_entropy)


@contextlib.contextmanager
def _grads_on(leaves):
    """Autograd on for the step (even inside an engine's inference mode
    elsewhere on the thread's stack) with the trainable leaves recording;
    the flags are off again afterwards, so that the tree serves as
    plain tensors."""
    with torch.inference_mode(False), torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        try:
            yield
        finally:
            for t in leaves:
                t.requires_grad_(False)


def make_step(tx, loss_fn: Callable, metric: str,
              after: Optional[Callable] = None):
    """A step from ``loss_fn(params, batch, gen) → (loss, aux)``, where
    aux is the named metric or (metric, extra) when ``after`` takes the
    extra once the update is applied."""

    def step(params, opt_state, batch, gen=None):
        with _grads_on(opt_state.leaves):
            loss, aux = loss_fn(params, batch, gen)
            grads = torch.autograd.grad(loss, opt_state.leaves,
                                        allow_unused=True)
        tx.update(grads, opt_state)
        if after is not None:
            aux, extra = aux
            params = after(params, extra)
        return params, opt_state, {"loss": loss.detach(),
                                   metric: aux.detach()}

    return step


def make_text_head_step(tx, det_cfg: DetectorConfig, policy: Policy,
                        head: str = "misinfo_head"):
    """Dual-head text step: with head='misinfo_head' the RoBERTa detective
    recipe, with head='ai_head' and a freeze mask the HC3 AI-head recipe
    (loss on ai_logits only)."""

    def loss_fn(params, batch, gen):
        ai, mis = dual_head_logits(
            params["roberta"], params["ai_head"], params["misinfo_head"],
            batch["input_ids"], batch["attention_mask"], det_cfg.roberta,
            policy, gen=gen, deterministic=False)
        logits = ai if head == "ai_head" else mis
        return (cross_entropy(logits, batch["labels"]),
                binary_accuracy(logits, batch["labels"]))

    return make_step(tx, loss_fn, "accuracy")


def make_packed_text_head_step(tx, det_cfg: DetectorConfig, policy: Policy,
                               head: str = "misinfo_head"):
    """Text-head step over packed batches (preprocess/packing.StreamPacker):
    ragged sequences share rows under block-diagonal segment attention;
    loss and accuracy weight by ``slot_valid``. The head runs without
    dropout, as in JAX."""

    def loss_fn(params, batch, gen):
        hidden = roberta_encode(
            params["roberta"], batch["input_ids"], batch["attention_mask"],
            det_cfg.roberta, policy, gen=gen, deterministic=False,
            position_ids=batch["position_ids"],
            segment_ids=batch["segment_ids"])
        pooled = hidden[batch["cls_rows"].long(), batch["cls_cols"].long()]
        logits = head_apply(params[head], pooled, policy,
                            dropout_rate=det_cfg.roberta.head_dropout)
        w = batch["slot_valid"]
        return (weighted_cross_entropy(logits, batch["labels"], w),
                weighted_accuracy(logits, batch["labels"], w))

    return make_step(tx, loss_fn, "accuracy")


def make_effnet_step(tx, policy: Policy, stats: str = "clip"):
    """CIFAKE EfficientNet step: CE on 2-class logits; BatchNorm on batch
    statistics, the running statistics written back after the update.
    ``stats='clip'`` keeps the reference trainer's CLIP-stat
    normalization."""

    def loss_fn(params, batch, gen):
        imgs = normalize_images(batch["images_u8"], stats, policy.compute)
        logits, bn_state = effnet_train_apply(params["efficientnet"], imgs,
                                              policy, gen=gen)
        return (cross_entropy(logits, batch["labels"]),
                (binary_accuracy(logits, batch["labels"]), bn_state))

    def after(params, bn_state):
        merge_bn_updates(params["efficientnet"], bn_state)
        return params

    return make_step(tx, loss_fn, "accuracy", after)


def make_clip_step(tx, det_cfg: DetectorConfig, policy: Policy):
    """CLIPDetective step: symmetric InfoNCE on matched pairs; only the
    projections and ``logit_scale`` train (the optimizer's mask)."""

    def loss_fn(params, batch, gen):
        te = clip_text_features(params["clip"], batch["input_ids"],
                                batch["attention_mask"], det_cfg.clip, policy)
        ie = clip_image_features(params["clip"],
                                 normalize_images(batch["images_u8"], "clip",
                                                  policy.compute),
                                 det_cfg.clip, policy)
        loss = clip_contrastive_loss(ie, te, params["clip"]["logit_scale"])
        sims = torch.sum(l2_normalize(ie) * l2_normalize(te), dim=-1)
        return loss, sims.mean()

    return make_step(tx, loss_fn, "mean_matched_sim")


def make_fusion_step(tx):
    """Fusion-judge step on a precomputed [B, 5] score matrix."""

    def loss_fn(params, batch, gen):
        logits = fusion_apply(params["fusion"], batch["score_vectors"],
                              gen=gen, deterministic=False)
        return (cross_entropy(logits, batch["labels"]),
                binary_accuracy(logits, batch["labels"]))

    return make_step(tx, loss_fn, "accuracy")


def make_full_step(tx, det_cfg: DetectorConfig, policy: Policy,
                   jit: bool = True):
    """Joint full-detector step: dual-head CE + EfficientNet CE (inference
    BatchNorm) + CLIP InfoNCE + fusion CE in one backward pass. The fusion
    MLP's dropout always runs here, as in JAX. ``jit`` is JAX's flag and
    changes nothing here: PyTorch runs the step eagerly either way."""

    def loss_fn(params, batch, gen):
        ai, mis = dual_head_logits(
            params["roberta"], params["ai_head"], params["misinfo_head"],
            batch["input_ids"], batch["attention_mask"], det_cfg.roberta,
            policy, gen=gen, deterministic=False)
        imgs_clip = normalize_images(batch["images_u8"], "clip",
                                     policy.compute)
        imgs_eff = normalize_images(batch["images_u8"], "imagenet",
                                    policy.compute)
        eff_logits, _ = effnet_apply(params["efficientnet"], imgs_eff,
                                     policy=policy)
        te = clip_text_features(params["clip"], batch["clip_ids"],
                                batch["clip_mask"], det_cfg.clip, policy)
        ie = clip_image_features(params["clip"], imgs_clip, det_cfg.clip,
                                 policy)
        sims = torch.sum(l2_normalize(ie) * l2_normalize(te), dim=-1)
        ai_p = torch.softmax(ai, dim=-1)[:, 1]
        mis_p = torch.softmax(mis, dim=-1)[:, 1]
        eff_p = torch.softmax(eff_logits, dim=-1)[:, 1]
        vec = torch.stack([ai_p, mis_p, eff_p, sims, torch.zeros_like(sims)],
                          dim=1)
        if gen is None:
            gen = torch.Generator(vec.device)
        fusion_logits = fusion_apply(params["fusion"], vec, gen=gen,
                                     deterministic=False)
        labels = batch["labels"]
        loss = (cross_entropy(mis, labels) + cross_entropy(ai, labels)
                + cross_entropy(eff_logits, labels)
                + clip_contrastive_loss(ie, te, params["clip"]["logit_scale"])
                + cross_entropy(fusion_logits, labels))
        return loss, binary_accuracy(fusion_logits, labels)

    return make_step(tx, loss_fn, "accuracy")


def batch_to(batch: Dict, device) -> Dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
