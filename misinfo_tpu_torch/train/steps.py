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

Over a mesh (core/mesh.py::``setup_train_mesh``) ``params`` is a
``TrainParams``, ``opt_state`` its ``MeshOptState`` and ``batch`` one
piece a key for each of this process's data positions
(``place_train_batch``). Each position runs its replica on its rows; the
per-row outputs are gathered and the loss is the single-device loss over
the global batch: cross-entropy's mean, the packed step's slot-weighted
sums and InfoNCE's [B, B] matrix over every row, EfficientNet's
BatchNorm on the global batch's statistics. The gradients are summed
over ``data`` before the update (parallel/collectives.py), and dropout
masks are drawn over the global batch and split by rows, so that a mesh
step equals the single-device step on the same seed.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from misinfo_tpu_torch.models.clip import (
    clip_image_features, clip_text_features)
from misinfo_tpu_torch.models.detector import DetectorConfig
from misinfo_tpu_torch.models.efficientnet import (
    effnet_apply, effnet_train_apply_shards, merge_bn_updates)
from misinfo_tpu_torch.models.fusion import fusion_apply
from misinfo_tpu_torch.models.roberta import (
    dual_head_logits, head_apply, roberta_encode)
from misinfo_tpu_torch.ops.common import Policy, l2_normalize
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.parallel.collectives import ONE
from misinfo_tpu_torch.parallel.sharding import TrainParams
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
    """A step from ``loss_fn(axis, rows, batches, gens) → (loss, aux)``:
    ``rows``, ``batches`` and ``gens`` hold one entry a local data
    position (one without a mesh), ``axis`` does the data axis's
    exchanges (``collectives.ONE`` without a mesh); aux is the named
    metric, or (metric, extras a position) when ``after(row, extra)``
    takes the extra once the update is applied."""

    def step(params, opt_state, batch, gen=None):
        if isinstance(params, TrainParams):
            axis, rows, states = params.axis, params.rows, opt_state.states
            batches = [{k: v[i] for k, v in batch.items()}
                       for i in range(len(rows))]
        else:
            axis, rows, states, batches = ONE, [params], [opt_state], [batch]
        gens = axis.generators(gen)
        leaves = [s.leaves for s in states]
        flat = [t for ls in leaves for t in ls]
        with _grads_on(flat):
            loss, aux = loss_fn(axis, rows, batches, gens)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        per, i = [], 0
        for ls in leaves:
            per.append(list(grads[i:i + len(ls)]))
            i += len(ls)
        for s, g in zip(states, axis.sum_grads(per, leaves)):
            tx.update(g, s)
        axis.advance(gen, gens)
        if after is not None:
            aux, extras = aux
            for row, extra in zip(rows, extras):
                after(row, extra)
        return params, opt_state, {"loss": loss.detach(),
                                   metric: aux.detach()}

    return step


def make_text_head_step(tx, det_cfg: DetectorConfig, policy: Policy,
                        head: str = "misinfo_head"):
    """Dual-head text step: with head='misinfo_head' the RoBERTa detective
    recipe, with head='ai_head' and a freeze mask the HC3 AI-head recipe
    (loss on ai_logits only)."""
    pick = 0 if head == "ai_head" else 1

    def loss_fn(axis, rows, batches, gens):
        logits = axis.gather([dual_head_logits(
            p["roberta"], p["ai_head"], p["misinfo_head"], b["input_ids"],
            b["attention_mask"], det_cfg.roberta, policy, gen=g,
            deterministic=False)[pick]
            for p, b, g in zip(rows, batches, gens)])
        labels = axis.gather([b["labels"] for b in batches])
        return (cross_entropy(logits, labels),
                binary_accuracy(logits, labels))

    return make_step(tx, loss_fn, "accuracy")


def make_packed_text_head_step(tx, det_cfg: DetectorConfig, policy: Policy,
                               head: str = "misinfo_head"):
    """Text-head step over packed batches (preprocess/packing.StreamPacker):
    ragged sequences share rows under block-diagonal segment attention;
    loss and accuracy weight by ``slot_valid`` over every slot of the
    global batch (a position's slots are those whose CLS sits in its
    rows: ``place_train_batch``). The head runs without dropout, as in
    JAX."""

    def logits_of(p, b, g):
        hidden = roberta_encode(
            p["roberta"], b["input_ids"], b["attention_mask"],
            det_cfg.roberta, policy, gen=g, deterministic=False,
            position_ids=b["position_ids"], segment_ids=b["segment_ids"])
        pooled = hidden[b["cls_rows"].long(), b["cls_cols"].long()]
        return head_apply(p[head], pooled, policy,
                          dropout_rate=det_cfg.roberta.head_dropout)

    def loss_fn(axis, rows, batches, gens):
        logits = axis.gather([logits_of(p, b, g)
                              for p, b, g in zip(rows, batches, gens)])
        labels = axis.gather([b["labels"] for b in batches])
        w = axis.gather([b["slot_valid"] for b in batches])
        return (weighted_cross_entropy(logits, labels, w),
                weighted_accuracy(logits, labels, w))

    return make_step(tx, loss_fn, "accuracy")


def make_effnet_step(tx, policy: Policy, stats: str = "clip"):
    """CIFAKE EfficientNet step: CE on 2-class logits; BatchNorm on batch
    statistics (the global batch's over a mesh), the running statistics
    written back after the update. ``stats='clip'`` keeps the reference
    trainer's CLIP-stat normalization."""

    def loss_fn(axis, rows, batches, gens):
        imgs = [normalize_images(b["images_u8"], stats, policy.compute)
                for b in batches]
        logits, bn_states = effnet_train_apply_shards(
            [p["efficientnet"] for p in rows], imgs, policy, gens, axis)
        logits = axis.gather(logits)
        labels = axis.gather([b["labels"] for b in batches])
        return (cross_entropy(logits, labels),
                (binary_accuracy(logits, labels), bn_states))

    def after(row, bn_state):
        merge_bn_updates(row["efficientnet"], bn_state)

    return make_step(tx, loss_fn, "accuracy", after)


def _clip_features(p, b, det_cfg, policy, ids="input_ids",
                   mask="attention_mask"):
    te = clip_text_features(p["clip"], b[ids], b[mask], det_cfg.clip,
                            policy)
    ie = clip_image_features(p["clip"],
                             normalize_images(b["images_u8"], "clip",
                                              policy.compute),
                             det_cfg.clip, policy)
    return te, ie


def make_clip_step(tx, det_cfg: DetectorConfig, policy: Policy):
    """CLIPDetective step: symmetric InfoNCE on matched pairs over the
    global batch's [B, B] similarities (each position's embeddings
    gathered); only the projections and ``logit_scale`` train (the
    optimizer's mask)."""

    def loss_fn(axis, rows, batches, gens):
        te, ie = zip(*(_clip_features(p, b, det_cfg, policy)
                       for p, b in zip(rows, batches)))
        te, ie = axis.gather(te), axis.gather(ie)
        loss = clip_contrastive_loss(
            ie, te, axis.counted_once(rows[0]["clip"]["logit_scale"]))
        sims = torch.sum(l2_normalize(ie) * l2_normalize(te), dim=-1)
        return loss, sims.mean()

    return make_step(tx, loss_fn, "mean_matched_sim")


def make_fusion_step(tx):
    """Fusion-judge step on a precomputed [B, 5] score matrix."""

    def loss_fn(axis, rows, batches, gens):
        logits = axis.gather([fusion_apply(p["fusion"], b["score_vectors"],
                                           gen=g, deterministic=False)
                              for p, b, g in zip(rows, batches, gens)])
        labels = axis.gather([b["labels"] for b in batches])
        return (cross_entropy(logits, labels),
                binary_accuracy(logits, labels))

    return make_step(tx, loss_fn, "accuracy")


def make_full_step(tx, det_cfg: DetectorConfig, policy: Policy,
                   jit: bool = True):
    """Joint full-detector step: dual-head CE + EfficientNet CE (inference
    BatchNorm) + CLIP InfoNCE + fusion CE in one backward pass, over a
    (data, model) mesh as JAX's ``__graft_entry__.dryrun_multichip``
    runs it. The fusion MLP's dropout always runs here, as in JAX. ``jit``
    is JAX's flag and changes nothing here: PyTorch runs the step eagerly
    either way."""

    def outputs(i, axis, p, b, g):
        ai, mis = dual_head_logits(
            p["roberta"], p["ai_head"], p["misinfo_head"], b["input_ids"],
            b["attention_mask"], det_cfg.roberta, policy, gen=g,
            deterministic=False)
        imgs_eff = normalize_images(b["images_u8"], "imagenet",
                                    policy.compute)
        eff_logits, _ = effnet_apply(p["efficientnet"], imgs_eff,
                                     policy=policy)
        te, ie = _clip_features(p, b, det_cfg, policy, "clip_ids",
                                "clip_mask")
        sims = torch.sum(l2_normalize(ie) * l2_normalize(te), dim=-1)
        ai_p = torch.softmax(ai, dim=-1)[:, 1]
        mis_p = torch.softmax(mis, dim=-1)[:, 1]
        eff_p = torch.softmax(eff_logits, dim=-1)[:, 1]
        vec = torch.stack([ai_p, mis_p, eff_p, sims, torch.zeros_like(sims)],
                          dim=1)
        fusion_logits = fusion_apply(
            p["fusion"], vec, gen=g if g is not None
            else axis.fresh(i, vec.device), deterministic=False)
        return mis, ai, eff_logits, ie, te, fusion_logits, b["labels"]

    def loss_fn(axis, rows, batches, gens):
        mis, ai, eff_logits, ie, te, fusion_logits, labels = (
            axis.gather(list(x)) for x in zip(*(
                outputs(i, axis, p, b, g) for i, (p, b, g)
                in enumerate(zip(rows, batches, gens)))))
        loss = (cross_entropy(mis, labels) + cross_entropy(ai, labels)
                + cross_entropy(eff_logits, labels)
                + clip_contrastive_loss(
                    ie, te, axis.counted_once(rows[0]["clip"]["logit_scale"]))
                + cross_entropy(fusion_logits, labels))
        return loss, binary_accuracy(fusion_logits, labels)

    return make_step(tx, loss_fn, "accuracy")


def batch_to(batch: Dict, device) -> Dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
