"""Feature-fusion training model (reference training_pipeline.py).

Counterpart of ``misinfo_tpu/train/feature_fusion.py``: frozen CLIP and
RoBERTa backbones with EfficientNet-B0, fused at the feature level —
``cat[clip_img, clip_txt, roberta_CLS, clip_sim, deepfake_prob] →
Linear(·,512) → ReLU → Dropout(0.3) → Linear(512,256) → ReLU →
Linear(256,2)``; the forward returns ``(logits, clip_similarity,
deepfake_probability)``. A training-time graph only: its branch weights
live in the detector tree, so what it trains serves directly.

    python -m misinfo_tpu_torch.train.feature_fusion --steps 5
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.models.clip import (
    clip_image_features, clip_text_features)
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.models.efficientnet import effnet_apply
from misinfo_tpu_torch.models.roberta import roberta_cls
from misinfo_tpu_torch.ops.common import (
    Policy, dense, dense_init, dropout, l2_normalize, set_exact_f32,
    softmax_f32)
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.train.harness import select_device
from misinfo_tpu_torch.train.losses import binary_accuracy, cross_entropy
from misinfo_tpu_torch.train.optim import OptimConfig, make_optimizer
from misinfo_tpu_torch.train.steps import batch_to, make_step
from misinfo_tpu_torch.utils.tree import tree_map


def feature_fusion_head_init(gen: torch.Generator,
                             det_cfg: DetectorConfig) -> Dict:
    """The (2·proj + hidden + 2)→512→256→2 feature-fusion head."""
    in_dim = (det_cfg.clip.projection_dim * 2
              + det_cfg.roberta.hidden_size + 2)
    return {"fc1": dense_init(gen, in_dim, 512),
            "fc2": dense_init(gen, 512, 256),
            "fc3": dense_init(gen, 256, 2)}


def feature_fusion_forward(params: Dict, batch: Dict,
                           det_cfg: DetectorConfig, policy: Policy, *,
                           gen: Optional[torch.Generator] = None,
                           deterministic: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """→ (logits [B,2], clip_similarity [B], deepfake_probability [B])."""
    imgs_clip = normalize_images(batch["images_u8"], "clip", policy.compute)
    imgs_eff = normalize_images(batch["images_u8"], "imagenet",
                                policy.compute)
    ci = clip_image_features(params["clip"], imgs_clip, det_cfg.clip, policy)
    ct = clip_text_features(params["clip"], batch["clip_ids"],
                            batch["clip_mask"], det_cfg.clip, policy)
    sim = torch.sum(l2_normalize(ci) * l2_normalize(ct), dim=-1)
    rb = roberta_cls(params["roberta"], batch["input_ids"],
                     batch["attention_mask"], det_cfg.roberta, policy)
    eff_logits, _ = effnet_apply(params["efficientnet"], imgs_eff,
                                 policy=policy)
    deep_p = softmax_f32(eff_logits)[:, 1]

    feats = torch.cat([ci.float(), ct.float(), rb.float(), sim[:, None],
                       deep_p[:, None]], dim=1)
    h = params["feature_fusion"]
    x = torch.relu(dense(h["fc1"], feats.to(policy.compute), policy))
    x = dropout(gen, x, 0.3, deterministic or gen is None)
    x = torch.relu(dense(h["fc2"], x, policy))
    logits = dense(h["fc3"], x, policy).float()
    return logits, sim, deep_p


def make_feature_fusion_step(tx, det_cfg: DetectorConfig, policy: Policy):
    def loss_fn(axis, rows, batches, gens):
        logits = axis.gather([feature_fusion_forward(
            p, b, det_cfg, policy, gen=g, deterministic=False)[0]
            for p, b, g in zip(rows, batches, gens)])
        labels = axis.gather([b["labels"] for b in batches])
        return cross_entropy(logits, labels), binary_accuracy(logits, labels)

    return make_step(tx, loss_fn, "accuracy")


def freeze_backbones_mask(params: Dict) -> Dict:
    """CLIP and RoBERTa frozen; EfficientNet and the fusion head train."""
    mask = {k: tree_map(lambda _: False, v) for k, v in params.items()}
    for k in ("efficientnet", "feature_fusion"):
        if k in params:
            mask[k] = tree_map(lambda _: True, params[k])
    return mask


def training_loop_example(num_steps: int = 5, batch_size: int = 4,
                          det_cfg: Optional[DetectorConfig] = None,
                          log=print, device="cuda"):
    """Self-contained demo on synthetic data (reference
    training_pipeline.py:262-331)."""
    det_cfg = det_cfg or DetectorConfig.tiny()
    policy = Policy(PrecisionConfig.highest())
    set_exact_f32(parity=True)
    params = detector_init(0, det_cfg)
    params["feature_fusion"] = feature_fusion_head_init(
        torch.Generator().manual_seed(1), det_cfg)
    params = tree_map(lambda t: t.to(device), params)
    tx = make_optimizer(OptimConfig(lr=1e-3, total_steps=num_steps,
                                    warmup_fraction=0.0, clip_norm=1.0),
                        trainable_mask=freeze_backbones_mask(params))
    opt_state = tx.init(params)
    step = make_feature_fusion_step(tx, det_cfg, policy)

    rng = np.random.default_rng(0)
    s = det_cfg.clip.image_size
    batch = batch_to({
        "input_ids": rng.integers(3, det_cfg.roberta.vocab_size,
                                  (batch_size, 12)).astype(np.int32),
        "attention_mask": np.ones((batch_size, 12), np.int32),
        "clip_ids": rng.integers(1, det_cfg.clip.vocab_size - 2,
                                 (batch_size, 16)).astype(np.int32),
        "clip_mask": np.ones((batch_size, 16), np.int32),
        "images_u8": rng.integers(0, 255, (batch_size, s, s, 3)
                                  ).astype(np.uint8),
        "labels": rng.integers(0, 2, (batch_size,)).astype(np.int32),
    }, device)
    for i in range(num_steps):
        gen = torch.Generator(torch.device(device)).manual_seed(i)
        params, opt_state, m = step(params, opt_state, batch, gen)
        log(f"step {i}: loss={float(m['loss']):.4f} "
            f"acc={float(m['accuracy']):.2f}")
    return params


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="Feature-fusion training demo")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", choices=["auto", "cpu", "cuda"],
                   default="auto")
    args = p.parse_args()
    training_loop_example(args.steps, device=select_device(args.device))
