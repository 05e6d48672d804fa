"""Training losses and metrics, the reference trainers' math.

Counterpart of ``misinfo_tpu/train/losses.py``:

* ``cross_entropy`` — mean softmax cross-entropy of every classifier
  trainer;
* ``clip_contrastive_loss`` — CLIPDetective's symmetric InfoNCE over
  in-batch negatives at ``exp(logit_scale)``;
* ``median_threshold_accuracy`` — the reference's per-batch
  median-threshold match accuracy; ``fixed_threshold_accuracy`` its
  companion at the standalone engine's 0.25;
* ``binary_accuracy``, and the slot-weighted ``weighted_cross_entropy`` /
  ``weighted_accuracy`` of the packed text step.
"""

from __future__ import annotations

import torch


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; logits [B,C], labels [B] int."""
    return _nll(logits, labels).mean()


def clip_contrastive_loss(image_embeds: torch.Tensor,
                          text_embeds: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives. Embeddings are
    L2-normalized here (idempotent if already normalized)."""
    ie = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1,
                                                 keepdim=True)
    te = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1,
                                                keepdim=True)
    logits_it = torch.exp(logit_scale) * ie @ te.T          # [B, B]
    labels = torch.arange(ie.shape[0], device=ie.device)
    return 0.5 * (cross_entropy(logits_it, labels)
                  + cross_entropy(logits_it.T, labels))


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values for an even
    count (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def median_threshold_accuracy(sims: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """pred = 1 (match) iff sim ≥ median(sims) of the batch."""
    preds = (sims >= _median(sims)).to(torch.int32)
    return (preds == labels).float().mean()


def fixed_threshold_accuracy(sims: torch.Tensor, labels: torch.Tensor,
                             threshold: float = 0.25) -> torch.Tensor:
    preds = (sims >= threshold).to(torch.int32)
    return (preds == labels).float().mean()


def binary_accuracy(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """CE averaged over weighted rows (packed-slot validity masking)."""
    w = weights.float()
    return (_nll(logits, labels) * w).sum() / w.sum().clamp_min(1.0)


def weighted_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    w = weights.float()
    hits = (torch.argmax(logits, dim=-1) == labels).float() * w
    return hits.sum() / w.sum().clamp_min(1.0)
