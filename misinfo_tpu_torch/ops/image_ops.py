"""On-device image normalization (first stage of the signal program).

Counterpart of ``misinfo_tpu/ops/image_ops.py``: the host ships uint8
NHWC batches; the float conversion and per-channel normalization run on
the device. ImageNet stats feed EfficientNet, CLIP stats the CLIP tower.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from misinfo_tpu_torch.preprocess.image import (
    CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD,
)

_STATS = {
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "clip": (CLIP_MEAN, CLIP_STD),
}


_CONSTANTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _constants(stats: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean·255, 1/(std·255)) in f32 on ``device``, made once per (device,
    stats) with the same f32 operations on the host and copied over once,
    so that a program copies nothing to the device (a CUDA graph cannot
    hold the blocking copy)."""
    key = (stats, str(device))
    hit = _CONSTANTS.get(key)
    if hit is None:
        mean, std = _STATS[stats]
        m = torch.tensor(mean, dtype=torch.float32) * 255.0
        inv = 1.0 / (torch.tensor(std, dtype=torch.float32) * 255.0)
        hit = _CONSTANTS[key] = (m.to(device), inv.to(device))
    return hit


def normalize_images(images_u8: torch.Tensor, stats: str = "imagenet",
                     dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [B,H,W,3] → normalized [B,H,W,3] in `dtype` (NHWC)."""
    mean, inv_std = _constants(stats, images_u8.device)
    return ((images_u8.float() - mean) * inv_std).to(dtype)
