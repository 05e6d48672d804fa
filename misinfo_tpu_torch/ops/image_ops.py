"""On-device image normalization (first stage of the signal program).

Counterpart of ``misinfo_tpu/ops/image_ops.py``: the host ships uint8
NHWC batches; the float conversion and per-channel normalization run on
the device. ImageNet stats feed EfficientNet, CLIP stats the CLIP tower.
"""

from __future__ import annotations

import torch

from misinfo_tpu_torch.preprocess.image import (
    CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD,
)

_STATS = {
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "clip": (CLIP_MEAN, CLIP_STD),
}


def normalize_images(images_u8: torch.Tensor, stats: str = "imagenet",
                     dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [B,H,W,3] → normalized [B,H,W,3] in `dtype` (NHWC)."""
    mean, std = _STATS[stats]
    dev = images_u8.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    inv_std = 1.0 / (torch.tensor(std, dtype=torch.float32, device=dev)
                     * 255.0)
    return ((images_u8.float() - mean) * inv_std).to(dtype)
