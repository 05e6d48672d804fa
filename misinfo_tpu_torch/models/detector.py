"""The inference detector container.

Counterpart of ``misinfo_tpu/models/detector.py``: one parameter tree
with the branches ``roberta``, ``ai_head``, ``misinfo_head``,
``efficientnet``, ``fusion`` and ``clip``, named and laid out as the JAX
tree so checkpoints/from_jax.py copies weights across without
transposes. ``detector_init`` is the port's own seeded init: its numbers
differ from the JAX init of the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

from misinfo_tpu_torch.models.clip import ClipConfig, clip_init
from misinfo_tpu_torch.models.efficientnet import effnet_b0_init
from misinfo_tpu_torch.models.fusion import fusion_init
from misinfo_tpu_torch.models.roberta import (
    RobertaConfig, head_init, roberta_init)


@dataclass(frozen=True)
class DetectorConfig:
    roberta: RobertaConfig = field(default_factory=RobertaConfig)
    clip: ClipConfig = field(default_factory=ClipConfig)
    num_image_classes: int = 2

    @staticmethod
    def tiny() -> "DetectorConfig":
        return DetectorConfig(roberta=RobertaConfig.tiny(),
                              clip=ClipConfig.tiny())


def detector_init(seed: int, cfg: DetectorConfig = DetectorConfig()) -> Dict:
    """Seeded random parameters (f32, on the CPU) for the whole detector."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "roberta": roberta_init(gen, cfg.roberta),
        "ai_head": head_init(gen, cfg.roberta),
        "misinfo_head": head_init(gen, cfg.roberta),
        "efficientnet": effnet_b0_init(gen, cfg.num_image_classes),
        "fusion": fusion_init(gen),
        "clip": clip_init(gen, cfg.clip),
    }
