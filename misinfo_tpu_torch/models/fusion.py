"""Fusion judge MLP: 5 forensic signals → REAL/FAKE logits.

Counterpart of ``misinfo_tpu/models/fusion.py``: Linear(5,64) → ReLU →
Linear(64,32) → ReLU → Linear(32,2) over ``[ai_score, misinfo_score,
deepfake_score, clip_similarity, vault_discrepancy]``, run in f32, with
dropout after the first ReLU in training.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from misinfo_tpu_torch.ops.common import (
    F32_POLICY, Policy, dense, dense_init, dropout)

FUSION_DIMS = (5, 64, 32, 2)
FUSION_DROPOUT = 0.2  # reference misinfo_forensics.py:86


def fusion_init(gen: torch.Generator) -> Dict:
    return {f"fc{i + 1}": dense_init(gen, FUSION_DIMS[i], FUSION_DIMS[i + 1])
            for i in range(3)}


def fusion_apply(params: Dict, scores: torch.Tensor, *,
                 gen: Optional[torch.Generator] = None,
                 deterministic: bool = True,
                 policy: Optional[Policy] = None) -> torch.Tensor:
    """scores [B,5] → logits [B,2] f32. Dropout runs only in training and
    with a generator (JAX's ``rng is not None``). ``policy`` is taken, as
    JAX's, and the MLP runs in f32 regardless."""
    h = torch.relu(dense(params["fc1"], scores.float(), F32_POLICY))
    h = dropout(gen, h, FUSION_DROPOUT, deterministic or gen is None)
    h = torch.relu(dense(params["fc2"], h, F32_POLICY))
    return dense(params["fc3"], h, F32_POLICY)
