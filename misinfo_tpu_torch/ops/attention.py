"""Multi-head attention for the RoBERTa and CLIP towers.

Counterpart of ``misinfo_tpu/ops/attention.py``. The default path is
einsum attention: scores materialised in ``policy.score`` dtype with an
f32 softmax (``scaled_dot_product_attention`` is deliberately not used:
it rounds in other places than the reference). ``use_pallas=True`` runs
the fused attention kernel K3 (ops/fused_attention.py) wherever rows are
not packed, as the JAX package does; ``use_pallas="flash"`` selects JAX's
library TPU flash-attention kernel there, which is not this repository's
code, and is refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, dense_init)
from misinfo_tpu_torch.ops import fused_attention as K3

_NEG_INF = -1e9  # additive mask value, as the JAX package


def attention_init(gen: torch.Generator, dim: int,
                   out_dim: Optional[int] = None) -> Dict:
    out_dim = out_dim or dim
    return {"q": dense_init(gen, dim, dim), "k": dense_init(gen, dim, dim),
            "v": dense_init(gen, dim, dim), "o": dense_init(gen, dim, out_dim)}


def _additive(allowed_f32: torch.Tensor, dtype) -> torch.Tensor:
    """(1 − allowed) · −1e9 in f32, then cast: the JAX mask arithmetic."""
    return ((1.0 - allowed_f32) * _NEG_INF).to(dtype)


def multi_head_attention(
    params: Dict,
    x: torch.Tensor,                          # [B, S, D]
    num_heads: int,
    mask: Optional[torch.Tensor] = None,      # [B, S] 1 = valid, 0 = pad
    causal: bool = False,
    policy: Policy = DEFAULT_POLICY,
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] int, 0 = padding
    kv: Optional[torch.Tensor] = None,        # [B, S_kv, D] cross-attention
    use_pallas=False,
) -> torch.Tensor:
    """Self- or cross-attention with padding, causal or block-diagonal
    (packed segments) masking; bf16 matmuls in serving mode, f32 softmax."""
    if use_pallas == "flash":
        not_ported("use_pallas='flash' (JAX's library TPU flash-attention "
                   "kernel, not this repository's code; use_pallas=True "
                   "runs the fused attention kernel)", "queue 2, K3")
    B, S, D = x.shape
    kv = x if kv is None else kv
    S_kv = kv.shape[1]
    hd = D // num_heads
    q = dense(params["q"], x, policy).reshape(B, S, num_heads, hd)
    k = dense(params["k"], kv, policy).reshape(B, S_kv, num_heads, hd)
    v = dense(params["v"], kv, policy).reshape(B, S_kv, num_heads, hd)
    if use_pallas and segment_ids is None:
        ctx = K3.fused_attention(q, k, v, mask=mask, causal=causal)
        return dense(params["o"], ctx.reshape(B, S, D), policy)

    sdt = policy.score
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=x.device))
    scores = torch.einsum("bshd,bthd->bhst", q.to(sdt), k.to(sdt))
    scores = scores * scale.to(sdt)
    if segment_ids is not None:
        assert mask is None, "segment packing replaces the padding mask"
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        allowed = same & (segment_ids[:, None, :] > 0)        # [B, S, S]
        scores = scores + _additive(allowed[:, None].float(), sdt)
    elif mask is not None:
        scores = scores + _additive(mask[:, None, None, :].float(), sdt)
    if causal:
        idx = torch.arange(S, device=x.device)
        cmask = (idx[:, None] >= torch.arange(S_kv, device=x.device)[None, :]
                 ).float()
        scores = scores + _additive(cmask[None, None], sdt)
    probs = torch.softmax(scores.float(), dim=-1).to(policy.compute)
    ctx = torch.einsum("bhst,bthd->bshd", probs, v)
    return dense(params["o"], ctx.reshape(B, S, D), policy)
