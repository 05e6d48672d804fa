"""Multi-head attention for the RoBERTa and CLIP towers.

Counterpart of ``misinfo_tpu/ops/attention.py``. The default path is
einsum attention: scores materialised in ``policy.score`` dtype with an
f32 softmax (``scaled_dot_product_attention`` is deliberately not used:
it rounds in other places than the reference). ``use_pallas=True`` runs
the fused attention kernel K3 (ops/fused_attention.py) wherever rows are
not packed, as the JAX package does. ``use_pallas="flash"`` runs the flash
attention kernel K11 (ops/flash_attention.py, JAX's library TPU kernel's
counterpart) where JAX's gate opens: S ≥ 128, S a multiple of 128 and
S == S_kv; packed rows pass their segment ids as both query and key ids,
padded rows all-ones query ids and the mask as key ids. Where the gate
shuts, "flash" takes JAX's fall-through: K3 without segment ids, else the
einsum path. On the card a head width other than 64, which neither
kernel takes, goes to the einsum path (``_kernel_route``). A fused ``qkv``
param dict (serving's
``fuse_qkv_params``) runs one [D, 3D] product and splits its output. A
``ModelSplit`` runs over a model group (parallel/tensor.py). A non-f32
``policy.accum`` rounds the context product to it, as JAX's
``preferred_element_type``; K3 sums in f32 only and refuses it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, check_accum, dense, dense_init)
from misinfo_tpu_torch.ops import flash_attention as K11
from misinfo_tpu_torch.ops import fused_attention as K3
from misinfo_tpu_torch.parallel.tensor import ModelSplit, row_dense

_NEG_INF = -1e9  # additive mask value, as the JAX package


def attention_init(gen: torch.Generator, dim: int, num_heads: int,
                   out_dim: Optional[int] = None) -> Dict:
    """q, k, v and o dense dicts; ``num_heads`` is JAX's argument (the
    layout does not depend on it)."""
    del num_heads
    out_dim = out_dim or dim
    return {"q": dense_init(gen, dim, dim), "k": dense_init(gen, dim, dim),
            "v": dense_init(gen, dim, dim), "o": dense_init(gen, dim, out_dim)}


@functools.lru_cache(maxsize=None)
def score_scale(hd: int, dtype) -> float:
    """1/sqrt(hd) as the score multiply sees it: the f32 square root and
    reciprocal, rounded to the score dtype, as a Python float that holds
    that value exactly. Evaluated once on the host, so that an attention
    call copies no scalar to the device (a CUDA graph cannot hold the
    blocking copy)."""
    return (1.0 / torch.sqrt(torch.tensor(float(hd)))).to(dtype).item()


def _additive(allowed_f32: torch.Tensor, dtype) -> torch.Tensor:
    """(1 − allowed) · −1e9 in f32, then cast: the JAX mask arithmetic."""
    return ((1.0 - allowed_f32) * _NEG_INF).to(dtype)


def _kernel_route(use_pallas, S: int, S_kv: int, hd: int, device_type: str,
                 packed: bool) -> str:
    """Which engine computes the attention: "flash" (K11), "fused" (K3) or
    "einsum". JAX's gates: flash where ``use_pallas == "flash"``, S >= 128,
    S a multiple of 128 and S == S_kv; else K3 for any ``use_pallas``
    without segment ids (``packed`` false). A rule on the shape, not a
    fallback: on a CUDA tensor the kernels take heads of HEAD_DIM (64)
    only, so any other width takes the einsum path there; on the CPU the
    kernels' plain versions take every width, as JAX's kernels do."""
    if not use_pallas or (device_type == "cuda" and hd != K11.HEAD_DIM):
        return "einsum"
    if use_pallas == "flash" and S >= 128 and S % 128 == 0 and S == S_kv:
        return "flash"
    return "einsum" if packed else "fused"


def multi_head_attention(
    params: Dict,
    x: torch.Tensor,                          # [B, S, D]
    num_heads: int,
    mask: Optional[torch.Tensor] = None,      # [B, S] 1 = valid, 0 = pad
    causal: bool = False,
    kv: Optional[torch.Tensor] = None,        # [B, S_kv, D] cross-attention
    policy: Policy = DEFAULT_POLICY,
    use_pallas=False,
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] int, 0 = padding
) -> torch.Tensor:
    """Self- or cross-attention with padding, causal or block-diagonal
    (packed segments) masking; bf16 matmuls in serving mode, f32 softmax.
    The positional order is JAX's. ``params`` may be a ``ModelSplit``
    (parallel/tensor.py): each position of the model group attends with
    its heads and the ``o`` partials are summed before the bias."""
    hd = x.shape[-1] // num_heads
    if isinstance(params, ModelSplit):
        heads = num_heads // len(params)
        xs = params.inputs(x)
        kvs = [None] * len(xs) if kv is None else params.inputs(kv)
        ctxs = [_context(p, xi, heads, hd,
                         None if mask is None else mask.to(d), causal,
                         kvi, policy, use_pallas,
                         None if segment_ids is None else segment_ids.to(d))
                for p, d, xi, kvi in zip(params.parts, params.devices, xs,
                                         kvs)]
        return row_dense(params, [p["o"] for p in params.parts], ctxs,
                         policy)
    ctx = _context(params, x, num_heads, hd, mask, causal, kv, policy,
                   use_pallas, segment_ids)
    return dense(params["o"], ctx, policy)


def _context(params, x, heads, hd, mask, causal, kv, policy, use_pallas,
             segment_ids) -> torch.Tensor:
    """The attention context [B, S, heads·hd] of ``heads`` heads of width
    ``hd`` (all of them, or a model position's share), before ``o``."""
    B, S, _ = x.shape
    kv = x if kv is None else kv
    S_kv = kv.shape[1]
    W = heads * hd
    if "qkv" in params:
        # the serving-fused projection (ops/serving.py::fuse_qkv_params):
        # one [D, 3D] product, the same math as three. Self-attention only
        # (k and v would need the other operand). Each third is copied out
        # contiguous: the unfused path's layout, which K3 reads
        assert kv is x, "fused qkv params require self-attention"
        qkv = dense(params["qkv"], x, policy)
        q, k, v = (t.reshape(B, S, heads, hd).contiguous()
                   for t in torch.split(qkv, W, dim=-1))
    else:
        q = dense(params["q"], x, policy).reshape(B, S, heads, hd)
        k = dense(params["k"], kv, policy).reshape(B, S_kv, heads, hd)
        v = dense(params["v"], kv, policy).reshape(B, S_kv, heads, hd)
    route = _kernel_route(use_pallas, S, S_kv, hd, q.device.type,
                         segment_ids is not None)
    if route == "flash":
        # JAX's segment ids for its library flash kernel
        q_seg = kv_seg = None
        if segment_ids is not None:
            q_seg = kv_seg = segment_ids.to(torch.int32).contiguous()
        elif mask is not None:
            q_seg = torch.ones(B, S, dtype=torch.int32, device=x.device)
            kv_seg = mask.to(torch.int32).contiguous()
        return K11.flash_attention(q, k, v, q_seg, kv_seg, causal=causal,
                                   sm_scale=1.0 / hd ** 0.5).reshape(B, S, W)
    if route == "fused":
        check_accum(policy, "the fused attention kernel K3")
        return K3.fused_attention(q, k, v, mask=mask,
                                  causal=causal).reshape(B, S, W)

    sdt = policy.score
    scores = torch.einsum("bshd,bthd->bhst", q.to(sdt), k.to(sdt))
    scores = scores * score_scale(hd, sdt)
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
    if policy.accum == torch.float32:
        ctx = torch.einsum("bhst,bthd->bshd", probs, v)
    else:
        # JAX's context product comes out in ``accum``, then the compute
        # dtype
        ctx = torch.einsum("bhst,bthd->bshd", probs.float(), v.float()
                           ).to(policy.accum).to(policy.compute)
    return ctx.reshape(B, S, W)
