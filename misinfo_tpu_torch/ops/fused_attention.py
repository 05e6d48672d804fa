"""Fused attention (K3) and row LayerNorm (K4): the hand-written CUDA
kernels and their plain versions.

Counterparts of ``misinfo_tpu/ops/pallas_attention.py``:

* ``fused_attention`` (TPU kernel ``_attn_kernel``, selected by
  ``use_pallas=True``): ``softmax(QKᵀ/√D + (1 − mask)·(−1e9), causal by
  where)·V`` per (batch, head) with f32 scores and softmax, the
  probabilities rounded to V's dtype, f32 PV sums, output in Q's dtype.
  These are that kernel's numerics, not the einsum path's (which rounds
  scores to ``policy.score`` and adds the causal mask).
* ``fused_layer_norm`` (``fused_layer_norm``'s inner kernel): f32
  two-pass mean and variance, ``rsqrt(var + eps)``, affine, input dtype
  out. No model calls it; the JAX package's tests do.

Each dispatches on where its input lies: CUDA tensors launch the kernel
in ``csrc/fused_attention.cu`` / ``csrc/layer_norm.cu`` (built with
``nvcc`` at first use) or raise; CPU tensors run the plain version.
``launches`` and ``ln_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.cuda_build import build, check_tensor

_NEG = -1e9
HEAD_DIM = 64                   # the kernel's one head width (every tower)
MAX_KV = 512                    # whole f32 score rows in shared memory
_DTYPES = (torch.bfloat16, torch.float32)

launches = 0                    # K3 launches since import (or reset)
ln_launches = 0                 # K4 launches
graphs.count_launches(__name__, "launches", "ln_launches")
build_log = ""                  # nvcc's output of the last K3 build
ln_build_log = ""
_lib = None
_ln_lib = None


def attention_scores_plain(q, k, mask=None, causal=False) -> torch.Tensor:
    """f32 scores [B, H, S, S_kv] after the padding and causal masks."""
    D = q.shape[-1]
    scores = torch.matmul(q.permute(0, 2, 1, 3).float(),
                          k.permute(0, 2, 3, 1).float()) * (1.0 / D ** 0.5)
    if mask is not None:
        scores = scores + (1.0 - mask.float())[:, None, None, :] * _NEG
    if causal:
        S, S_kv = scores.shape[-2:]
        idx = torch.arange(S, device=q.device)
        keep = idx[:, None] >= torch.arange(S_kv, device=q.device)[None, :]
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG))
    return scores


def fused_attention_plain(q, k, v, mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: q [B,S,H,D], k/v
    [B,S_kv,H,D], mask [B,S_kv] (1 = valid) → [B,S,H,D] in q's dtype."""
    return attention_from_scores_plain(
        attention_scores_plain(q, k, mask, causal), v, q.dtype)


def attention_from_scores_plain(scores, v, out_dtype) -> torch.Tensor:
    """f32 softmax of scores [B, H, S, S_kv], probabilities rounded to
    v's dtype, f32 PV → [B, S, H, D] in ``out_dtype``."""
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.matmul(probs.to(v.dtype).float(),
                       v.permute(0, 2, 1, 3).float())
    return ctx.to(out_dtype).permute(0, 2, 1, 3).contiguous()


def fused_layer_norm_plain(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _library():
    """Build (once per source hash) and load K3's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("fused_attention")
    lib.fused_attention_launch.restype = ctypes.c_int
    lib.fused_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.fused_attention_error_string.restype = ctypes.c_char_p
    lib.fused_attention_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def _ln_library():
    """Build (once per source hash) and load K4's shared library."""
    global _ln_lib, ln_build_log
    if _ln_lib is not None:
        return _ln_lib
    lib, ln_build_log = build("layer_norm")
    lib.layer_norm_launch.restype = ctypes.c_int
    lib.layer_norm_launch.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                              ctypes.c_int,
                                                              ctypes.c_void_p])
    lib.layer_norm_error_string.restype = ctypes.c_char_p
    lib.layer_norm_error_string.argtypes = [ctypes.c_int]
    _ln_lib = lib
    return lib


def _launch_attention(q, k, v, mask, causal) -> torch.Tensor:
    global launches
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"fused_attention: q must be bf16 or f32, got "
                         f"{q.dtype}")
    if D != HEAD_DIM:
        raise ValueError(f"fused_attention: head dim {D} (the kernel takes "
                         f"{HEAD_DIM})")
    if not 1 <= S_kv <= MAX_KV:
        raise ValueError(f"fused_attention: {S_kv} keys (the kernel takes "
                         f"1..{MAX_KV})")
    check_tensor(q, "fused_attention: q", q.dtype, (B, S, H, D), q.device)
    for t, name in ((k, "k"), (v, "v")):
        check_tensor(t, f"fused_attention: {name}", q.dtype, (B, S_kv, H, D),
                     q.device)
    if mask is not None:
        check_tensor(mask, "fused_attention: mask", torch.float32,
                     (B, S_kv), q.device)
    out = torch.empty_like(q)
    if B and S:
        lib = _library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, S, H, S_kv, D, int(causal), int(q.dtype == torch.float32),
            1.0 / D ** 0.5, stream)
        if err:
            raise RuntimeError(
                f"fused_attention kernel launch failed (B={B} S={S} H={H} "
                f"S_kv={S_kv}): "
                f"{lib.fused_attention_error_string(err).decode()}")
        launches += 1
    return out


def fused_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,S_kv,H,D], mask [B,S_kv] (1 = valid) →
    [B,S,H,D]. CUDA tensors run the kernel (D = 64, S_kv ≤ 512) or raise;
    CPU tensors run the plain version."""
    if mask is not None:
        mask = mask.float()
    if not q.is_cuda:
        return fused_attention_plain(q, k, v, mask, causal)
    return _launch_attention(q, k, v, mask, causal)


def fused_layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm of x [..., D] with f32 scale and bias [D]. CUDA
    tensors run the kernel or raise; CPU tensors run the plain version."""
    global ln_launches
    if not x.is_cuda:
        return fused_layer_norm_plain(x, scale, bias, eps)
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    rows = x2.shape[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_layer_norm: x must be bf16 or f32, got "
                         f"{x.dtype}")
    check_tensor(x2, "fused_layer_norm: x", x.dtype, (rows, D), x.device)
    check_tensor(scale, "fused_layer_norm: scale", torch.float32, (D,),
                 x.device)
    check_tensor(bias, "fused_layer_norm: bias", torch.float32, (D,),
                 x.device)
    out = torch.empty_like(x2)
    if rows:
        lib = _ln_library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.layer_norm_launch(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, D, eps, int(x.dtype == torch.float32), stream)
        if err:
            raise RuntimeError(
                f"layer_norm kernel launch failed (rows={rows} D={D}): "
                f"{lib.layer_norm_error_string(err).decode()}")
        ln_launches += 1
    return out.reshape(x.shape)
