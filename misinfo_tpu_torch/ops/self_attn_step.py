"""Fused Whisper decoder self-attention step: the CUDA kernel and its
plain version.

Counterpart of ``misinfo_tpu/ops/pallas_decode.py``
(``fused_self_attn_step``; TPU kernels K6a ``_self_attn_step_kernel``,
bf16 weights, and K6b ``_self_attn_step_kernel_i8``, int8 weights). One
decoder layer's self-attention for one decode step:

    h = LN(x);  q, k, v = split(h @ Wqkv + b);  cache[:, pos] = k, v
    out = x + (softmax_{s ≤ pos}(q·K_s / √64) · V) @ Wo + bo

with merged-head caches [B, S, D]. The casts are the TPU kernel's: LN in
f32 (single-pass variance in bf16 mode, two-pass in f32), products with
f32 sums, q/k/v, probabilities and context rounded to the compute dtype.
With int8 weights (``kernel_q`` + ``w_scale``) h and the context are
quantized per row; q dequantizes as (acc·s_chan)·s_row + b, k and v as
(acc·s_row)·s_chan + b — the two orders of the TPU kernel, kept because
f32 products do not associate.

The caches are written in place at row ``pos`` (JAX aliased them); the
function returns ``(out, cache_k, cache_v)`` with the same cache tensors.

``fused_self_attn_step`` dispatches on where x lies: a CUDA tensor
launches ``csrc/self_attn_step.cu`` (bf16 activations only) or raises; a
CPU tensor runs ``self_attn_step_plain``. ``launches`` counts kernel
calls (one per call), ``launches_i8`` the calls among them with int8
weights; ``kernel_launches`` reads the library's own count of
``__global__`` launches (two per call where the o product is folded into
the attention launch: int8 weights, a head split into two or more chunks,
the blocks in one wave; three else). A call carries at most
``MAX_BATCH`` rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, layer_norm)
from misinfo_tpu_torch.ops.cuda_build import (
    build, check_tensor, multiprocessors, tickets, weight_pointers, workspace)
from misinfo_tpu_torch.ops.quant import int_matmul, quantize_rows

HEAD_DIM = 64                   # the kernel's head width (every Whisper size)
MAX_BATCH = 32                  # decode_common.cuh MAXB

launches = 0                    # kernel calls since import (or reset)
launches_i8 = 0                 # those with int8 weights
graphs.count_launches(__name__, "launches", "launches_i8")
build_log = ""                  # nvcc's output of the last build
_lib = None


def _qkv_int8(h: torch.Tensor, qkv: Dict, compute, D: int):
    """q, k, v from int8 weights in the TPU kernel's orders."""
    hq, sh = quantize_rows(h.float())
    acc = int_matmul(hq, qkv["kernel_q"])
    s, b = qkv["w_scale"], qkv["bias"].float()
    q = (acc[:, :D] * s[:D] * sh + b[:D]).to(compute)
    kv = (acc[:, D:] * sh * s[D:] + b[D:]).to(compute)
    return q, kv[:, :D], kv[:, D:]


def self_attn_step_plain(x, ln: Dict, qkv: Dict, o: Dict, cache_k, cache_v,
                         pos: int, *, n_heads: int,
                         policy: Policy = DEFAULT_POLICY):
    """The kernel's arithmetic in PyTorch ops."""
    compute = policy.compute
    x = x.to(compute)
    B, D = x.shape
    H = n_heads
    Dh = D // H
    h = layer_norm(ln, x, policy=policy)
    if "kernel_q" in qkv:
        q, k_new, v_new = _qkv_int8(h, qkv, compute, D)
    else:
        q, k_new, v_new = dense(qkv, h, policy).split(D, dim=-1)
    cache_k[:, pos] = k_new.to(cache_k.dtype)
    cache_v[:, pos] = v_new.to(cache_v.dtype)
    S = cache_k.shape[1]
    k = cache_k.to(compute).float().reshape(B, S, H, Dh)
    v = cache_v.to(compute).float().reshape(B, S, H, Dh)
    scores = torch.einsum("bhd,bshd->bhs", q.float().reshape(B, H, Dh),
                          k) / math.sqrt(Dh)
    masked = torch.arange(S, device=x.device) > pos
    scores = scores.masked_fill(masked, -1e9)
    probs = torch.softmax(scores, dim=-1).to(compute)
    ctx = torch.einsum("bhs,bshd->bhd", probs.float(), v)
    ctx = ctx.reshape(B, D).to(compute)
    return x + dense(o, ctx, policy), cache_k, cache_v


def _library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("self_attn_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.self_attn_step_launch.restype = i
    lib.self_attn_step_launch.argtypes = [p] * 14 + [i] * 6 + [p]
    lib.self_attn_step_workspace.restype = ctypes.c_size_t
    lib.self_attn_step_workspace.argtypes = [i, i, i]
    lib.self_attn_step_tickets.restype = i
    lib.self_attn_step_tickets.argtypes = [i]
    lib.self_attn_step_kernel_launches.restype = ctypes.c_longlong
    lib.self_attn_step_kernel_launches.argtypes = []
    lib.self_attn_step_error_string.restype = ctypes.c_char_p
    lib.self_attn_step_error_string.argtypes = [i]
    _lib = lib
    return lib


def kernel_launches() -> int:
    """``__global__`` launches the library has made since it was loaded."""
    return int(_library().self_attn_step_kernel_launches())


def _weight_leaves(ln, qkv, o, D: int, int8: bool, device):
    """The C entry's weight arguments, ``weight_pointers``' leaves, each
    checked: the TPU wrapper's casts, bf16 (or int8) weights and f32
    LayerNorm parameters, biases and scales."""
    f32, wdt = torch.float32, (torch.int8 if int8 else torch.bfloat16)
    leaves = []

    def leaf(i, p, name, dtype, shape, what):
        if name == "w_scale" and not int8:
            leaves.append((i, name, None, None))    # bf16 weights: no scale
            return
        t = p[name].to(dtype)
        check_tensor(t, f"self_attn_step: {what}", dtype, shape, device)
        leaves.append((i, name, p[name], t))

    leaf(0, ln, "scale", f32, (D,), "ln scale")
    leaf(0, ln, "bias", f32, (D,), "ln bias")
    for i, (what, p, n) in enumerate((("qkv", qkv, 3 * D), ("o", o, D)), 1):
        leaf(i, p, "kernel_q" if int8 else "kernel", wdt, (D, n),
             f"{what} kernel")
        leaf(i, p, "w_scale", f32, (n,), f"{what} w_scale")
        leaf(i, p, "bias", f32, (n,), f"{what} bias")
    return leaves


def _launch(x, ln, qkv, o, cache_k, cache_v, pos: int, n_heads: int):
    global launches, launches_i8
    B, D = x.shape
    S = cache_k.shape[1]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"self_attn_step: the kernel carries 1..{MAX_BATCH} "
                         f"rows, got B={B}")
    if D != n_heads * HEAD_DIM:
        raise ValueError(f"self_attn_step: the kernel needs {HEAD_DIM}-wide "
                         f"heads, got D={D}, n_heads={n_heads}")
    if not 0 <= pos < S:
        raise ValueError(f"self_attn_step: pos {pos} outside the cache ({S})")
    int8 = "kernel_q" in qkv
    dev = x.device
    weights, keep = weight_pointers(
        "self_attn_step", (ln, qkv, o), dev,
        lambda: _weight_leaves(ln, qkv, o, D, int8, dev))
    for t, name, shape in ((x, "x", (B, D)), (cache_k, "cache_k", (B, S, D)),
                           (cache_v, "cache_v", (B, S, D))):
        check_tensor(t, f"self_attn_step: {name}", torch.bfloat16, shape,
                     dev)
    lib = _library()
    sms = multiprocessors(dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = workspace(lib.self_attn_step_workspace(B, D, sms), dev, stream)
    tk = tickets(lib.self_attn_step_tickets(D), dev, stream)
    out = torch.empty(B, D, dtype=torch.bfloat16, device=dev)
    err = lib.self_attn_step_launch(
        x.data_ptr(), *weights, cache_k.data_ptr(), cache_v.data_ptr(),
        out.data_ptr(), ws.data_ptr(), tk.data_ptr(), B, D, S, pos,
        int(int8), sms, stream)
    del keep                    # the casts lived until the launch
    if err:
        raise RuntimeError(
            f"self_attn_step kernel launch failed (B={B} D={D} S={S} "
            f"pos={pos} int8={int8}): "
            f"{lib.self_attn_step_error_string(err).decode()}")
    launches += 1
    launches_i8 += int8
    return out, cache_k, cache_v


def fused_self_attn_step(x, ln: Dict, qkv: Dict, o: Dict, cache_k, cache_v,
                         pos: int, *, n_heads: int,
                         policy: Policy = DEFAULT_POLICY):
    """One decoder layer's self-attention decode step. x [B, D]; qkv the
    fused [D, 3D] projection (bf16 ``kernel`` or int8 ``kernel_q`` +
    ``w_scale``); caches [B, S, D], row ``pos`` written in place. Returns
    ``(x + self_attn(LN(x)), cache_k, cache_v)``. CUDA tensors run the
    kernel (bf16 serving mode only) or raise; CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return self_attn_step_plain(x, ln, qkv, o, cache_k, cache_v, pos,
                                    n_heads=n_heads, policy=policy)
    if policy.compute != torch.bfloat16:
        raise ValueError("self_attn_step: the kernel runs bf16 serving "
                         "mode only")
    return _launch(x.to(torch.bfloat16), ln, qkv, o, cache_k, cache_v,
                   int(pos), n_heads)
