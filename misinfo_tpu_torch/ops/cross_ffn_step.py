"""Fused Whisper decoder cross-attention + FFN step: the CUDA kernel and
its plain version.

Counterpart of ``misinfo_tpu/ops/pallas_cross_ffn.py``
(``fused_cross_ffn_step``; TPU kernels K7a ``_cross_ffn_kernel``, bf16
weights, and K7b ``_cross_ffn_kernel_i8``, int8 weights). The second half
of one decoder layer for one decode step:

    x2  = x + o(softmax_{t < t_actual}(q·K_t / √64) · V),  q = W_q·LN(x)
    out = x2 + W2·gelu(W1·LN(x2))

over merged-head encoder K/V planes [B, T, D] (positions ≥ t_actual are
masked to −1e9; the port keeps the planes unpadded). The casts are the
TPU kernel's: LN in f32 (single-pass variance in bf16 mode), products
with f32 sums, q, probabilities, context, x2, the FFN pre-activation and
its activation rounded to the compute dtype. GELU is the tanh form in
bf16 mode and erf in f32 mode, as the TPU kernel has it (the unfused step
uses erf always). With int8 weights every product's input is quantized
per row over its whole width (F columns for W2); q dequantizes as
(acc·s_chan)·s_row + b, the other products as (acc·s_row)·s_chan + b.

``fused_cross_ffn_step`` dispatches on where x lies: a CUDA tensor
launches ``csrc/cross_ffn_step.cu`` (bf16 activations only) or raises; a
CPU tensor runs ``cross_ffn_step_plain``. ``launches`` counts kernel
calls (one per call; the C entry runs eleven kernels), ``launches_i8``
the calls among them with int8 weights. A call carries at most
``MAX_BATCH`` rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch
import torch.nn.functional as F

from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, layer_norm)
from misinfo_tpu_torch.ops.cuda_build import build, check_tensor
from misinfo_tpu_torch.ops.quant import int_matmul, quantize_rows

HEAD_DIM = 64                   # the kernel's head width (every Whisper size)
MAX_BATCH = 32                  # decode_common.cuh MAXB

launches = 0                    # kernel calls since import (or reset)
launches_i8 = 0                 # those with int8 weights
build_log = ""                  # nvcc's output of the last build
_lib = None


def _q_proj(p: Dict, v: torch.Tensor, policy: Policy) -> torch.Tensor:
    """The query product: ``dense``, except that int8 weights dequantize
    in the TPU kernel's q order (acc·s_chan)·s_row + b."""
    if "kernel_q" not in p:
        return dense(p, v, policy)
    vq, sv = quantize_rows(v.float())
    y = int_matmul(vq, p["kernel_q"]) * p["w_scale"] * sv
    return (y + p["bias"].float()).to(policy.compute)


def cross_ffn_step_plain(x, ln_cross: Dict, q: Dict, o: Dict, ln2: Dict,
                         mlp_in: Dict, mlp_out: Dict, cache_k, cache_v,
                         t_actual: int, *, n_heads: int,
                         policy: Policy = DEFAULT_POLICY):
    """The kernel's arithmetic in PyTorch ops."""
    compute = policy.compute
    x = x.to(compute)
    B, D = x.shape
    H = n_heads
    Dh = D // H
    T = cache_k.shape[1]
    qv = _q_proj(q, layer_norm(ln_cross, x, policy=policy), policy)
    k = cache_k.to(compute).float().reshape(B, T, H, Dh)
    v = cache_v.to(compute).float().reshape(B, T, H, Dh)
    scores = torch.einsum("bhd,bthd->bht", qv.float().reshape(B, H, Dh),
                          k) / math.sqrt(Dh)
    scores = scores.masked_fill(torch.arange(T, device=x.device) >= t_actual,
                                -1e9)
    probs = torch.softmax(scores, dim=-1).to(compute)
    ctx = torch.einsum("bht,bthd->bhd", probs.float(), v)
    ctx = ctx.reshape(B, D).to(compute)
    x2 = x + dense(o, ctx, policy)
    mid = dense(mlp_in, layer_norm(ln2, x2, policy=policy), policy)
    approx = "tanh" if compute == torch.bfloat16 else "none"
    g = F.gelu(mid.float(), approximate=approx).to(compute)
    return x2 + dense(mlp_out, g, policy)


def _library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("cross_ffn_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cross_ffn_step_launch.restype = i
    lib.cross_ffn_step_launch.argtypes = [p] * 21 + [i] * 7 + [p]
    lib.cross_ffn_step_workspace.restype = ctypes.c_size_t
    lib.cross_ffn_step_workspace.argtypes = [i] * 5
    lib.cross_ffn_step_error_string.restype = ctypes.c_char_p
    lib.cross_ffn_step_error_string.argtypes = [i]
    _lib = lib
    return lib


def _launch(x, ln_cross, q, o, ln2, mlp_in, mlp_out, cache_k, cache_v,
            t_actual: int, n_heads: int):
    global launches, launches_i8
    B, D = x.shape
    T = cache_k.shape[1]
    int8 = "kernel_q" in q
    Fd = (mlp_in["kernel_q"] if int8 else mlp_in["kernel"]).shape[1]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"cross_ffn_step: the kernel carries 1..{MAX_BATCH} "
                         f"rows, got B={B}")
    if D != n_heads * HEAD_DIM:
        raise ValueError(f"cross_ffn_step: the kernel needs {HEAD_DIM}-wide "
                         f"heads, got D={D}, n_heads={n_heads}")
    if not 1 <= t_actual <= T:
        raise ValueError(f"cross_ffn_step: t_actual {t_actual} outside the "
                         f"cross cache ({T})")
    f32, wdt = torch.float32, (torch.int8 if int8 else torch.bfloat16)
    mats = {"q": (q, (D, D)), "o": (o, (D, D)), "mlp_in": (mlp_in, (D, Fd)),
            "mlp_out": (mlp_out, (Fd, D))}
    # the TPU wrapper's casts: bf16 weights, f32 LayerNorm/bias/scales
    args = {"x": (x, torch.bfloat16, (B, D)),
            "cache_k": (cache_k, torch.bfloat16, (B, T, D)),
            "cache_v": (cache_v, torch.bfloat16, (B, T, D))}
    for name, ln in (("ln_cross", ln_cross), ("ln2", ln2)):
        args[f"{name} scale"] = (ln["scale"].float(), f32, (D,))
        args[f"{name} bias"] = (ln["bias"].float(), f32, (D,))
    for name, (p, shape) in mats.items():
        w = p["kernel_q"] if int8 else p["kernel"].to(torch.bfloat16)
        args[f"{name} kernel"] = (w, wdt, shape)
        args[f"{name} bias"] = (p["bias"].float(), f32, (shape[1],))
        if int8:
            args[f"{name} w_scale"] = (p["w_scale"].float(), f32,
                                       (shape[1],))
    for name, (t, dt, shape) in args.items():
        check_tensor(t, f"cross_ffn_step: {name}", dt, shape, x.device)
    a = {k: v[0].data_ptr() for k, v in args.items()}
    s = (lambda name: a.get(f"{name} w_scale"))
    lib = _library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ws = torch.empty(lib.cross_ffn_step_workspace(B, D, Fd, T, sms),
                     dtype=torch.uint8, device=x.device)
    out = torch.empty(B, D, dtype=torch.bfloat16, device=x.device)
    err = lib.cross_ffn_step_launch(
        a["x"], a["ln_cross scale"], a["ln_cross bias"],
        a["q kernel"], s("q"), a["q bias"],
        a["o kernel"], s("o"), a["o bias"],
        a["ln2 scale"], a["ln2 bias"],
        a["mlp_in kernel"], s("mlp_in"), a["mlp_in bias"],
        a["mlp_out kernel"], s("mlp_out"), a["mlp_out bias"],
        a["cache_k"], a["cache_v"], out.data_ptr(), ws.data_ptr(),
        B, D, Fd, T, t_actual, int(int8), sms,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"cross_ffn_step kernel launch failed (B={B} D={D} F={Fd} T={T} "
            f"t_actual={t_actual} int8={int8}): "
            f"{lib.cross_ffn_step_error_string(err).decode()}")
    launches += 1
    launches_i8 += int8
    return out


def fused_cross_ffn_step(x, ln_cross: Dict, q: Dict, o: Dict, ln2: Dict,
                         mlp_in: Dict, mlp_out: Dict, cache_k, cache_v,
                         t_actual: int, *, n_heads: int,
                         policy: Policy = DEFAULT_POLICY,
                         k_scale=None, v_scale=None):
    """One decoder layer's cross-attention + FFN decode step. x [B, D];
    the projections bf16 (``kernel``) or int8 (``kernel_q`` + ``w_scale``);
    cache_k/cache_v [B, T, D] merged-head encoder planes; positions
    ≥ t_actual are masked. Returns x2 + FFN(LN(x2)), x2 = x +
    crossattn(LN(x)). CUDA tensors run the kernel (bf16 serving mode only)
    or raise; CPU tensors run the plain version."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 cross caches (cross_int8, TPU kernel K8) are not ported "
            "yet (ROADMAP.md queue 2, K8)")
    if not x.is_cuda:
        return cross_ffn_step_plain(x, ln_cross, q, o, ln2, mlp_in, mlp_out,
                                    cache_k, cache_v, t_actual,
                                    n_heads=n_heads, policy=policy)
    if policy.compute != torch.bfloat16:
        raise ValueError("cross_ffn_step: the kernel runs bf16 serving "
                         "mode only")
    return _launch(x.to(torch.bfloat16), ln_cross, q, o, ln2, mlp_in,
                   mlp_out, cache_k, cache_v, int(t_actual), n_heads)
