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

With ``k_scale``/``v_scale`` the planes are int8 with one f32 scale per
(batch row, position) over all D lanes (``init_kv_cache(cross_int8=True)``;
TPU kernel K8 ``_cross_ffn_kernel_i8cc``): the query stays f32 and is
quantized with one scale per batch row, max(amax, 1e-30) · f32(1/127)
(the TPU kernel's ``/ 127.0`` as XLA folds it under jit, here and for the
probabilities' scale); scores
are ((s32·s_q)·s_k) / √64; the softmax is f32 over all T and is not
rounded; the V pass takes the positions in tiles of ``v_tile(B, D, T)``
rows, folds the V row scales into the probabilities, quantizes them with
one scale per (batch row, tile) taken over all heads, and adds the tiles'
s32·scale contexts in tile order. The tile is part of the function: the
kernel and the plain version both take it from ``v_tile``, which is the
TPU wrapper's rule. The TPU kept the scales as [Tp, B] and padded T to
the tile; the port keeps [B, T] and no padding (a padded row has
probability 0, so the ragged last tile gives the same scales).

``fused_cross_ffn_step`` dispatches on where x lies: a CUDA tensor
launches ``csrc/cross_ffn_step.cu`` (``csrc/cross_ffn_step_i8cc.cu`` for
int8 planes; bf16 activations only) or raises; a CPU tensor runs
``cross_ffn_step_plain`` (``cross_ffn_step_i8cc_plain``). ``launches``
counts kernel calls on bf16 planes (one per call), ``launches_i8`` the
calls among them with int8 weights, ``launches_i8cc`` the calls on int8
planes; ``kernel_launches`` and ``kernel_launches_i8cc`` read the two
libraries' own counts of ``__global__`` launches (five per call on bf16
planes and on int8 planes). A call carries at most ``MAX_BATCH`` rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch
import torch.nn.functional as F

from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, layer_norm)
from misinfo_tpu_torch.ops.cuda_build import (
    build, check_tensor, multiprocessors, tickets, weight_pointers, workspace)
from misinfo_tpu_torch.ops.quant import (
    int_einsum, int_matmul, quantize_rows, times_r127)

HEAD_DIM = 64                   # the kernel's head width (every Whisper size)
MAX_BATCH = 32                  # decode_common.cuh MAXB

launches = 0                    # kernel calls since import (or reset)
launches_i8 = 0                 # those with int8 weights
launches_i8cc = 0               # kernel calls on int8 planes (K8)
graphs.count_launches(__name__, "launches", "launches_i8", "launches_i8cc")
build_log = ""                  # nvcc's output of the last build
build_log_i8cc = ""
_lib = None
_lib_i8cc = None

V_TILE = 512                    # most rows of one V-pass tile


def _q_f32(p: Dict, v: torch.Tensor) -> torch.Tensor:
    """The int8 query product in f32, dequantized in the TPU kernel's q
    order (acc·s_chan)·s_row + b."""
    vq, sv = quantize_rows(v.float())
    y = int_matmul(vq, p["kernel_q"]) * p["w_scale"] * sv
    return y + p["bias"].float()


def _q_proj(p: Dict, v: torch.Tensor, policy: Policy) -> torch.Tensor:
    """The query product: ``dense``, except that int8 weights dequantize
    in the q order."""
    if "kernel_q" not in p:
        return dense(p, v, policy)
    return _q_f32(p, v).to(policy.compute)


def _after_attention(x, ctx, o: Dict, ln2: Dict, mlp_in: Dict,
                     mlp_out: Dict, policy: Policy):
    """x2 = x + o(ctx); x2 + W2·gelu(W1·LN(x2))."""
    compute = policy.compute
    x2 = x + dense(o, ctx, policy)
    mid = dense(mlp_in, layer_norm(ln2, x2, policy=policy), policy)
    approx = "tanh" if compute == torch.bfloat16 else "none"
    g = F.gelu(mid.float(), approximate=approx).to(compute)
    return x2 + dense(mlp_out, g, policy)


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
    return _after_attention(x, ctx, o, ln2, mlp_in, mlp_out, policy)


# ------------------------------------------------- int8 cross planes (K8)

def cross_cache_pad(t: int) -> int:
    """The TPU kernel's padded T: a V_TILE multiple above V_TILE, else a
    128 multiple. The port pads nothing; the tile rule reads it."""
    if t > V_TILE:
        return -(-t // V_TILE) * V_TILE
    return -(-t // 128) * 128


def v_tile(B: int, D: int, T: int) -> int:
    """Rows of one V-pass tile, the TPU wrapper's rule
    (``pallas_cross_ffn.fused_cross_ffn_step``): min(512, Tp), halved
    while two [B, tile, D] two-byte buffers exceed 6 MiB, the tile exceeds
    128 and the half still divides Tp. The probabilities are quantized
    per tile, so the kernel and the plain version both call this."""
    Tp = cross_cache_pad(T)
    tile = min(V_TILE, Tp)
    while (B * tile * D * 2 * 2 > 6 * 2 ** 20 and tile > 128
           and Tp % (tile // 2) == 0):
        tile //= 2
    return tile


def i8cc_scores(qf, cache_k, k_scale, t_actual: int, n_heads: int):
    """Masked f32 scores [B, H, T] of an f32 query [B, D] against int8
    planes: q quantized with one scale per batch row, floor 1e-30."""
    B, D = qf.shape
    H, T = n_heads, cache_k.shape[1]
    Dh = D // H
    sq = times_r127(qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30))
    qq = torch.clamp(torch.round(qf / sq), -127, 127).to(torch.int8)
    si = int_einsum("bhd,bthd->bht", qq.reshape(B, H, Dh),
                    cache_k.reshape(B, T, H, Dh))
    scores = si * sq[:, :, None] * k_scale[:, None, :] / math.sqrt(Dh)
    return scores.masked_fill(
        torch.arange(T, device=qf.device) >= t_actual, -1e9)


def i8cc_tile_scale(pv: torch.Tensor) -> torch.Tensor:
    """One scale per batch row for a tile's folded probabilities
    [B, H, t]: max over heads and positions, floor 1e-30, times
    f32(1/127)."""
    return times_r127(pv.amax(dim=(1, 2), keepdim=True).clamp_min(1e-30))


def i8cc_context(probs, cache_v, v_scale, tile: int, n_heads: int):
    """f32 context [B, D] of f32 probabilities [B, H, T] over int8 V
    planes, tile by tile in order."""
    B, T, D = cache_v.shape
    H = n_heads
    ctx = torch.zeros(B, D, device=probs.device)
    for t0 in range(0, T, tile):
        t1 = min(T, t0 + tile)
        pv = probs[:, :, t0:t1] * v_scale[:, None, t0:t1]
        sp = i8cc_tile_scale(pv)
        pq = torch.clamp(torch.round(pv / sp), 0, 127).to(torch.int8)
        ci = int_einsum("bht,bthd->bhd", pq,
                        cache_v[:, t0:t1].reshape(B, t1 - t0, H, D // H))
        ctx = ctx + (ci * sp).reshape(B, D)
    return ctx


def _need_int8_weights(q: Dict) -> None:
    if "kernel_q" not in q:
        raise ValueError("int8 cross caches require int8 decode weights "
                         "(quant='kernels')")


def cross_ffn_step_i8cc_plain(x, ln_cross: Dict, q: Dict, o: Dict, ln2: Dict,
                              mlp_in: Dict, mlp_out: Dict, cache_k, cache_v,
                              t_actual: int, *, n_heads: int,
                              policy: Policy = DEFAULT_POLICY,
                              k_scale=None, v_scale=None):
    """The int8-plane kernel's arithmetic in PyTorch ops: cache_k/cache_v
    int8 [B, T, D], k_scale/v_scale f32 [B, T]."""
    _need_int8_weights(q)
    x = x.to(policy.compute)
    B, D = x.shape
    qf = _q_f32(q, layer_norm(ln_cross, x, policy=policy))
    scores = i8cc_scores(qf, cache_k, k_scale.float(), t_actual, n_heads)
    probs = torch.softmax(scores, dim=-1)
    ctx = i8cc_context(probs, cache_v, v_scale.float(),
                       v_tile(B, D, cache_k.shape[1]), n_heads)
    return _after_attention(x, ctx.to(policy.compute), o, ln2, mlp_in,
                            mlp_out, policy)


def _library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("cross_ffn_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cross_ffn_step_launch.restype = i
    lib.cross_ffn_step_launch.argtypes = [p] * 22 + [i] * 7 + [p]
    lib.cross_ffn_step_workspace.restype = ctypes.c_size_t
    lib.cross_ffn_step_workspace.argtypes = [i] * 5
    lib.cross_ffn_step_tickets.restype = i
    lib.cross_ffn_step_tickets.argtypes = [i, i]
    lib.cross_ffn_step_kernel_launches.restype = ctypes.c_longlong
    lib.cross_ffn_step_kernel_launches.argtypes = []
    lib.cross_ffn_step_error_string.restype = ctypes.c_char_p
    lib.cross_ffn_step_error_string.argtypes = [i]
    _lib = lib
    return lib


def _library_i8cc():
    """The same for the int8-plane kernel (K8)."""
    global _lib_i8cc, build_log_i8cc
    if _lib_i8cc is not None:
        return _lib_i8cc
    lib, build_log_i8cc = build("cross_ffn_step_i8cc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cross_ffn_step_i8cc_launch.restype = i
    lib.cross_ffn_step_i8cc_launch.argtypes = [p] * 24 + [i] * 7 + [p]
    lib.cross_ffn_step_i8cc_workspace.restype = ctypes.c_size_t
    lib.cross_ffn_step_i8cc_workspace.argtypes = [i] * 6
    lib.cross_ffn_step_i8cc_tickets.restype = i
    lib.cross_ffn_step_i8cc_tickets.argtypes = [i] * 5
    lib.cross_ffn_step_i8cc_kernel_launches.restype = ctypes.c_longlong
    lib.cross_ffn_step_i8cc_kernel_launches.argtypes = []
    lib.cross_ffn_step_i8cc_error_string.restype = ctypes.c_char_p
    lib.cross_ffn_step_i8cc_error_string.argtypes = [i]
    _lib_i8cc = lib
    return lib


def kernel_launches() -> int:
    """``__global__`` launches of the bf16-plane library (K7) since it was
    loaded."""
    return int(_library().cross_ffn_step_kernel_launches())


def kernel_launches_i8cc() -> int:
    """The same for the int8-plane library (K8)."""
    return int(_library_i8cc().cross_ffn_step_i8cc_kernel_launches())


def _weight_leaves(ln_cross, q, o, ln2, mlp_in, mlp_out, D: int, Fd: int,
                   int8: bool, device):
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
        check_tensor(t, f"cross_ffn_step: {what}", dtype, shape, device)
        leaves.append((i, name, p[name], t))

    for i, (what, p, shape) in enumerate((
            ("ln_cross", ln_cross, None), ("q", q, (D, D)), ("o", o, (D, D)),
            ("ln2", ln2, None), ("mlp_in", mlp_in, (D, Fd)),
            ("mlp_out", mlp_out, (Fd, D)))):
        if shape is None:
            leaf(i, p, "scale", f32, (D,), f"{what} scale")
            leaf(i, p, "bias", f32, (D,), f"{what} bias")
            continue
        leaf(i, p, "kernel_q" if int8 else "kernel", wdt, shape,
             f"{what} kernel")
        leaf(i, p, "w_scale", f32, (shape[1],), f"{what} w_scale")
        leaf(i, p, "bias", f32, (shape[1],), f"{what} bias")
    return leaves


def _launch(x, ln_cross, q, o, ln2, mlp_in, mlp_out, cache_k, cache_v,
            t_actual: int, n_heads: int, k_scale=None, v_scale=None):
    global launches, launches_i8, launches_i8cc
    B, D = x.shape
    T = cache_k.shape[1]
    int8 = "kernel_q" in q
    i8cc = k_scale is not None
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
    dev, cdt = x.device, (torch.int8 if i8cc else torch.bfloat16)
    weights, keep = weight_pointers(
        "cross_ffn_step", (ln_cross, q, o, ln2, mlp_in, mlp_out), dev,
        lambda: _weight_leaves(ln_cross, q, o, ln2, mlp_in, mlp_out, D, Fd,
                               int8, dev))
    check_tensor(x, "cross_ffn_step: x", torch.bfloat16, (B, D), dev)
    planes = [cache_k, cache_v]
    if i8cc:
        planes += [k_scale.float(), v_scale.float()]
    for name, t in zip(("cache_k", "cache_v", "k_scale", "v_scale"), planes):
        check_tensor(t, f"cross_ffn_step: {name}",
                     cdt if t.dim() == 3 else torch.float32,
                     (B, T, D) if t.dim() == 3 else (B, T), dev)
    sms = multiprocessors(dev.index)
    out = torch.empty(B, D, dtype=torch.bfloat16, device=dev)
    ptrs = (x.data_ptr(), *weights, *(t.data_ptr() for t in planes),
            out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if i8cc:
        lib = _library_i8cc()
        tile = v_tile(B, D, T)
        ws = workspace(
            lib.cross_ffn_step_i8cc_workspace(B, D, Fd, T, tile, sms), dev,
            stream)
        tk = tickets(lib.cross_ffn_step_i8cc_tickets(B, D, Fd, T, tile),
                     dev, stream)
        err = lib.cross_ffn_step_i8cc_launch(
            *ptrs, ws.data_ptr(), tk.data_ptr(), B, D, Fd, T, t_actual, tile,
            sms, stream)
        what = lib.cross_ffn_step_i8cc_error_string
    else:
        lib = _library()
        ws = workspace(lib.cross_ffn_step_workspace(B, D, Fd, T, sms), dev,
                       stream)
        tk = tickets(lib.cross_ffn_step_tickets(D, Fd), dev, stream)
        err = lib.cross_ffn_step_launch(
            *ptrs, ws.data_ptr(), tk.data_ptr(), B, D, Fd, T, t_actual,
            int(int8), sms, stream)
        what = lib.cross_ffn_step_error_string
    del keep                    # the casts lived until the launch
    if err:
        raise RuntimeError(
            f"cross_ffn_step kernel launch failed (B={B} D={D} F={Fd} T={T} "
            f"t_actual={t_actual} int8={int8} int8 planes={i8cc}): "
            f"{what(err).decode()}")
    if i8cc:
        launches_i8cc += 1
    else:
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
    cache_k/cache_v [B, T, D] merged-head encoder planes, bf16, or int8
    with ``k_scale``/``v_scale`` f32 [B, T] (these need int8 projections);
    positions ≥ t_actual are masked. Returns x2 + FFN(LN(x2)), x2 = x +
    crossattn(LN(x)). CUDA tensors run the kernel (bf16 serving mode only)
    or raise; CPU tensors run the plain version."""
    if k_scale is not None:
        _need_int8_weights(q)
    if not x.is_cuda:
        if k_scale is not None:
            return cross_ffn_step_i8cc_plain(
                x, ln_cross, q, o, ln2, mlp_in, mlp_out, cache_k, cache_v,
                t_actual, n_heads=n_heads, policy=policy, k_scale=k_scale,
                v_scale=v_scale)
        return cross_ffn_step_plain(x, ln_cross, q, o, ln2, mlp_in, mlp_out,
                                    cache_k, cache_v, t_actual,
                                    n_heads=n_heads, policy=policy)
    if policy.compute != torch.bfloat16:
        raise ValueError("cross_ffn_step: the kernel runs bf16 serving "
                         "mode only")
    return _launch(x.to(torch.bfloat16), ln_cross, q, o, ln2, mlp_in,
                   mlp_out, cache_k, cache_v, int(t_actual), n_heads,
                   k_scale, v_scale)
