"""Whole-layer Whisper decode step: the CUDA kernel and its plain version.

Counterpart of ``misinfo_tpu/ops/pallas_layer.py`` (``fused_layer_step``;
TPU kernel K9 ``_layer_step_kernel_i8``): one decoder layer's whole step
for int8 decode weights, the self-attention step (ops/self_attn_step.py,
K6b) followed by the cross-attention + FFN step (ops/cross_ffn_step.py,
K7b), in one kernel where those are two. The TPU kernel composes the two
int8 bodies verbatim, so its numerics are theirs; here too: the plain
version is ``self_attn_step_plain`` followed by ``cross_ffn_step_plain``,
and the CUDA kernel (``csrc/layer_step.cu``) is one cooperative launch
whose blocks walk the phases of the two kernels' device code with
grid-wide barriers between them, over the same partitions, so that every
partial sum is formed over the same elements in the same order and the
output and the written cache rows are bit for bit those of the two calls.

The self caches [B, S, D] are written in place at row ``pos``; the cross
planes are bf16 [B, T, D] (there is no int8-plane form of this kernel).

``fused_layer_step`` dispatches on where x lies: a CUDA tensor launches
the kernel (bf16 activations only) or raises; a CPU tensor runs
``layer_step_plain``. ``launches`` counts kernel calls; ``kernel_launches``
reads the library's own count of ``__global__`` launches (one per call). A
call carries at most ``MAX_BATCH`` rows.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from misinfo_tpu_torch.ops import cross_ffn_step as _cross
from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops import self_attn_step as _self
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY, Policy
from misinfo_tpu_torch.ops.cuda_build import (
    build, check_tensor, multiprocessors, tickets, weight_pointers, workspace)

HEAD_DIM = 64                   # the kernel's head width (every Whisper size)
MAX_BATCH = 32                  # decode_common.cuh MAXB

launches = 0                    # kernel calls since import (or reset)
graphs.count_launches(__name__, "launches")
build_log = ""                  # nvcc's output of the last build
_lib = None


def _need_int8_weights(blk: Dict) -> None:
    if "kernel_q" not in blk["self_attn"]["qkv"]:
        raise ValueError("fused_layer_step needs int8 decode weights "
                         "(quant='kernels'); got unquantized params")


def layer_step_plain(x, blk: Dict, cache_k, cache_v, cross_k, cross_v,
                     pos: int, t_actual: int, *, n_heads: int,
                     policy: Policy = DEFAULT_POLICY):
    """The kernel's arithmetic: the two steps' plain versions composed."""
    sa, ca = blk["self_attn"], blk["cross_attn"]
    x, cache_k, cache_v = _self.self_attn_step_plain(
        x, blk["ln1"], sa["qkv"], sa["o"], cache_k, cache_v, pos,
        n_heads=n_heads, policy=policy)
    x = _cross.cross_ffn_step_plain(
        x, blk["ln_cross"], ca["q"], ca["o"], blk["ln2"], blk["mlp_in"],
        blk["mlp_out"], cross_k, cross_v, t_actual, n_heads=n_heads,
        policy=policy)
    return x, cache_k, cache_v


_N_POINTERS, _N_INTS = 32, 8


def _library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("layer_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.layer_step_launch.restype = i
    lib.layer_step_launch.argtypes = [p] * _N_POINTERS + [i] * _N_INTS + [p]
    lib.layer_step_workspace.restype = ctypes.c_size_t
    lib.layer_step_workspace.argtypes = [i] * 5
    lib.layer_step_tickets.restype = i
    lib.layer_step_tickets.argtypes = [i, i]
    lib.layer_step_kernel_launches.restype = ctypes.c_longlong
    lib.layer_step_kernel_launches.argtypes = []
    lib.layer_step_error_string.restype = ctypes.c_char_p
    lib.layer_step_error_string.argtypes = [i]
    _lib = lib
    return lib


def kernel_launches() -> int:
    """``__global__`` launches the library has made since it was loaded."""
    return int(_library().layer_step_kernel_launches())


def _launch(x, blk, cache_k, cache_v, cross_k, cross_v, pos: int,
            t_actual: int, n_heads: int):
    global launches
    B, D = x.shape
    S, T = cache_k.shape[1], cross_k.shape[1]
    Fd = blk["mlp_in"]["kernel_q"].shape[1]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"layer_step: the kernel carries 1..{MAX_BATCH} "
                         f"rows, got B={B}")
    if D != n_heads * HEAD_DIM:
        raise ValueError(f"layer_step: the kernel needs {HEAD_DIM}-wide "
                         f"heads, got D={D}, n_heads={n_heads}")
    if not 0 <= pos < S:
        raise ValueError(f"layer_step: pos {pos} outside the cache ({S})")
    if not 1 <= t_actual <= T:
        raise ValueError(f"layer_step: t_actual {t_actual} outside the "
                         f"cross cache ({T})")
    f32, bf16, dev = torch.float32, torch.bfloat16, x.device
    sa, ca = blk["self_attn"], blk["cross_attn"]
    dicts = (blk["ln1"], sa["qkv"], sa["o"], blk["ln_cross"], ca["q"],
             ca["o"], blk["ln2"], blk["mlp_in"], blk["mlp_out"])

    def leaves():
        out = []

        def leaf(i, name, dtype, shape, what):
            t = dicts[i][name].to(dtype)
            check_tensor(t, f"layer_step: {what}", dtype, shape, dev)
            out.append((i, name, dicts[i][name], t))
        for i, what, shape in ((0, "ln1", None), (1, "self qkv", (D, 3 * D)),
                               (2, "self o", (D, D)), (3, "ln_cross", None),
                               (4, "cross q", (D, D)), (5, "cross o", (D, D)),
                               (6, "ln2", None), (7, "mlp_in", (D, Fd)),
                               (8, "mlp_out", (Fd, D))):
            if shape is None:
                leaf(i, "scale", f32, (D,), f"{what} scale")
                leaf(i, "bias", f32, (D,), f"{what} bias")
            else:
                leaf(i, "kernel_q", torch.int8, shape, f"{what} kernel")
                leaf(i, "w_scale", f32, (shape[1],), f"{what} w_scale")
                leaf(i, "bias", f32, (shape[1],), f"{what} bias")
        return out
    weights, keep = weight_pointers("layer_step", dicts, dev, leaves)
    acts = [(x, "x", (B, D)), (cache_k, "cache_k", (B, S, D)),
            (cache_v, "cache_v", (B, S, D)), (cross_k, "cross_k", (B, T, D)),
            (cross_v, "cross_v", (B, T, D))]
    for t, name, shape in acts:
        check_tensor(t, f"layer_step: {name}", bf16, shape, dev)
    lib = _library()
    sms = multiprocessors(dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = workspace(lib.layer_step_workspace(B, D, Fd, T, sms), dev, stream)
    tk = tickets(lib.layer_step_tickets(D, Fd), dev, stream)
    out = torch.empty(B, D, dtype=bf16, device=dev)
    ptrs = (x.data_ptr(), *weights, *(t.data_ptr() for t, *_ in acts[1:]),
            out.data_ptr(), ws.data_ptr(), tk.data_ptr())
    assert len(ptrs) == _N_POINTERS
    err = lib.layer_step_launch(*ptrs, B, D, Fd, S, pos, T, t_actual, sms,
                                stream)
    del keep                    # the casts lived until the launch
    if err:
        raise RuntimeError(
            f"layer_step kernel launch failed (B={B} D={D} F={Fd} S={S} "
            f"pos={pos} T={T} t_actual={t_actual}): "
            f"{lib.layer_step_error_string(err).decode()}")
    launches += 1
    return out, cache_k, cache_v


def fused_layer_step(x, blk: Dict, cache_k, cache_v, cross_k, cross_v,
                     pos: int, t_actual: int, *, n_heads: int,
                     policy: Policy = DEFAULT_POLICY):
    """One decoder layer's whole decode step. x [B, D]; ``blk`` a decoder
    block with the fused ``self_attn.qkv`` and int8 ``kernel_q`` leaves;
    self caches [B, S, D], row ``pos`` written in place; bf16 cross planes
    [B, T, D], positions ≥ t_actual masked. Returns ``(x_out, cache_k,
    cache_v)`` with the same cache tensors. CUDA tensors run the kernel
    (bf16 serving mode only) or raise; CPU tensors run the plain version."""
    _need_int8_weights(blk)
    if not x.is_cuda:
        return layer_step_plain(x, blk, cache_k, cache_v, cross_k, cross_v,
                                pos, t_actual, n_heads=n_heads, policy=policy)
    if policy.compute != torch.bfloat16:
        raise ValueError("layer_step: the kernel runs bf16 serving mode only")
    return _launch(x.to(torch.bfloat16), blk, cache_k, cache_v, cross_k,
                   cross_v, int(pos), int(t_actual), n_heads)
