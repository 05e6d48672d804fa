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
from misinfo_tpu_torch.ops import self_attn_step as _self
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY, Policy
from misinfo_tpu_torch.ops.cuda_build import build, check_tensor

HEAD_DIM = 64                   # the kernel's head width (every Whisper size)
MAX_BATCH = 32                  # decode_common.cuh MAXB

launches = 0                    # kernel calls since import (or reset)
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


_N_POINTERS, _N_INTS = 31, 8


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
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    sa, ca = blk["self_attn"], blk["cross_attn"]
    args = [(x, "x", bf16, (B, D))]

    def ln(name):
        args.append((blk[name]["scale"].float(), f"{name} scale", f32, (D,)))
        args.append((blk[name]["bias"].float(), f"{name} bias", f32, (D,)))

    def mat(p, name, shape):
        args.append((p["kernel_q"], f"{name} kernel", i8, shape))
        args.append((p["w_scale"].float(), f"{name} w_scale", f32,
                     (shape[1],)))
        args.append((p["bias"].float(), f"{name} bias", f32, (shape[1],)))

    ln("ln1")
    mat(sa["qkv"], "self qkv", (D, 3 * D))
    mat(sa["o"], "self o", (D, D))
    ln("ln_cross")
    mat(ca["q"], "cross q", (D, D))
    mat(ca["o"], "cross o", (D, D))
    ln("ln2")
    mat(blk["mlp_in"], "mlp_in", (D, Fd))
    mat(blk["mlp_out"], "mlp_out", (Fd, D))
    args += [(cache_k, "cache_k", bf16, (B, S, D)),
             (cache_v, "cache_v", bf16, (B, S, D)),
             (cross_k, "cross_k", bf16, (B, T, D)),
             (cross_v, "cross_v", bf16, (B, T, D))]
    for t, name, dt, shape in args:
        check_tensor(t, f"layer_step: {name}", dt, shape, x.device)
    lib = _library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ws = torch.empty(lib.layer_step_workspace(B, D, Fd, T, sms),
                     dtype=torch.uint8, device=x.device)
    out = torch.empty(B, D, dtype=bf16, device=x.device)
    ptrs = [t.data_ptr() for t, *_ in args] + [out.data_ptr(), ws.data_ptr()]
    assert len(ptrs) == _N_POINTERS
    err = lib.layer_step_launch(
        *ptrs, B, D, Fd, S, pos, T, t_actual, sms,
        torch.cuda.current_stream(x.device).cuda_stream)
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
