"""Fused transformer FFN (K5): the hand-written CUDA kernel and its plain
version.

Counterpart of ``misinfo_tpu/ops/pallas_ffn.py`` (the TPU kernel
``_ffn_kernel``, selected by ``use_pallas="ffn"`` in the towers and by
``pallas_ffn=True`` in the Whisper decode step): ``x @ W1 + b1`` in f32,
rounded to the compute dtype, the activation with the casts of ``_act``
(tanh or erf GELU, or CLIP's quick_gelu), then ``g @ W2`` summed in f32
chunk by chunk over ``jc`` intermediate columns, ``+ b2`` and the compute
dtype out.

``fused_ffn`` dispatches on where its input lies: a CUDA tensor launches
the kernel in ``csrc/fused_ffn.cu`` (built with ``nvcc`` at first use) or
raises; a CPU tensor runs ``fused_ffn_plain``. ``launches`` counts calls
that launched the kernel. In bf16 that is two or three CUDA kernels on
the tensor cores (the up product with the activation, writing the
intermediate to a per-stream workspace; the down product; with N split,
the sum of the splits), with tiles and split chosen by ``plan``; in f32
one.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY, Policy, matmul_f32
from misinfo_tpu_torch.ops.cuda_build import (
    build, check_tensor, multiprocessors, workspace)
from misinfo_tpu_torch.ops.int8_ffn import _MODES, _act, pick_chunk

_DTYPES = (torch.bfloat16, torch.float32)
# csrc/fused_ffn.cu's bf16 tiles (rows, columns) by configuration index
UP_TILES = ((128, 256), (64, 128), (64, 64))
DOWN_TILES = ((128, 256), (64, 128), (64, 64))
K_SLICE = 64                    # N columns per slice of the down product
F32_TILES = (16, 128)           # the f32 kernel's rows per block, chunk
H100_SMS = 132


class Plan(NamedTuple):
    """The bf16 kernel's tiles and split for one call: ``up``/``down``
    index UP_TILES/DOWN_TILES; N's ``N/64`` slices go to ``splits``
    ranges of ``per`` (the last may be shorter)."""
    up: int
    down: int
    splits: int
    per: int


def plan(M: int, N: int, K2: int, sms: int = H100_SMS) -> Plan:
    """Tiles and split of a bf16 call on a card with ``sms`` SMs: the
    large tiles where they make at least one wave, else the 64-row tiles
    (two blocks to an SM); the down product splits N until its blocks
    fill the card (each range at least two slices)."""
    def count(shape, cols):
        return -(-M // shape[0]) * -(-cols // shape[1])

    up = 0 if count(UP_TILES[0], N) >= sms else 1 if M > 64 else 2
    if K2 % 256 == 0 and count(DOWN_TILES[0], K2) >= sms:
        down = 0
    else:
        down = 1 if M > 64 else 2
    slots = sms * (1 if down == 0 else 2)
    kb = -(-N // K_SLICE)
    splits = max(1, min(slots // count(DOWN_TILES[down], K2), kb // 2))
    per = -(-kb // splits)
    return Plan(up, down, -(-kb // per), per)


def tiles(M: int, N: int, K2: int, dtype, sms: int = H100_SMS):
    """(rows of an output tile, columns of an intermediate tile) of the
    kernel for this call: the f32 kernel's block and chunk, or the bf16
    down and up tiles of ``plan``."""
    if dtype == torch.float32:
        return F32_TILES
    p = plan(M, N, K2, sms)
    return DOWN_TILES[p.down][0], UP_TILES[p.up][1]


def sm_count(device) -> int:
    """The SM count that sets a call's plan: the card's, or an H100's for
    the CPU (where the checks emulate the card's tiles)."""
    device = torch.device(device)
    if device.type == "cuda":
        return multiprocessors(device.index or 0)
    return H100_SMS

launches = 0                    # kernel launches since import (or reset)
graphs.count_launches(__name__, "launches")
build_log = ""                  # nvcc's output of the last build
_lib = None


def fused_ffn_plain(x, w1, b1, w2, b2, *, mode: str = "tanh",
                    jc: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops; output in x's dtype."""
    K, N = w1.shape
    K2 = w2.shape[1]
    jc = jc or pick_chunk(N)
    x2 = x.reshape(-1, K)
    acc = torch.zeros(x2.shape[0], K2, device=x.device)
    for j0 in range(0, N, jc):
        h = matmul_f32(x2, w1[:, j0:j0 + jc]) + b1[j0:j0 + jc].float()
        acc = acc + matmul_f32(_act(h, x.dtype, mode), w2[j0:j0 + jc])
    return (acc + b2.float()).to(x.dtype).reshape(*x.shape[:-1], K2)


def _library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("fused_ffn")
    lib.fused_ffn_launch.restype = ctypes.c_int
    lib.fused_ffn_launch.argtypes = ([ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.fused_ffn_workspace.restype = ctypes.c_size_t
    lib.fused_ffn_workspace.argtypes = [ctypes.c_int] * 4
    lib.fused_ffn_error_string.restype = ctypes.c_char_p
    lib.fused_ffn_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def _launch(x, w1, b1, w2, b2, mode: str) -> torch.Tensor:
    global launches
    K, N = w1.shape
    K2 = w2.shape[1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    dt = x.dtype
    if dt not in _DTYPES:
        raise ValueError(f"fused_ffn: x must be bf16 or f32, got {dt}")
    for t, name, tdt, shape in (
            (x2, "x", dt, (M, K)), (w1, "w1", dt, (K, N)),
            (b1, "b1", torch.float32, (N,)), (w2, "w2", dt, (N, K2)),
            (b2, "b2", torch.float32, (K2,))):
        check_tensor(t, f"fused_ffn: {name}", tdt, shape, x.device)
    out = torch.empty(M, K2, dtype=dt, device=x.device)
    if M:
        lib = _library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        f32 = dt == torch.float32
        p = Plan(0, 0, 1, 1) if f32 else plan(M, N, K2, sm_count(x.device))
        work = None if f32 else workspace(
            lib.fused_ffn_workspace(M, N, K2, p.splits), x.device,
            stream).data_ptr()
        err = lib.fused_ffn_launch(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), work, M, K, N, K2, _MODES[mode],
            int(f32), *p, stream)
        if err:
            raise RuntimeError(
                f"fused_ffn kernel launch failed (M={M} K={K} N={N} K2={K2} "
                f"{dt} mode={mode} {p}): "
                f"{lib.fused_ffn_error_string(err).decode()}")
        launches += 1
    return out.reshape(*x.shape[:-1], K2)


def fused_ffn(x, w1, b1, w2, b2, *, mode: str = "tanh") -> torch.Tensor:
    """x [..., K] @ w1 [K, N] (+b1) → act → @ w2 [N, K2] (+b2), operands
    in the compute dtype, biases f32. CUDA tensors run the kernel or
    raise; CPU tensors run the plain version."""
    if not x.is_cuda:
        return fused_ffn_plain(x, w1, b1, w2, b2, mode=mode)
    return _launch(x, w1, b1, w2, b2, mode)


def ffn_apply(p_in: Dict, p_out: Dict, x: torch.Tensor, *,
              policy: Policy = DEFAULT_POLICY,
              mode: str = "tanh") -> torch.Tensor:
    """Tower FFN entry point for a {kernel, bias} pair (the contract of
    ``dense → act → dense``)."""
    c = policy.compute
    return fused_ffn(x.to(c), p_in["kernel"].to(c), p_in["bias"].float(),
                     p_out["kernel"].to(c), p_out["bias"].float(), mode=mode)
