"""Fused int8 FFN: the hand-written CUDA kernel and its plain version.

Counterpart of ``misinfo_tpu/ops/pallas_int8.py`` (``_ffn_kernel``, the
TPU kernel K1). Per row of x: quantize to int8, then for each chunk of
``jc`` intermediate columns run an int8 product against W1, dequantize
and add the bias in f32, apply the activation with bf16 roundings,
re-quantize the chunk per row and accumulate its int8 product against W2
in f32; finally scale by W2's channel scales and add its bias.

``int8_ffn`` dispatches on where its input lies: a CUDA tensor launches
the kernel in ``csrc/int8_ffn.cu`` (built with ``nvcc`` at first use into
``build/misinfo_tpu_torch/``, keyed by a hash of the source) or raises; a
CPU tensor runs ``int8_ffn_plain``. ``launches`` counts kernel launches.

When the 32-row tiles of x are fewer than the card's SMs, the wrapper
hands the kernel an f32 workspace for the split form (one block per
(row tile, chunk), partials summed in chunk order by a second pass), so
a single request spreads over the card; results are bit-identical
either way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from misinfo_tpu_torch.ops.common import DEFAULT_POLICY, Policy
from misinfo_tpu_torch.ops.quant import int_matmul, quantize_rows

_JC = 512                       # intermediate chunk target, as on the TPU
_BM = 32                        # rows per block (BM in csrc/int8_ffn.cu)
_MODES = {"tanh": 0, "erf": 1, "quick": 2}
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "int8_ffn.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "misinfo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0                    # kernel launches since import (or reset)
build_log = ""                  # nvcc's output of the last build
_lib = None


def pick_chunk(total: int, target: int = _JC, align: int = 128) -> int:
    """Largest divisor of `total` ≤ target that is a multiple of `align`,
    else `total` (``pallas_int8._pick``): the default ``jc``."""
    for c in range(min(target, total), align - 1, -align):
        if total % c == 0 and c % align == 0:
            return c
    return total


def _act(h32: torch.Tensor, dtype: torch.dtype, mode: str) -> torch.Tensor:
    """f32 pre-activation → activation in ``dtype`` (``_act_f32``)."""
    h = h32.to(dtype)
    hf = h.float()
    if mode == "quick":
        return h * torch.sigmoid(1.702 * hf).to(dtype)
    approx = "tanh" if mode == "tanh" else "none"
    return torch.nn.functional.gelu(hf, approximate=approx).to(dtype)


def int8_ffn_plain(x, w1q, s1, b1, w2q, s2, b2, *, mode: str = "tanh",
                   jc: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops; output in x's dtype. With
    ``jc == N`` this is the JAX package's ``int8_ffn_xla``."""
    K, N = w1q.shape
    K2 = w2q.shape[1]
    jc = jc or pick_chunk(N)
    lead = x.shape[:-1]
    xq, sx = quantize_rows(x.reshape(-1, K).float())
    acc = torch.zeros(xq.shape[0], K2, device=x.device)
    for j0 in range(0, N, jc):
        h = int_matmul(xq, w1q[:, j0:j0 + jc]) * sx * s1[j0:j0 + jc] \
            + b1[j0:j0 + jc]
        gq, sg = quantize_rows(_act(h, x.dtype, mode).float())
        acc = acc + int_matmul(gq, w2q[j0:j0 + jc]) * sg
    return (acc * s2 + b2).to(x.dtype).reshape(*lead, K2)


def _library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"int8_ffn_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {_SRC}:\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.int8_ffn_launch.restype = ctypes.c_int
    lib.int8_ffn_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.int8_ffn_error_string.restype = ctypes.c_char_p
    lib.int8_ffn_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"int8_ffn: {name} must be on {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"int8_ffn: {name} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"int8_ffn: {name} must be contiguous, 16-B aligned")


def _launch(x, w1q, s1, b1, w2q, s2, b2, mode: str, jc: int) -> torch.Tensor:
    global launches
    K, N = w1q.shape
    K2 = w2q.shape[1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    for t, name, dt, shape in (
            (x2, "x", torch.bfloat16, (M, K)),
            (w1q, "w1q", torch.int8, (K, N)), (s1, "s1", torch.float32, (N,)),
            (b1, "b1", torch.float32, (N,)),
            (w2q, "w2q", torch.int8, (N, K2)),
            (s2, "s2", torch.float32, (K2,)),
            (b2, "b2", torch.float32, (K2,))):
        _check(t, name, dt, shape, x.device)
    out = torch.empty(M, K2, dtype=torch.bfloat16, device=x.device)
    if M:
        lib = _library()
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        part = (torch.empty(N // jc, M, K2, device=x.device)
                if -(-M // _BM) < sms else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_ffn_launch(
            x2.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2q.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            M, K, N, K2, jc, _MODES[mode], stream)
        if err:
            raise RuntimeError(
                f"int8_ffn kernel launch failed (M={M} K={K} N={N} K2={K2} "
                f"jc={jc} mode={mode}): "
                f"{lib.int8_ffn_error_string(err).decode()}")
        launches += 1
    return out.reshape(*x.shape[:-1], K2)


def int8_ffn(x, w1q, s1, b1, w2q, s2, b2, *, mode: str = "tanh",
             jc: Optional[int] = None) -> torch.Tensor:
    """Fused int8 FFN on x [..., K] → [..., K2] in x's dtype. CUDA tensors
    run the kernel (bf16 only) or raise; CPU tensors run the plain version."""
    jc = jc or pick_chunk(w1q.shape[1])
    if not x.is_cuda:
        return int8_ffn_plain(x, w1q, s1, b1, w2q, s2, b2, mode=mode, jc=jc)
    return _launch(x, w1q, s1, b1, w2q, s2, b2, mode, jc)


def int8_ffn_apply(p_in: Dict, p_out: Dict, x: torch.Tensor, *,
                   policy: Policy = DEFAULT_POLICY,
                   mode: str = "tanh") -> torch.Tensor:
    """Tower FFN entry point for int8-quantized layers
    ({kernel_q, w_scale, bias})."""
    return int8_ffn(x.to(policy.compute), p_in["kernel_q"], p_in["w_scale"],
                    p_in["bias"], p_out["kernel_q"], p_out["w_scale"],
                    p_out["bias"], mode=mode)
