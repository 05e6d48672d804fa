"""int8 dense layer: the hand-written CUDA kernel and its plain version.

Counterpart of ``misinfo_tpu/ops/pallas_int8.py::int8_dense_pallas`` (the
TPU kernel K2, ``_dense_kernel``), which serves ``quant="int8"`` from 256
rows: quantize each row of x to int8, multiply by the int8 kernel with
exact int32 sums, then ``(yi·sx)·w_scale + bias`` in f32 and cast to the
output dtype.

The numerics are those of the JAX function as XLA compiles it, which the
JAX package's tests hold bit-identical to the jitted ``dense_int8``:
the row scale multiplies the abs-max by f32(1/127) (XLA folds JAX's
``/ 127.0`` into that multiply; the eager function divides, and one scale
in a few differs by an ulp), and the multiply-add of the epilogue rounds
once (XLA fuses it). ``int8_dense_plain`` reproduces both: the scale with
a 0-d f32 tensor, the fused multiply-add in float64, where the product of
two floats is exact, rounded to f32 once.

``int8_dense`` dispatches on where its input lies: a CUDA tensor launches
the kernels in ``csrc/int8_dense.cu`` (built with ``nvcc`` at first use:
a quantize pass, then the product) or raises; a CPU tensor runs
``int8_dense_plain``. On the card the weight must be K-major
(``wq.t()`` contiguous: the layout ``serving.kmajor`` gives it and the
engine serves). ``launches`` counts calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.cuda_build import build, check_tensor, workspace
from misinfo_tpu_torch.ops.quant import (
    int_matmul, quantize_rows_folded)

_IN_DTYPES = (torch.bfloat16, torch.float32)

launches = 0                        # kernel launches since import (or reset)
graphs.count_launches(__name__, "launches")
build_log = ""                      # nvcc's output of the last build
_lib = None


def int8_dense_rows(xq, sx, wq, w_scale, bias, out_dtype) -> torch.Tensor:
    """The product and epilogue of quantized rows (xq [M, K], sx [M, 1])."""
    p = int_matmul(xq, wq) * sx
    if bias is None:
        y = p * w_scale
    else:
        y = (p.double() * w_scale.double() + bias.double()).float()
    return y.to(out_dtype)


def int8_dense_plain(x, wq, w_scale, bias=None, *,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: x [..., K] → [..., N]."""
    K, N = wq.shape
    xq, sx = quantize_rows_folded(x.reshape(-1, K).float())
    y = int8_dense_rows(xq, sx, wq, w_scale, bias, out_dtype)
    return y.reshape(*x.shape[:-1], N)


def _library():
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("int8_dense")
    lib.int8_dense_launch.restype = ctypes.c_int
    lib.int8_dense_launch.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.int8_dense_workspace.restype = ctypes.c_size_t
    lib.int8_dense_workspace.argtypes = [ctypes.c_int] * 2
    lib.int8_dense_error_string.restype = ctypes.c_char_p
    lib.int8_dense_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def _launch(x, wq, w_scale, bias, out_dtype) -> torch.Tensor:
    global launches
    K, N = wq.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if x.dtype not in _IN_DTYPES or out_dtype not in _IN_DTYPES:
        raise ValueError(f"int8_dense: x and out must be bf16 or f32, got "
                         f"{x.dtype} → {out_dtype}")
    check_tensor(x2, "int8_dense: x", x.dtype, (M, K), x.device)
    check_tensor(wq.t(), "int8_dense: wq.t() (the K-major weight)",
                 torch.int8, (N, K), x.device)
    check_tensor(w_scale, "int8_dense: w_scale", torch.float32, (N,),
                 x.device)
    if bias is not None:
        check_tensor(bias, "int8_dense: bias", torch.float32, (N,), x.device)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    if M:
        lib = _library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        work = workspace(lib.int8_dense_workspace(M, K), x.device, stream)
        err = lib.int8_dense_launch(
            x2.data_ptr(), wq.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            work.data_ptr(), M, K, N, int(x.dtype == torch.float32),
            int(out_dtype == torch.float32), stream)
        if err:
            raise RuntimeError(
                f"int8_dense kernel launch failed (M={M} K={K} N={N}): "
                f"{lib.int8_dense_error_string(err).decode()}")
        launches += 1
    return out.reshape(*x.shape[:-1], N)


def int8_dense(x, wq, w_scale, bias: Optional[torch.Tensor] = None, *,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 dense on x [..., K] → [..., N] in ``out_dtype``. CUDA tensors
    run the kernel or raise; CPU tensors run the plain version."""
    if not x.is_cuda:
        return int8_dense_plain(x, wq, w_scale, bias, out_dtype=out_dtype)
    return _launch(x, wq, w_scale, bias, out_dtype)
