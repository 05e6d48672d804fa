"""int4 vault storage: packed nibble rows, per-row scales, and the two
similarity kernels (K10a, K10b) with their plain versions.

Counterpart of ``misinfo_tpu/vault/int4.py``. The host half
(``Int4Vault``, ``quantize_rows_int4``, ``pad_int4_vault``) is the same
numpy code, so a ``<vault>.int4.npz`` sidecar written by either package
holds the same bytes. Byte ``j`` of a packed row holds dimension ``j`` in
its low nibble and dimension ``j + D/2`` in its high nibble (two's
complement, the quantizer emits [-7, 7]); a value dequantizes as
nibble · ``scale[row]``.

Two similarity functions, each a CUDA kernel in ``csrc/int4_sims.cu``
with a plain PyTorch version beside it:

* K10a ``int4_sims`` (TPU kernel ``_int4_sims_kernel``): bf16 query ·
  nibbles with f32 sums, then · scale per row. Every product is exact in
  f32, so kernel and plain version differ only in the order of the sums.
* K10b ``int4_sims_i8`` (TPU kernel ``_int4_sims_kernel_i8``): the query
  quantized per row to int8 (``quantize_query_i8``; the kernel does it
  in its prologue with the same IEEE arithmetic), int8 · nibble products
  summed exactly in int32, then ``(acc · scale[row]) · qscale[b]`` in
  that order. The plain version
  runs the sum as an f32 matmul over the unpacked nibbles: |Σ| ≤
  512·127·7 = 455,168 < 2^24, so every partial sum is an exact integer and
  kernel and plain version are equal bit for bit.

Each wrapper dispatches on where the query lies: a CUDA tensor launches
the kernel or raises; a CPU tensor runs the plain version. ``launches``
counts K10a launches and ``launches_i8`` K10b launches. A launch carries
at most ``MAX_BATCH`` query rows; ``int4_vault_sims`` splits a larger
query batch into consecutive slices of at most ``MAX_BATCH`` rows (every
row is independent, K10b's query quantized per row), one launch each,
and each launch reads the packed rows again.

``int4_vault_sims`` picks between them as the JAX package's dispatcher
does on a TPU: K10b from ``KERNEL_MIN_ROWS`` rows when the row count is
a multiple of ``INT4_TILE_ROWS``, K10a otherwise;
``MISINFO_TPU_INT4_PALLAS`` = ``i8``/``1``/``on``/``true`` forces K10b,
``bf16``/``0`` K10a.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.cuda_build import build, check_tensor
from misinfo_tpu_torch.vault.search import exact_matmul

# The engine pads int4 vaults to this many rows, as the JAX package does
# for its TPU kernel's row tile.
INT4_TILE_ROWS = 2048
# From this many rows the dispatcher runs K10b (the JAX package's
# ``_PALLAS_MIN_ROWS``).
KERNEL_MIN_ROWS = 1 << 16
MAX_BATCH = 64                  # csrc/int4_sims.cu MAXB

_QMAX = 7.0  # symmetric int4 grid [-7, 7]
_INV127 = float(np.float32(1.0) / np.float32(127.0))  # f32 1/127, as XLA folds it

launches = 0                    # K10a launches since import (or reset)
launches_i8 = 0                 # K10b launches
graphs.count_launches(__name__, "launches", "launches_i8")
build_log = ""                  # nvcc's output of the last build
_lib = None


class Int4Vault(NamedTuple):
    """Packed int4 embedding rows: ``packed[n, j]`` holds dim ``j`` (low
    nibble) and dim ``j + D/2`` (high nibble) of row ``n``; dequantized
    value = nibble · ``scale[n]``."""
    packed: np.ndarray   # [N, D//2] uint8
    scale: np.ndarray    # [N] f32 (0.0 for all-zero / padded rows)


def quantize_rows_int4(rows) -> Int4Vault:
    """Per-row symmetric int4 quantization of embedding rows (numpy, host
    side, once at vault prep). D must be even."""
    rows = np.asarray(rows, np.float32)
    n, d = rows.shape
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim, got {d}")
    amax = np.abs(rows).max(axis=1)
    scale = (amax / _QMAX).astype(np.float32)          # 0.0 for zero rows
    safe = np.where(scale > 0, scale, 1.0)[:, None]
    q = np.clip(np.rint(rows / safe), -_QMAX, _QMAX).astype(np.int8)
    lo = q[:, : d // 2].astype(np.uint8) & 0xF
    hi = q[:, d // 2:].astype(np.uint8) & 0xF
    return Int4Vault(packed=(lo | (hi << 4)).astype(np.uint8), scale=scale)


def pad_int4_vault(v: Int4Vault, multiple: int = INT4_TILE_ROWS) -> Int4Vault:
    """Pad the row axis to a multiple (scale 0 ⇒ padded sims are 0; the
    engine pads ``row_valid`` alongside so they can never be top-k)."""
    n = v.packed.shape[0]
    pad = (-n) % multiple
    if not pad:
        return v
    return Int4Vault(
        packed=np.pad(v.packed, ((0, pad), (0, 0))),
        scale=np.pad(v.scale, (0, pad)))


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, D/2] packed uint8 → [N, D] int32 nibble values in [-8, 7].
    The bytes widen to int32 before ``(x ^ 8) - 8`` sign-extends them
    (in uint8 the subtraction would wrap)."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=1)


def quantize_query_i8(query: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Per-row int8 query of K10b → (qi8 int8 [B, D], qscale f32 [B, 1]):
    ``qmax = max(|q|.max(1), 1e-12)``, ``qi8 = clip(round(q · (127 /
    qmax)))``, ``qscale = qmax · f32(1/127)``, the arithmetic of JAX's
    jitted ``int4_sims_pallas_i8``: ``127.0 / qmax`` is an IEEE division
    there, here one of a 0-d tensor (``127.0 / t`` in PyTorch multiplies by
    ``t.reciprocal()``, one ulp off for a quarter of f32 inputs), while
    XLA folds ``qmax / 127.0``, a division by a constant, into a multiply
    by the constant's f32 reciprocal."""
    q = query.float()
    qmax = q.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    qi8 = torch.round(q * torch.div(q.new_full((), 127.0), qmax))
    qi8 = torch.clamp(qi8, -127, 127).to(torch.int8)
    return qi8, qmax * qmax.new_full((), _INV127)


def int4_sims_plain(query: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """K10a's arithmetic in PyTorch ops: bf16 query · nibbles with f32
    sums (a bf16 matmul would round its output to bf16; the upcast
    operands give the exact products), then · scale per row."""
    nib = unpack_int4(packed).float()
    s = exact_matmul(query.to(torch.bfloat16), nib.T)
    return s * scale.float()[None, :]


def int4_sims_i8_plain(query: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """K10b's arithmetic in PyTorch ops: int8 query · nibbles as an f32
    matmul (exact: every partial sum is an integer below 2^24), then
    ``(acc · scale) · qscale``."""
    qi8, qs = quantize_query_i8(query)
    acc = exact_matmul(qi8, unpack_int4(packed).T)
    return acc * scale.float()[None, :] * qs


def _library():
    """Build (once per source hash) and load the kernels' shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("int4_sims")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int4_sims_launch.restype = i
    lib.int4_sims_launch.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.int4_sims_error_string.restype = ctypes.c_char_p
    lib.int4_sims_error_string.argtypes = [i]
    _lib = lib
    return lib


def _launch(q, packed, scale, i8: bool) -> torch.Tensor:
    global launches, launches_i8
    B, D = q.shape
    N = packed.shape[0]
    what = "int4_sims_i8" if i8 else "int4_sims"
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"{what}: the kernel carries 1..{MAX_BATCH} query "
                         f"rows, got B={B}")
    if D % 32 or N < 1:
        raise ValueError(f"{what}: needs D % 32 == 0 and N ≥ 1, got D={D} "
                         f"N={N}")
    dev = q.device
    checks = [(q, "query", torch.float32 if i8 else torch.bfloat16, (B, D)),
              (packed, "packed", torch.uint8, (N, D // 2)),
              (scale, "scale", torch.float32, (N,))]
    for t, name, dt, shape in checks:
        check_tensor(t, f"{what}: {name}", dt, shape, dev)
    lib = _library()
    out = torch.empty(B, N, dtype=torch.float32, device=dev)
    err = lib.int4_sims_launch(
        q.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        B, N, D, int(i8),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed (B={B} N={N} D={D}):"
                           f" {lib.int4_sims_error_string(err).decode()}")
    if i8:
        launches_i8 += 1
    else:
        launches += 1
    return out


def int4_sims(query: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """K10a: [B, D] query (cast to bf16) · int4 rows [N, D/2] · diag(scale)
    → f32 [B, N]. CUDA tensors run the kernel or raise; CPU tensors run
    the plain version. Any N (the kernel masks the ragged edge)."""
    if not query.is_cuda:
        return int4_sims_plain(query, packed, scale)
    return _launch(query.to(torch.bfloat16).contiguous(), packed,
                   scale, i8=False)


def int4_sims_i8(query: torch.Tensor, packed: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """K10b: the query quantized per row to int8, int8 · nibble sums in
    int32, ``(acc · scale) · qscale`` → f32 [B, N]. CUDA tensors run the
    kernel or raise; CPU tensors run the plain version."""
    if not query.is_cuda:
        return int4_sims_i8_plain(query, packed, scale)
    return _launch(query.float().contiguous(), packed, scale, i8=True)


def int4_vault_sims(query: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The dispatcher of ``vault_sims`` for int4 rows (module docstring):
    the same choice on the card (kernels) and on the CPU (their plain
    versions). A query batch of more than ``MAX_BATCH`` rows goes through
    in consecutive slices of at most ``MAX_BATCH`` rows, whose results are
    concatenated: ceil(B / MAX_BATCH) calls."""
    env = os.getenv("MISINFO_TPU_INT4_PALLAS", "auto")
    n = packed.shape[0]
    if env in ("i8", "1", "on", "true") or (
            env == "auto" and n >= KERNEL_MIN_ROWS
            and n % INT4_TILE_ROWS == 0):
        fn = int4_sims_i8
    else:
        fn = int4_sims
    if query.shape[0] <= MAX_BATCH:
        return fn(query, packed, scale)
    return torch.cat([fn(query[lo:lo + MAX_BATCH], packed, scale)
                      for lo in range(0, query.shape[0], MAX_BATCH)])
