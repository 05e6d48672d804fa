"""Build a kernel source of ``csrc/`` with nvcc into a shared library.

Each source is compiled for sm_90a into ``build/misinfo_tpu_torch/`` at
first use, keyed by a hash of the source and of the headers it includes
from ``csrc/``, and loaded with ctypes (a plain C interface, no PyTorch
headers: a build takes seconds, not minutes). Never add
``--use_fast_math``: the kernels' quantization scales need IEEE division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "misinfo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _local_headers(src: Path, seen=None):
    """The headers of ``csrc/`` that `src` includes, directly or through
    one of them, each once, in a fixed order."""
    seen = [] if seen is None else seen
    for h in re.findall(r'#include "([^"]+)"', src.read_text()):
        if CSRC / h not in seen:
            seen.append(CSRC / h)
            _local_headers(CSRC / h, seen)
    return seen


def build(name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` (once per content hash) and load it.
    Returns the library and nvcc's output ("" when the build was cached).
    Raises RuntimeError with nvcc's output when the build fails."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in _local_headers(src):
        h.update(dep.read_bytes())
    so = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC),
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log


def check_tensor(t, what: str, dtype, shape, device) -> None:
    """Raise ValueError unless `t` lies on `device` with this dtype and
    shape, contiguous and 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{what} must be on {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous, 16-B aligned")
