"""Build a kernel source of ``csrc/`` with nvcc into a shared library.

Each source is compiled for sm_90a into ``build/misinfo_tpu_torch/`` at
first use, keyed by a hash of the source and of the headers it includes
from ``csrc/``, and loaded with ctypes (a plain C interface, no PyTorch
headers: a build takes seconds, not minutes). Never add
``--use_fast_math``: the kernels' quantization scales need IEEE division.
``build_host`` does the same for a host source, ``csrc/<name>.cpp``, with
the host C++ compiler (the BPE encoder of preprocess/native_bpe.py).

``tickets`` keeps the zeroed counters that the decode-step kernels use to
find the last block of each column tile (or batch row), ``workspace``
their scratch, one each per stream, sized before a CUDA-graph capture
(ops/graphs.py) and never moved under one;
``weight_pointers`` validates a decode step's weights once per weight set
and keeps their pointers, so that a step's host work is its activations.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import weakref
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "misinfo_tpu_torch"
_PER_STREAM: Dict[tuple, torch.Tensor] = {}
_CAPTURED: set = set()          # per-stream buffers a CUDA graph points at
_RETIRED: List[torch.Tensor] = []   # outgrown ones among them, kept alive
_WEIGHTS: "OrderedDict[tuple, tuple]" = OrderedDict()
_WEIGHTS_LOCK = threading.Lock()
WEIGHT_SETS = 64        # weight sets whose pointers are kept (LRU)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def _local_headers(src: Path, seen=None):
    """The headers of ``csrc/`` that `src` includes, directly or through
    one of them, each once, in a fixed order."""
    seen = [] if seen is None else seen
    for h in re.findall(r'#include "([^"]+)"', src.read_text()):
        if CSRC / h not in seen:
            seen.append(CSRC / h)
            _local_headers(CSRC / h, seen)
    return seen


def _compiled(src: Path, digest, tool: str, flags: Sequence[str]
              ) -> Tuple[ctypes.CDLL, str]:
    """Compile ``src`` with ``tool`` into ``BUILD_DIR`` under the name of
    its content ``digest`` (once) and load it. Returns the library and the
    compiler's output ("" when the build was cached). The output goes to a
    name of this process and thread first, then into place, so workers
    that build the same source at once do not race. Raises RuntimeError
    with the compiler's output when the build fails."""
    so = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([tool, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(tool).name} failed building {src}:"
                               f"\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log


def build(name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` (once per content hash) and load it.
    Returns the library and nvcc's output ("" when the build was cached).
    Raises RuntimeError with nvcc's output when the build fails."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in _local_headers(src):
        h.update(dep.read_bytes())
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return _compiled(src, h, nvcc, (*NVCC_FLAGS, "-I", str(CSRC)))


def host_compiler() -> Optional[str]:
    """The host C++ compiler on PATH (g++, else c++), or None."""
    return shutil.which("g++") or shutil.which("c++")


def build_host(name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile the host source ``csrc/<name>.cpp`` with the host C++
    compiler (once per content hash) and load it, as ``build`` does a
    kernel. Raises FileNotFoundError when there is no compiler, and
    RuntimeError with its output when the build fails."""
    cxx = host_compiler()
    if cxx is None:
        raise FileNotFoundError("no host C++ compiler (g++ or c++) on PATH")
    src = CSRC / f"{name}.cpp"
    return _compiled(src, hashlib.sha256(src.read_bytes()), cxx, CXX_FLAGS)


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


def _per_stream(kind: str, n: int, dtype, device, stream: int):
    """The buffer of (kind, device, stream), grown to ``n`` elements.
    Under a CUDA-graph capture it must not grow: the new buffer would land
    in the graph's pool and the old one be freed while earlier graphs
    point at it, so a capture that needs more raises (run the program
    eagerly on the capture stream first, which sizes it). A buffer that a
    capture has used is kept alive when a later eager call outgrows it."""
    key = (kind, device.index, stream)
    t = _PER_STREAM.get(key)
    capturing = torch.cuda.is_current_stream_capturing()
    if t is None or t.numel() < n:
        if capturing:
            raise RuntimeError(
                f"{kind}: {n} elements asked for during a CUDA-graph capture "
                f"on stream {stream:#x}, which has "
                f"{0 if t is None else t.numel()}; run the program eagerly "
                "on the capture stream before capturing it")
        if key in _CAPTURED:
            _RETIRED.append(t)
        t = torch.zeros(n, dtype=dtype, device=device)
        _PER_STREAM[key] = t
    elif capturing:
        _CAPTURED.add(key)
    return t


def tickets(n: int, device, stream: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` tickets on ``device``, one
    per stream. A kernel call takes tickets and leaves them at zero again,
    so the calls in one stream's order share it."""
    return _per_stream("tickets", n, torch.int32, device, stream)


def workspace(nbytes: int, device, stream: int) -> torch.Tensor:
    """A scratch buffer of at least ``nbytes`` on ``device``, one per
    stream: the calls in one stream's order run one after the other (a
    kernel launched early writes nothing before the kernel ahead of it
    has finished), so they share it."""
    return _per_stream("workspace", nbytes, torch.uint8, device, stream)


@functools.lru_cache(maxsize=None)
def multiprocessors(index: int) -> int:
    """The SM count of CUDA device ``index``, which sets the kernels'
    partitions."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _absent():
    return None


def weight_pointers(tag: str, dicts: Sequence[Dict], device,
                    prepare: Callable[[], List[tuple]]) -> Tuple[tuple, list]:
    """The kernel-side pointers of one call's weights, and the tensors the
    caller must hold until its launch. ``prepare()`` returns ``(i, name,
    source, tensor)`` per leaf: the leaf ``name`` of ``dicts[i]`` and the
    tensor the kernel reads (``source`` itself or a cast of it), after
    checking each; an absent leaf (None, None) passes a null pointer. Where no leaf needed a cast, the pointers are kept per
    (tag, device, the dicts' ids) while every dict still holds the same
    leaf objects, so a decode runs the checks once per layer; a weight set
    with casts is prepared anew at every call."""
    key = (tag, device, *map(id, dicts))
    with _WEIGHTS_LOCK:
        hit = _WEIGHTS.get(key)
        if hit is not None and all(dicts[i].get(name) is ref()
                                   for i, name, ref in hit[0]):
            _WEIGHTS.move_to_end(key)
            return hit[1], []
    leaves = prepare()
    ptrs = tuple(None if t is None else t.data_ptr() for *_, t in leaves)
    if all(src is t for _, _, src, t in leaves):
        with _WEIGHTS_LOCK:
            _WEIGHTS[key] = ([(i, name, _absent if src is None
                               else weakref.ref(src))
                              for i, name, src, _ in leaves], ptrs)
            while len(_WEIGHTS) > WEIGHT_SETS:
                _WEIGHTS.popitem(last=False)
    return ptrs, [t for *_, t in leaves]
