"""ctypes bindings for the native C++ byte-level BPE encoder.

Port of ``misinfo_tpu/preprocess/native_bpe.py``, importable without JAX;
held to the JAX package's Python tokenizer by tests/test_torch_native_bpe.py.

`NativeRobertaTokenizer` is a drop-in for preprocess.tokenizer.
RobertaTokenizer with a multithreaded C++ batch path
(``misinfo_tpu_torch/csrc/bpe_encoder.cpp``, built with the host C++
compiler into ``build/misinfo_tpu_torch/`` at first use by
ops/cuda_build.py::build_host). The C++ pre-tokenizer implements the GPT-2
regex exactly for ASCII input; a text with a non-ASCII character or a NUL
goes through the pure-Python ``encode`` instead, so the output is the
Python tokenizer's for every input.

The vocab/merges hand-off inverts GPT-2's byte→printable-unicode mapping
once at load and ships raw-byte hex TSVs to C++, keeping the native side
free of unicode/JSON handling. ctypes' ``CDLL`` releases the GIL for the
length of a batch call.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np

from misinfo_tpu_torch.preprocess.bpe import bytes_to_unicode
from misinfo_tpu_torch.preprocess.tokenizer import RobertaTokenizer

_SOURCE = "bpe_encoder"      # misinfo_tpu_torch/csrc/bpe_encoder.cpp


def _load_lib() -> Optional[ctypes.CDLL]:
    """The encoder's library, built at first use, with its C ABI declared;
    None when the host has no C++ compiler. A compiler that fails raises
    RuntimeError with its output."""
    from misinfo_tpu_torch.ops import cuda_build

    if cuda_build.host_compiler() is None:
        return None
    lib, _ = cuda_build.build_host(_SOURCE)
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int32]
    lib.bpe_destroy.restype = None
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.bpe_encode_batch.restype = None
    lib.bpe_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.bpe_vocab_size.restype = ctypes.c_int32
    lib.bpe_vocab_size.argtypes = [ctypes.c_void_p]
    return lib


def _export_raw_tsvs(bpe, out_dir: str) -> Tuple[str, str]:
    """vocab.json/merges.txt (printable alphabet) → raw-byte hex TSVs."""
    byte_decoder = {v: k for k, v in bytes_to_unicode().items()}

    def to_raw_hex(tok: str) -> Optional[str]:
        try:
            return bytes(byte_decoder[c] for c in tok).hex()
        except KeyError:
            return None  # special tokens — never produced by the merge loop

    vocab_path = os.path.join(out_dir, "vocab_raw.tsv")
    merges_path = os.path.join(out_dir, "merges_raw.tsv")
    with open(vocab_path, "w") as f:
        for tok, idx in bpe.core.encoder.items():
            h = to_raw_hex(tok)
            if h is not None:
                f.write(f"{idx}\t{h}\n")
    with open(merges_path, "w") as f:
        for (a, b), _rank in sorted(bpe.core.bpe_ranks.items(),
                                    key=lambda kv: kv[1]):
            ha, hb = to_raw_hex(a), to_raw_hex(b)
            if ha is not None and hb is not None:
                f.write(f"{ha}\t{hb}\n")
    return vocab_path, merges_path


def _native_text(t: str) -> bool:
    """Whether the C++ pre-tokenizer gives Python's tokens for ``t``: ASCII
    without a NUL (a C string ends at its first NUL)."""
    return t.isascii() and "\x00" not in t


class NativeRobertaTokenizer(RobertaTokenizer):
    """RobertaTokenizer with a C++ batch path. Without a host C++ compiler
    ``native_available`` is False and ``batch`` is the Python one."""

    def __init__(self, vocab_file: str, merges_file: str,
                 num_threads: int = 0):
        super().__init__(vocab_file, merges_file)
        self.num_threads = num_threads or min(8, os.cpu_count() or 1)
        self._handle = None
        self._lib = _load_lib()
        if self._lib is not None:
            with tempfile.TemporaryDirectory(prefix="misinfo_bpe_") as tmp:
                vp, mp = _export_raw_tsvs(self.bpe, tmp)
                self._handle = self._lib.bpe_create(
                    vp.encode(), mp.encode(), self.bpe.unk_id)
            if not self._handle:
                raise RuntimeError("bpe_create could not read the exported "
                                   f"vocab and merges of {vocab_file}")

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    def batch(self, texts: Sequence[str], max_length: int):
        if self._handle is None:
            return super().batch(texts, max_length)
        native, other = [], []
        for i, t in enumerate(texts):
            (native if _native_text(t) else other).append(i)
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        if native:
            n = len(native)
            arr = (ctypes.c_char_p * n)(*[texts[i].encode("ascii")
                                          for i in native])
            sub_ids = np.empty((n, max_length), np.int32)
            sub_mask = np.empty((n, max_length), np.int32)
            self._lib.bpe_encode_batch(
                self._handle, arr, n, max_length, self.bos_id, self.eos_id,
                self.pad_id,
                sub_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                sub_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self.num_threads)
            ids[native] = sub_ids
            mask[native] = sub_mask
        for i in other:                 # → the exact Python path
            seq = self.encode(texts[i], max_length)
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return ids, mask

    def __del__(self):  # pragma: no cover
        handle, self._handle = getattr(self, "_handle", None), None
        if handle is not None:
            self._lib.bpe_destroy(handle)


def build_native_library(log=print) -> bool:
    """Compile csrc/bpe_encoder.cpp into build/misinfo_tpu_torch/ with the
    host C++ compiler (idempotent: keyed by the source's hash). False, with
    the reason logged, when there is no compiler or the build fails."""
    from misinfo_tpu_torch.ops import cuda_build

    try:
        cuda_build.build_host(_SOURCE)
        return True
    except (OSError, RuntimeError) as e:
        log(f"native build failed: {e}")
        return False
