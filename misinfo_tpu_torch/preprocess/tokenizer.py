"""Tokenizer facades producing fixed-shape int32 arrays for the XLA engine.

Host copy of ``misinfo_tpu/preprocess/tokenizer.py``, importable without
JAX; held to the original by tests/test_torch_host.py.

The engine's jit signatures are static (SURVEY.md §7.1): RoBERTa text is
padded to ``max_length`` (512 at inference, reference misinfo_forensics.py:329;
256 in training, reference train_roberta_detective.py:160) and CLIP text to 77
(reference misinformation_dataset.py:73). Special-token layout matches the
HuggingFace tokenizers the reference relies on.

When no vocab assets are on disk (this framework never downloads), the
deterministic :class:`HashTokenizer` stands in so the full pipeline remains
runnable end-to-end; it is explicitly not parity-grade and engines report it
via ``tokenizer.parity_grade``.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from misinfo_tpu_torch.preprocess.bpe import ByteLevelBPE, ClipBPE, _whitespace_clean


class _Batcher:
    """Shared pad/truncate logic → (ids, mask) int32 arrays."""

    def batch(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for r, t in enumerate(texts):
            seq = self.encode(t, max_length)
            ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = 1
        return ids, mask


class RobertaTokenizer(_Batcher):
    """Byte-level BPE with RoBERTa special tokens <s>/<pad>/</s>/<unk>."""

    parity_grade = True

    def __init__(self, vocab_file: str, merges_file: str):
        self.bpe = ByteLevelBPE(vocab_file, merges_file)
        enc = self.bpe.core.encoder
        self.bos_id = enc.get("<s>", 0)
        self.pad_id = enc.get("<pad>", 1)
        self.eos_id = enc.get("</s>", 2)
        self.vocab_size = self.bpe.vocab_size

    @classmethod
    def from_dir(cls, d: str) -> "RobertaTokenizer":
        return cls(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        body = self.bpe.encode(text)[: max_length - 2]
        return [self.bos_id] + body + [self.eos_id]

    def decode(self, ids: Sequence[int]) -> str:
        specials = {self.bos_id, self.pad_id, self.eos_id}
        return self.bpe.decode([i for i in ids if i not in specials])


class ClipTokenizer(_Batcher):
    """CLIP BPE with <|startoftext|>/<|endoftext|>; pads with EOT, matching
    HF so the text tower's argmax-EOT pooling lands on the first EOT."""

    parity_grade = True

    def __init__(self, vocab_file: str, merges_file: str):
        self.bpe = ClipBPE(vocab_file, merges_file)
        enc = self.bpe.core.encoder
        self.sot_id = enc.get("<|startoftext|>", len(enc) - 2)
        self.eot_id = enc.get("<|endoftext|>", len(enc) - 1)
        self.pad_id = self.eot_id
        self.vocab_size = self.bpe.vocab_size

    @classmethod
    def from_dir(cls, d: str) -> "ClipTokenizer":
        return cls(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))

    def encode(self, text: str, max_length: int = 77) -> List[int]:
        body = self.bpe.encode(text)[: max_length - 2]
        return [self.sot_id] + body + [self.eot_id]


class HashTokenizer(_Batcher):
    """Deterministic whitespace/punct word hasher into a fixed vocab range.

    Stand-in used when BPE vocab assets are absent (zero-egress environment).
    Token layout mimics the requested dialect so downstream shapes and
    special-token semantics are identical.
    """

    parity_grade = False

    def __init__(self, dialect: str = "roberta", vocab_size: int = 50265):
        self.dialect = dialect
        self.vocab_size = vocab_size
        if dialect == "roberta":
            self.bos_id, self.pad_id, self.eos_id = 0, 1, 2
            self._lo = 10
        elif dialect == "clip":
            self.sot_id, self.eot_id = vocab_size - 2, vocab_size - 1
            self.bos_id, self.eos_id = self.sot_id, self.eot_id
            self.pad_id = self.eot_id
            self._lo = 1
        else:
            raise ValueError(dialect)

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        hi = self.vocab_size - (3 if self.dialect == "clip" else 4)
        return self._lo + (h % (hi - self._lo))

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        if self.dialect == "clip":
            text = _whitespace_clean(text).lower()
        words: List[str] = []
        for raw in text.split():
            cur = ""
            for ch in raw:
                if ch.isalnum() or ch == "'":
                    cur += ch
                else:
                    if cur:
                        words.append(cur)
                        cur = ""
                    words.append(ch)
            if cur:
                words.append(cur)
        body = [self._word_id(w) for w in words][: max_length - 2]
        return [self.bos_id] + body + [self.eos_id]


def load_roberta_tokenizer(tokenizer_dir: Optional[str],
                           vocab_size: int = 50265) -> _Batcher:
    """The native C++ batch encoder (preprocess/native_bpe.py) where
    ``tokenizer_dir`` holds vocab.json and the host has a C++ compiler,
    the Python one where it has none, else the hash stand-in. A compiler
    that fails raises with its output: the main path never serves the
    slow encoder in the fast one's place unnoticed."""
    if tokenizer_dir and os.path.exists(os.path.join(tokenizer_dir, "vocab.json")):
        vocab = os.path.join(tokenizer_dir, "vocab.json")
        merges = os.path.join(tokenizer_dir, "merges.txt")
        from misinfo_tpu_torch.ops.cuda_build import host_compiler
        if host_compiler() is None:
            return RobertaTokenizer(vocab, merges)
        from misinfo_tpu_torch.preprocess.native_bpe import (
            NativeRobertaTokenizer)
        return NativeRobertaTokenizer(vocab, merges)
    return HashTokenizer("roberta", vocab_size=vocab_size)


def load_clip_tokenizer(tokenizer_dir: Optional[str],
                        vocab_size: int = 49408) -> _Batcher:
    if tokenizer_dir and os.path.exists(os.path.join(tokenizer_dir, "vocab.json")):
        return ClipTokenizer.from_dir(tokenizer_dir)
    return HashTokenizer("clip", vocab_size=vocab_size)
