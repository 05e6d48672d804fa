"""Byte-pair-encoding engines, written from scratch.

Host copy of ``misinfo_tpu/preprocess/bpe.py``, importable without JAX;
held to the original by tests/test_torch_host.py.

Two dialects are needed for tokenizer parity with the reference
(SURVEY.md §7 "Hard parts: tokenizer parity"):

* **Byte-level BPE** (GPT-2/RoBERTa dialect) — used by the RoBERTa dual-head
  text detective (reference misinfo_forensics.py:169, :327-333). Unicode text
  is mapped byte-by-byte onto a printable alphabet, pre-tokenized with the
  GPT-2 regex, then greedily merged by rank.
* **CLIP BPE** — used by the CLIP consistency/vault towers (reference
  misinfo_forensics.py:210, :386-391). Text is whitespace-cleaned and
  lowercased; each word's final character carries a ``</w>`` marker.

Both load standard HuggingFace `vocab.json` + `merges.txt` assets, so any
stock `roberta-base` / `clip-vit-base-patch32` tokenizer directory drops in.
Tokenization is host-side work; the engine consumes fixed-shape int32 arrays.
"""

from __future__ import annotations

import functools
import html
import json
from typing import Dict, List, Tuple

try:  # `regex` supports \p{L}/\p{N}; it ships as a transformers dependency.
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re  # degraded: \p classes unavailable

_GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)
_CLIP_PATTERN = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map (256 entries)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class _BPECore:
    """Rank-greedy merge loop shared by both dialects."""

    def __init__(self, encoder: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self._cache: Dict[str, Tuple[str, ...]] = {}

    def merge(self, token: str, end_of_word: str = "") -> Tuple[str, ...]:
        cache_key = token
        if cache_key in self._cache:
            return self._cache[cache_key]
        if end_of_word:
            word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + end_of_word,)
        else:
            word = tuple(token)
        if not word:
            return ()
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[cache_key] = word
        return word


def _load_vocab_merges(vocab_file: str, merges_file: str):
    with open(vocab_file, encoding="utf-8") as f:
        encoder = json.load(f)
    merges: List[Tuple[str, str]] = []
    with open(merges_file, encoding="utf-8") as f:
        for line in f.read().split("\n"):
            line = line.strip()
            if not line or line.startswith("#version"):
                continue
            a, b = line.split()
            merges.append((a, b))
    return encoder, merges


class ByteLevelBPE:
    """GPT-2/RoBERTa byte-level BPE encoder (vocab.json + merges.txt)."""

    def __init__(self, vocab_file: str, merges_file: str):
        encoder, merges = _load_vocab_merges(vocab_file, merges_file)
        self.core = _BPECore(encoder, merges)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pat = _re.compile(_GPT2_PATTERN)
        self.unk_id = encoder.get("<unk>", 3)

    @property
    def vocab_size(self) -> int:
        return len(self.core.encoder)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        enc = self.core.encoder
        for tok in self.pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self.core.merge(mapped):
                ids.append(enc.get(piece, self.unk_id))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.core.decoder.get(i, "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")


def _whitespace_clean(text: str) -> str:
    text = _re.sub(r"\s+", " ", text)
    return text.strip()


class ClipBPE:
    """CLIP's lowercase BPE with ``</w>`` word-final markers."""

    def __init__(self, vocab_file: str, merges_file: str):
        encoder, merges = _load_vocab_merges(vocab_file, merges_file)
        self.core = _BPECore(encoder, merges)
        self.byte_encoder = bytes_to_unicode()
        self.pat = _re.compile(_CLIP_PATTERN, _re.IGNORECASE)
        self.unk_id = encoder.get("<|endoftext|>", 0)

    @property
    def vocab_size(self) -> int:
        return len(self.core.encoder)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        enc = self.core.encoder
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        for tok in self.pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self.core.merge(mapped, end_of_word="</w>"):
                ids.append(enc.get(piece, self.unk_id))
        return ids
