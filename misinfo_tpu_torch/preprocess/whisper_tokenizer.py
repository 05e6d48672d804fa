"""Whisper tokenizers: GPT-2-style byte-level BPE + multilingual specials.

Host copy of ``misinfo_tpu/preprocess/whisper_tokenizer.py`` on the
port's ``preprocess/bpe.py``, importable without JAX; held to the
original by tests/test_torch_host.py.

openai-whisper's tokenizer is a GPT-2 byte-level BPE with a fixed block of
special tokens appended after the base vocab:

    <|endoftext|>  <|startoftranscript|>  <|xx|>×99 languages
    <|translate|>  <|transcribe|>  <|startoflm|>  <|startofprev|>
    <|nospeech|>  <|notimestamps|>  <|0.00|> … <|30.00|> (1501 timestamps)

For the multilingual vocab (base 50257 + <|endoftext|> merged in) that puts
eot at 50257, sot at 50258 and the full size at 51865. The layout is
derived from the base vocab size, so English-only assets (base 50256) land
on their shifted ids automatically.

When no vocab assets exist, :class:`ByteWhisperTokenizer` stands in: raw
UTF-8 bytes as ids 0–255 with the same special block starting at 256 —
deterministic, decodes real text, explicitly not parity-grade.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

# openai-whisper's language order (whisper/tokenizer.py LANGUAGES); the
# position of a language in this tuple fixes its special-token id.
WHISPER_LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su",
)
N_TIMESTAMPS = 1501  # <|0.00|> … <|30.00|> at 20 ms steps


class _WhisperSpecials:
    """Id layout of the special block, anchored at the end-of-text id."""

    def __init__(self, eot: int, languages: Sequence[str] = WHISPER_LANGUAGES,
                 multilingual: bool = True):
        self.eot = eot
        self.multilingual = multilingual
        self.sot = eot + 1
        self.languages = tuple(languages)  # index order fixes the token ids
        self.language_ids = {lang: self.sot + 1 + i
                             for i, lang in enumerate(languages)}
        base = self.sot + 1 + len(languages)
        self.translate = base
        self.transcribe = base + 1
        self.sot_lm = base + 2
        self.sot_prev = base + 3
        self.no_speech = base + 4
        self.no_timestamps = base + 5
        self.timestamp_begin = base + 6
        self.vocab_size = self.timestamp_begin + N_TIMESTAMPS

    def sot_sequence(self, language: str = "en", task: str = "transcribe",
                     notimestamps: bool = True) -> List[int]:
        """The decoder prompt openai-whisper feeds before free decoding.
        English-only models were trained without language/task
        conditioning — their sot_sequence is just ``[sot]``."""
        seq = [self.sot]
        if self.multilingual:
            seq += [self.language_ids.get(language, self.language_ids["en"]),
                    self.transcribe if task == "transcribe"
                    else self.translate]
        if notimestamps:
            seq.append(self.no_timestamps)
        return seq


class WhisperTokenizer:
    """Byte-level BPE over openai/HF vocab.json+merges.txt with the
    multilingual special block."""

    parity_grade = True

    def __init__(self, vocab_file: str, merges_file: str,
                 language: str = "en", task: str = "transcribe"):
        from misinfo_tpu_torch.preprocess.bpe import ByteLevelBPE

        self.bpe = ByteLevelBPE(vocab_file, merges_file)
        enc = self.bpe.core.encoder
        # multilingual assets carry <|endoftext|> inside vocab.json at
        # 50257; if absent it sits right after the base vocab
        eot = enc.get("<|endoftext|>", len(enc))
        # English-only assets (.en models) use gpt2's vocab → eot 50256
        self.specials = _WhisperSpecials(eot, multilingual=eot != 50256)
        self.language, self.task = language, task
        self.vocab_size = self.specials.vocab_size

    @classmethod
    def from_dir(cls, d: str, **kw) -> "WhisperTokenizer":
        return cls(os.path.join(d, "vocab.json"),
                   os.path.join(d, "merges.txt"), **kw)

    def sot_sequence(self, notimestamps: bool = True,
                     language: Optional[str] = None) -> List[int]:
        """``language`` overrides the constructor default for one prompt."""
        return self.specials.sot_sequence(language or self.language,
                                          self.task, notimestamps)

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        """Text ids only — the whole special block (eot and above) is
        skipped, like openai-whisper's decode(skip_special_tokens)."""
        return self.bpe.decode([i for i in ids if i < self.specials.eot])


class ByteWhisperTokenizer:
    """Asset-free fallback: UTF-8 bytes 0–255 + the canonical special block
    at 256. Vocab size 256+1+1+99+6+1501 = 1864."""

    parity_grade = False

    def __init__(self, language: str = "en", task: str = "transcribe"):
        self.specials = _WhisperSpecials(eot=256)
        self.language, self.task = language, task
        self.vocab_size = self.specials.vocab_size

    def sot_sequence(self, notimestamps: bool = True,
                     language: Optional[str] = None) -> List[int]:
        return self.specials.sot_sequence(language or self.language,
                                          self.task, notimestamps)

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < self.specials.eot)
        return data.decode("utf-8", errors="replace")


def specials_for_vocab(vocab_size: int) -> _WhisperSpecials:
    """The canonical special-token layout implied by a total vocab size:
    multilingual 51865 → eot 50257; English-only 51864 → eot 50256; the v3
    family's 51866 keeps eot 50257 and adds a 100th language (Cantonese)."""
    if vocab_size == 51866:  # large-v3 / v3-turbo
        return _WhisperSpecials(eot=50257,
                                languages=tuple(WHISPER_LANGUAGES) + ("yue",))
    return _WhisperSpecials(eot=max(vocab_size - 1608, 0),
                            multilingual=vocab_size != 51864)


def load_whisper_tokenizer(tokenizer_dir: Optional[str] = None,
                           language: str = "en", task: str = "transcribe"):
    """Parity-grade BPE when vocab assets exist, byte fallback otherwise."""
    tokenizer_dir = tokenizer_dir or os.getenv("WHISPER_TOKENIZER")
    if tokenizer_dir and os.path.exists(os.path.join(tokenizer_dir,
                                                     "vocab.json")):
        return WhisperTokenizer.from_dir(tokenizer_dir, language=language,
                                         task=task)
    return ByteWhisperTokenizer(language=language, task=task)
