"""The PyTorch port's host copies held to their JAX-package originals.

Each copy must match exactly: config defaults, token ids (hash fallback
and BPE), packed arrays, image arrays, the vault round trip, the
explanation text, and the transcript path's audio frontend and Whisper
tokenizers. Also checks that importing the port's engine loads
neither JAX nor the JAX package.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from misinfo_tpu.core import config as j_config
from misinfo_tpu.engine import explain as j_explain
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.preprocess import audio as j_audio
from misinfo_tpu.preprocess import image as j_image
from misinfo_tpu.preprocess import packing as j_packing
from misinfo_tpu.preprocess import tokenizer as j_tok
from misinfo_tpu.preprocess import whisper_tokenizer as j_wtok
from misinfo_tpu.preprocess.bpe import bytes_to_unicode
from misinfo_tpu.vault.store import TruthVault as JVault

from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import explain as t_explain
from misinfo_tpu_torch.models.detector import DetectorConfig as TDetectorConfig
from misinfo_tpu_torch.preprocess import audio as t_audio
from misinfo_tpu_torch.preprocess import image as t_image
from misinfo_tpu_torch.preprocess import packing as t_packing
from misinfo_tpu_torch.preprocess import tokenizer as t_tok
from misinfo_tpu_torch.preprocess import whisper_tokenizer as t_wtok
from misinfo_tpu_torch.vault.store import TruthVault as TVault

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["Breaking: the moon landing was FAKED, experts say!!",
         "Ünïcödé café — naïve façade 2024 #tag @user",
         "", "   spaced   out   ", "It's the end of the world as we know it."]


def test_config_defaults_identical():
    for name in ("ForensicsConfig", "PrecisionConfig", "ServingConfig",
                 "SequenceConfig", "Thresholds", "VideoConfig",
                 "ModelPaths", "MeshConfig", "WhisperDecodeConfig"):
        assert (dataclasses.asdict(getattr(t_config, name)())
                == dataclasses.asdict(getattr(j_config, name)())), name
    assert (dataclasses.asdict(t_config.PrecisionConfig.highest())
            == dataclasses.asdict(j_config.PrecisionConfig.highest()))
    for make in (lambda c: c(), lambda c: c.tiny()):
        assert (dataclasses.asdict(make(TDetectorConfig))
                == dataclasses.asdict(make(JDetectorConfig)))


@pytest.mark.parametrize("dialect,vocab", [("roberta", 50265),
                                           ("clip", 49408), ("roberta", 1024)])
def test_hash_tokenizer_ids_identical(dialect, vocab):
    a = j_tok.HashTokenizer(dialect, vocab).batch(TEXTS, 24)
    b = t_tok.HashTokenizer(dialect, vocab).batch(TEXTS, 24)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _bpe_assets(tmp_path, clip: bool):
    chars = list(bytes_to_unicode().values())
    merges = (["t h", "th e</w>", "a n", "an d</w>"] if clip
              else ["Ġ t", "h e", "Ġt he", "a n", "an d"])
    vocab = list(chars) + ([c + "</w>" for c in chars] if clip else [])
    vocab += [m.replace(" ", "") for m in merges]
    vocab += (["<|startoftext|>", "<|endoftext|>"] if clip
              else ["<s>", "<pad>", "</s>", "<unk>"])
    d = tmp_path / ("clip" if clip else "roberta")
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in
                                              enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges))
    return str(d)


@pytest.mark.parametrize("clip", [False, True])
def test_bpe_tokenizer_ids_identical(tmp_path, clip):
    d = _bpe_assets(tmp_path, clip)
    load_j = j_tok.load_clip_tokenizer if clip else j_tok.load_roberta_tokenizer
    load_t = t_tok.load_clip_tokenizer if clip else t_tok.load_roberta_tokenizer
    tj, tt = load_j(d), load_t(d)
    assert tt.parity_grade
    for x, y in zip(tj.batch(TEXTS + ["the and then"], 32),
                    tt.batch(TEXTS + ["the and then"], 32)):
        np.testing.assert_array_equal(x, y)


def test_packed_arrays_identical():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(3, 900, n).astype(np.int32)
            for n in (5, 17, 30, 2, 9, 31, 1)]
    a = j_packing.pack_token_rows(seqs, 32, 1, n_slots=8)
    b = t_packing.pack_token_rows(seqs, 32, 1, n_slots=8)
    a, b = (j_packing.pad_packed_rows(a, 8, 1),
            t_packing.pad_packed_rows(b, 8, 1))
    for f in ("ids", "mask", "position_ids", "segment_ids", "cls_rows",
              "cls_cols"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for x, y in zip(j_packing.dense_rows_from_seqs(seqs, 8, 32, 1),
                    t_packing.dense_rows_from_seqs(seqs, 8, 32, 1)):
        np.testing.assert_array_equal(x, y)
    ids, mask = j_tok.HashTokenizer().batch(TEXTS, 16)
    for x, y in zip(j_packing.trim_padded(ids, mask),
                    t_packing.trim_padded(ids, mask)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(300, 200, 3), (64, 64, 3), (97, 130, 4),
                                   (50, 80)])
@pytest.mark.parametrize("mode", ["effnet", "clip"])
def test_image_arrays_identical(shape, mode):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    want = j_image.image_to_array(j_image.decode_rgb(img), mode, 64)
    got = t_image.image_to_array(t_image.decode_rgb(img), mode, 64)
    np.testing.assert_array_equal(got, want)


def test_image_at_size_needs_no_library(monkeypatch):
    img = np.random.default_rng(2).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    want = {m: j_image.image_to_array(j_image.decode_rgb(img), m, 64)
            for m in ("effnet", "clip")}
    monkeypatch.setattr(t_image, "_pil", lambda: None)
    monkeypatch.setattr(t_image, "_cv", lambda: None)
    for m in ("effnet", "clip"):
        np.testing.assert_array_equal(
            t_image.image_to_array(t_image.decode_rgb(img), m, 64), want[m])


@pytest.mark.parametrize("ext", ["npz", "pkl"])
def test_vault_roundtrip_identical(tmp_path, ext):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(5, 16)).astype(np.float32)
    te = rng.normal(size=(5, 16)).astype(np.float32)
    meta = [{"title": f"t{i}", "url": f"u{i}", "date": "d"} for i in range(5)]
    for saver in (TVault, JVault):          # saved by either, read by both
        path = str(tmp_path / f"{saver.__module__.split('.')[0]}.{ext}")
        saver(emb, meta, te).save(path)
        a, b = TVault.load(path), JVault.load(path)
        np.testing.assert_array_equal(a.embeddings, b.embeddings)
        np.testing.assert_array_equal(a.text_embeddings, b.text_embeddings)
        np.testing.assert_array_equal(a.row_valid, b.row_valid)
        assert list(a.metadata) == list(b.metadata)
        assert (a.matches_from_indices([4, 0, 200], [.9, .5, .1])
                == b.matches_from_indices([4, 0, 200], [.9, .5, .1]))
    assert TVault.load(str(tmp_path / "missing.pkl")) is None


@pytest.mark.parametrize("scores", [
    {"verdict": 1, "vault_discrepancy": 0.9, "confidence": 0.8},
    {"verdict": 1, "deepfake_score": 0.93, "confidence": 0.7},
    {"verdict": 0, "ai_score": 0.8},
    {"verdict": 1, "misinfo_score": 0.71, "clip_similarity": 0.5},
    {"verdict": 0, "clip_similarity": 0.1},
    {"verdict": 0, "clip_similarity": 0.6, "confidence": 0.55,
     "real_probability": 0.55, "fake_probability": 0.45,
     "text_similarity": 0.3},
])
def test_explanation_text_identical(scores):
    matches = [{"title": "Old story", "similarity": 0.93, "date": "2020"}]
    assert (t_explain.rule_based_explanation(scores, matches)
            == j_explain.rule_based_explanation(scores, matches))
    assert (t_explain.build_llm_prompt(scores, matches)
            == j_explain.build_llm_prompt(scores, matches))
    assert (t_explain.Explainer(None).explain(scores, matches)
            == j_explain.Explainer(None).explain(scores, matches))


def test_port_imports_no_jax():
    code = ("import misinfo_tpu_torch.engine.forensics, sys; "
            "import misinfo_tpu_torch.serve.transcript; "
            "import misinfo_tpu_torch.checkpoints.from_jax; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'misinfo_tpu' or m.startswith('misinfo_tpu.')"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def _write_wav(path, pcm, rate, width, channels=1):
    import wave
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def test_audio_frontend_identical(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    audio = (0.3 * rng.normal(size=16000 * 3)).astype(np.float32)
    np.testing.assert_array_equal(t_audio.log_mel_spectrogram(audio),
                                  j_audio.log_mel_spectrogram(audio))
    for n in (8000, 16000 * 5):
        np.testing.assert_array_equal(t_audio.pad_or_trim_audio(audio, n),
                                      j_audio.pad_or_trim_audio(audio, n))
    mel = j_audio.log_mel_spectrogram(audio)
    for frames in (100, 400):
        np.testing.assert_array_equal(t_audio.pad_or_trim_mel(mel, frames),
                                      j_audio.pad_or_trim_mel(mel, frames))
    for cap in (1, 5):
        a, b = (m.mel_windows(audio, 128, cap) for m in (t_audio, j_audio))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    # no ffmpeg: a PCM WAV decodes with numpy and the stdlib alone
    for m in (t_audio, j_audio):
        monkeypatch.setattr(m, "ffmpeg_decode_audio", lambda *a, **k: None)
    wavs = {"s16.wav": ((audio * 32767).astype(np.int16), 16000, 2, 1),
            "u8_stereo_8k.wav": (
                (np.repeat(audio[:8000, None], 2, 1) * 100 + 128)
                .astype(np.uint8), 8000, 1, 2)}
    for name, (pcm, rate, width, ch) in wavs.items():
        _write_wav(tmp_path / name, pcm, rate, width, ch)
        a = t_audio.decode_audio(str(tmp_path / name))
        b = j_audio.decode_audio(str(tmp_path / name))
        assert a is not None and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        for x, y in zip(t_audio.prep_mel_windows(str(tmp_path / name), 128, 3),
                        j_audio.prep_mel_windows(str(tmp_path / name), 128, 3)):
            np.testing.assert_array_equal(x, y)
    assert t_audio.prep_mel_windows(str(tmp_path / "missing.wav"), 128, 3) \
        == (None, 0)


def _specials(sp):
    return {k: v for k, v in vars(sp).items()}


def test_whisper_tokenizer_identical(tmp_path):
    for vocab in (51865, 51864, 51866, 1864):
        assert (_specials(t_wtok.specials_for_vocab(vocab))
                == _specials(j_wtok.specials_for_vocab(vocab)))
        sp_t, sp_j = (m.specials_for_vocab(vocab) for m in (t_wtok, j_wtok))
        for lang in ("en", "de", "xx"):
            for task in ("transcribe", "translate"):
                assert (sp_t.sot_sequence(lang, task)
                        == sp_j.sot_sequence(lang, task))
    bt, bj = t_wtok.ByteWhisperTokenizer(), j_wtok.ByteWhisperTokenizer()
    assert _specials(bt.specials) == _specials(bj.specials)
    assert bt.vocab_size == bj.vocab_size == 1864
    for text in TEXTS:
        ids = bt.encode(text)
        assert ids == bj.encode(text)
        seq = bt.sot_sequence(language="de") + ids + [bt.specials.eot]
        assert seq == bj.sot_sequence(language="de") + ids + [bj.specials.eot]
        assert bt.decode(seq) == bj.decode(seq)
    vocab = {"h": 0, "e": 1, "l": 2, "o": 3, "he": 4, "ll": 5, "llo": 6,
             "hello": 7, "<|endoftext|>": 8}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\nh e\nl l\nll o\nhe llo\n")
    tt, tj = (m.load_whisper_tokenizer(str(tmp_path)) for m in (t_wtok, j_wtok))
    assert tt.parity_grade and _specials(tt.specials) == _specials(tj.specials)
    assert tt.encode("hello hell") == tj.encode("hello hell")
    assert tt.decode([7, 8, 9, 3]) == tj.decode([7, 8, 9, 3])
    assert tt.sot_sequence() == tj.sot_sequence()
    assert isinstance(t_wtok.load_whisper_tokenizer(None),
                      t_wtok.ByteWhisperTokenizer)
