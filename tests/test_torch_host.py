"""The PyTorch port's host copies held to their JAX-package originals.

Each copy must match exactly: config defaults, token ids (hash fallback
and BPE), packed arrays, image arrays, the vault round trip, the
explanation text, and the transcript path's audio frontend and Whisper
tokenizers, and the training host code (metrics, the median pruner,
the train/val split and eval batching, the datasets' augmentations and
batches, the stream packer). Also checks that importing the port's engine
and trainers loads neither JAX nor the JAX package.
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
from misinfo_tpu.train import datasets as j_data
from misinfo_tpu.train import harness as j_harness
from misinfo_tpu.train import metrics as j_metrics
from misinfo_tpu.vault.store import TruthVault as JVault

from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import explain as t_explain
from misinfo_tpu_torch.models.detector import DetectorConfig as TDetectorConfig
from misinfo_tpu_torch.preprocess import audio as t_audio
from misinfo_tpu_torch.preprocess import image as t_image
from misinfo_tpu_torch.preprocess import packing as t_packing
from misinfo_tpu_torch.preprocess import tokenizer as t_tok
from misinfo_tpu_torch.preprocess import whisper_tokenizer as t_wtok
from misinfo_tpu_torch.train import datasets as t_data
from misinfo_tpu_torch.train import harness as t_harness
from misinfo_tpu_torch.train import metrics as t_metrics
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


def test_packed_row_bucket_identical():
    for buckets in ((1, 2, 4, 8, 16, 32, 64), (3,), (8, 32)):
        for n in (0, 1, 2, 3, 5, 8, 9, 33, 64, 65, 1000):
            assert (t_packing.packed_row_bucket(n, buckets)
                    == j_packing.packed_row_bucket(n, buckets))


def test_image_backend_and_fast_decode_setters_match_jax(tmp_path,
                                                         monkeypatch):
    """``set_image_backend`` flips ``_use_cv2()`` as JAX's does and refuses
    the same names with the same error; ``set_fast_decode`` switches a
    large JPEG path to the reduced decode as JAX's does."""
    pytest.importorskip("cv2")
    Image = pytest.importorskip("PIL.Image")
    try:
        for name, cv in (("cv2", True), ("pil", False), ("auto", True)):
            for m in (t_image, j_image):
                m.set_image_backend(name)
                assert m._use_cv2() is cv
        for bad in ("PIL", "opencv", "", None):
            errs = []
            for m in (t_image, j_image):
                with pytest.raises(ValueError) as e:
                    m.set_image_backend(bad)
                errs.append(str(e.value))
            assert errs[0] == errs[1]
        assert t_image._use_cv2() and j_image._use_cv2()
        path = str(tmp_path / "big.jpg")
        rng = np.random.default_rng(9)
        Image.fromarray(rng.integers(0, 256, (1000, 1400, 3),
                                     dtype=np.uint8)).save(path, quality=90)
        for backend in ("cv2", "pil"):
            for on in (True, False):
                outs = []
                for m in (t_image, j_image):
                    m.set_image_backend(backend)
                    m.set_fast_decode(on)
                    outs.append(m.decode_rgb(path))
                np.testing.assert_array_equal(outs[0], outs[1])
                assert outs[0].shape == ((500, 700, 3) if on
                                         else (1000, 1400, 3))
    finally:
        for m in (t_image, j_image):
            m.set_image_backend("auto")
            m.set_fast_decode(False)


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


def test_tracer_identical():
    """The tracing copy against its original: the same events, counts
    and durations past the rolling windows give the same counters,
    percentiles, rates, summary and sink records (timestamps aside);
    stage_timer feeds the tracer it is given."""
    from misinfo_tpu.utils import tracing as j_tr
    from misinfo_tpu_torch.utils import tracing as t_tr
    assert (t_tr.MAX_EVENTS, t_tr.RESERVOIR) == (j_tr.MAX_EVENTS,
                                                 j_tr.RESERVOIR)
    sinks = ([], [])
    tracers = [m.Tracer(sink=s.append) for m, s in zip((j_tr, t_tr), sinks)]
    rng = np.random.default_rng(0)
    for i in range(2 * t_tr.RESERVOIR + 37):
        sec = float(rng.exponential(0.01))
        stage = ("analyze", "prep", "transcribe")[i % 3]
        for t in tracers:
            t.event(stage, sec, n_requests=i % 7, note="x")
            if i % 50 == 0:
                t.incr("gemini_ok_count")
    j, t = tracers
    assert j.summary() == t.summary()
    for stage in ("analyze", "prep", "transcribe", "absent"):
        assert j.quantiles(stage) == t.quantiles(stage)
        assert j.rate(stage) == t.rate(stage)
    assert len(j.events) == len(t.events)

    def strip(lines):
        return [{k: v for k, v in json.loads(x).items() if k != "ts"}
                for x in lines]
    assert strip(sinks[0]) == strip(sinks[1])
    with t_tr.stage_timer("prep", t, n=3):
        pass
    assert t.counters["prep_n"] == 3
    assert t.counters["prep_count"] == j.counters["prep_count"] + 1


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


def test_host_prep_probe_and_recommendation_identical():
    """preprocess/hostprobe.py's image-prep half: the probe's keys, and
    ``recommend``'s decisions on the same probes (host-bound or not, the
    fast decode worth it or not). The port's device rate and hint text
    are its own (no TPU rate); the link probe and the auto policy are
    held to JAX's in tests/test_torch_host_policy.py."""
    from misinfo_tpu.preprocess import hostprobe as j_hp
    from misinfo_tpu_torch.preprocess import hostprobe as t_hp
    got = t_hp.probe_host_prep(res=120, trials=1)
    assert set(got) == set(j_hp.probe_host_prep(res=120, trials=1))
    assert got["probe_resolution"] == 120 and got["exact_ms_per_image"] > 0
    assert t_hp.probe_host_prep(res=120) is got          # cached
    for exact, fast in ((50.0, 200.0), (50.0, 55.0), (5000.0, 9000.0)):
        probe = dict(got, exact_ceiling_images_per_s=exact,
                     fast_ceiling_images_per_s=fast)
        for rate in (100.0, t_hp.DEVICE_IMAGES_PER_S):
            a = t_hp.recommend(probe, device_images_per_s=rate)
            b = j_hp.recommend(probe, device_images_per_s=rate)
            assert set(a) == set(b)
            for k in ("host_bound_at_probe_res", "fast_decode_recommended",
                      "probe"):
                assert a[k] == b[k], (exact, fast, rate, k)
            assert ("FAST_DECODE" in a["summary"]) == (
                "FAST_DECODE" in b["summary"])


def test_serving_modules_import_no_jax():
    code = ("import sys; "
            "import misinfo_tpu_torch.serve.api, misinfo_tpu_torch.serve.cli; "
            "import misinfo_tpu_torch.serve.webui, "
            "misinfo_tpu_torch.serve.dashboard; "
            "import misinfo_tpu_torch.serve.similarity, "
            "misinfo_tpu_torch.serve.download; "
            "import misinfo_tpu_torch.engine.batching, "
            "misinfo_tpu_torch.checkpoints.torch_convert, "
            "misinfo_tpu_torch.preprocess.hostprobe; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'misinfo_tpu' or m.startswith('misinfo_tpu.')"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


# ------------------------------------------------------ training host code

def test_train_metrics_identical():
    rng = np.random.default_rng(3)
    y, p = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    np.testing.assert_array_equal(t_metrics.confusion_matrix(y, p),
                                  j_metrics.confusion_matrix(y, p))
    for names in (None, ["real", "fake", "other"]):
        a = t_metrics.classification_report(y, p, names)
        assert a == j_metrics.classification_report(y, p, names)
        assert t_metrics.format_report(a) == j_metrics.format_report(a)


def test_median_pruner_identical():
    rng = np.random.default_rng(4)
    for mode, warm in (("max", 0), ("min", 1)):
        pruners = [m.MedianPruner(mode=mode, n_startup_trials=2,
                                  n_warmup_steps=warm)
                   for m in (j_harness, t_harness)]
        for trial in range(8):
            for pr in pruners:
                pr.start_trial()
            vals = rng.uniform(size=4)
            for epoch, v in enumerate(vals):
                out = [pr.report(epoch, v) for pr in pruners]
                assert out[0] == out[1], (mode, trial, epoch)
                if out[0]:
                    break
            for pr in pruners:
                pr.complete_trial(pruned=out[0])
        assert pruners[0].trials == pruners[1].trials


def test_split_and_eval_batches_identical():
    items = [f"s{i}" for i in range(23)]
    for frac, seed in ((0.2, 42), (0.5, 1)):
        assert (t_harness.split_train_val(items, frac, seed)
                == j_harness.split_train_val(items, frac, seed))

    def batches(size, n=5):
        return [list(range(s, s + size)) for s in range(0, n - size + 1,
                                                        size)]
    for n_items, bs in ((5, 2), (5, 8), (0, 4)):
        got = list(t_harness.eval_batches(lambda b: batches(b, n_items),
                                          n_items, bs))
        assert got == list(j_harness.eval_batches(
            lambda b: batches(b, n_items), n_items, bs))


def _pngs(tmp_path, n, size=40):
    from PIL import Image
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (size, size + 8, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def test_augmentations_identical():
    img = np.random.default_rng(6).integers(0, 256, (48, 40, 3),
                                            dtype=np.uint8)
    for fn in ("color_jitter", "gaussian_blur", "random_jpeg_compress"):
        for seed in range(4):
            a = getattr(t_data, fn)(img, np.random.default_rng(seed))
            b = getattr(j_data, fn)(img, np.random.default_rng(seed))
            np.testing.assert_array_equal(a, b)
    for jpeg in (True, False):
        for seed in range(6):
            np.testing.assert_array_equal(
                t_data.train_augment(img, np.random.default_rng(seed), jpeg),
                j_data.train_augment(img, np.random.default_rng(seed), jpeg))


@pytest.mark.parametrize("train", [True, False])
def test_dataset_batches_identical(tmp_path, train):
    paths = _pngs(tmp_path, 4)
    texts = TEXTS * 2
    rows = [dict(text=t, image_path=(paths[i % 4] if i % 3 else None),
                 label=i % 2) for i, t in enumerate(texts)]
    sets = []
    for m, tok in ((t_data, t_tok), (j_data, j_tok)):
        samples = [m.Sample(**r) for r in rows]
        sets.append(m.MisinfoDataset(
            samples, tok.HashTokenizer("roberta", 1024),
            tok.HashTokenizer("clip", 512), image_size=32, roberta_len=24,
            clip_len=16, train=train, seed=3))
    for bs, drop in ((3, False), (4, True)):
        got = list(sets[0].batches(bs, drop_remainder=drop))
        want = list(sets[1].batches(bs, drop_remainder=drop))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = list(sets[0].packed_batches(n_rows=2, n_slots=4))
    want = list(sets[1].packed_batches(n_rows=2, n_slots=4))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    part = {k: v[:2] for k, v in want[0].items()}
    for k, v in t_data.pad_batch_to(part, 5).items():
        np.testing.assert_array_equal(v, j_data.pad_batch_to(part, 5)[k])
    assert list(t_data.prefetch(iter(range(7)), depth=2)) == list(range(7))


def test_stream_packer_identical():
    rng = np.random.default_rng(8)
    packers = [m.StreamPacker(row_len=16, pad_id=1, n_rows=3, n_slots=5)
               for m in (t_packing, j_packing)]
    outs = [[], []]
    for i in range(40):
        seq = rng.integers(3, 900, int(rng.integers(0, 17))).astype(np.int32)
        for pk, out in zip(packers, outs):
            r = pk.add(seq, i)
            if r is not None:
                out.append(r)
    for pk, out in zip(packers, outs):
        out.append(pk.flush())
    assert len(outs[0]) == len(outs[1]) > 3
    for (a, ma), (b, mb) in zip(*outs):
        assert ma == mb and a.n_real == b.n_real
        for f in ("ids", "mask", "position_ids", "segment_ids", "cls_rows",
                  "cls_cols"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="row_len"):
        packers[0].add(np.zeros(17, np.int32))


def test_trainers_import_no_jax():
    code = ("import sys; "
            "import misinfo_tpu_torch.train, misinfo_tpu_torch.train.steps; "
            "import misinfo_tpu_torch.train.roberta_detective, "
            "misinfo_tpu_torch.train.ai_head, "
            "misinfo_tpu_torch.train.cifake_efficientnet, "
            "misinfo_tpu_torch.train.clip_detective, "
            "misinfo_tpu_torch.train.fusion_judge, "
            "misinfo_tpu_torch.train.feature_fusion, "
            "misinfo_tpu_torch.train.metrics; "
            "import misinfo_tpu_torch.checkpoints.io, "
            "misinfo_tpu_torch.checkpoints.convert; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'misinfo_tpu' or m.startswith('misinfo_tpu.')"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
