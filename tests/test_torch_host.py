"""The PyTorch port's host copies held to their JAX-package originals.

Each copy must match exactly: config defaults, token ids (hash fallback
and BPE), packed arrays, image arrays, the vault round trip and the
explanation text. Also checks that importing the port's engine loads
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
from misinfo_tpu.preprocess import image as j_image
from misinfo_tpu.preprocess import packing as j_packing
from misinfo_tpu.preprocess import tokenizer as j_tok
from misinfo_tpu.preprocess.bpe import bytes_to_unicode
from misinfo_tpu.vault.store import TruthVault as JVault

from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import explain as t_explain
from misinfo_tpu_torch.models.detector import DetectorConfig as TDetectorConfig
from misinfo_tpu_torch.preprocess import image as t_image
from misinfo_tpu_torch.preprocess import packing as t_packing
from misinfo_tpu_torch.preprocess import tokenizer as t_tok
from misinfo_tpu_torch.vault.store import TruthVault as TVault

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["Breaking: the moon landing was FAKED, experts say!!",
         "Ünïcödé café — naïve façade 2024 #tag @user",
         "", "   spaced   out   ", "It's the end of the world as we know it."]


def test_config_defaults_identical():
    for name in ("ForensicsConfig", "PrecisionConfig", "ServingConfig",
                 "SequenceConfig", "Thresholds", "VideoConfig",
                 "ModelPaths", "MeshConfig"):
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
            "import misinfo_tpu_torch.checkpoints.from_jax; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'misinfo_tpu' or m.startswith('misinfo_tpu.')"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
