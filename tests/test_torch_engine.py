"""The port's engine held to the JAX engine at DetectorConfig.tiny().

Both engines get the same parameter tree (the port's seeded init as numpy
arrays; the JAX side takes them as they are, the port through
checkpoints/from_jax.py), the same vault and one mixed ``analyze_batch``
that runs every program of the slice: ``full`` on dense text rows,
``text_only`` on packed rows (``pack_text="auto"``) and ``visual_only``.

This file checks f32 parity mode: scores within 1e-4, vault top-k
indices equal, verdicts equal wherever |fake_p − 0.5| > 1e-4, and the
single-request ``analyze`` report (keys, matches, explanation). The int8
and bf16 settings are in test_torch_engine_int8.py / _bf16.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.core import config as j_config
from misinfo_tpu.engine.forensics import MisinfoForensics as JEngine
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.ops.quant import quantize_ffn_params
from misinfo_tpu.vault.store import TruthVault

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.models.detector import (
    DetectorConfig as TDetectorConfig, detector_init)

SCORES = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
          "vault_discrepancy", "text_similarity", "fake_probability",
          "real_probability", "confidence")


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)


def requests():
    """3 full requests too long to share a packed row (dense), 8 short
    text-only requests (packed), 2 image-only requests."""
    rng = np.random.default_rng(11)

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(0, 999, n))
    return ([{"text": words(n), "image": _image(n)} for n in (20, 24, 28)]
            + [{"text": words(n)} for n in (1, 2, 3, 3, 4, 5, 2, 6)]
            + [{"image": _image(1)}, {"image": _image(2)}])


def build_engines(tmp_path, precision: str, quant: str, quantize: bool):
    """→ (JAX engine, port engine) over one tree, vault and config."""
    det = TDetectorConfig.tiny()
    tree = jax.tree.map(lambda t: t.numpy(), detector_init(0, det))
    if quantize:
        tree = jax.tree.map(np.asarray, quantize_ffn_params(tree, 1))
    rng = np.random.default_rng(5)
    d = det.clip.projection_dim
    emb = rng.normal(size=(6, d)).astype(np.float32)
    vault = TruthVault(emb, [{"title": f"article {i}", "url": f"u{i}",
                              "date": "2024"} for i in range(6)],
                       rng.normal(size=(6, d)).astype(np.float32))
    vpath = str(tmp_path / "vault.npz")
    vault.save(vpath)
    engines = []
    for cfgmod, engine, params in (
            (j_config, JEngine, tree),
            (t_config, t_forensics.MisinfoForensics,
             params_from_jax(tree))):
        prec = (cfgmod.PrecisionConfig.highest() if precision == "float32"
                else cfgmod.PrecisionConfig())
        cfg = cfgmod.ForensicsConfig(
            verbose=False,
            precision=dataclasses.replace(prec, quant=quant),
            paths=cfgmod.ModelPaths(vault_path=vpath),
            seq=cfgmod.SequenceConfig(roberta_max_len=32, image_size=64))
        kw = {} if engine is JEngine else {"device": "cpu"}
        engines.append(engine(config=cfg, det_cfg=(
            JDetectorConfig.tiny() if engine is JEngine else det),
            params=params, **kw))
    return engines


def run_both(j_eng, t_eng, monkeypatch):
    """analyze_batch on both engines; records the port's programs."""
    seen = []
    prog = t_forensics.signals_program

    def spy(params, batch, *, variant, **kw):
        seen.append((variant, "roberta_seg" in batch))
        return prog(params, batch, variant=variant, **kw)
    monkeypatch.setattr(t_forensics, "signals_program", spy)
    reqs = requests()
    a, b = j_eng.analyze_batch(reqs), t_eng.analyze_batch(reqs)
    assert sorted(seen) == [("full", False), ("text_packed", True),
                            ("visual_only", False)]
    return a, b


def assert_close(a, b, tol):
    for ra, rb in zip(a, b):
        for k in SCORES:
            assert abs(ra["scores"][k] - rb["scores"][k]) <= tol, (
                k, ra["scores"][k], rb["scores"][k])
        if abs(ra["scores"]["fake_probability"] - 0.5) > tol:
            assert ra["verdict"] == rb["verdict"]
            assert ra["verdict_text"] == rb["verdict_text"]
        assert ([m["title"] for m in ra["vault_matches"]]
                == [m["title"] for m in rb["vault_matches"]])


@pytest.fixture(scope="module")
def f32_engines(tmp_path_factory):
    return build_engines(tmp_path_factory.mktemp("vault"), "float32",
                         "auto", quantize=False)


def test_f32_batch_parity(f32_engines, monkeypatch):
    a, b = run_both(*f32_engines, monkeypatch)
    assert_close(a, b, 1e-4)


def test_f32_dense_text_only_parity(f32_engines, monkeypatch):
    """Text-only requests too long to share a packed row run the dense
    ``text_only`` program (``pack_text="auto"`` declines to pack)."""
    j_eng, t_eng = f32_engines
    seen = []
    prog = t_forensics.signals_program

    def spy(params, batch, *, variant, **kw):
        seen.append((variant, "roberta_seg" in batch))
        return prog(params, batch, variant=variant, **kw)
    monkeypatch.setattr(t_forensics, "signals_program", spy)
    rng = np.random.default_rng(12)
    reqs = [{"text": " ".join(f"w{i}" for i in rng.integers(0, 999, n))}
            for n in (22, 26)]
    a, b = j_eng.analyze_batch(reqs), t_eng.analyze_batch(reqs)
    assert seen == [("text_only", False)]
    assert_close(a, b, 1e-4)


def test_f32_analyze_report(f32_engines):
    j_eng, t_eng = f32_engines
    kw = dict(text="Breaking news: shocking claim", image_path=_image(3),
              verbose=False)
    a, b = j_eng.analyze(**kw), t_eng.analyze(**kw)
    assert set(a) == set(b) and set(a["scores"]) == set(b["scores"])
    assert_close([a], [b], 1e-4)
    assert a["explanation"] == b["explanation"]
    assert len(b["vault_matches"]) == 5


def test_out_of_slice_requests_refused(f32_engines):
    _, t_eng = f32_engines
    with pytest.raises(NotImplementedError):
        t_eng.analyze_batch([{"video": "clip.mp4"}])
    with pytest.raises(NotImplementedError):
        t_eng.warmup()
    with pytest.raises(ValueError):
        t_eng.analyze(verbose=False)
