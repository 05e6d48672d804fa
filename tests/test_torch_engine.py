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


def build_engines(tmp_path, precision: str, quant: str, quantize,
                  use_pallas=False):
    """→ (JAX engine, port engine) over one tree, vault and config.
    ``quantize``: False, True (``quantize_ffn_params(tree, 1)``) or a
    transform of the tree."""
    det = TDetectorConfig.tiny()
    tree = jax.tree.map(lambda t: t.numpy(), detector_init(0, det))
    if quantize:
        fn = quantize if callable(quantize) else quantize_ffn_params
        tree = jax.tree.map(np.asarray, fn(tree, 1))
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
        kw = ({"use_pallas": use_pallas} if engine is JEngine
              else {"use_pallas": use_pallas, "device": "cpu"})
        engines.append(engine(config=cfg, det_cfg=(
            JDetectorConfig.tiny() if engine is JEngine else det),
            params=params, **kw))
    return engines


def run_both(j_eng, t_eng, monkeypatch):
    """analyze_batch on both engines; records the port's programs. JAX's
    programs trace in TPU interpret mode, so that its ``use_pallas``
    kernels run on the CPU."""
    from jax.experimental.pallas import tpu as pltpu
    seen = []
    prog = t_forensics.signals_program

    def spy(params, batch, *, variant, **kw):
        seen.append((variant, "roberta_seg" in batch))
        return prog(params, batch, variant=variant, **kw)
    monkeypatch.setattr(t_forensics, "signals_program", spy)
    reqs = requests()
    with pltpu.force_tpu_interpret_mode():
        a = j_eng.analyze_batch(reqs)
    b = t_eng.analyze_batch(reqs)
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


def test_entry_points_default_to_the_card(monkeypatch):
    """``MisinfoForensics()`` and ``WhisperTranscriber()`` without a device
    place their weights on CUDA; the CPU runs only when asked for. The
    weight placement is intercepted, so nothing is allocated."""
    from misinfo_tpu_torch.serve import transcript as t_transcript

    class Placed(Exception):
        pass

    def place(tree, device):
        raise Placed(torch.device(device))
    for mod, init in ((t_forensics, "detector_init"),
                      (t_transcript, "whisper_init")):
        monkeypatch.setattr(mod, init, lambda seed, cfg: {})
        monkeypatch.setattr(mod, "to_device", place)
    with pytest.raises(Placed) as e:
        t_forensics.MisinfoForensics(
            config=t_config.ForensicsConfig(verbose=False))
    assert e.value.args[0].type == "cuda"
    with pytest.raises(Placed) as e:
        t_transcript.WhisperTranscriber(size="tiny")
    assert e.value.args[0].type == "cuda"


@pytest.mark.parametrize("mode", ["off", "ffn", "dense"])
def test_card_engine_refuses_a_mode_that_turns_a_kernel_off(mode,
                                                            monkeypatch):
    """On a CUDA device the int8 kernels always run: an engine that would
    serve int8 weights there under MISINFO_TPU_INT8_PALLAS=off, ffn or
    dense raises before any weight reaches the card."""
    placed = []
    monkeypatch.setattr(t_forensics, "detector_init", lambda seed, cfg: {})
    monkeypatch.setattr(t_forensics, "to_device",
                        lambda tree, device: placed.append(device))
    monkeypatch.setenv("MISINFO_TPU_INT8_PALLAS", mode)
    with pytest.raises(ValueError, match="CUDA device"):
        t_forensics.MisinfoForensics(
            config=t_config.ForensicsConfig(verbose=False))
    assert placed == []
