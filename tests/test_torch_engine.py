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
import os

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
from misinfo_tpu_torch.engine import signals as t_signals
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
    prog = t_signals.signals_program

    def spy(params, batch, *, variant, **kw):
        seen.append((variant, "roberta_seg" in batch))
        return prog(params, batch, variant=variant, **kw)
    monkeypatch.setattr(t_signals, "signals_program", spy)
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
    prog = t_signals.signals_program

    def spy(params, batch, *, variant, **kw):
        seen.append((variant, "roberta_seg" in batch))
        return prog(params, batch, variant=variant, **kw)
    monkeypatch.setattr(t_signals, "signals_program", spy)
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
        t_forensics.MisinfoForensics(
            config=t_eng.cfg.replace(serving=dataclasses.replace(
                t_eng.cfg.serving, aot_cache=True)),
            det_cfg=t_eng.det_cfg, params=t_eng.params, device="cpu")
    assert t_eng.warmup(batch_sizes=(1,), text_buckets=(32,),
                        variants=("text_only",), videos=()) == [
        ("text_only", 1, 32, 0)]
    with pytest.raises(ValueError):
        t_eng.analyze(verbose=False)


def test_packed_text_program_matches_jax(f32_engines):
    """``packed_text_program`` (the JAX name) is ``text_only`` over packed
    rows: on one packed batch it gives JAX's scores and the port's
    ``signals_program(variant="text_packed")`` exactly."""
    from misinfo_tpu.engine import signals as j_signals
    from misinfo_tpu_torch.engine import signals as t_signals
    from misinfo_tpu_torch.preprocess import packing as t_packing
    j_eng, t_eng = f32_engines
    rng = np.random.default_rng(13)
    seqs = [rng.integers(3, 900, n).astype(np.int32)
            for n in (5, 17, 30, 2, 9)]
    packed = t_packing.pad_packed_rows(
        t_packing.pack_token_rows(seqs, 32, 1, n_slots=8), 4, 1)
    arrays = {"roberta_ids": packed.ids, "roberta_mask": packed.mask,
              "roberta_pos": packed.position_ids,
              "roberta_seg": packed.segment_ids,
              "cls_rows": packed.cls_rows, "cls_cols": packed.cls_cols}
    want = jax.jit(lambda p, b: j_signals.packed_text_program(
        p, b, det_cfg=j_eng.det_cfg, cfg=j_eng.cfg, policy=j_eng.policy))(
            j_eng.params, arrays)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    kw = dict(det_cfg=t_eng.det_cfg, cfg=t_eng.cfg, policy=t_eng.policy)
    with torch.inference_mode():
        got = t_signals.packed_text_program(t_eng.params, batch, **kw)
        again = t_signals.signals_program(t_eng.params, batch,
                                          variant="text_packed", **kw)
    assert got.ai_score.shape == (8,)
    for a, b, c in zip(want, got, again):
        assert torch.equal(b, c)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)


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


# ------------------------------------------- the rest of the public surface

def test_per_signal_methods_match_jax(f32_engines):
    """analyze_text / analyze_image / analyze_consistency / search_vault /
    fusion_verdict, each a convenience over one batched call, against the
    JAX engine's (f32: scores within 1e-4, verdicts and matches equal)."""
    j_eng, t_eng = f32_engines
    text, image = "Breaking news: shocking claim", _image(3)
    for name, args in (("analyze_text", (text,)),
                       ("analyze_image", (image,)),
                       ("analyze_consistency", (text, image))):
        a, b = getattr(j_eng, name)(*args), getattr(t_eng, name)(*args)
        assert set(a) == set(b), name
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4, (name, k, a[k], b[k])
    a, b = j_eng.search_vault(image, text), t_eng.search_vault(image, text)
    assert set(a) == set(b) and b["vault_available"]
    for k in ("vault_discrepancy", "text_similarity"):
        assert abs(a[k] - b[k]) <= 1e-4, (k, a[k], b[k])
    assert ([m["title"] for m in a["matches"]]
            == [m["title"] for m in b["matches"]])
    for scores in ({"ai_score": 0.9, "misinfo_score": 0.8,
                    "deepfake_score": 0.1, "clip_similarity": 0.3,
                    "vault_discrepancy": 0.0},
                   {"deepfake_score": 0.95}):
        a, b = j_eng.fusion_verdict(scores), t_eng.fusion_verdict(scores)
        assert a["verdict"] == b["verdict"] and set(a) == set(b)
        for k in ("confidence", "fake_probability", "real_probability"):
            assert abs(a[k] - b[k]) <= 1e-4, (k, a[k], b[k])


def test_async_and_stream_equal_the_batch(f32_engines, monkeypatch):
    """analyze_batch_async(...)() is analyze_batch; analyze_stream yields
    the same reports in input order with one batch in flight (batch N + 1
    dispatched before batch N is finalized); both paths feed the analyze
    counters."""
    from misinfo_tpu_torch.utils.tracing import GLOBAL_TRACER
    _, t_eng = f32_engines
    reqs = requests()
    want = t_eng.analyze_batch(reqs)
    before = GLOBAL_TRACER.summary()
    got = t_eng.analyze_batch_async(reqs)()
    after = GLOBAL_TRACER.summary()
    assert after["analyze_count"] == before["analyze_count"] + 1
    assert (after["analyze_n_requests"]
            == before["analyze_n_requests"] + len(reqs))
    assert [r["scores"] for r in got] == [r["scores"] for r in want]
    order = []
    dispatch, finalize = t_eng._dispatch_batch, t_eng._finalize_batch

    def spy_dispatch(rs):
        order.append(("dispatch", len(rs)))
        return dispatch(rs)

    def spy_finalize(d, rs, explanations=False):
        order.append(("finalize", len(rs)))
        return finalize(d, rs, explanations)
    monkeypatch.setattr(t_eng, "_dispatch_batch", spy_dispatch)
    monkeypatch.setattr(t_eng, "_finalize_batch", spy_finalize)
    streamed = list(t_eng.analyze_stream(iter(reqs), batch_size=5))
    assert order == [("dispatch", 5), ("dispatch", 5), ("finalize", 5),
                     ("dispatch", 3), ("finalize", 5), ("finalize", 3)]
    assert len(streamed) == len(reqs)
    # other batch compositions, other padding: the same reports up to the
    # order of f32 sums
    assert_close(want, streamed, 1e-5)


def test_image_prep_pool_equals_serial(f32_engines, monkeypatch):
    """More than one image is prepared on the engine's thread pool of
    min(16, cpu_count) workers, one image inline; the batch equals the
    serial one."""
    _, t_eng = f32_engines
    images = [_image(s) for s in (4, 5, 6)]
    used = []
    pool = t_eng._pool

    def spy():
        used.append(True)
        return pool()
    monkeypatch.setattr(t_eng, "_pool", spy)
    pooled = t_eng._image_batch(images, 4)
    assert used and t_eng._pool()._max_workers == min(16, os.cpu_count())
    used.clear()
    t_eng._image_batch(images[:1], 1)
    assert not used
    monkeypatch.setattr(t_eng, "_prep_map",
                        lambda fn, items: [fn(x) for x in items])
    serial = t_eng._image_batch(images, 4)
    for k in pooled:
        assert torch.equal(pooled[k], serial[k]), k


def test_engine_attributes_match_jax(f32_engines, tmp_path, capsys):
    """tokenizer_grades, load_report (keys and grades) and
    gemini_available as the JAX engine has them; the boot banner names
    the hash-fallback tokenizer."""
    j_eng, t_eng = f32_engines
    assert set(t_eng.load_report) == set(j_eng.load_report)
    assert t_eng.tokenizer_grades == j_eng.tokenizer_grades
    assert (t_eng.load_report["tokenizer_grades"]
            == j_eng.load_report["tokenizer_grades"])
    assert t_eng.gemini_available == j_eng.gemini_available is False
    cfg = dataclasses.replace(t_eng.cfg, verbose=True)
    t_forensics.MisinfoForensics(config=cfg, det_cfg=t_eng.det_cfg,
                                 params=params_from_jax(jax.tree.map(
                                     lambda t: t.numpy(),
                                     detector_init(0, t_eng.det_cfg))),
                                 device="cpu")
    assert "tokenizer=HASH-FALLBACK" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["forensics_master_final.pth",
                                  "clip_detective_best.pth"])
def test_reference_checkpoints_are_refused(tmp_path, monkeypatch, name):
    """Without ``params`` the engine loads ModelPaths' reference .pth
    files, as the JAX engine does (the cascade's parity with JAX is in
    tests/test_torch_serve.py); an unreadable one is refused by the
    cascade, and the engine serves its seeded init with the error in
    ``load_report`` (JAX's soft-fail). With none present it serves its
    seeded init, reported as JAX reports it (the per-branch mode with
    nothing applied). A native checkpoint directory that holds no params
    passes on to the .pth cascade, as in JAX; one that holds only an
    orbax tree is refused by name (tests/test_torch_native_ckpt.py loads
    the native ones)."""
    monkeypatch.chdir(tmp_path)
    cfg = t_config.ForensicsConfig(verbose=False)
    det = TDetectorConfig.tiny()
    engine = t_forensics.MisinfoForensics(config=cfg, det_cfg=det,
                                          device="cpu")
    assert (engine.load_report["mode"], engine.load_report["applied"],
            engine.load_report["skipped"]) == ("individual", 0, [])
    assert "error" not in engine.load_report
    (tmp_path / name).write_bytes(b"")
    engine = t_forensics.MisinfoForensics(config=cfg, det_cfg=det,
                                          device="cpu")
    assert engine.load_report["mode"] == "init"
    assert engine.load_report["error"]
    native = cfg.replace(paths=dataclasses.replace(cfg.paths,
                                                   orbax_dir="ckpt"))
    engine = t_forensics.MisinfoForensics(config=native, det_cfg=det,
                                          device="cpu")
    assert engine.load_report["mode"] == "init"
    (tmp_path / "ckpt" / "params").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax params/ tree"):
        t_forensics.MisinfoForensics(config=native, det_cfg=det,
                                     device="cpu")
