"""The port's engine with every vault capacity mode, held to the JAX engine
at DetectorConfig.tiny() (f32 parity mode) on the same seeded vault and
weights.

For each of vault_dtype float32 / bfloat16 / int8 / int4 and for IVF,
both engines serve one mixed ``analyze_batch`` (``full`` and
``visual_only``) against a 2,000-row vault in which two request images
are planted as near-duplicate rows: scores within 1e-4, the same matches
in the same order, the gate open for the planted requests and shut for
the other. The JAX engine boots first and writes the ``<vault>.int4.npz``
/ ``<vault>.ivf.npz`` sidecar; the port must load it (building is made to
fail), so both search the same index and the same packed rows. Also:
the int4 device planes, the int4 + IVF refusal, ``reload_vault`` (swap,
soft-fail, ``drop_first``, a failed staging that leaves the old vault
serving), ``memory_report``'s keys and the capacity guardrail.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.core import config as j_config
from misinfo_tpu.engine.forensics import MisinfoForensics as JEngine
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.vault.store import TruthVault

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine.forensics import MisinfoForensics as TEngine
from misinfo_tpu_torch.models.clip import clip_image_features
from misinfo_tpu_torch.models.detector import (
    DetectorConfig as TDetectorConfig, detector_init)
from misinfo_tpu_torch.ops.common import l2_normalize
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.vault import int4 as t_int4
from misinfo_tpu_torch.vault import ivf as t_ivf
from misinfo_tpu_torch.vault import prepack as t_prepack

DET = TDetectorConfig.tiny()
N_ROWS = 2000
PLANT = {0: 123, 2: 1777}        # request index → vault row
SCORES = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
          "vault_discrepancy", "text_similarity", "fake_probability",
          "real_probability", "confidence")


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)


REQUESTS = [{"text": "w1 w2 w3 w4", "image": _image(1)},
            {"text": "w5 w6 w7", "image": _image(2)},
            {"image": _image(3)}]


def _cfg(mod, vault_path, **serving):
    return mod.ForensicsConfig(
        verbose=False, precision=mod.PrecisionConfig.highest(),
        paths=mod.ModelPaths(vault_path=vault_path),
        seq=mod.SequenceConfig(roberta_max_len=32, image_size=64),
        serving=dataclasses.replace(mod.ServingConfig(), **serving))


@pytest.fixture(scope="module")
def tree():
    """Seeded weights with the vision tower's class and position
    embeddings zeroed: otherwise the image-independent class token
    dominates a random-weight CLIP embedding and any two images sit at
    cosine ~0.9, so no request could miss the 0.85 gate."""
    t = jax.tree.map(lambda a: a.numpy(), detector_init(0, DET))
    for k in ("class_embedding", "position_embedding"):
        t["clip"]["vision"][k] = np.zeros_like(t["clip"]["vision"][k])
    return t


def _port(tree, path, **serving):
    return TEngine(config=_cfg(t_config, path, **serving), det_cfg=DET,
                   params=params_from_jax(tree), device="cpu")


def _save_vault(path, seed, n=N_ROWS, prefix="article", planted=None):
    rng = np.random.default_rng(seed)
    d = DET.clip.projection_dim
    emb = rng.normal(size=(n, d)).astype(np.float32)
    for row, e in (planted or {}).items():
        emb[row] = e + 0.02 * rng.normal(size=d) / np.sqrt(d)
    TruthVault(emb, [{"title": f"{prefix} {i}", "url": f"u{i}",
                      "date": "2024"} for i in range(n)],
               rng.normal(size=(n, d)).astype(np.float32)).save(path)
    return path


@pytest.fixture(scope="module")
def planted(tree):
    """The port's f32 CLIP image embeddings of the planted requests."""
    eng = _port(tree, "")
    out = {}
    for req, row in PLANT.items():
        b = eng._image_batch([REQUESTS[req]["image"]], 1)
        img = normalize_images(b["image_clip"], "clip", eng.policy.compute)
        with torch.inference_mode():
            out[row] = l2_normalize(clip_image_features(
                eng.params["clip"], img, DET.clip, eng.policy))[0].numpy()
    return out


@pytest.fixture
def vault_path(tmp_path, planted):
    return _save_vault(str(tmp_path / "vault.npz"), 5, planted=planted)


MODES = {"float32": {}, "bfloat16": {"vault_dtype": "bfloat16"},
         "int8": {"vault_dtype": "int8"}, "int4": {"vault_dtype": "int4"},
         "ivf": {"vault_ivf": True, "ivf_nprobe": 4},
         "ivf_bf16_gather": {"vault_ivf": True, "ivf_bf16_gather": True}}


@pytest.mark.parametrize("mode", list(MODES))
def test_reports_match_jax(tree, vault_path, mode, monkeypatch):
    serving = MODES[mode]
    j_eng = JEngine(config=_cfg(j_config, vault_path, **serving),
                    det_cfg=JDetectorConfig.tiny(), params=tree)
    # the port must take the sidecar JAX just wrote, not build its own
    boom = lambda *a, **k: pytest.fail("port rebuilt a fresh sidecar")  # noqa
    monkeypatch.setattr(t_prepack, "build_prepacked", boom)
    monkeypatch.setattr(t_ivf, "build_ivf", boom)
    t_eng = _port(tree, vault_path, **serving)
    a, b = j_eng.analyze_batch(REQUESTS), t_eng.analyze_batch(REQUESTS)
    for i, (ra, rb) in enumerate(zip(a, b)):
        for k in SCORES:
            assert abs(ra["scores"][k] - rb["scores"][k]) <= 1e-4, (k, i)
        assert ra["verdict"] == rb["verdict"]
        assert ([m["title"] for m in ra["vault_matches"]]
                == [m["title"] for m in rb["vault_matches"]])
        gate = rb["scores"]["vault_discrepancy"]
        if i in PLANT:
            assert rb["vault_matches"][0]["title"] == f"article {PLANT[i]}"
            assert gate > 0.85
        else:
            assert gate == 0.0
    assert ("ivf_centroids" in t_eng._vault_device) == mode.startswith("ivf")
    assert ("ivf_emb16" in t_eng._vault_device) == (mode == "ivf_bf16_gather")
    assert (set(t_eng.memory_report()) == set(j_eng.memory_report()))


def test_int4_device_planes_and_ivf_refusal(tree, vault_path):
    eng = _port(tree, vault_path, vault_dtype="int4")
    dev, d = eng._vault_device, DET.clip.projection_dim
    rows = t_int4.INT4_TILE_ROWS
    assert dev["vault_emb"].dtype == torch.uint8
    assert tuple(dev["vault_emb"].shape) == (rows, d // 2)
    assert tuple(dev["vault_scale"].shape) == (rows,)
    assert dev["vault_text_emb"].dtype == torch.uint8
    assert tuple(dev["vault_text_emb"].shape) == (rows, d // 2)
    assert tuple(dev["vault_text_scale"].shape) == (rows,)
    assert not dev["vault_valid"][N_ROWS:].any()
    assert dev["vault_valid"][:N_ROWS].all()
    rep = eng.memory_report()
    assert rep["vault_dtype"] == "int4" and rep["vault_rows_padded"] == rows
    assert rep["vault_bytes_by_key"]["vault_emb"] == rows * d // 2
    with pytest.raises(ValueError, match="exclusive"):
        _port(tree, vault_path, vault_dtype="int4", vault_ivf=True)


def test_int4_vault_without_titles_gets_zero_title_plane(tree, tmp_path):
    rng = np.random.default_rng(9)
    p = str(tmp_path / "notitles.npz")
    TruthVault(rng.normal(size=(50, 64)).astype(np.float32),
               [{"title": f"t{i}"} for i in range(50)]).save(p)
    dev = _port(tree, p, vault_dtype="int4")._vault_device
    assert not dev["vault_text_emb"].any() and not dev["vault_text_scale"].any()


def test_reload_swaps_soft_fails_and_drops_first(tree, tmp_path):
    pa = _save_vault(str(tmp_path / "a.npz"), 1, n=40, prefix="alpha")
    pb = _save_vault(str(tmp_path / "b.npz"), 2, n=40, prefix="beta")
    eng = _port(tree, pa, vault_dtype="int4")
    img = _image(7)
    assert eng.analyze(image_path=img, verbose=False)[
        "vault_matches"][0]["title"].startswith("alpha")
    info = eng.reload_vault(path=pb)
    assert info == {"articles": 40, "rows": t_int4.INT4_TILE_ROWS,
                    "sharded": False}
    assert eng.cfg.paths.vault_path == pb
    after = eng.analyze(image_path=img, verbose=False)
    fresh = _port(tree, pb, vault_dtype="int4").analyze(image_path=img,
                                                        verbose=False)
    assert after["vault_matches"] == fresh["vault_matches"]
    assert after["scores"] == fresh["scores"]
    # a missing file soft-fails to the 128-row dummy, as at start
    info = eng.reload_vault(path=str(tmp_path / "missing.npz"))
    assert info["articles"] == 0 and info["rows"] == 128
    assert not eng.vault_loaded
    rep = eng.analyze(image_path=img, verbose=False)
    assert rep["vault_matches"] == [] and rep["scores"][
        "vault_discrepancy"] == 0.0
    info = eng.reload_vault(path=pa, drop_first=True)
    assert info["articles"] == 40 and eng.vault_loaded
    assert eng.analyze(image_path=img, verbose=False)[
        "vault_matches"][0]["title"].startswith("alpha")


def test_reload_staging_failure_keeps_old_vault(tree, tmp_path, monkeypatch):
    pa = _save_vault(str(tmp_path / "a.npz"), 1, n=40, prefix="alpha")
    pb = _save_vault(str(tmp_path / "b.npz"), 2, n=40, prefix="beta")
    eng = _port(tree, pa)
    old = eng._vault_device

    def boom(*a, **k):
        raise RuntimeError("staging boom")
    monkeypatch.setattr(eng, "_prepare_vault", boom)
    with pytest.raises(RuntimeError, match="staging boom"):
        eng.reload_vault(path=pb)
    assert eng._vault_device is old and eng.cfg.paths.vault_path == pa
    assert eng.analyze(image_path=_image(7), verbose=False)[
        "vault_matches"][0]["title"].startswith("alpha")


def test_memory_report_device_keys_and_guardrail(tree, vault_path,
                                                 monkeypatch, caplog):
    eng = _port(tree, vault_path)
    rep = eng.memory_report()
    assert not any(k.startswith("hbm_") for k in rep)     # the CPU: none
    assert rep["vault_bytes"] == sum(rep["vault_bytes_by_key"].values())
    assert rep["params_bytes"] > 0
    used = rep["vault_bytes"]
    monkeypatch.setattr(eng, "_device_memory", lambda: (1000, int(used / 0.9)))
    rep = eng.memory_report()
    assert rep["hbm_in_use_bytes"] == 1000
    assert rep["hbm_headroom_bytes"] == rep["hbm_limit_bytes"] - 1000
    with caplog.at_level(logging.WARNING, logger="misinfo_tpu_torch.engine"):
        eng._warn_vault_capacity(eng._vault_device)
    assert any("int8" in r.getMessage() and "HBM" in r.getMessage()
               for r in caplog.records)
    caplog.clear()
    monkeypatch.setattr(eng, "_device_memory", lambda: (0, used * 100))
    with caplog.at_level(logging.WARNING, logger="misinfo_tpu_torch.engine"):
        eng._warn_vault_capacity(eng._vault_device)
    assert not caplog.records
