"""Native checkpoint directories (misinfo_tpu_torch/checkpoints/io.py)
across the two packages, and the entry points that read them.

- Bit for bit both ways: JAX's ``save_checkpoint`` with orbax hidden
  (``sys.modules["orbax.checkpoint"] = None``, its portable fallback) is
  read by the port, and the port's directory by JAX's ``load_checkpoint``
  (whose orbax branch fails on it and falls back); the leaf order is
  proved by these round trips over the whole tiny detector. An orbax-only
  directory is refused by name, a tree of other leaves too.
- The optimizer state round-trips, and a run resumed from a checkpoint
  equals an unbroken one.
- ``convert_detector`` and ``convert_whisper_file`` give JAX's
  converter's trees (the JAX inits patched to the port's, so that the
  leaves no file carries agree too), metadata and refusals.
- The engine booted from ``orbax_dir`` (a port directory and a JAX one)
  gives JAX's ``load_report`` and reports within the f32 engine tests'
  1e-4; the transcriber from a converted directory transcribes as JAX's
  does from it; the CLI and the API pass ``--checkpoint`` on as JAX's do;
  ``ClipSimilarityEngine(checkpoint=dir)`` equals JAX's.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.checkpoints import convert as j_convert
from misinfo_tpu.checkpoints import io as j_io
from misinfo_tpu.core import config as j_config
from misinfo_tpu.engine import forensics as j_forensics
from misinfo_tpu.models import detector as j_detector
from misinfo_tpu.models import whisper as j_whisper
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.serve import api as j_api
from misinfo_tpu.serve import cli as j_cli
from misinfo_tpu.serve import similarity as j_sim
from misinfo_tpu.serve import transcript as j_tr

from misinfo_tpu_torch.checkpoints import convert as t_convert
from misinfo_tpu_torch.checkpoints import io as t_io
from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.checkpoints.torch_convert import (
    export_reference_state_dicts)
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.models.whisper import whisper_init
from misinfo_tpu_torch.serve import api as t_api
from misinfo_tpu_torch.serve import cli as t_cli
from misinfo_tpu_torch.serve import similarity as t_sim
from misinfo_tpu_torch.serve import transcript as t_tr
from misinfo_tpu_torch.train import optim as t_optim
from misinfo_tpu_torch.train import steps as t_steps
from misinfo_tpu_torch.utils.tree import leaves_with_paths, tree_map

from tests.test_torch_checkpoints import _hf_file, trained  # noqa: F401
from tests.test_torch_serve import _assert_reports_close, _image, _requests
from tests.test_torch_transcript import TEXT

DET = DetectorConfig.tiny()
JDET = JDetectorConfig.tiny()


def _np_tree(seed):
    return tree_map(lambda t: t.numpy(), detector_init(seed, DET))


def _port_init(key, cfg=None):
    """The port's seeded init in place of JAX's ``detector_init`` (for
    ``PRNGKey(seed)``: [0, seed])."""
    return _np_tree(int(np.asarray(key)[-1]))


def _hide_orbax(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _assert_equal_np(tree_a, tree_b):
    a, b = leaves_with_paths(tree_a), leaves_with_paths(tree_b)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), p


@pytest.fixture(scope="module")
def tree():
    return _np_tree(21)


def test_jax_fallback_dir_read_by_the_port(tmp_path, tree, monkeypatch):
    _hide_orbax(monkeypatch)
    j_io.save_checkpoint(str(tmp_path), tree, metadata={"epoch": 3})
    assert not os.path.isdir(tmp_path / "params")
    got = t_io.load_checkpoint(str(tmp_path), detector_init(0, DET))
    _assert_equal_np(got, tree)
    assert t_io.load_metadata(str(tmp_path)) == {"epoch": 3}


def test_port_dir_read_by_jax(tmp_path, tree):
    tp = params_from_jax(tree)
    tx = t_optim.make_optimizer(t_optim.OptimConfig(),
                                t_optim.branch_mask(tp, ["fusion"]))
    t_io.save_checkpoint(str(tmp_path), tp, tx.init(tp),
                         {"epoch": 1, "trainer": "test"})
    like = jax.tree.map(jnp.zeros_like, tree)
    got = j_io.load_checkpoint(str(tmp_path), like)  # orbax present: falls back
    _assert_equal_np(jax.tree.map(np.asarray, got), tree)
    assert j_io.load_metadata(str(tmp_path)) == {"epoch": 1,
                                                 "trainer": "test"}
    # JAX's optimizer-state reader never picks up the port's file
    assert os.path.exists(tmp_path / t_io.OPT_STATE)
    assert j_io.load_opt_state(str(tmp_path), None) is None


def test_orbax_only_and_foreign_dirs_refused(tmp_path, tree):
    j_io.save_checkpoint(str(tmp_path / "orbax"), tree)   # orbax installed
    assert os.path.isdir(tmp_path / "orbax" / "params")
    with pytest.raises(ValueError, match="orbax params/ tree.*params_flat"):
        t_io.load_checkpoint(str(tmp_path / "orbax"), detector_init(0, DET))
    assert t_io.load_checkpoint(str(tmp_path / "none"), tree) is None
    os.makedirs(tmp_path / "empty")
    assert t_io.load_checkpoint(str(tmp_path / "empty"), tree) is None
    t_io.save_checkpoint(str(tmp_path / "tiny"), params_from_jax(tree))
    other = dataclasses.replace(DET, roberta=dataclasses.replace(
        DET.roberta, num_layers=1))
    with pytest.raises(ValueError, match="not this tree's"):
        t_io.load_checkpoint(str(tmp_path / "tiny"), detector_init(0, other))
    os.remove(tmp_path / "tiny" / t_io.PATHS)      # JAX-written: no paths
    with pytest.raises(ValueError, match="leaves saved"):
        t_io.load_checkpoint(str(tmp_path / "tiny"), detector_init(0, other))


def test_resumed_run_equals_unbroken(tmp_path, tree):
    from tests.test_torch_train_steps import TDET, _batch, _policies
    _, pol = _policies()
    rng = np.random.default_rng(3)
    batches = [t_steps.batch_to(_batch("text", rng), "cpu")
               for _ in range(4)]
    cfg = t_optim.OptimConfig(lr=1e-3, warmup_fraction=0.25, total_steps=4)

    def fresh(params):
        tx = t_optim.make_optimizer(
            cfg, t_optim.branch_mask(params, ["roberta", "misinfo_head"]))
        return tx, tx.init(params)
    p1 = params_from_jax(tree)
    tx, s1 = fresh(p1)
    step = t_steps.make_text_head_step(tx, TDET, pol)
    for b in batches:
        p1, s1, _ = step(p1, s1, b)
    p2 = params_from_jax(tree)
    tx2, s2 = fresh(p2)
    step2 = t_steps.make_text_head_step(tx2, TDET, pol)
    for b in batches[:2]:
        p2, s2, _ = step2(p2, s2, b)
    t_io.save_checkpoint(str(tmp_path), p2, s2)
    p3 = t_io.load_checkpoint(str(tmp_path), detector_init(0, DET))
    tx3, s3 = fresh(p3)
    assert t_io.load_opt_state(str(tmp_path), s3) is s3 and s3.count == 2
    step3 = t_steps.make_text_head_step(tx3, TDET, pol)
    for b in batches[2:]:
        p3, s3, _ = step3(p3, s3, b)
    _assert_equal_np(p3, p1)
    for a, b in zip(s3.m + s3.v, s1.m + s1.v):
        assert torch.equal(a, b)
    assert t_io.load_opt_state(str(tmp_path / "none"), s3) is None


# ------------------------------------------------------------ converters

def _reference_files(root, tree_t):
    full, clip_sd = export_reference_state_dicts(tree_t)
    os.makedirs(root, exist_ok=True)
    torch.save({"full_model_state_dict": {k: torch.from_numpy(v)
                                          for k, v in full.items()},
                "epoch": 4, "accuracy": 0.9},
               os.path.join(root, "forensics_master_final.pth"))
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in clip_sd.items()}},
               os.path.join(root, "clip_detective_best.pth"))
    return str(root)


def test_convert_detector_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(j_detector, "detector_init", _port_init)
    assets = _reference_files(tmp_path / "assets",
                              detector_init(22, DET))
    _hide_orbax(monkeypatch)
    want = j_convert.convert_detector(assets, str(tmp_path / "jax"),
                                      det_cfg=JDET)
    got = t_convert.convert_detector(assets, str(tmp_path / "port"),
                                     det_cfg=DET)
    assert (got["mode"], got["applied"], got["skipped"]) == (
        want["mode"], want["applied"], want["skipped"])
    like = detector_init(0, DET)
    _assert_equal_np(t_io.load_checkpoint(str(tmp_path / "port"), like),
                     t_io.load_checkpoint(str(tmp_path / "jax"), like))
    meta = [m.load_metadata(str(tmp_path / d))
            for m, d in ((t_io, "port"), (j_io, "jax"))]
    assert meta[0] == meta[1] and meta[0]["load_mode"] == "monolithic"
    # an empty conversion is refused with JAX's message
    os.makedirs(tmp_path / "nothing")
    errs = []
    for conv in (j_convert, t_convert):
        with pytest.raises(SystemExit) as e:
            conv.convert_detector(str(tmp_path / "nothing"),
                                  str(tmp_path / "x"),
                                  det_cfg=JDET if conv is j_convert else DET)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "refusing" in errs[0]


@pytest.fixture(scope="module")
def whisper_dirs(trained, tmp_path_factory):
    """The JAX-trained tiny Whisper as an HF .pt, converted by each
    package (the JAX init patched to the port's) with a vocabulary
    bundled: {"jax": dir, "port": dir, "pt": file, ...}."""
    params, cfg, wav = trained
    root = tmp_path_factory.mktemp("native_whisper")
    pt = _hf_file(root, params, cfg)
    vocab = root / "vocab"
    vocab.mkdir()
    (vocab / "vocab.json").write_text(json.dumps({"a": 0}))
    (vocab / "merges.txt").write_text("#version: 0.2\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_whisper, "whisper_init", lambda key, c: jax.tree.map(
            lambda t: t.numpy(), whisper_init(0, c)))
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        metas = {
            "jax": j_convert.convert_whisper_file(pt, str(root / "jax")),
            "port": t_convert.convert_whisper_file(pt, str(root / "port")),
            "port_tok": t_convert.convert_whisper_file(
                pt, str(root / "port_tok"), str(vocab))}
    return {**{k: str(root / k) for k in metas}, "pt": pt, "wav": wav,
            "metas": metas, "root": root, "vocab": str(vocab)}


def test_convert_whisper_equals_jax(whisper_dirs, trained):
    params, cfg, _ = trained
    d = whisper_dirs
    for k in ("applied", "skipped", "whisper_config"):
        assert d["metas"]["port"][k] == d["metas"]["jax"][k], k
    assert d["metas"]["port"]["whisper_config"] == dataclasses.asdict(cfg)
    like = whisper_init(0, t_tr.WhisperConfig(
        **d["metas"]["port"]["whisper_config"]))
    _assert_equal_np(t_io.load_checkpoint(d["port"], like),
                     t_io.load_checkpoint(d["jax"], like))
    _assert_equal_np(t_io.load_checkpoint(d["port"], like), params)
    assert sorted(os.listdir(os.path.join(d["port_tok"], "tokenizer"))) == [
        "merges.txt", "vocab.json"]
    os.remove(os.path.join(d["vocab"], "merges.txt"))
    errs = []
    for conv in (j_convert, t_convert):
        with pytest.raises(SystemExit) as e:
            conv.convert_whisper_file(d["pt"], str(d["root"] / "partial"),
                                      d["vocab"])
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "partial" in errs[0]


def test_transcriber_from_native_dir_as_jax(whisper_dirs, trained):
    params, cfg, wav = trained
    for src in ("port", "jax"):
        tr = t_tr.WhisperTranscriber(checkpoint_dir=whisper_dirs[src],
                                     device="cpu")
        jt = j_tr.WhisperTranscriber(checkpoint_dir=whisper_dirs[src])
        assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jt.cfg)
        assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(cfg)
        assert tr.has_weights and jt.has_weights
        from_tree = t_tr.WhisperTranscriber(params, config=cfg, device="cpu")
        for (p, a), (_, b) in zip(leaves_with_paths(tr.params),
                                  leaves_with_paths(from_tree.params)):
            assert torch.equal(a, b), p
        assert tr.transcribe(wav) == jt.transcribe(wav) == TEXT
    # a bundled tokenizer directory is the one the transcriber loads
    tr = t_tr.WhisperTranscriber(checkpoint_dir=whisper_dirs["port_tok"],
                                 device="cpu")
    jt = j_tr.WhisperTranscriber(checkpoint_dir=whisper_dirs["port_tok"])
    assert (type(tr.tokenizer).__name__, tr.tokenizer_compatible) == (
        type(jt.tokenizer).__name__, jt.tokenizer_compatible)


# ------------------------------------------------------- serving entries

def _config(mod, ckpt, vault=None):
    paths = mod.ModelPaths(orbax_dir=ckpt, vault_path=vault or "none.npz")
    return mod.ForensicsConfig(
        verbose=False, precision=mod.PrecisionConfig.highest(), paths=paths,
        seq=mod.SequenceConfig(roberta_max_len=32, image_size=64))


@pytest.fixture(scope="module")
def native_dirs(tmp_path_factory):
    """A trained-looking tree saved by each package: {"port": dir,
    "jax": dir (orbax hidden), "tree": numpy tree}."""
    root = tmp_path_factory.mktemp("native_engine")
    tree = _np_tree(23)
    t_io.save_checkpoint(str(root / "port"), params_from_jax(tree),
                         metadata={"epoch": 2, "trainer": "fusion_judge"})
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        j_io.save_checkpoint(str(root / "jax"), tree,
                             metadata={"epoch": 5, "accuracy": 0.75})
    return {"port": str(root / "port"), "jax": str(root / "jax"),
            "tree": tree}


def _engines(ckpt):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_forensics, "detector_init", _port_init)
        j = j_forensics.MisinfoForensics(config=_config(j_config, ckpt),
                                         det_cfg=JDET)
    t = t_forensics.MisinfoForensics(config=_config(t_config, ckpt),
                                     det_cfg=DET, device="cpu")
    return j, t


def _report(engine):
    return {k: v for k, v in engine.load_report.items()
            if k not in ("tokenizer_grades",)}


@pytest.mark.parametrize("src", ["port", "jax"])
def test_engine_boots_from_native_dir_as_jax(native_dirs, src):
    j, t = _engines(native_dirs[src])
    assert _report(t) == _report(j)
    assert t.load_report["mode"] == "native"
    assert t.load_report["path"] == native_dirs[src]
    given = t_forensics.MisinfoForensics(
        config=_config(t_config, None), det_cfg=DET, device="cpu",
        params=params_from_jax(native_dirs["tree"]))
    for (p, a), (_, b) in zip(leaves_with_paths(t.params),
                              leaves_with_paths(given.params)):
        assert torch.equal(a, b), p
    _assert_reports_close(j.analyze_batch(_requests()),
                          t.analyze_batch(_requests()), tol=1e-4)


def test_cli_and_api_checkpoint_flag_as_jax(native_dirs, tmp_path,
                                            monkeypatch):
    """``--checkpoint`` reaches each engine's config as ``orbax_dir``; the
    port's CLI output from the booted directory equals JAX's."""
    ckpt = native_dirs["port"]
    j_engine, _ = _engines(ckpt)
    Real = t_forensics.MisinfoForensics
    made = []

    def tiny(config=None, device="cuda", **kw):
        config = config.replace(
            precision=t_config.PrecisionConfig.highest(),
            seq=t_config.SequenceConfig(roberta_max_len=32, image_size=64))
        made.append(Real(config, DET, device=device, **kw))
        return made[-1]
    monkeypatch.setattr(t_forensics, "MisinfoForensics", tiny)
    seen = []

    def j_engine_for(config=None, mesh=None, **kw):
        seen.append(config.paths.orbax_dir)
        return j_engine
    monkeypatch.setattr(j_forensics, "MisinfoForensics", j_engine_for)
    monkeypatch.chdir(tmp_path)
    outs = [tmp_path / "jax.json", tmp_path / "port.json"]
    argv = ["--text", "a claim about some news", "--checkpoint", ckpt,
            "--quiet"]
    assert j_cli.main(argv + ["--output", str(outs[0])]) == 0
    assert t_cli.main(argv + ["--device", "cpu", "--output",
                              str(outs[1])]) == 0
    assert seen == [ckpt]
    assert made[0].cfg.paths.orbax_dir == ckpt
    assert made[0].load_report["mode"] == "native"
    _assert_reports_close(*[[json.loads(o.read_text())] for o in outs],
                          tol=1e-4)

    class Stop(Exception):
        pass
    configs = []

    def api_for(config=None, **kw):
        configs.append(config.paths.orbax_dir)
        raise Stop
    monkeypatch.setattr(j_api, "ForensicsAPI", api_for)
    monkeypatch.setattr(t_api, "ForensicsAPI", api_for)
    for main, extra in ((j_api.main, []), (t_api.main, ["--device", "cpu"])):
        with pytest.raises(Stop):
            main(["--port", "0", "--checkpoint", ckpt] + extra)
    assert configs == [ckpt, ckpt]


def test_similarity_engine_from_checkpoint_as_jax(native_dirs):
    ckpt = native_dirs["port"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sim, "detector_init", _port_init)
        j = j_sim.ClipSimilarityEngine(det_cfg=JDET, checkpoint=ckpt)
    t = t_sim.ClipSimilarityEngine(det_cfg=DET, checkpoint=ckpt,
                                   device="cpu")
    _assert_equal_np(t.params, native_dirs["tree"]["clip"])
    texts = ["a dog on a beach", "stock market news"]
    images = [_image(s) for s in (1, 2)]
    for a, b in zip(t.analyze_pairs(texts, images),
                    j.analyze_pairs(texts, images)):
        assert abs(a["similarity"] - b["similarity"]) <= 1e-4
        assert (a["label"], a["explanation"]) == (b["label"],
                                                  b["explanation"])
