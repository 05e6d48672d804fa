"""Training over a device mesh in the port (core/mesh.py::
setup_train_mesh, parallel/{sharding,collectives}.py, train/steps.py)
held to the JAX package's training, on grids of ``cpu`` entries.

- each of the seven step kinds of tests/test_torch_train_steps.py (its
  ``RECIPES``, batches and ``_make``) under ``data=8`` and
  ``data=4,model=2``: after three steps on global batches of 8 (two of
  that file's batches; a packed batch of 8 rows), loss, metric and every
  leaf within 1e-5 of JAX's single-device step, every replica bit for
  bit the first (against JAX's step over its 8 virtual devices:
  tests/test_torch_trainers_mesh_jax.py);
- the local-negatives control: InfoNCE over per-shard negatives differs
  from the global loss by > 1e-2, and the mesh step's loss is the global
  one;
- dropout live (fusion, EfficientNet's stochastic depth and classifier
  dropout, RoBERTa's hidden dropout): the mesh step equals the port's
  single-device step on the same seed;
- the batch-divisibility ValueError;
- the five trainers end to end under both specs (the RoBERTa detective
  with ``pack=True`` too): histories within 1e-5 of the single-device
  run's (``HISTORY_BAND`` for the bf16 AI head), checkpoints within
  ``BAND``, loaded by the port's and JAX's
  ``load_checkpoint``; the CLIs under ``--device cpu --mesh data=8``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.checkpoints.io import load_checkpoint as j_load
from misinfo_tpu.core import mesh as j_mesh
from misinfo_tpu.core.config import MeshConfig as JMeshConfig
from misinfo_tpu.models import fusion as j_fusion
from misinfo_tpu.parallel.sharding import shard_params as j_shard_params
from misinfo_tpu.preprocess.packing import StreamPacker

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.checkpoints.io import load_checkpoint, load_metadata
from misinfo_tpu_torch.core import mesh as t_mesh
from misinfo_tpu_torch.models import fusion as t_fusion
from misinfo_tpu_torch.models.clip import (
    clip_image_features, clip_text_features)
from misinfo_tpu_torch.models.detector import detector_init
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.parallel.sharding import (
    replica_leaves, shard_train_params)
from misinfo_tpu_torch.train import ai_head as t_ai
from misinfo_tpu_torch.train import cifake_efficientnet as t_cifake
from misinfo_tpu_torch.train import clip_detective as t_clip
from misinfo_tpu_torch.train import fusion_judge as t_fj
from misinfo_tpu_torch.train import roberta_detective as t_rd
from misinfo_tpu_torch.train import steps as t_steps
from misinfo_tpu_torch.train.losses import clip_contrastive_loss
from misinfo_tpu_torch.utils.tree import leaves_with_paths, tree_map

from tests.test_torch_train_steps import (
    STEP_KINDS, TDET, _assert_trees_close, _batch, _jax, _make, _policies)
from tests.test_torch_trainers import _pairs_csv, _pngs, _text_csv

SPECS = ["data=8", "data=4,model=2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Eight positions run in turn, each a few small ops: one intra-op
    thread keeps them cheap beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _mesh_flags(monkeypatch):
    """The trainers' ``device="cpu"`` meshes set core/mesh.py's platform
    flags (as ``--device cpu --mesh``); each test gets them back."""
    monkeypatch.setattr(t_mesh, "_platform", t_mesh._platform)
    monkeypatch.setattr(t_mesh, "_num_cpu_devices", t_mesh._num_cpu_devices)


@pytest.fixture(scope="module")
def tree():
    return tree_map(lambda t: t.numpy(), detector_init(3, TDET))


def _mesh(spec):
    mc = t_mesh.parse_mesh_spec(spec)
    return t_mesh.make_mesh(mc, devices=["cpu"] * (mc.data * mc.model))


def _packed8(rng):
    """A packed batch of 8 rows of 24 tokens and 32 slots."""
    packer = StreamPacker(row_len=24, pad_id=TDET.roberta.pad_token_id,
                          n_rows=8, n_slots=32)
    lens = (7, 5, 9, 4, 11, 6, 13, 3, 8, 10, 5, 7, 12, 6, 9, 4, 14, 5)
    for i, n in enumerate(lens):
        seq = rng.integers(3, TDET.roberta.vocab_size, n).astype(np.int32)
        assert packer.add(seq, i % 2) is None
    packed, metas = packer.flush()
    labels = np.zeros(32, np.int32)
    valid = np.zeros(32, np.float32)
    labels[:len(metas)] = metas
    valid[:len(metas)] = 1.0
    return {"input_ids": packed.ids, "attention_mask": packed.mask,
            "position_ids": packed.position_ids,
            "segment_ids": packed.segment_ids, "cls_rows": packed.cls_rows,
            "cls_cols": packed.cls_cols, "labels": labels,
            "slot_valid": valid}


def _batch8(kind, rng):
    if kind == "packed":
        return _packed8(rng)
    if kind == "fusion":
        return _batch(kind, rng)            # 8 rows already
    a, b = _batch(kind, rng), _batch(kind, rng)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def _batches(kind):
    rng = np.random.default_rng(7)
    return [_batch8(kind, rng) for _ in range(3)]


def _metric(kind):
    return "mean_matched_sim" if kind == "clip" else "accuracy"


_JAX = {}


def _jax_run(tree, kind, on_mesh=False):
    """JAX's three steps on the global batches: (metrics per step, the
    final tree), single-device or over its 8 virtual devices (data=8);
    computed once per kind and placement."""
    if (kind, on_mesh) not in _JAX:
        jpol, tpol = _policies()
        jtx, _, jstep, _, key = _make(kind, tree, jpol, tpol)
        jmesh = (j_mesh.make_mesh(JMeshConfig(model=1)) if on_mesh
                 else None)
        jp = _jax(tree)
        if on_mesh:
            jp = j_shard_params(jmesh, jp)
        js = jtx.init(jp)
        ms = []
        for b in _batches(kind):
            jp, js, m = jstep(jp, js, j_mesh.place_train_batch(jmesh, b),
                              key)
            ms.append({k: float(v) for k, v in m.items()})
        _JAX[kind, on_mesh] = (ms, jax.tree.map(np.asarray, jp))
    return _JAX[kind, on_mesh]


def _assert_replicas_equal(tp):
    first = replica_leaves(tp.rows[0])
    for row in tp.rows[1:]:
        for (p, j, a), (_, _, b) in zip(first, replica_leaves(row)):
            assert torch.equal(a, b), (p, j)


def _port_run(tree, kind, mesh, gen_seed=None):
    jpol, tpol = _policies()
    _, ttx, _, tstep, _ = _make(kind, tree, jpol, tpol)
    tp = params_from_jax(tree)
    if mesh is not None:
        tp = shard_train_params(mesh, tp)
    ts = ttx.init(tp)
    gen = (None if gen_seed is None
           else torch.Generator().manual_seed(gen_seed))
    ms = []
    for b in _batches(kind):
        tb = (t_mesh.place_train_batch(mesh, b) if mesh is not None
              else t_steps.batch_to(b, "cpu"))
        tp, ts, m = tstep(tp, ts, tb, gen)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, tp


def _no_fusion_dropout(monkeypatch):
    monkeypatch.setattr(j_fusion, "FUSION_DROPOUT", 0.0)
    monkeypatch.setattr(t_fusion, "FUSION_DROPOUT", 0.0)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kind", STEP_KINDS)
def test_mesh_step_matches_jax(tree, kind, spec, monkeypatch):
    _no_fusion_dropout(monkeypatch)
    j_ms, jp = _jax_run(tree, kind)
    t_ms, tp = _port_run(tree, kind, _mesh(spec))
    metric = _metric(kind)
    for i, (a, b) in enumerate(zip(j_ms, t_ms)):
        for k in ("loss", metric):
            assert abs(a[k] - b[k]) <= 1e-5, (kind, spec, i, k, a[k], b[k])
    _assert_trees_close(jp, tp.gather(), 1e-5, (kind, spec))
    _assert_replicas_equal(tp)
    assert tp.rows[0] is not tp.rows[1]
    if spec.endswith("model=2") and kind not in ("effnet", "fusion"):
        assert any(j == 1 for _, j, _ in replica_leaves(tp.rows[0]))


def test_infonce_negatives_span_the_global_batch(tree):
    """The mesh step's loss is InfoNCE over the global [16, 16] matrix;
    per-shard negatives (pairs of rows) would give a loss that differs
    by > 1e-2 (JAX's control, tests/test_trainers_mesh.py)."""
    rng = np.random.default_rng(0)
    batch = {k: np.concatenate([v, w]) for (k, v), w in zip(
        _batch8("clip", rng).items(), _batch8("clip", rng).values())}
    p0 = params_from_jax(tree)
    _, pol = _policies()
    b = t_steps.batch_to(batch, "cpu")
    te = clip_text_features(p0["clip"], b["input_ids"], b["attention_mask"],
                            TDET.clip, pol)
    ie = clip_image_features(p0["clip"], normalize_images(
        b["images_u8"], "clip", pol.compute), TDET.clip, pol)
    scale = p0["clip"]["logit_scale"]
    global_loss = float(clip_contrastive_loss(ie, te, scale))
    local = np.mean([float(clip_contrastive_loss(ie[s:s + 2], te[s:s + 2],
                                                 scale))
                     for s in range(0, 16, 2)])
    assert abs(local - global_loss) > 1e-2
    _, ttx, _, tstep, _ = _make("clip", tree, *_policies())
    mesh = _mesh("data=8")
    tp = shard_train_params(mesh, params_from_jax(tree))
    _, _, m = tstep(tp, ttx.init(tp), t_mesh.place_train_batch(mesh, batch))
    assert abs(float(m["loss"]) - global_loss) <= 1e-6


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kind", ["fusion", "effnet", "text"])
def test_dropout_live_mesh_equals_single(tree, kind, spec, monkeypatch):
    """Dropout masks drawn over the global batch and split by rows: the
    mesh step equals the single-device step on the same seed."""
    if kind == "text":
        hot = dataclasses.replace(TDET, roberta=dataclasses.replace(
            TDET.roberta, hidden_dropout=0.1))
        monkeypatch.setattr("tests.test_torch_train_steps.TDET", hot)
    single_ms, single = _port_run(tree, kind, None, gen_seed=5)
    mesh_ms, tp = _port_run(tree, kind, _mesh(spec), gen_seed=5)
    for a, b in zip(single_ms, mesh_ms):
        for k, v in a.items():
            assert abs(v - b[k]) <= 1e-6, (kind, spec, k, v, b[k])
    # with the same seed and dropout on, the first step already differs
    # from a step without masks
    plain_ms, _ = _port_run(tree, kind, None)
    assert plain_ms[0]["loss"] != single_ms[0]["loss"]
    worst = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        leaves_with_paths(single), leaves_with_paths(tp.gather())))
    assert worst <= 1e-5, (kind, spec, worst)
    _assert_replicas_equal(tp)


def test_batch_must_divide_the_data_axis(tree):
    t_mesh.apply_device_override("cpu", "data=8")
    with pytest.raises(ValueError, match="batch_size 12 not divisible by "
                       "data axis 8"):
        t_mesh.setup_train_mesh("data=8", params_from_jax(tree), 12)
    with pytest.raises(ValueError, match="leading axis 4 not divisible"):
        t_mesh.place_train_batch(_mesh("data=8"),
                                 {"x": np.zeros((4, 2), np.float32)})
    mesh, tp = t_mesh.setup_train_mesh("data=8", params_from_jax(tree), 16)
    assert mesh.shape == {"data": 8, "model": 1} and len(tp.rows) == 8


# --------------------------------------------------------------- trainers

def _fusion_data():
    rng = np.random.default_rng(2)
    vecs = rng.uniform(size=(72, 5)).astype(np.float32)
    labels = (vecs[:, 1] + 0.3 * rng.normal(size=72) > 0.5).astype(np.int32)
    return vecs, labels


def _run_trainer(name, tmp, spec, root):
    """One trainer's run (``spec`` None: the single-device run)."""
    out = str(tmp / f"{name}-{spec}")
    start = detector_init(4, TDET)
    kw = dict(device="cpu", mesh_spec=spec, log=lambda *_: None)
    if name in ("roberta", "roberta_packed"):
        return out, t_rd.train(
            root["text"], out, epochs=1, batch_size=8, max_len=16,
            det_cfg=TDET, params=start, precision="float32",
            pack=name == "roberta_packed", **kw)
    if name == "ai_head":
        cfg = dataclasses.replace(TDET, roberta=dataclasses.replace(
            TDET.roberta, max_position_embeddings=258))
        return out, t_ai.train(root["text"], out, epochs=1, batch_size=8,
                               det_cfg=cfg, **kw)
    if name == "cifake":
        return out, t_cifake.train("", out, epochs=1, batch_size=8,
                                   image_size=48, det_cfg=TDET, params=start,
                                   precision="float32", items=root["items"],
                                   **kw)
    if name == "clip":
        return out, t_clip.train(root["pairs"], out_dir=out, epochs=1,
                                 batch_size=8, det_cfg=TDET, params=start,
                                 precision="float32", **kw)
    vecs, labels = _fusion_data()
    return out, t_fj.train_on_scores(vecs, labels, start, out, epochs=2,
                                     batch_size=16, **kw)


TRAINERS = ["roberta", "roberta_packed", "ai_head", "cifake", "clip",
            "fusion"]
# each leaf's band against the single-device run: 1e-5, or 2.1 × the
# learning rate where the trainer runs AdamW at eps 1e-8 (the AI head at
# 1e-3, CIFAKE at 1e-4): the mesh sums each gradient in another order, and
# AdamW turns a gradient at the rounding floor into an update of up to
# ±lr either way (JAX's own mesh-against-single band for the EfficientNet
# step, tests/test_trainers_mesh.py, is 2.1 × its lr)
BAND = {"ai_head": 2.1e-3, "cifake": 2.1e-4}
# the metrics' band: 1e-5; the AI head trains in bf16 (its recipe) at lr
# 1e-3, and its later steps' losses moved by up to 9.8e-5 (measured)
HISTORY_BAND = {"ai_head": 1e-3}


@pytest.fixture(scope="module")
def trainer_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainers_mesh")
    pngs = _pngs(tmp, 6)
    return {"tmp": tmp, "text": _text_csv(tmp / "text.csv", n=50),
            "pairs": _pairs_csv(tmp, pngs, n=30),
            "items": [(p, i % 2) for i, p in
                      enumerate(_pngs(tmp, 12, 48, seed=4))]}


_SINGLE = {}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_on_mesh_equals_single(name, spec, trainer_root):
    tmp = trainer_root["tmp"]
    if name not in _SINGLE:
        _SINGLE[name] = _run_trainer(name, tmp, None, trainer_root)
    s_out, single = _SINGLE[name]
    m_out, res = _run_trainer(name, tmp, spec, trainer_root)
    assert len(res.history) == len(single.history)
    for a, b in zip(single.history, res.history):
        for k, v in a.items():
            if k not in ("seconds", "epoch"):
                assert abs(v - b[k]) <= HISTORY_BAND.get(name, 1e-5), (
                    name, spec, k, v, b[k])
    assert res.best_epoch == single.best_epoch
    like = detector_init(0, TDET if name != "ai_head" else
                         dataclasses.replace(TDET, roberta=dataclasses.replace(
                             TDET.roberta, max_position_embeddings=258)))
    want = load_checkpoint(s_out, like)
    got = load_checkpoint(m_out, like)
    j_got = j_load(m_out, _jax(tree_map(lambda t: t.numpy(), like)))
    assert got is not None and j_got is not None
    for (p, a), (_, b), c in zip(leaves_with_paths(want),
                                 leaves_with_paths(got),
                                 jax.tree_util.tree_leaves(j_got)):
        assert float((a - b).abs().max()) <= BAND.get(name, 1e-5), (name, p)
        assert np.array_equal(np.asarray(c), b.numpy()), (name, p)
    for (p, a), (_, b) in zip(leaves_with_paths(got),
                              leaves_with_paths(res.params)):
        assert torch.equal(a, b), (name, p)
    assert load_metadata(m_out)["epoch"] == res.best_epoch
    # the gathered optimizer state is the plain tree's, as one card's
    want_st, got_st = (torch.load(f"{d}/opt_state_torch.pt")
                       for d in (s_out, m_out))
    assert got_st["paths"] == want_st["paths"]
    assert got_st["count"] == want_st["count"]
    assert [t.shape for t in got_st["m"]] == [t.shape for t in want_st["m"]]


@pytest.mark.parametrize("module,argv", [
    (t_rd, ["--csv", "{text}", "--max-len", "16", "--batch-size", "8",
            "--epochs", "1"]),
    (t_rd, ["--csv", "{text}", "--max-len", "16", "--batch-size", "8",
            "--epochs", "1", "--pack"]),
    (t_clip, ["--train-csv", "{pairs}", "--batch-size", "8", "--epochs",
              "1"])])
def test_trainer_cli_trains_on_a_cpu_mesh(module, argv, trainer_root,
                                          monkeypatch, tmp_path):
    """``--device cpu --mesh data=8`` provisions eight ``cpu`` entries
    (``select_device`` → ``apply_device_override``) and trains over them;
    the tiny config stands in for the CLI's full-width default."""
    monkeypatch.setattr(module, "DetectorConfig", lambda: TDET)
    out = str(tmp_path / "out")
    argv = [a.format(**trainer_root) for a in argv]
    res = module.main(argv + ["--out", out, "--device", "cpu", "--mesh",
                              "data=8"])
    assert np.isfinite(res.best_metric)
    assert t_mesh.make_mesh().shape == {"data": 8, "model": 1}
    assert load_checkpoint(out, detector_init(0, TDET)) is not None
