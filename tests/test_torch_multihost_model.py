"""A model group across processes in training (core/mesh.py::Mesh,
parallel/collectives.py::ModelGroup, parallel/{sharding,tensor}.py,
train/{optim,harness}.py), in real ``gloo`` processes on the CPU.

Each worker imports only the port (no JAX): it opens the group through
``init_multihost``'s ``JAX_*`` env path, builds its meshes and writes
what it computed to a file that this process reads. On the seeded tiny
detector:

- (a) ``make_mesh(MeshConfig(data=1, model=2))`` over two one-entry
  processes: one step each of the ``text`` step with RoBERTa's hidden
  dropout live, the ``text`` step without dropout, the ``clip`` step
  (``logit_scale`` counted once), the ``packed`` step and the ``effnet``
  step (replicated leaves only). The ranks' trees, metrics and generator
  states are ``torch.equal``, each within 1e-6 of the one-process
  ``data=1,model=2`` grid; the dropout-free ``text`` step within 1e-5 of
  JAX's single-device step (ROADMAP's f32 bar);
- (b) ``Mesh([["cpu","cpu"],["cpu","cpu"]], ranks=[[0,1],[0,1]])``, data
  local and model across, and (c) four processes under ``data=2,model=2``
  (ranks ``[[0,1],[2,3]]``: the data sums per model column and the rows
  gathered by data position): the live-dropout ``text`` step against the
  one-process ``data=2,model=2`` grid, within 1e-6, ranks ``torch.equal``;
- (d) the RoBERTa detective's CLI (``main``, the tiny config patched in
  for its full-width default, as tests/test_torch_trainers_mesh.py does)
  with ``--device cpu --mesh data=1,model=2`` in the same two processes:
  rank 0 alone saves, the port's and JAX's ``load_checkpoint`` both load
  the checkpoint, and the history is within phase 31 (a)'s bf16 band of
  the one-process grid's (the CLI's recipe is bf16); the same trainer in
  f32 within 1e-5 (history) and 1e-6 (every leaf).

The pair and the four run at once, every worker with its own timeout and
the rendezvous its own (``MISINFO_TPU_DIST_TIMEOUT_S``), torch on one
thread.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from misinfo_tpu_torch.core import mesh as t_mesh
from misinfo_tpu_torch.core.config import MeshConfig, PrecisionConfig
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy
from misinfo_tpu_torch.parallel.sharding import shard_train_params
from misinfo_tpu_torch.preprocess.packing import StreamPacker
from misinfo_tpu_torch.train import steps as t_steps
from misinfo_tpu_torch.train.clip_detective import clip_trainable_mask
from misinfo_tpu_torch.train.optim import (
    OptimConfig, branch_mask, make_optimizer)
from misinfo_tpu_torch.utils.tree import leaves_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = DetectorConfig.tiny()
COLD = dataclasses.replace(TINY, roberta=dataclasses.replace(
    TINY.roberta, hidden_dropout=0.0))
HOT = dataclasses.replace(TINY, roberta=dataclasses.replace(
    TINY.roberta, hidden_dropout=0.1))
B = 4
SEED = 5
# each kind's optimizer (tests/test_torch_train_steps.py's RECIPES)
RECIPES = {
    "text": dict(lr=2e-5, weight_decay=0.01, clip_norm=1.0),
    "text_hot": dict(lr=2e-5, weight_decay=0.01, clip_norm=1.0),
    "packed": dict(lr=2e-5, weight_decay=0.01, clip_norm=1.0),
    "effnet": dict(lr=1e-4, weight_decay=0.0, clip_norm=None,
                   schedule="constant", eps=1e-2),
    "clip": dict(lr=1e-4, weight_decay=0.01, clip_norm=1.0),
}
KINDS_A = ["text_hot", "text", "clip", "packed", "effnet"]
CLI = ["--max-len", "16", "--batch-size", "8", "--epochs", "2"]

WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from misinfo_tpu_torch.core import mesh as M
from misinfo_tpu_torch.core.config import MeshConfig

mode, out, csv, ckpt = sys.argv[1:5]
M.apply_device_override("cpu")
assert M.init_multihost() is True, "the env path did not open a group"
rank, world = dist.get_rank(), dist.get_world_size()
from tests.test_torch_multihost_model import run_steps
res = {"rank": rank}
if mode == "pair":
    mesh = M.make_mesh(MeshConfig(data=1, model=2))
    assert mesh.ranks.tolist() == [[0, 1]], mesh.ranks
    assert mesh.local_data == [0] and mesh.local_model(0) == [rank]
    res["a"] = run_steps(mesh, ["text_hot", "text", "clip", "packed",
                                "effnet"])
    both = M.Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ranks=[[0, 1], [0, 1]])
    assert both.local_data == [0, 1] and both.local_model(1) == [rank]
    res["b"] = run_steps(both, ["text_hot"])
    from misinfo_tpu_torch.checkpoints import io as ckpt_io
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.train import roberta_detective as rd
    saves = []
    real_save = ckpt_io.save_checkpoint
    ckpt_io.save_checkpoint = lambda *a, **k: (saves.append(1),
                                               real_save(*a, **k))
    rd.DetectorConfig = DetectorConfig.tiny
    r = rd.main(["--csv", csv, "--out", ckpt, "--device", "cpu", "--mesh",
                 "data=1,model=2"] + sys.argv[5:])
    res["d"] = {"history": r.history, "saves": len(saves),
                "best_epoch": r.best_epoch, "params": r.params}
    r = rd.train(csv, ckpt + "_f32", epochs=2, batch_size=8, max_len=16,
                 det_cfg=DetectorConfig.tiny(), precision="float32",
                 mesh_spec="data=1,model=2", device="cpu",
                 log=lambda *_: None)
    res["d32"] = {"history": r.history, "params": r.params}
else:
    mesh = M.make_mesh(MeshConfig(data=2, model=2))
    assert mesh.ranks.tolist() == [[0, 1], [2, 3]], mesh.ranks
    assert mesh.local_data == [rank // 2]
    assert mesh.column_ranks() == [rank % 2, rank % 2 + 2]
    res["c"] = run_steps(mesh, ["text_hot"])
torch.save(res, out)
M.shutdown_multihost()
print("WORKER_OK", rank)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(tmp, mode, n, csv):
    """``n`` workers of ``mode`` → (processes, their result files)."""
    worker = tmp / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    procs, outs = [], []
    for pid in range(n):
        env = dict(os.environ)
        for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID", "MISINFO_TPU_MULTIHOST", "MASTER_ADDR",
                  "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                  "MISINFO_TPU_NUM_CPU_DEVICES"):
            env.pop(k, None)
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(pid),
                   MISINFO_TPU_DIST_TIMEOUT_S="60", CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        outs.append(tmp / f"{mode}{pid}.pt")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), mode, str(outs[-1]), csv,
             str(tmp / "ckpt")] + CLI, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, outs


def _finish(procs, outs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a multi-process worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-3000:]}"
        assert "WORKER_OK" in log, log[-3000:]
        assert "backend gloo (CPU entries)" in log, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]


def _text_csv(path, n=40):
    rng = np.random.default_rng(0)
    words = ["claim", "report", "vaccine", "study", "official", "rumor",
             "source", "photo", "video", "election", "market", "storm"]
    pd.DataFrame([{"text": " ".join(rng.choice(words, int(rng.integers(
        3, 20)))), "label": int(rng.integers(0, 2))} for _ in range(n)]
    ).to_csv(path, index=False)
    return str(path)


# ------------------------------------------------------------- the steps

def _batch(kind):
    rng = np.random.default_rng(11)
    if kind == "packed":
        packer = StreamPacker(row_len=24, pad_id=TINY.roberta.pad_token_id,
                              n_rows=2, n_slots=8)
        for n, lab in ((7, 0), (5, 1), (9, 1), (4, 0), (11, 1), (6, 0)):
            seq = rng.integers(3, TINY.roberta.vocab_size, n).astype(
                np.int32)
            assert packer.add(seq, lab) is None
        packed, metas = packer.flush()
        labels = np.zeros(8, np.int32)
        valid = np.zeros(8, np.float32)
        labels[:len(metas)] = metas
        valid[:len(metas)] = 1.0
        return {"input_ids": packed.ids, "attention_mask": packed.mask,
                "position_ids": packed.position_ids,
                "segment_ids": packed.segment_ids,
                "cls_rows": packed.cls_rows, "cls_cols": packed.cls_cols,
                "labels": labels, "slot_valid": valid}
    labels = np.asarray([0, 1, 1, 0], np.int32)
    if kind in ("text", "text_hot"):
        ids = rng.integers(3, TINY.roberta.vocab_size, (B, 16)).astype(
            np.int32)
        mask = np.ones((B, 16), np.int32)
        for i, n in enumerate((16, 11, 9, 3)):
            mask[i, n:] = 0
            ids[i, n:] = TINY.roberta.pad_token_id
        return {"input_ids": ids, "attention_mask": mask, "labels": labels}
    s = TINY.clip.image_size
    imgs = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    if kind == "effnet":
        return {"images_u8": imgs, "labels": labels}
    ids = rng.integers(1, TINY.clip.vocab_size - 2, (B, 12)).astype(np.int32)
    mask = np.ones((B, 12), np.int32)
    for i, n in enumerate((12, 7, 5, 10)):
        ids[i, n - 1] = TINY.clip.eos_token_id
        mask[i, n:] = 0
    return {"input_ids": ids, "attention_mask": mask, "images_u8": imgs}


def _step(kind, tree):
    cfg = OptimConfig(warmup_fraction=0.0, total_steps=10, **RECIPES[kind])
    pol = Policy(PrecisionConfig(compute_dtype="float32", gelu_mode="erf"))
    text = ["roberta", "ai_head", "misinfo_head"]
    if kind == "clip":
        tx = make_optimizer(cfg, clip_trainable_mask(tree))
        return tx, t_steps.make_clip_step(tx, TINY, pol)
    if kind == "effnet":
        tx = make_optimizer(cfg, branch_mask(tree, ["efficientnet"]))
        return tx, t_steps.make_effnet_step(tx, pol)
    tx = make_optimizer(cfg, branch_mask(tree, text))
    if kind == "packed":
        return tx, t_steps.make_packed_text_head_step(tx, HOT, pol)
    return tx, t_steps.make_text_head_step(
        tx, HOT if kind == "text_hot" else COLD, pol)


def run_steps(mesh, kinds):
    """One step of each kind from the seeded tiny detector over ``mesh``
    (dropout live but in ``text``): per kind the metrics, the gathered
    tree and the generator's state after the step."""
    out = {}
    for kind in kinds:
        tree = detector_init(SEED, TINY)
        tx, step = _step(kind, tree)
        params = shard_train_params(mesh, tree)
        state = tx.init(params)
        gen = (None if kind == "text"
               else torch.Generator().manual_seed(3))
        params, state, m = step(params, state, t_mesh.place_train_batch(
            mesh, _batch(kind)), gen)
        out[kind] = {"metrics": {k: float(v) for k, v in m.items()},
                     "tree": params.gather(),
                     "gen": None if gen is None else gen.get_state()}
    return out


def _grid(data, kinds):
    """The same steps in this process over a data×model grid of ``cpu``
    entries, on one thread as the workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_steps(t_mesh.make_mesh(MeshConfig(data=data, model=2),
                                          devices=["cpu"] * (2 * data)),
                         kinds)
    finally:
        torch.set_num_threads(threads)


def _assert_ranks_equal_and_near(ranks, one, kind, band=1e-6):
    first = ranks[0]
    start = dict(leaves_with_paths(detector_init(SEED, TINY)))
    for other in ranks[1:]:
        assert first["metrics"] == other["metrics"], kind
        assert (first["gen"] is None) == (other["gen"] is None)
        if first["gen"] is not None:
            assert torch.equal(first["gen"], other["gen"]), kind
        for (p, x), (_, y) in zip(leaves_with_paths(first["tree"]),
                                  leaves_with_paths(other["tree"])):
            assert torch.equal(x, y), (kind, p)
    if first["gen"] is not None:
        assert torch.equal(first["gen"], one["gen"]), kind
    moved = 0
    for (p, x), (_, z) in zip(leaves_with_paths(first["tree"]),
                              leaves_with_paths(one["tree"])):
        assert x.shape == z.shape, (kind, p)
        assert float((x - z).abs().max()) <= band, (kind, p)
        moved += not torch.equal(x, start[p])
    assert moved, kind
    for k, v in one["metrics"].items():
        assert abs(first["metrics"][k] - v) <= band, (kind, k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pair (a, b, d) and the four (c), started together."""
    tmp = tmp_path_factory.mktemp("multihost_model")
    csv = _text_csv(tmp / "text.csv")
    pair = _start(tmp, "pair", 2, csv)
    quad = _start(tmp, "quad", 4, csv)
    return {"pair": _finish(*pair), "quad": _finish(*quad), "csv": csv,
            "tmp": tmp}


@pytest.fixture(scope="module")
def grid_one():
    return _grid(1, KINDS_A)


@pytest.mark.parametrize("kind", KINDS_A)
def test_model_group_across_two_processes_equals_one_process(runs, grid_one,
                                                             kind):
    r0, r1 = runs["pair"]
    _assert_ranks_equal_and_near([r0["a"][kind], r1["a"][kind]],
                                 grid_one[kind], kind)


def test_text_step_across_processes_equals_jax(runs):
    """The dropout-free text step over the two processes against JAX's
    single-device step on the same tree and batch, within 1e-5."""
    import jax
    import jax.numpy as jnp
    from misinfo_tpu.core.config import PrecisionConfig as JPrecision
    from misinfo_tpu.models.detector import DetectorConfig as JDetector
    from misinfo_tpu.ops.common import Policy as JPolicy
    from misinfo_tpu.train import optim as j_optim
    from misinfo_tpu.train import steps as j_steps
    jdet = dataclasses.replace(JDetector.tiny(), roberta=dataclasses.replace(
        JDetector.tiny().roberta, hidden_dropout=0.0))
    np_tree = jax.tree.map(lambda t: t.numpy(), detector_init(SEED, TINY))
    jp = jax.tree.map(jnp.array, np_tree)
    jtx = j_optim.make_optimizer(j_optim.OptimConfig(
        warmup_fraction=0.0, total_steps=10, **RECIPES["text"]),
        j_optim.branch_mask(np_tree, ["roberta", "ai_head", "misinfo_head"]))
    jstep = j_steps.make_text_head_step(jtx, jdet, JPolicy(JPrecision(
        compute_dtype="float32", gelu_mode="erf")))
    jp, _, jm = jstep(jp, jtx.init(jp), {k: jnp.asarray(v) for k, v in
                                        _batch("text").items()},
                      jax.random.PRNGKey(0))
    got = runs["pair"][0]["a"]["text"]
    for k in ("loss", "accuracy"):
        assert abs(float(jm[k]) - got["metrics"][k]) <= 1e-5, k
    j_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    t_pairs = leaves_with_paths(got["tree"])
    assert len(j_leaves) == len(t_pairs)
    for a, (p, t) in zip(j_leaves, t_pairs):
        assert float(np.max(np.abs(a - t.numpy()), initial=0.0)) <= 1e-5, p


@pytest.fixture(scope="module")
def grid_two():
    return _grid(2, ["text_hot"])


@pytest.mark.parametrize("case", ["b", "c"])
def test_data_and_model_axes_across_processes(runs, grid_two, case):
    """(b) data local and model across; (c) both axes across four
    processes: every rank equal, the one-process grid within 1e-6."""
    ranks = runs["pair"] if case == "b" else runs["quad"]
    _assert_ranks_equal_and_near([r[case]["text_hot"] for r in ranks],
                                 grid_two["text_hot"], case)


def test_roberta_cli_across_two_processes(runs, monkeypatch, tmp_path):
    """(d): the CLI's ``--mesh data=1,model=2`` over the two processes:
    rank 0 alone saves, both packages load the checkpoint, the ranks'
    trees ``torch.equal``, the history near the same CLI's over a
    one-process grid: the CLI trains in bf16 (its recipe), where the
    column-split inputs' gradient partials, summed in another order than
    autograd's in one process, round apart; phase 31 (a)'s bf16 band of
    1e-2 relative holds it (measured: 5.5e-4 absolute on losses near
    0.6). The same trainer in f32 (``train(precision="float32")``) keeps
    the history within 1e-5 and every leaf within 1e-6."""
    import jax
    from misinfo_tpu.checkpoints.io import load_checkpoint as j_load
    from misinfo_tpu_torch.checkpoints.io import load_checkpoint
    from misinfo_tpu_torch.train import roberta_detective as rd
    r0, r1 = (r["d"] for r in runs["pair"])
    assert r0["saves"] >= 1 and r1["saves"] == 0
    assert r0["history"] and r0["best_epoch"] == r1["best_epoch"]
    for run in ("d", "d32"):
        for (p, x), (_, y) in zip(
                leaves_with_paths(runs["pair"][0][run]["params"]),
                leaves_with_paths(runs["pair"][1][run]["params"])):
            assert torch.equal(x, y), (run, p)
    monkeypatch.setattr(t_mesh, "_platform", t_mesh._platform)
    monkeypatch.setattr(t_mesh, "_num_cpu_devices", t_mesh._num_cpu_devices)
    monkeypatch.setattr(rd, "DetectorConfig", DetectorConfig.tiny)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = rd.main(["--csv", runs["csv"], "--out", str(tmp_path / "one"),
                       "--device", "cpu", "--mesh", "data=1,model=2"] + CLI)
        one32 = rd.train(runs["csv"], str(tmp_path / "one32"), epochs=2,
                         batch_size=8, max_len=16, det_cfg=TINY,
                         precision="float32", mesh_spec="data=1,model=2",
                         device="cpu", log=lambda *_: None)
    finally:
        torch.set_num_threads(threads)
    for ref, got, band, rel in ((one, r0, 1e-2, True),
                                (one32, runs["pair"][0]["d32"], 1e-5,
                                 False)):
        assert len(ref.history) == len(got["history"])
        for a, b in zip(ref.history, got["history"]):
            for k, v in a.items():
                if k not in ("seconds", "epoch"):
                    assert abs(v - b[k]) <= band * (abs(v) if rel else 1), (
                        k, v, b[k])
    for (p, a), (_, b) in zip(leaves_with_paths(one32.params),
                              leaves_with_paths(
                                  runs["pair"][0]["d32"]["params"])):
        assert float((a - b).abs().max()) <= 1e-6, p
    like = detector_init(0, TINY)
    got = load_checkpoint(str(runs["tmp"] / "ckpt"), like)
    j_got = j_load(str(runs["tmp"] / "ckpt"),
                   jax.tree.map(lambda t: t.numpy(), like))
    assert got is not None and j_got is not None
    for (p, a), b in zip(leaves_with_paths(got),
                         jax.tree_util.tree_leaves(j_got)):
        assert np.array_equal(np.asarray(b), a.numpy()), p
    for (p, a), (_, b) in zip(leaves_with_paths(got),
                              leaves_with_paths(r0["params"])):
        assert torch.equal(a, b), p


def test_training_layouts_that_split_unevenly_are_refused():
    """A process on other model positions in another row, or blocks of
    unequal size, cannot pair its pieces over ``data``: a ValueError
    before any group opens."""
    for ranks in ([[0, 0], [0, 1]], [[0, 1], [1, 0]],
                  [[0, 0, 1], [2, 2, 3]]):
        n, m = len(ranks), len(ranks[0])
        mesh = t_mesh.Mesh([["cpu"] * m] * n, ranks=ranks)
        with pytest.raises(ValueError):
            mesh._layout()
    t_mesh.Mesh([["cpu"] * 2] * 2, ranks=[[0, 1], [2, 3]])._layout()
    t_mesh.Mesh([["cpu"] * 2] * 2, ranks=[[0, 1], [0, 1]])._layout()
    t_mesh.Mesh([["cpu"] * 4], ranks=[[0, 0, 1, 1]])._layout()
