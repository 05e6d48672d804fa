"""The port's multi-process runtime (core/mesh.py::init_multihost,
parallel/collectives.py) in two real ``gloo`` processes on the CPU.

Each worker imports only the port (no JAX): it opens the group through
``init_multihost``'s ``JAX_*`` env path (or ``MISINFO_TPU_MULTIHOST=1``
and torch's ``env://``), builds ``make_mesh()`` over both processes'
entries (data=2), and writes what it computed to a file that this
process reads:

- the data-parallel step of tests/test_multihost.py (a linear model's
  mean squared error over a global batch of 8 rows, 4 a process):
  loss and gradient equal to full-batch numpy (JAX's rtol 1e-5 / 1e-4);
- one CLIP step and one EfficientNet step (dropout live) of the tiny
  detector: equal to the one-process data=2 run within 1e-6, and the two
  ranks' trees ``torch.equal``.

Every worker has its own timeout, and the rendezvous its own
(``MISINFO_TPU_DIST_TIMEOUT_S``), so a hang fails one test.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from misinfo_tpu_torch.core import mesh as t_mesh
from misinfo_tpu_torch.core.config import MeshConfig, PrecisionConfig
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy
from misinfo_tpu_torch.parallel.sharding import shard_train_params
from misinfo_tpu_torch.train.clip_detective import clip_trainable_mask
from misinfo_tpu_torch.train.optim import (
    OptimConfig, branch_mask, make_optimizer)
from misinfo_tpu_torch.train.steps import make_clip_step, make_effnet_step
from misinfo_tpu_torch.utils.tree import leaves_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = DetectorConfig.tiny()
B = 4

WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from misinfo_tpu_torch.core import mesh as M
from misinfo_tpu_torch.core.config import MeshConfig

mode, out = sys.argv[1], sys.argv[2]
M.apply_device_override("cpu")
assert M.init_multihost() is True, "the env path did not open a group"
assert M.init_multihost() is False            # already open
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = M.make_mesh(MeshConfig())              # data=2 across processes
assert mesh.shape == {"data": 2, "model": 1} and mesh.multiprocess
rank = dist.get_rank()
assert mesh.local_data == [rank]
res = {"rank": rank}

if mode == "steps":
    from misinfo_tpu_torch.parallel.collectives import DataAxis
    # tests/test_multihost.py's data-parallel step
    rng = np.random.default_rng(0)
    Xg = rng.normal(size=(8, 4)).astype(np.float32)
    yg = rng.normal(size=(8,)).astype(np.float32)
    local = M.place_train_batch(mesh, {"x": Xg, "y": yg})
    w = torch.tensor(np.linspace(-1, 1, 4), dtype=torch.float32,
                     requires_grad=True)
    axis = DataAxis(mesh)
    r = axis.gather([local["x"][0] @ w - local["y"][0]])
    loss = torch.mean(r ** 2)
    g, = torch.autograd.grad(loss, [w])
    (g,), = axis.sum_grads([[g]], [[w]])
    res["dp"] = (float(loss), g.numpy())
    from tests.test_torch_multihost import run_steps
    res["steps"] = run_steps(mesh)
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


def _run_pair(tmp_path, mode, env_path=False):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        env = dict(os.environ)
        for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID", "MISINFO_TPU_MULTIHOST", "MASTER_ADDR",
                  "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            env.pop(k, None)
        if env_path:
            env.update(MISINFO_TPU_MULTIHOST="1", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(pid))
        else:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        env.update(MISINFO_TPU_DIST_TIMEOUT_S="60", CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = tmp_path / f"rank{pid}.pt"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), mode, str(out)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
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


def _batch(kind):
    rng = np.random.default_rng(11)
    s = DET.clip.image_size
    imgs = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    if kind == "effnet":
        return {"images_u8": imgs, "labels": np.asarray([0, 1, 1, 0],
                                                        np.int32)}
    ids = rng.integers(1, DET.clip.vocab_size - 2, (B, 12)).astype(np.int32)
    ids[:, -1] = DET.clip.eos_token_id
    return {"input_ids": ids, "attention_mask": np.ones((B, 12), np.int32),
            "images_u8": imgs}


def run_steps(mesh):
    """One CLIP and one EfficientNet step (dropout live) of the seeded tiny
    detector over ``mesh``: per kind the metrics, the gathered tree and
    the generator's state after the step."""
    pol = Policy(PrecisionConfig.highest())
    out = {}
    for kind in ("clip", "effnet"):
        tree = detector_init(5, DET)
        if kind == "clip":
            tx = make_optimizer(OptimConfig(
                lr=1e-4, weight_decay=0.01, warmup_fraction=0.0,
                total_steps=10, clip_norm=1.0), clip_trainable_mask(tree))
            step = make_clip_step(tx, DET, pol)
        else:
            tx = make_optimizer(OptimConfig(
                lr=1e-4, weight_decay=0.0, warmup_fraction=0.0,
                total_steps=10, clip_norm=None, schedule="constant",
                eps=1e-2), branch_mask(tree, ["efficientnet"]))
            step = make_effnet_step(tx, pol)
        params = shard_train_params(mesh, tree)
        state = tx.init(params)
        gen = torch.Generator().manual_seed(3)
        params, state, m = step(params, state, t_mesh.place_train_batch(
            mesh, _batch(kind)), gen)
        out[kind] = {"metrics": {k: float(v) for k, v in m.items()},
                     "tree": params.gather(), "gen": gen.get_state()}
    return out


def test_two_process_steps_equal_one_process_and_full_batch(tmp_path):
    r0, r1 = _run_pair(tmp_path, "steps")
    # the DP step against full-batch numpy, on both ranks
    rng = np.random.default_rng(0)
    Xg = rng.normal(size=(8, 4)).astype(np.float32)
    yg = rng.normal(size=(8,)).astype(np.float32)
    w = np.linspace(-1, 1, 4).astype(np.float32)
    resid = Xg @ w - yg
    for r in (r0, r1):
        loss, g = r["dp"]
        np.testing.assert_allclose(loss, float(np.mean(resid ** 2)),
                                   rtol=1e-5)
        np.testing.assert_allclose(g, 2.0 * Xg.T @ resid / len(yg),
                                   rtol=1e-4)
    assert r0["dp"][0] == r1["dp"][0]
    assert np.array_equal(r0["dp"][1], r1["dp"][1])
    # the CLIP and EfficientNet steps: ranks bit for bit, and the
    # one-process data=2 run within 1e-6
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run_steps(t_mesh.make_mesh(MeshConfig(data=2),
                                         devices=["cpu"] * 2))
    finally:
        torch.set_num_threads(threads)
    for kind in ("clip", "effnet"):
        a, b, c = r0["steps"][kind], r1["steps"][kind], one[kind]
        assert a["metrics"] == b["metrics"], kind
        assert torch.equal(a["gen"], b["gen"]) and torch.equal(a["gen"],
                                                               c["gen"])
        start = dict(leaves_with_paths(detector_init(5, DET)))
        moved = 0
        for (p, x), (_, y), (_, z) in zip(leaves_with_paths(a["tree"]),
                                          leaves_with_paths(b["tree"]),
                                          leaves_with_paths(c["tree"])):
            assert torch.equal(x, y), (kind, p)
            assert float((x - z).abs().max()) <= 1e-6, (kind, p)
            moved += not torch.equal(x, start[p])
        assert moved, kind
        for k, v in c["metrics"].items():
            assert abs(a["metrics"][k] - v) <= 1e-6, (kind, k)


def test_env_rendezvous_opens_the_group(tmp_path):
    """``MISINFO_TPU_MULTIHOST=1`` takes torch's ``env://`` rendezvous."""
    r0, r1 = _run_pair(tmp_path, "init", env_path=True)
    assert (r0["rank"], r1["rank"]) == (0, 1)


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(t_mesh, "_platform", "cpu")
    assert t_mesh.dist_backend(2)[0] == "gloo"
    monkeypatch.setattr(t_mesh, "_platform", "auto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert t_mesh.dist_backend(2) == ("gloo", "2 local ranks share 1 "
                                      "card(s)")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert t_mesh.dist_backend(4)[0] == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert t_mesh.dist_backend(16)[0] == "gloo"
