"""Shared training harness: epoch loop, validation, early stopping and
best-checkpoint policy — the structure every reference trainer repeats.

Counterpart of ``misinfo_tpu/train/harness.py``; ``MedianPruner``,
``split_train_val`` and ``eval_batches`` are host code, copied (held to
the originals by tests/test_torch_host.py). ``run_training`` draws every
step's dropout masks from one ``torch.Generator`` seeded with ``seed`` on
the tree's device, reads each step's metrics (device tensors) once per
epoch, and keeps a copy of the best epoch's tree: the steps update the
tree in place.

Over a mesh (``train_mesh``) the tree is a ``TrainParams``: eval runs on
the first local replica, the best tree and the checkpoints are the
gathered plain tree and optimizer state, and in a run of several
processes process 0 writes the checkpoint while the others wait at a
barrier. Every process evaluates the same replica bits on the same
rows, so all of them take the same best epoch and stop together; where
a model group spans processes, eval and the gathers are collectives
over it, which every process of the group runs.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from misinfo_tpu_torch.core.mesh import (
    apply_device_override, init_multihost, place_train_batch, process_index,
    setup_train_mesh, shutdown_multihost)
from misinfo_tpu_torch.parallel.sharding import TrainParams
from misinfo_tpu_torch.train.steps import batch_to
from misinfo_tpu_torch.utils.tree import clone_tree, tree_device


@dataclass
class TrainResult:
    best_metric: float
    best_epoch: int
    history: list = field(default_factory=list)
    params: Optional[Dict] = None
    pruned: bool = False


class MedianPruner:
    """Native median-stopping rule — the reference's optuna
    ``MedianPruner`` semantics (train_clip_detective.py:427-454) without
    the optuna dependency: a running trial is pruned at epoch ``e`` when
    its best intermediate metric so far is strictly worse than the median
    of prior COMPLETED (non-pruned) trials' intermediate values reported
    at the same epoch — optuna's PercentilePruner filters
    ``TrialState.COMPLETE`` for the median. ``n_startup_trials``
    prior trials are required before any pruning and the first
    ``n_warmup_steps`` epochs of each trial are never pruned (optuna
    defaults 5 / 0). Optuna remains the optional backend in
    `hpo_search`; this rule makes pruning real when it is absent."""

    def __init__(self, mode: str = "max", n_startup_trials: int = 5,
                 n_warmup_steps: int = 0):
        assert mode in ("max", "min")
        self.mode = mode
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.trials: list = []          # per-trial {epoch: value}
        self._cur: Optional[Dict[int, float]] = None

    def start_trial(self) -> None:
        self._cur = {}

    def report(self, epoch: int, value: float) -> bool:
        """Record an intermediate value; True ⇒ the trial should be
        PRUNED now. As in optuna, the comparison value is the running
        trial's BEST intermediate result so far (PercentilePruner's
        _get_best_intermediate_result_over_steps), not just the current
        epoch's — a trial that once beat the median is never pruned by a
        later dip at that level."""
        assert self._cur is not None, "call start_trial() first"
        self._cur[epoch] = float(value)
        if epoch < self.n_warmup_steps:
            return False
        if len(self.trials) < self.n_startup_trials:
            return False
        prior = [t[epoch] for t in self.trials if epoch in t]
        if not prior:
            return False
        med = float(np.median(prior))
        vals = self._cur.values()
        best = max(vals) if self.mode == "max" else min(vals)
        return best < med if self.mode == "max" else best > med

    def complete_trial(self, pruned: bool = False) -> None:
        """Finish the running trial. A pruned trial's reports do NOT
        inform future medians or the startup count (optuna considers
        COMPLETE trials only)."""
        if self._cur is not None and not pruned:
            self.trials.append(self._cur)
        self._cur = None


def run_training(
    params,
    opt_state,
    step_fn: Callable,            # (params, opt_state, batch, gen) -> (p, o, metrics)
    train_batches: Callable[[], Iterable[Dict]],
    eval_fn: Optional[Callable] = None,   # (params) -> {metric: float}
    *,
    epochs: int,
    seed: int = 0,
    select_metric: str = "loss",
    select_mode: str = "min",             # 'min' (val loss) | 'max' (accuracy)
    early_stop_patience: Optional[int] = None,  # reference: 3 (C15)
    checkpoint_fn: Optional[Callable] = None,   # (params, opt_state, epoch, metrics)
    epoch_callback: Optional[Callable] = None,  # (epoch, metrics) -> bool; False = prune
    log: Callable[[str], None] = print,
) -> TrainResult:
    mesh = isinstance(params, TrainParams)
    gen = torch.Generator(params.devices[0] if mesh
                          else tree_device(params)).manual_seed(seed)
    best = np.inf if select_mode == "min" else -np.inf
    best_epoch = -1
    patience = 0
    history = []
    best_params = params
    pruned = False

    for epoch in range(epochs):
        t0 = time.perf_counter()
        n_batches = 0
        running: Dict[str, torch.Tensor] = {}
        for batch in train_batches():
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 gen)
            n_batches += 1
            for mk, mv in metrics.items():
                mv = torch.as_tensor(mv).double()
                running[mk] = running[mk] + mv if mk in running else mv
        train_metrics = {k: float(v) / max(1, n_batches)
                         for k, v in running.items()}

        eval_metrics = (eval_fn(params.rows[0] if mesh else params)
                        if eval_fn else {})
        all_metrics = {**{f"train_{k}": v for k, v in train_metrics.items()},
                       **{f"val_{k}": v for k, v in eval_metrics.items()}}
        all_metrics["epoch"] = epoch
        all_metrics["seconds"] = time.perf_counter() - t0
        history.append(all_metrics)
        log(f"epoch {epoch}: " + "  ".join(
            f"{k}={v:.4f}" for k, v in all_metrics.items()
            if isinstance(v, float)))

        current = eval_metrics.get(select_metric,
                                   train_metrics.get(select_metric))
        if current is None:
            current = train_metrics.get("loss", 0.0)
        if epoch_callback is not None and epoch_callback(epoch,
                                                         all_metrics) is False:
            log(f"trial pruned at epoch {epoch} (median-stopping rule)")
            pruned = True
            break
        improved = (current < best) if select_mode == "min" else (current > best)
        if improved:
            best, best_epoch, patience = current, epoch, 0
            best_params = params.gather() if mesh else clone_tree(params)
            if checkpoint_fn and mesh:
                state = opt_state.gather()       # collective, as gather()
                if process_index() == 0:
                    checkpoint_fn(best_params, state, epoch, all_metrics)
                params.axis.barrier()
            elif checkpoint_fn:
                checkpoint_fn(params, opt_state, epoch, all_metrics)
        else:
            patience += 1
            if early_stop_patience and patience >= early_stop_patience:
                log(f"early stop at epoch {epoch} "
                    f"(no improvement for {patience} epochs)")
                break

    return TrainResult(best_metric=float(best), best_epoch=best_epoch,
                       history=history, params=best_params, pruned=pruned)


def split_train_val(samples, val_fraction: float = 0.2, seed: int = 42):
    """80/20 split with the reference's canonical seed 42."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(samples))
    n_val = int(len(samples) * val_fraction)
    val_idx = set(idx[:n_val].tolist())
    train = [s for i, s in enumerate(samples) if i not in val_idx]
    val = [s for i, s in enumerate(samples) if i in val_idx]
    return train, val


def eval_batches(batches_fn, n_items: int, batch_size: int):
    """Validation batches with a sub-batch-split fallback, shared by every
    trainer: `batches_fn(size)` must yield full-size batches only (the
    batchers drop remainders to keep one eval jit signature). When the val
    split is smaller than one batch that would yield nothing and silently
    report 0.0 metrics — the reference's validate() always runs — so fall
    back to a single whole-split batch (one extra jit signature, and only
    on toy splits)."""
    n = 0
    for b in batches_fn(batch_size):
        n += 1
        yield b
    if n == 0 and n_items:
        yield from batches_fn(n_items)


# ------------------------------------------------ the trainers' preamble

def select_device(device: str = "auto",
                  mesh_spec: Optional[str] = None) -> torch.device:
    """A trainer's ``--device``: ``auto`` and ``cuda`` mean the card and
    raise where there is none (no silent fall back to the CPU); ``cpu``
    only when asked for. With ``--mesh`` it provisions the mesh's entries
    as JAX's mains do (``apply_device_override(device, mesh_spec)``:
    ``--device cpu --mesh data=8`` gives eight ``cpu`` entries)."""
    if device not in ("auto", "cuda", "cpu"):
        raise ValueError(f"--device {device!r}: expected auto, cuda or cpu")
    if mesh_spec:
        apply_device_override(device, mesh_spec)
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    return torch.device("cuda")


def train_mesh(mesh_spec: Optional[str], params, batch_size: int,
               device: torch.device):
    """``setup_train_mesh`` over entries of ``device``'s type (``cpu``
    entries for ``device="cpu"``, as ``--device cpu --mesh``); returns
    ``(mesh, params, device)`` with the first local position's device,
    or ``(None, params, device)`` unchanged without a spec."""
    if not mesh_spec:
        return None, params, device
    apply_device_override(torch.device(device).type, mesh_spec)
    mesh, params = setup_train_mesh(mesh_spec, params, batch_size)
    return mesh, params, params.devices[0]


def placer(mesh, device) -> Callable[[Dict], Dict]:
    """A host batch → the step's input: ``place_train_batch`` under a
    mesh, else tensors on ``device``."""
    if mesh is not None:
        return lambda b: place_train_batch(mesh, b)
    return lambda b: batch_to(b, device)


@contextlib.contextmanager
def multihost():
    """A trainer CLI's ``init_multihost()`` (a no-op without the
    ``JAX_*`` or ``MISINFO_TPU_MULTIHOST`` env hints); a group it opened
    is closed on the way out."""
    opened = init_multihost()
    try:
        yield
    finally:
        if opened:
            shutdown_multihost()


def own_params(params, det_cfg, device):
    """The trainer's own tree on ``device``: the port's seeded init, or a
    copy of the caller's (the steps update it in place, and a caller's
    tree is often a live engine's)."""
    if params is None:
        from misinfo_tpu_torch.models.detector import detector_init
        params = detector_init(0, det_cfg)
    return clone_tree(params, device)
