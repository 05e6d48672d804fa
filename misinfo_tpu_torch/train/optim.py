"""The trainers' optimizer: AdamW with a schedule, global-norm clipping
and per-branch freeze masks.

Counterpart of ``misinfo_tpu/train/optim.py``, which builds the chain
with optax: ``masked(set_to_zero, frozen)`` then ``masked(clip ∘ adamw,
trainable)``. This module runs the same arithmetic over the trainable
leaves of a tree, in place, in optax's order:

1. the global norm over the trainable gradients only; at or above
   ``clip_norm`` each gradient becomes ``(g / ‖g‖) · clip_norm``;
2. Adam's moments ``m = (1−b1)·g + b1·m``, ``v = (1−b2)·g² + b2·v``, both
   bias-corrected at the incremented count before ``√v̂ + eps``;
3. the decoupled weight decay ``+ wd · p``;
4. times the learning rate scheduled at the count *before* the
   increment (with warmup the first update uses lr 0).

Frozen leaves get no update and no weight decay: the optimizer never
touches them. ``make_optimizer`` returns the transformation (``init``
gives the state over a tree); the state's ``step(grads)`` applies one
update, ``state_dict()``/``load_state_dict()`` carry it across a
checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from misinfo_tpu_torch.utils.tree import leaves_with_paths, tree_map


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-5
    weight_decay: float = 0.01
    warmup_fraction: float = 0.1      # reference train_roberta_detective.py (10% warmup)
    total_steps: int = 1000
    clip_norm: Optional[float] = 1.0  # reference grad-clip 1.0
    schedule: str = "cosine"          # 'cosine' | 'constant'
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


_F32 = np.float32


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c
                                              / _F32(decay_steps)))
        return float(_F32(init) * ((_F32(1) - _F32(alpha)) * decay
                                   + _F32(alpha)))
    return schedule


def _linear(init: float, end: float, steps: int):
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return float((_F32(init) - _F32(end)) * frac + _F32(end))
    return schedule


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """count → learning rate: optax's ``constant``,
    ``warmup_cosine_decay_schedule(0, lr, warmup, total)`` or
    ``cosine_decay_schedule(lr, total)``, evaluated in f32 as optax
    evaluates them (near the cosine's end, 1 + cos loses digits: f64
    arithmetic would drift from optax's values by up to 1e-5 relative)."""
    if cfg.schedule == "constant":
        return lambda count: cfg.lr
    warmup = max(0, int(cfg.total_steps * cfg.warmup_fraction))
    if warmup > 0:
        ramp = _linear(0.0, cfg.lr, warmup)
        decay = _cosine(cfg.lr, cfg.total_steps - warmup)
        return lambda count: (ramp(count) if count < warmup
                              else decay(count - warmup))
    return _cosine(cfg.lr, cfg.total_steps)


class OptState:
    """AdamW state over a tree's trainable leaves: the leaves themselves
    (updated in place), their paths, the moments and the step count."""

    def __init__(self, tx: "Optimizer", params, pairs=None):
        self.tx = tx
        mask = (None if tx.trainable_mask is None
                else dict(leaves_with_paths(tx.trainable_mask)))
        if pairs is None:
            pairs = leaves_with_paths(params)
        pairs = [(p, t) for p, t in pairs
                 if isinstance(t, torch.Tensor) and (mask is None or mask[p])]
        self.paths: List[tuple] = [p for p, _ in pairs]
        self.leaves: List[torch.Tensor] = [t for _, t in pairs]
        for t in self.leaves:
            if not t.is_floating_point():
                raise TypeError(f"trainable leaf {t.dtype} is not a float")
        self.m = [torch.zeros_like(t) for t in self.leaves]
        self.v = [torch.zeros_like(t) for t in self.leaves]
        self.count = 0
        # over a model group across processes (MeshOptState): the group,
        # and each leaf's (model position, whether it is a split piece)
        self.group = None
        self.pieces: List[tuple] = []

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        self.tx.update(grads, self)

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "paths": [list(p) for p in self.paths],
                "m": [t.detach().cpu() for t in self.m],
                "v": [t.detach().cpu() for t in self.v]}

    def load_state_dict(self, state: Dict) -> None:
        paths = [tuple(p) for p in state["paths"]]
        if paths != self.paths:
            raise ValueError("optimizer state is over other leaves than "
                             "this tree's trainable ones")
        for dst, src in zip(self.m + self.v, state["m"] + state["v"]):
            dst.copy_(src)
        self.count = int(state["count"])


class MeshOptState:
    """AdamW state over a tree placed for training on a mesh
    (parallel/sharding.py::``TrainParams``): one ``OptState`` a local
    replica, over its leaves with split pieces apart (a piece's path is
    its unsplit leaf's, for the mask). The gradients reach every replica
    summed over ``data`` (train/steps.py), so each replica's clip sees
    the global norm and every replica ends the step with the same bits.
    Where a replica's model group spans processes, its state holds this
    process's pieces, and the clip's norm and ``gather`` are collectives
    over the group. ``gather()`` is the state over the plain tree (a
    checkpoint's)."""

    def __init__(self, tx: "Optimizer", params):
        from misinfo_tpu_torch.parallel.sharding import replica_pieces
        self.tx = tx
        self.params = params
        self.states = []
        for row, group in zip(params.rows, params.groups):
            pieces = replica_pieces(row)
            st = OptState(tx, row, [(p, t) for p, _, t, _ in pieces])
            if group is not None:
                where = {id(t): (j, split) for _, j, t, split in pieces}
                st.group = group
                st.pieces = [where[id(t)] for t in st.leaves]
            self.states.append(st)

    def gather(self) -> OptState:
        """The first replica's state over the plain tree: split leaves'
        moments put back whole, on the first position's device (every
        process of a model group across processes calls it)."""
        from misinfo_tpu_torch.parallel.sharding import (
            full_pieces, merge_pieces)
        s0 = self.states[0]
        dev = self.params.devices[0]
        flags = s0.pieces or [(0, False)] * len(s0.paths)

        def merged(ts):
            return merge_pieces(full_pieces(s0.group, [
                (p, j, t, split)
                for p, t, (j, split) in zip(s0.paths, ts, flags)]), dev)
        st = OptState.__new__(OptState)
        st.tx = self.tx
        pairs = merged(s0.leaves)
        st.paths = [p for p, _ in pairs]
        st.leaves = [t for _, t in pairs]
        st.m = [t for _, t in merged(s0.m)]
        st.v = [t for _, t in merged(s0.v)]
        st.count = s0.count
        return st

    def state_dict(self) -> Dict:
        return self.gather().state_dict()


class Optimizer:
    """The transformation: ``init(params)`` → ``OptState`` (a
    ``MeshOptState`` for a tree placed on a mesh); ``update(grads,
    state)`` applies one step in place."""

    def __init__(self, cfg: OptimConfig, trainable_mask=None):
        self.cfg = cfg
        self.trainable_mask = trainable_mask
        self.schedule = make_schedule(cfg)

    def init(self, params):
        from misinfo_tpu_torch.parallel.sharding import TrainParams
        if isinstance(params, TrainParams):
            return MeshOptState(self, params)
        return OptState(self, params)

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]],
               state: OptState) -> None:
        cfg = self.cfg
        leaves = state.leaves
        if not leaves:
            state.count += 1
            return
        g = [torch.zeros_like(p) if gi is None else gi.to(p.dtype)
             for gi, p in zip(grads, leaves)]
        if cfg.clip_norm:
            norms = torch._foreach_norm(g)
            if state.group is not None:
                # every position's piece norms, in the one-process order
                norms = [t for _, _, t in state.group.gather_pieces([
                    (p, j, n, split) for p, n, (j, split)
                    in zip(state.paths, norms, state.pieces)])]
            norm = torch.linalg.vector_norm(torch.stack(norms))
            under = norm < cfg.clip_norm
            one = torch.ones_like(norm)
            denom = torch.where(under, one, norm)
            mult = torch.where(under, one, torch.full_like(norm,
                                                           cfg.clip_norm))
            g = torch._foreach_div(g, denom)
            torch._foreach_mul_(g, mult)
        lr = self.schedule(state.count)
        state.count += 1
        b1, b2 = cfg.b1, cfg.b2
        torch._foreach_mul_(state.m, b1)
        torch._foreach_add_(state.m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(state.v, b2)
        torch._foreach_add_(state.v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** state.count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** state.count
        m_hat = torch._foreach_div(state.m, c1.item())
        v_hat = torch._foreach_div(state.v, c2.item())
        denom = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(denom, cfg.eps)
        u = torch._foreach_div(m_hat, denom)
        if cfg.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(leaves,
                                                      cfg.weight_decay))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(leaves, u)


def make_optimizer(cfg: OptimConfig, trainable_mask=None) -> Optimizer:
    """``trainable_mask``: a tree of bools (True = train) matching the
    params; frozen leaves are never updated — the reference's
    ``requires_grad=False``."""
    return Optimizer(cfg, trainable_mask)


def branch_mask(params, trainable_branches: Sequence[str]):
    """Mask tree: True for leaves under any of ``trainable_branches``
    (top-level detector branch names)."""
    return {k: tree_map(lambda _, k=k: k in trainable_branches, v)
            for k, v in params.items()}
