"""The data axis's exchanges for training over a mesh.

JAX trains over a mesh as one program that GSPMD partitions: it sums the
gradients over ``data`` (a psum), gathers the CLIP embeddings for the
global [B, B] similarity matrix and reduces EfficientNet's BatchNorm
statistics over the global batch. Here each data position runs its own
replica of the tree on its rows (parallel/sharding.py::
``shard_train_params``) and ``DataAxis`` does those exchanges:

* ``gather(xs)``: the global rows of a per-row output, differentiable;
* ``sum(xs)``: a global sum, differentiable, back on every position;
* ``sum_grads``: the gradients summed over ``data``, the same bits on
  every replica;
* ``counted_once(t)``: a leaf read by the global loss, counted at data
  position 0 only.

Within one process the pieces go to the first position by ``.to()`` and
add up there in position order, as the serving mesh's gathers do. Across
processes (``init_multihost``) they go through ``torch.distributed``: an
all-gather, then a sum in rank order, so that every rank ends with the
same bits (an all-reduce's order is the backend's own). The loss over
the gathered rows is computed on every rank, the same on each, so a
gather's backward keeps this rank's rows of the gradient (it does not
sum the ranks' copies, as ``torch.distributed.nn``'s all-gather would,
which would count the loss once per rank), and a leaf that the loss
reads itself (CLIP's ``logit_scale``) takes its gradient on the rank
holding position 0 only. A sum's backward sums: each rank's rows use the
total. Under ``gloo`` the exchanges stage CUDA tensors through host
memory (PyTorch documents gloo's CUDA support for broadcast and
all-reduce only; builds differ, and chip_smoke.py phase 31 (b) prints which
collectives the card's build takes); under ``nccl`` they never leave the
card.

``ONE`` is the step without a mesh: one position, no exchange.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from misinfo_tpu_torch.core.mesh import Mesh, process_count, process_index
from misinfo_tpu_torch.ops.common import RowShare


class OneDevice:
    """The exchanges of a step on one device: nothing to exchange."""

    size = 1
    holds_first = True

    def gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def sum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return list(xs)

    def counted_once(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def sum_grads(self, grads, leaves):
        return grads

    def generators(self, gen):
        return [gen]

    def advance(self, gen, gens) -> None:
        pass

    def fresh(self, i: int, device) -> torch.Generator:
        return torch.Generator(device)

    def barrier(self) -> None:
        pass


ONE = OneDevice()


class DataAxis(OneDevice):
    """The data axis of a training mesh as this process sees it: its data
    positions (``mesh.local_data``), their first devices, and the
    ``torch.distributed`` group when the mesh spans processes."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.positions = mesh.local_data
        self.devices = [mesh.devices[d, 0] for d in self.positions]
        self.size = mesh.data
        self.world = process_count() if mesh.multiprocess else 1
        self.rank = process_index()
        self.holds_first = 0 in self.positions
        self.staged = False
        if self.world > 1:
            import torch.distributed as dist
            self.staged = dist.get_backend() == "gloo"

    # -------------------------------------------------- across processes
    def _all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (equal shapes), in rank order, on x's
        device."""
        import torch.distributed as dist
        src = x.detach().contiguous()
        if self.staged:
            src = src.cpu()
        outs = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(outs, src)
        return [o.to(x.device) for o in outs]

    def _ordered_sum(self, x: torch.Tensor) -> torch.Tensor:
        parts = self._all_gather(x)
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        return tot

    # ------------------------------------------------------- exchanges
    def gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global rows, in position order, on the first local
        position's device."""
        dev = self.devices[0]
        local = (xs[0] if len(xs) == 1
                 else torch.cat([x.to(dev) for x in xs]))
        if self.world == 1:
            return local
        return _GatherRows.apply(local, self)

    def sum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over every data position of ``xs`` (one a local
        position), on each local position's device."""
        tot = xs[0]
        for x in xs[1:]:
            tot = tot + x.to(tot.device)
        if self.world > 1:
            tot = _SumAcross.apply(tot, self)
        return [tot.to(dev) for dev in self.devices]

    def counted_once(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.holds_first else t.detach()

    @torch.no_grad()
    def sum_grads(self, grads: List[List[Optional[torch.Tensor]]],
                  leaves: List[List[torch.Tensor]]
                  ) -> List[List[torch.Tensor]]:
        """``grads[r][i]`` (local replica r's gradient of its leaf i, None
        where the leaf took none) summed over every data position, a copy
        for each local replica on its leaf's device."""
        total = []
        for i, leaf in enumerate(leaves[0]):
            acc = None
            for g in grads:
                if g[i] is not None:
                    acc = g[i] if acc is None else acc + g[i].to(acc.device)
            total.append(torch.zeros_like(leaf) if acc is None
                         else acc.to(leaf.device))
        if self.world > 1:
            total = self._sum_flat(total)
        return [[t.to(leaf.device) for t, leaf in zip(total, ls)]
                for ls in leaves]

    def _sum_flat(self, ts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each of ``ts`` summed over the ranks, through one buffer per
        dtype and device."""
        out = list(ts)
        groups = {}
        for i, t in enumerate(ts):
            groups.setdefault((t.dtype, t.device), []).append(i)
        for idx in groups.values():
            flat = self._ordered_sum(torch.cat([ts[i].reshape(-1)
                                                for i in idx]))
            for i, piece in zip(idx, torch.split(
                    flat, [ts[i].numel() for i in idx])):
                out[i] = piece.view_as(ts[i])
        return out

    # ------------------------------------------------------ generators
    def generators(self, gen: Optional[torch.Generator]) -> list:
        """Each local position's dropout generator: a copy of ``gen``'s
        state on the position's device that draws each mask over the
        global batch and keeps the position's rows (ops/common.py::
        ``RowShare``), so that a mesh step draws the single-device step's
        masks."""
        if gen is None:
            return [None] * len(self.devices)
        state = gen.get_state()
        out = []
        for d, dev in zip(self.positions, self.devices):
            g = torch.Generator(dev)
            g.set_state(state)
            out.append(RowShare(g, d, self.size))
        return out

    def advance(self, gen, gens) -> None:
        """Leave ``gen`` where the single-device step would."""
        if gen is not None:
            gen.set_state(gens[0].gen.get_state())

    def fresh(self, i: int, device) -> RowShare:
        """A fresh default generator's share for local position ``i``."""
        return RowShare(torch.Generator(device), self.positions[i],
                        self.size)

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()


class _GatherRows(torch.autograd.Function):
    """All-gather of this rank's rows; the backward keeps this rank's
    rows of the gradient (the loss past the gather is the same on every
    rank)."""

    @staticmethod
    def forward(ctx, x, axis: DataAxis):
        ctx.rows = (axis.rank * x.shape[0], (axis.rank + 1) * x.shape[0])
        return torch.cat(axis._all_gather(x))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        return g[a:b], None


class _SumAcross(torch.autograd.Function):
    """Sum over the ranks in rank order; the backward sums the ranks'
    gradients (each rank's rows use the total)."""

    @staticmethod
    def forward(ctx, x, axis: DataAxis):
        ctx.axis = axis
        return axis._ordered_sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._ordered_sum(g), None
