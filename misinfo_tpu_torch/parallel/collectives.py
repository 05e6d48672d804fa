"""The exchanges of training over a mesh: the data axis's, and the
model axis's where a model group spans processes.

JAX trains over a mesh as one program that GSPMD partitions: it sums the
gradients over ``data`` (a psum), gathers the CLIP embeddings for the
global [B, B] similarity matrix, reduces EfficientNet's BatchNorm
statistics over the global batch, and sums a row-split product's
partials over ``model``. Here each data position runs its own replica of
the tree on its rows (parallel/sharding.py::``shard_train_params``).
``DataAxis`` does the data axis's exchanges:

* ``gather(xs)``: the global rows of a per-row output, differentiable;
* ``sum(xs)``: a global sum, differentiable, back on every position;
* ``sum_grads``: the gradients summed over ``data``, the same bits on
  every replica;
* ``counted_once(t)``: a leaf read by the global loss, counted at data
  position 0 only.

Within one process the pieces go to the first position by ``.to()`` and
add up there in position order, as the serving mesh's gathers do. Across
processes (``init_multihost``) they go through ``torch.distributed``
within this process's model column (``Mesh.column_ranks``: the processes
that hold the same model positions, each for its own data positions; the
whole world when every process holds whole rows): an all-gather, then a
sum in data-position order, so that every rank ends with the same bits
(an all-reduce's order is the backend's own). The loss over the gathered
rows is computed on every rank, the same on each, so a gather's backward
keeps this rank's data positions' rows of the gradient (it does not sum
the ranks' copies, as ``torch.distributed.nn``'s all-gather would, which
would count the loss once per rank), and a leaf that the loss reads
itself (CLIP's ``logit_scale``) takes its gradient at data position 0
only, once in each model column. A sum's backward sums: each rank's rows
use the total.

A model group whose positions sit in several processes is a
``ModelGroup`` (Megatron's two exchanges, in a fixed order): each
process holds its own positions' pieces and its own copy of every
replicated leaf, and runs the unsplit parts of the step itself on the
same inputs. A row-split product's f32 partials are all-gathered and
folded left in model-position order, as ``row_dense`` does in one
process (its backward the identity); a column-split input's gradient
partials are all-gathered and summed in position order
(``ModelGroup.inputs``, its forward the identity). Every rank of the
group ends with the same bits.

Under ``gloo`` the exchanges stage CUDA tensors through host memory
(PyTorch documents gloo's CUDA support for broadcast and all-reduce
only; builds differ, and chip_smoke.py phase 31 (b) prints which
collectives the card's build takes); under ``nccl`` they never leave the
card.

``ONE`` is the step without a mesh: one position, no exchange.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from misinfo_tpu_torch.core.mesh import Mesh
from misinfo_tpu_torch.ops.common import RowShare


def _all_gather(x: torch.Tensor, group, world: int,
                staged: bool) -> List[torch.Tensor]:
    """Every member's ``x`` (equal shapes) in ``group``'s rank order, on
    x's device; through host memory when ``staged``."""
    import torch.distributed as dist
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(outs, src, group=group)
    return [o.to(x.device) for o in outs]


def _staged(group) -> bool:
    import torch.distributed as dist
    return dist.get_backend(group) == "gloo"


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
    positions (``mesh.local_data``), their first devices here, and the
    ``torch.distributed`` group of its model column when that spans
    processes."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.positions = mesh.local_data
        self.devices = [mesh.local_device(d) for d in self.positions]
        self.size = mesh.data
        self.holds_first = 0 in self.positions
        self.world, self.group, self.staged = 1, None, False
        if mesh.multiprocess:
            members = mesh.column_ranks()
            self.world = len(members)
        if self.world > 1:
            self.group = mesh.process_group(members)
            self.staged = _staged(self.group)
            held = [[d for d in range(self.size) if r in mesh.ranks[d]]
                    for r in members]
            # data position d's rows: (member, its block among the
            # member's positions); the members in their positions' order
            self.where = [next((i, ds.index(d)) for i, ds in enumerate(held)
                               if d in ds) for d in range(self.size)]
            self.order = sorted(range(self.world), key=lambda i: held[i])

    # -------------------------------------------------- across processes
    def _all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every column member's ``x`` (equal shapes), in rank order, on
        x's device."""
        return _all_gather(x, self.group, self.world, self.staged)

    def _ordered_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The members' ``x`` summed in their data positions' order."""
        parts = self._all_gather(x)
        tot = parts[self.order[0]]
        for i in self.order[1:]:
            tot = tot + parts[i]
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
        """Every process of the mesh waits for the others."""
        if self.mesh.multiprocess:
            import torch.distributed as dist
            dist.barrier()


class _GatherRows(torch.autograd.Function):
    """All-gather of this rank's rows within its model column, put in
    data-position order; the backward keeps this rank's positions' rows
    of the gradient (the loss past the gather is the same on every
    rank)."""

    @staticmethod
    def forward(ctx, x, axis: DataAxis):
        n = len(axis.positions)
        ctx.rows = x.shape[0] // n
        ctx.positions = axis.positions
        blocks = [torch.chunk(p, n) for p in axis._all_gather(x)]
        return torch.cat([blocks[i][j] for i, j in axis.where])

    @staticmethod
    def backward(ctx, g):
        m = ctx.rows
        return torch.cat([g[d * m:(d + 1) * m] for d in ctx.positions]), None


class _SumAcross(torch.autograd.Function):
    """Sum over the column's ranks in data-position order; the backward
    sums the ranks' gradients (each rank's rows use the total)."""

    @staticmethod
    def forward(ctx, x, axis: DataAxis):
        ctx.axis = axis
        return axis._ordered_sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._ordered_sum(g), None


class ModelGroup:
    """The model axis of data position ``d``'s row where its positions
    sit in several processes: this process's positions (``positions``),
    the row's size, and the ``torch.distributed`` group of the row's
    processes (``Mesh.process_groups``). Every exchange all-gathers and
    then folds or orders by model position, so that every rank of the
    group ends with the same bits."""

    def __init__(self, mesh: Mesh, d: int):
        row = mesh.ranks[d].tolist()
        members = mesh.row_ranks(d)
        self.size = len(row)
        self.positions = mesh.local_model(d)
        self.world = len(members)
        self.group = mesh.process_group(members)
        self.staged = _staged(self.group)
        held = [[j for j in range(self.size) if row[j] == r]
                for r in members]
        # model position j's piece: (member, its slot among the member's)
        self.where = [(members.index(row[j]), held[members.index(row[j])]
                       .index(j)) for j in range(self.size)]

    def by_position(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every position's tensor in position order, from this process's
        ``ts`` (one a local position, equal shapes; on ``ts[0]``'s
        device)."""
        dev = ts[0].device
        every = _all_gather(torch.stack([t.detach().to(dev) for t in ts]),
                            self.group, self.world, self.staged)
        return [every[i][k] for i, k in self.where]

    def fold(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The row-split product's sum: every position's partial, folded
        left in position order (``row_dense``'s fold); differentiable,
        the backward the identity."""
        return _FoldPositions.apply(self, *partials)

    def inputs(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` for each local position of a column split: the forward
        the identity, the backward the group's gradient partials summed
        in position order."""
        return list(_SplitInput.apply(self, x))

    def gather_pieces(self, pieces):
        """``(path, j, tensor, split)`` for this process's leaves of a
        replica, in ``replica_leaves`` order with its pieces of split
        leaves flagged → ``(path, j, tensor)`` with every position's
        piece of each split leaf in position order, the other processes'
        all-gathered (their pieces share this process's layout). A
        collective over the group."""
        by_dtype = {}
        for i, (_, _, t, split) in enumerate(pieces):
            if split:
                by_dtype.setdefault(t.dtype, []).append(i)
        got = {}
        for idx in by_dtype.values():
            ts = [pieces[i][2] for i in idx]
            buf = torch.cat([t.reshape(-1).to(ts[0].device) for t in ts])
            every = _all_gather(buf, self.group, self.world, self.staged)
            for m, flat in enumerate(every):
                for i, part in zip(idx, torch.split(
                        flat, [t.numel() for t in ts])):
                    got[i, m] = part.view_as(pieces[i][2])
        out = []
        for i, (path, j, t, split) in enumerate(pieces):
            if not split:
                out.append((path, j, t))
            elif j == self.positions[0]:     # the path's first local piece
                out += [(path, jj, got[i + k, m])
                        for jj, (m, k) in enumerate(self.where)]
        return out


class _FoldPositions(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mg: ModelGroup, *partials):
        ctx.k = len(partials)
        every = mg.by_position(partials)
        y = every[0]
        for p in every[1:]:
            y = y + p
        return y

    @staticmethod
    def backward(ctx, g):
        return (None,) + (g,) * ctx.k


class _SplitInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mg: ModelGroup, x):
        ctx.mg = mg
        return tuple(x.view_as(x) for _ in mg.positions)

    @staticmethod
    def backward(ctx, *gs):          # unused outputs' come as zeros
        every = ctx.mg.by_position(gs)
        tot = every[0]
        for g in every[1:]:
            tot = tot + g
        return None, tot
