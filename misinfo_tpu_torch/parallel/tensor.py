"""Tensor parallelism over a model group: the products GSPMD splits.

A layer piece served over the ``model`` axis of a mesh is a
``ModelSplit``: position j of the group holds ``parts[j]`` on
``devices[j]`` (parallel/sharding.py::shard_params makes them). The
column-split products (``q``/``k``/``v``/``qkv``, ``mlp_in``) need no
exchange: each position computes its heads or its intermediate columns
from the replicated input. The row-split products (``o``, ``mlp_out``)
give partial sums that ``row_dense`` adds up on the group's first
device, in position order, before the bias (added once) — what GSPMD's
all-reduce does in JAX. Partials stay f32 until the sum is done.

int8 rows (``kernel_q``): GSPMD quantizes a row-split product's input
per row over the WHOLE row. Each position therefore quantizes its slice
with the group's abs-max: its slice is handed to the int8 dense with one
more column that holds that abs-max, padded to ``AMAX_PAD`` columns, so
that the kernel K2 on the card, or the plain version on the CPU, derives
the group's scale while the extra columns add nothing: ``shard_params``
places each int8 row-split kernel with ``AMAX_PAD`` zero rows under it.

The float products are differentiable: training over a mesh
(parallel/sharding.py::shard_train_params) runs autograd through the
column and row splits, and AdamW updates each position's pieces. Where a
model group spans processes, a ``ModelSplit`` holds this process's
positions' parts only and its ``group`` (parallel/collectives.py::
``ModelGroup``) does the two exchanges: the row-split partials folded
in position order on every rank, and the column-split inputs' gradient
partials summed in position order. A group in one process keeps the
``.to()`` copies above.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops.common import (
    INT8_DENSE_MIN_ROWS, Policy, dense, matmul_f32)
from misinfo_tpu_torch.ops.quant import dense_int8
from misinfo_tpu_torch.ops.serving import dense_kernel_enabled
from misinfo_tpu_torch.utils.tree import leaves_with_paths

# the abs-max column is padded to this many columns (zero weight rows
# under all of them), so that the kernel's K keeps its alignment
AMAX_PAD = 64


class ModelSplit:
    """One layer piece split over a model group. ``parts[i]`` is the
    param dict of model position ``positions[i]`` on ``devices[i]``
    (every position of the group, or with ``group`` this process's
    only); ``bias`` is a row-split product's bias (on ``devices[0]``; with
    ``group`` each process's own copy), added once after the partial
    sums; None for a column split. ``len()`` is the group's size."""

    def __init__(self, parts: Sequence[Dict], devices: Sequence,
                 bias: Optional[torch.Tensor] = None,
                 bias_path: Tuple[str, ...] = ("bias",), group=None):
        self.parts = list(parts)
        self.devices = [torch.device(d) for d in devices]
        self.bias = bias
        self.bias_path = tuple(bias_path)   # where ``bias`` sits unsplit
        self.group = group
        self.positions = (list(range(len(self.parts))) if group is None
                          else group.positions)

    def __len__(self) -> int:
        return len(self.parts) if self.group is None else self.group.size

    def inputs(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A column split's replicated input for each held position, on
        its device: ``.to()`` copies in one process (autograd sums their
        gradients), else ``group.inputs``."""
        xs = [x] * len(self.parts) if self.group is None else \
            self.group.inputs(x)
        return [t.to(d) for t, d in zip(xs, self.devices)]

    def leaves_with_paths(self, prefix=()) -> List[Tuple[tuple, int,
                                                         torch.Tensor]]:
        """``(path, j, tensor)`` for every leaf, the paths the unsplit
        tree's (``prefix`` + the piece's), in its flatten order
        (utils/tree.py), position j's piece of a split leaf after j − 1's;
        the bias held once has j 0. With ``group``, this process's
        pieces only."""
        subs = [p for p, _ in leaves_with_paths(self.parts[0])]
        if self.bias is not None:
            subs.append(self.bias_path)
        out = []
        for sub in sorted(subs):
            if self.bias is not None and sub == self.bias_path:
                out.append((prefix + sub, 0, self.bias))
                continue
            for j, part in zip(self.positions, self.parts):
                t = part
                for k in sub:
                    t = t[k]
                out.append((prefix + sub, j, t))
        return out


def _int8_partial(p: Dict, x: torch.Tensor, amax: torch.Tensor,
                  policy: Policy) -> torch.Tensor:
    """This position's f32 partial of an int8 row-split product, its
    rows quantized with the group's abs-max ``amax`` [..., 1]; ``p``'s
    kernel carries the ``AMAX_PAD`` zero rows under its slice."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    col = amax.reshape(-1, 1).to(x.dtype)
    xa = torch.cat([x2, col, x2.new_zeros(x2.shape[0], AMAX_PAD - 1)], dim=1)
    if (x2.shape[0] >= INT8_DENSE_MIN_ROWS
            and dense_kernel_enabled(policy, x.device)):
        y = K2.int8_dense(xa, p["kernel_q"], p["w_scale"], None,
                          out_dtype=torch.float32)
    else:
        y = dense_int8(p, xa, torch.float32)
    return y.reshape(*lead, y.shape[-1])


def row_dense(split: ModelSplit, parts: List[Dict], xs: List[torch.Tensor],
              policy: Policy) -> torch.Tensor:
    """A row-split product: ``xs[i]`` (held position i's input columns)
    times ``parts[i]`` (its weight rows), the partials summed on the first
    position's device (across processes: ``split.group.fold``), then
    ``split.bias`` and one rounding to the compute dtype."""
    out_dev = xs[0].device
    if "kernel_q" in parts[0]:
        amax = None
        for x in xs:
            a = x.abs().amax(dim=-1, keepdim=True).to(out_dev)
            amax = a if amax is None else torch.maximum(amax, a)
        partials = [_int8_partial(p, x, amax.to(x.device), policy)
                    for p, x in zip(parts, xs)]
    else:
        partials = [matmul_f32(x.to(policy.compute),
                               p["kernel"].to(policy.compute))
                    for p, x in zip(parts, xs)]
    if split.group is not None:
        y = split.group.fold([p.to(out_dev) for p in partials])
    else:
        y = partials[0]
        for p in partials[1:]:
            y = y + p.to(out_dev)
    y = y.to(policy.accum)
    if split.bias is not None:
        y = y + split.bias.to(policy.accum)
    return y.to(policy.compute)


def tp_ffn(split_in: ModelSplit, split_out: ModelSplit, x: torch.Tensor,
           policy: Policy, act: Callable[[torch.Tensor], torch.Tensor]
           ) -> torch.Tensor:
    """``mlp_out(act(mlp_in(x)))`` over a model group: each position
    computes its intermediate columns from the replicated ``x``, then the
    row-split down product sums the partials. int8 pieces run the int8
    dense (K2 on the card) on both products: the kernel K1 fuses a
    per-chunk requantization of the intermediate that the split does not
    keep, and JAX serves a mesh through its plain int8 chain too."""
    hs = [act(dense(p, xi, policy))
          for p, xi in zip(split_in.parts, split_in.inputs(x))]
    return row_dense(split_out, split_out.parts, hs, policy)
