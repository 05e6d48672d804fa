"""Partitioning rules: how the detector maps onto a (data, model) mesh.

Counterpart of ``misinfo_tpu/parallel/sharding.py``, with JAX's rule and
names:

* **data axis**: the batch dimension of every request tensor; params
  replicate over it.
* **model axis**: Megatron-style tensor parallelism on the transformer
  towers: ``q``/``k``/``v``/``qkv`` and ``mlp_in`` kernels (and their
  biases) column-split, ``o`` and ``mlp_out`` row-split, so each
  attention/FFN pair needs one sum over the model group
  (parallel/tensor.py). int8 trees split ``kernel_q`` as ``kernel`` and
  ``w_scale`` as an output-dim bias.
* vault rows may split on ``data`` (vault/search.py).

``detector_pspecs`` gives JAX's specs, as tuples (core/mesh.py
``PartitionSpec``). ``shard_params`` places the tree: a
``ShardedParams`` whose ``grid[d][m]`` is grid position (d, m)'s slice,
on its device, and whose ``row(d)`` is the tree data position d runs,
with each split piece a ``ModelSplit`` over its model group. A fused
``qkv`` kernel [D, 3D] is split per third (position m takes its heads'
columns of q, of k and of v): the heads a column split must keep whole.

Training (``shard_train_params``) places a ``TrainParams``: a replica of
the tree for each of this process's data positions, every leaf a tensor
of its own (the optimizer updates them in place), the model axis split
as above; ``gather`` puts one replica back into the plain tree. Where a
data position's model group spans processes, each process holds its
positions' pieces and its own copy of every replicated leaf, and the
split pieces exchange through the row's ``ModelGroup``
(parallel/collectives.py); ``gather`` is then a collective over it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from misinfo_tpu_torch.core.mesh import Mesh, P, PartitionSpec, split_rows
from misinfo_tpu_torch.ops.serving import kmajor
from misinfo_tpu_torch.parallel.collectives import DataAxis, ModelGroup
from misinfo_tpu_torch.parallel.tensor import AMAX_PAD, ModelSplit


def _spec_for_path(keys: List[str], leaf) -> PartitionSpec:
    ndim = getattr(leaf, "ndim", 0)
    name = keys[-1] if keys else ""
    kernel_like = name in ("kernel", "kernel_q") and ndim == 2
    outvec_like = name in ("bias", "w_scale")
    if "attn" in keys:
        i = keys.index("attn") + 1
        which = keys[i] if i < len(keys) else ""
        if kernel_like:
            if which in ("q", "k", "v", "qkv"):
                return P(None, "model")
            if which == "o":
                return P("model", None)
        if outvec_like:
            if which in ("q", "k", "v", "qkv"):
                return P("model")
            return P()
    if kernel_like:
        if "mlp_in" in keys:
            return P(None, "model")
        if "mlp_out" in keys:
            return P("model", None)
    if outvec_like and "mlp_in" in keys:
        return P("model")
    # embeddings / norms / convs / heads: replicated
    return P()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


def detector_pspecs(params: Dict) -> Dict:
    """PartitionSpec tree mirroring the detector param tree."""
    return _map_with_path(_spec_for_path, params)


def _slice(x: torch.Tensor, spec: PartitionSpec, m: int, n: int,
           fused: bool) -> torch.Tensor:
    """Position m of n's piece of ``x`` under ``spec``; a fused qkv leaf
    (``fused``) is cut per third."""
    dim = next((i for i, a in enumerate(spec) if a == "model"), None)
    if dim is None or n == 1:
        return x
    if fused:
        thirds = torch.chunk(x, 3, dim=dim)
        return torch.cat([torch.chunk(t, n, dim=dim)[m] for t in thirds],
                         dim=dim)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {x.shape[dim]} does not split over "
                         f"model={n}")
    return torch.chunk(x, n, dim=dim)[m]


def _place(x, dev: torch.device, kmaj: bool):
    """``x`` on ``dev``, contiguous; an int8 kernel on the card K-major,
    as K2 reads it. A leaf already so laid out on ``dev`` is not copied,
    so positions that share a device share their whole leaves."""
    if not isinstance(x, torch.Tensor):
        return x
    y = x.to(dev)
    if kmaj and y.is_cuda:
        return y if y.t().is_contiguous() else kmajor(y)
    return y.contiguous()


class ShardedParams:
    """The detector tree placed on a mesh (``shard_params``)."""

    def __init__(self, mesh: Mesh, grid: List[List[Dict]], rows: List[Dict]):
        self.mesh = mesh
        self.grid = grid      # grid[d][m]: position (d, m)'s slice
        self._rows = rows

    def row(self, d: int) -> Dict:
        """The tree data position ``d`` runs."""
        return self._rows[d]

    def __getitem__(self, key):
        """The first data position's tree, for callers that read one
        sub-tree (``params["fusion"]``)."""
        return self._rows[0][key]


def _splits(tree, slices: List, devices: List[torch.device], path=(),
            group=None):
    """The first held position's tree with every split piece turned into
    a ``ModelSplit`` over the held positions' ``slices`` (one tree each;
    with ``group``, a ``ModelGroup``, this process's positions only)."""
    if isinstance(tree, dict):
        if path and str(path[-1]) == "attn" and "o" in tree:
            o = tree["o"]
            return ModelSplit(
                [{k: v for k, v in s.items()}
                 | {"o": {k: v for k, v in s["o"].items() if k != "bias"}}
                 for s in slices], devices, o.get("bias"), ("o", "bias"),
                group)
        if path and str(path[-1]) == "mlp_in":
            return ModelSplit(slices, devices, group=group)
        if path and str(path[-1]) == "mlp_out":
            return ModelSplit([{k: v for k, v in s.items() if k != "bias"}
                               for s in slices], devices, tree.get("bias"),
                              group=group)
        return {k: _splits(v, [s[k] for s in slices], devices,
                           path + (k,), group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_splits(v, [s[i] for s in slices], devices,
                                  path + (i,), group)
                          for i, v in enumerate(tree))
    return tree


def shard_params(mesh: Mesh, params: Dict) -> ShardedParams:
    """Place ``params`` on the mesh per ``detector_pspecs``: each grid
    position gets its slice (column-split ``q/k/v/qkv`` and ``mlp_in``
    kernels and biases, row-split ``o`` and ``mlp_out`` kernels, the rest
    whole), on its device. An int8 row-split kernel gets ``AMAX_PAD`` zero
    rows under its slice (parallel/tensor.py). A device named twice in the
    grid holds one copy of what its positions share."""
    mesh.require_local("shard_params")
    specs = detector_pspecs(params)
    n = mesh.model
    grid = []
    for d in range(mesh.data):
        row = []
        for m, dev in enumerate(mesh.row(d)):
            def piece(path, x, m=m, dev=dev):
                spec = _lookup(specs, path)
                y = _slice(x, spec, m, n, "qkv" in path)
                if (path[-1] == "kernel_q" and n > 1
                        and spec[:1] == ("model",)):
                    # an int8 row split: the abs-max columns' zero rows
                    # (parallel/tensor.py)
                    y = torch.cat([y, y.new_zeros(AMAX_PAD, y.shape[1])])
                return _place(y, dev, path[-1] == "kernel_q")
            row.append(_map_with_path(piece, params))
        grid.append(row)
    rows = [grid[d][0] if n == 1 else
            _splits(grid[d][0], grid[d], mesh.row(d))
            for d in range(mesh.data)]
    return ShardedParams(mesh, grid, rows)


def _lookup(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def batch_pspecs(batch: Dict) -> Dict:
    """Batch tensors shard on data; vault tensors replicate."""
    return {k: P() if k.startswith("vault")
            else P("data", *([None] * (v.ndim - 1)))
            for k, v in batch.items()}


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """Each batch tensor as a list of per-data-position pieces; a vault
    tensor as the same tensor on every data position's device."""
    specs = batch_pspecs(batch)
    return {k: (split_rows(v, mesh) if specs[k]
                else [v.to(dev) for dev in mesh.data_devices])
            for k, v in batch.items()}


# ---------------------------------------------------------------- training

class TrainParams:
    """The tree placed for training over a mesh (``shard_train_params``):
    ``rows[i]`` is the replica that this process's i-th data position
    (``mesh.local_data[i]``) runs, on its model group's devices, with
    each split piece a ``ModelSplit``; ``axis`` does the data axis's
    exchanges (parallel/collectives.py). Replicas end every step with
    the same bits."""

    def __init__(self, mesh: Mesh, rows: List[Dict],
                 groups: List[Optional[ModelGroup]]):
        self.mesh = mesh
        self.rows = rows
        self.groups = groups      # each replica's ModelGroup, or None
        self.axis = DataAxis(mesh)

    @property
    def devices(self) -> List[torch.device]:
        """Each local data position's first device."""
        return self.axis.devices

    def gather(self) -> Dict:
        """The plain tree from the first local replica: split leaves put
        back whole, every leaf a copy on the first position's device (a
        collective over the replica's model group where it spans
        processes: every process of the group calls it)."""
        return build_tree(merge_pieces(
            full_pieces(self.groups[0], replica_pieces(self.rows[0])),
            self.devices[0]))


def replica_pieces(tree, prefix=()) -> List[Tuple[tuple, int, object,
                                                  bool]]:
    """``replica_leaves`` with a flag on each piece of a split leaf (a
    row split's bias, held once, is a whole leaf)."""
    if isinstance(tree, ModelSplit):
        bias = prefix + tree.bias_path if tree.bias is not None else None
        return [(p, j, t, p != bias)
                for p, j, t in tree.leaves_with_paths(prefix)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in replica_pieces(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in replica_pieces(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, 0, tree, False)]


def replica_leaves(tree, prefix=()) -> List[Tuple[tuple, int, object]]:
    """``(path, j, leaf)`` for every leaf of a replica in the plain tree's
    flatten order (utils/tree.py), paths the plain tree's; ``j`` is the
    model position of a split piece (0 for a whole leaf). Where the
    model group spans processes, this process's pieces only."""
    return [(p, j, t) for p, j, t, _ in replica_pieces(tree, prefix)]


def full_pieces(group: Optional[ModelGroup], pieces):
    """``replica_pieces``-ordered pieces (any tensors in the leaves'
    places) → ``(path, j, tensor)`` with every model position's piece:
    as they are in one process, else all-gathered over ``group``."""
    if group is None:
        return [(p, j, t) for p, j, t, _ in pieces]
    return group.gather_pieces(pieces)


def merge_pieces(pieces, device) -> List[Tuple[tuple, object]]:
    """``replica_leaves``-ordered ``(path, j, tensor)`` → ``(path,
    tensor)`` with each split leaf's pieces put back along its
    ``detector_pspecs`` axis (a fused ``qkv`` per third), copies on
    ``device``."""
    out = []
    i = 0
    while i < len(pieces):
        path, _, x = pieces[i]
        group = [x]
        i += 1
        while i < len(pieces) and pieces[i][0] == path:
            group.append(pieces[i][2])
            i += 1
        if not isinstance(x, torch.Tensor):
            out.append((path, x))
            continue
        group = [g.detach().to(device, copy=True) for g in group]
        if len(group) == 1:
            out.append((path, group[0]))
            continue
        spec = _spec_for_path([str(k) for k in path], x)
        dim = spec.index("model")
        if "qkv" in path:
            thirds = [torch.chunk(g, 3, dim=dim) for g in group]
            whole = torch.cat([torch.cat([t[k] for t in thirds], dim=dim)
                               for k in range(3)], dim=dim)
        else:
            whole = torch.cat(group, dim=dim)
        out.append((path, whole))
    return out


def build_tree(pairs) -> Dict:
    """Nested dicts (lists where the keys are indices) from ``(path,
    leaf)`` pairs."""
    root: Dict = {}
    for path, leaf in pairs:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def listed(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [listed(node[k]) for k in sorted(node)]
        return {k: listed(v) for k, v in node.items()}
    return listed(root)


def shard_train_params(mesh: Mesh, params: Dict) -> TrainParams:
    """Place ``params`` for training over ``mesh``: for each of this
    process's data positions a replica of its own on the position's model
    group, the ``model`` axis split per ``detector_pspecs`` into leaf
    tensors that AdamW updates. A group in one process shares its first
    position's copy of each replicated leaf; where it spans processes,
    this process holds its positions' pieces and a copy of its own of
    every replicated leaf, on its first position's device. A collective
    over a mesh of several processes (``Mesh.process_groups``). Float
    trees only (training runs float policies; an int8 ``kernel_q`` is
    refused)."""
    specs = detector_pspecs(params)
    n = mesh.model
    mesh.process_groups()
    rows, groups = [], []
    for d in mesh.local_data:
        held = mesh.local_model(d)
        group = ModelGroup(mesh, d) if len(held) < n else None
        slices = []
        for m in held:
            def piece(path, x, m=m, dev=mesh.devices[d, m]):
                if not isinstance(x, torch.Tensor):
                    return x
                if path[-1] == "kernel_q":
                    raise ValueError("shard_train_params: an int8 tree "
                                     f"({'/'.join(path)}); training runs "
                                     "float trees")
                spec = _lookup(specs, path)
                if m != held[0] and "model" not in spec:
                    return x     # the first held position's copy serves
                return _slice(x, spec, m, n, "qkv" in path).detach().to(
                    dev, copy=True, memory_format=torch.contiguous_format)
            slices.append(_map_with_path(piece, params))
        rows.append(slices[0] if n == 1 else _splits(
            slices[0], slices, [mesh.devices[d, m] for m in held],
            group=group))
        groups.append(group)
    return TrainParams(mesh, rows, groups)
