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
"""

from __future__ import annotations

from typing import Dict, List

import torch

from misinfo_tpu_torch.core.mesh import Mesh, P, PartitionSpec, split_rows
from misinfo_tpu_torch.ops.serving import kmajor
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


def _splits(tree, slices: List, devices: List[torch.device], path=()):
    """Position 0's tree with every split piece turned into a
    ``ModelSplit`` over the group's ``slices`` (one tree per position)."""
    if isinstance(tree, dict):
        if path and str(path[-1]) == "attn" and "o" in tree:
            o = tree["o"]
            return ModelSplit(
                [{k: v for k, v in s.items()}
                 | {"o": {k: v for k, v in s["o"].items() if k != "bias"}}
                 for s in slices], devices, o.get("bias"))
        if path and str(path[-1]) == "mlp_in":
            return ModelSplit(slices, devices)
        if path and str(path[-1]) == "mlp_out":
            return ModelSplit([{k: v for k, v in s.items() if k != "bias"}
                               for s in slices], devices, tree.get("bias"))
        return {k: _splits(v, [s[k] for s in slices], devices,
                           path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_splits(v, [s[i] for s in slices], devices,
                                  path + (i,)) for i, v in enumerate(tree))
    return tree


def shard_params(mesh: Mesh, params: Dict) -> ShardedParams:
    """Place ``params`` on the mesh per ``detector_pspecs``: each grid
    position gets its slice (column-split ``q/k/v/qkv`` and ``mlp_in``
    kernels and biases, row-split ``o`` and ``mlp_out`` kernels, the rest
    whole), on its device. An int8 row-split kernel gets ``AMAX_PAD`` zero
    rows under its slice (parallel/tensor.py). A device named twice in the
    grid holds one copy of what its positions share."""
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
