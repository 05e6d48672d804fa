"""Parameter-tree helpers in ``jax.tree_util``'s order.

The port's trees are nested dicts and lists of tensors with the JAX
package's names. ``leaves_with_paths`` walks them as ``tree_flatten``
does — dict keys sorted, lists and tuples in order, ``None`` an empty
subtree — so that a leaf's index here is its index in the JAX package's
flat checkpoints (checkpoints/io.py) and masks line up leaf for leaf
(train/optim.py).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Path = Tuple[Any, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, prefix + (i,))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf; the same structure back."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def unflatten_like(tree, leaves: List):
    """The structure of ``tree`` with ``leaves`` (in flatten order)."""
    it = iter(leaves)
    paths = [p for p, _ in leaves_with_paths(tree)]
    slots = {p: next(it) for p in paths}

    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        if t is None:
            return None
        return slots[prefix]
    return build(tree, ())


def clone_tree(tree, device=None):
    """A copy of every tensor leaf (on ``device`` if given, strides kept)
    that shares no storage with ``tree``: a trainer owns the tree it
    updates in place."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        return (t.to(device, copy=True) if device is not None
                else t.clone())
    return tree_map(one, tree)


def tree_device(tree) -> torch.device:
    """The device of the tree's first tensor leaf."""
    for _, leaf in leaves_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")
