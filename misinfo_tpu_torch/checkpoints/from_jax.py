"""Weight bridge from the JAX package's parameter tree.

The JAX detector tree — plain, or after ``quantize_ffn_params`` /
``cast_big_kernels`` — handed over as nested dicts and lists of **numpy**
arrays (``jax.tree.map(np.asarray, tree)``) becomes the port's tree on a
given device. Names and layouts are the same on both sides (``[in, out]``
kernels, HWIO convs, int8 ``kernel_q`` with f32 ``w_scale``), so every
leaf is a copy: no transpose, no renaming.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One leaf: numpy (incl. ml_dtypes bfloat16) → torch on `device`."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dicts/lists/tuples of numpy arrays → the same structure of
    torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def to_device(tree, device):
    """Copy a parameter tree (nested dicts/lists of tensors) to `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
