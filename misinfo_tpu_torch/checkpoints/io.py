"""Native checkpoint directories: params, optimizer state and metadata.

Counterpart of ``misinfo_tpu/checkpoints/io.py``. The port writes the JAX
package's portable layout, the one its ``save_checkpoint`` falls back to
without orbax, so that each package reads the other's directories:

* ``params_flat.npz`` — the tree's leaves as ``arr_0 … arr_N`` in
  ``jax.tree_util``'s flatten order (dict keys sorted, lists in order,
  utils/tree.py), each as a numpy array of the leaf's dtype (bf16 leaves
  widen to f32, which numpy can store without ml_dtypes);
* ``metadata.json``;
* ``leaf_paths.json`` — the leaves' paths, checked on load when present
  (the JAX package ignores it; its own ``treedef.txt`` is not read here);
* ``opt_state_torch.pt`` — the port's optimizer state (train/optim.py),
  named so that JAX's ``load_opt_state``, which reads ``opt_state.npz``,
  never picks it up.

A directory that holds only an orbax ``params/`` tree (the JAX package's
default when orbax is installed) cannot be read without orbax: loading
it raises and names the layout this module reads; it is never taken for
an empty directory.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from misinfo_tpu_torch.utils.tree import leaves_with_paths, unflatten_like

PARAMS = "params_flat.npz"
PATHS = "leaf_paths.json"
OPT_STATE = "opt_state_torch.pt"


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().contiguous().numpy()
    return np.asarray(t)


def save_checkpoint(path: str, params, opt_state=None,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``params`` (and the optimizer state, if given) to ``path``."""
    os.makedirs(path, exist_ok=True)
    pairs = leaves_with_paths(params)
    np.savez(os.path.join(path, PARAMS), *[_to_numpy(t) for _, t in pairs])
    with open(os.path.join(path, PATHS), "w") as f:
        json.dump([list(p) for p, _ in pairs], f)
    if opt_state is not None:
        torch.save(opt_state.state_dict(), os.path.join(path, OPT_STATE))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata or {}, f, indent=2, default=str)


def load_checkpoint(path: str, params_like) -> Optional[Dict]:
    """The tree saved at ``path`` in the structure of ``params_like``
    (each leaf with the saved dtype, on the like leaf's device), or None
    when ``path`` is no directory or holds no params — as the JAX
    function. Raises ValueError for an orbax-only directory and for
    leaves that do not fit ``params_like``."""
    if not os.path.isdir(path):
        return None
    npz = os.path.join(path, PARAMS)
    if not os.path.exists(npz):
        if os.path.isdir(os.path.join(path, "params")):
            raise ValueError(
                f"{path} holds an orbax params/ tree, which "
                "misinfo_tpu_torch cannot read (no orbax on its machines): "
                "it reads the params_flat.npz + metadata.json layout, "
                "which misinfo_tpu.checkpoints.io.save_checkpoint writes "
                "when orbax is not installed")
        return None
    pairs = leaves_with_paths(params_like)
    paths_file = os.path.join(path, PATHS)
    if os.path.exists(paths_file):
        with open(paths_file) as f:
            saved = [tuple(p) for p in json.load(f)]
        want = [p for p, _ in pairs]
        if saved != want:
            missing = sorted(set(map(str, want)) - set(map(str, saved)))[:3]
            raise ValueError(f"{path}: its leaves are not this tree's "
                             f"(e.g. missing {missing})")
    with np.load(npz, allow_pickle=False) as data:
        flat = [data[k] for k in data.files]
    if len(flat) != len(pairs):
        raise ValueError(f"{path}: {len(flat)} leaves saved, the tree has "
                         f"{len(pairs)}")
    leaves = []
    for a, (p, like) in zip(flat, pairs):
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"{path}: leaf {p} saved with shape "
                             f"{a.shape}, the tree's is {tuple(like.shape)}")
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        leaves.append(torch.from_numpy(np.array(a)).to(dev))
    return unflatten_like(params_like, leaves)


def load_opt_state(path: str, opt_state_like) -> Optional[object]:
    """Restore the optimizer state written by ``save_checkpoint`` into
    ``opt_state_like`` (train/optim.OptState) → training resume; None
    when the directory holds none."""
    f = os.path.join(path, OPT_STATE)
    if not os.path.exists(f):
        return None
    opt_state_like.load_state_dict(torch.load(f, weights_only=True))
    return opt_state_like


def load_metadata(path: str) -> Dict:
    p = os.path.join(path, "metadata.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}
