"""The port's training steps over a device mesh held to JAX's steps over
its 8 virtual CPU devices (data=8), where JAX's own mesh test runs a
step (tests/test_trainers_mesh.py: CLIP, EfficientNet, fusion): after
three steps on the global batches of tests/test_torch_trainers_mesh.py,
loss, metric and every leaf within 1e-5. The single-device comparisons,
the controls and the trainers are in that file.
"""

import jax
import pytest

from tests.test_torch_train_steps import _assert_trees_close
from tests.test_torch_trainers_mesh import (  # noqa: F401
    _jax_run, _mesh, _metric, _mesh_flags, _no_fusion_dropout, _one_thread,
    _port_run, tree)


@pytest.mark.parametrize("kind", ["clip", "effnet", "fusion"])
def test_mesh_step_matches_jax_mesh_step(tree, kind, monkeypatch):
    """Against JAX's step over its 8 virtual devices (data=8)."""
    _no_fusion_dropout(monkeypatch)
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 virtual CPU devices")
    j_ms, jp = _jax_run(tree, kind, on_mesh=True)
    t_ms, tp = _port_run(tree, kind, _mesh("data=8"))
    for a, b in zip(j_ms, t_ms):
        for k in ("loss", _metric(kind)):
            assert abs(a[k] - b[k]) <= 1e-5, (kind, k, a[k], b[k])
    _assert_trees_close(jp, tp.gather(), 1e-5, kind)


