"""The int8 dense kernel K2 and the quant="int8" serving transforms in the
port, held to the JAX package on the CPU (the CUDA kernel is held to its
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: the plain K2 bit for bit against JAX's K2 in interpret mode
(``int8_dense_pallas(interpret=True)``) and against the jitted
``dense_int8``, which the JAX package's tests hold bit-identical to it;
the parameter trees of ``quantize_params`` and of the ``quant="int8"``
serving pipeline equal JAX's; ``quant_mode`` answers as JAX's for every
value of the config and the environment on the CPU, and on a CUDA device
answers "all" or raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.ops import pallas_int8 as j_pi
from misinfo_tpu.ops import quant as j_quant
from misinfo_tpu.ops import serving as j_serving
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.core.config import PrecisionConfig as JPrecision

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.ops import common as t_common
from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops import quant as t_quant
from misinfo_tpu_torch.ops import serving as t_serving
from misinfo_tpu_torch.ops.common import Policy as TPolicy

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _dense(rng, k, n, bias=True):
    p = {"kernel": jnp.asarray(rng.normal(size=(k, n)) * 0.02, jnp.float32)}
    if bias:
        p["bias"] = jnp.asarray(rng.normal(size=(n,)) * 0.01, jnp.float32)
    return j_quant.quantize_dense(p)


def _t(p):
    return params_from_jax(jax.tree.map(np.asarray, p))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256,), (270,), (3, 97)])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_k2_bitwise_equal_jax(out, shape, bias):
    """M = 256, a ragged M, and 3-D input; bf16 x for a bf16 output and
    f32 x for an f32 one, as the engine calls it."""
    rng = np.random.default_rng(len(shape) * 10 + shape[-1] + bias)
    jdt, tdt = _DT[out]
    p = _dense(rng, 128, 256, bias)
    x = jnp.asarray(rng.normal(size=(*shape, 128)), jdt)
    kern = j_pi.int8_dense_pallas(x, p["kernel_q"], p["w_scale"],
                                  p.get("bias"), out_dtype=jdt,
                                  interpret=True)
    jit = jax.jit(lambda a: j_quant.dense_int8(p, a, jdt))(x)
    tp = _t(p)
    got = K2.int8_dense(torch.tensor(_np(x)).to(tdt), tp["kernel_q"],
                        tp["w_scale"], tp.get("bias"), out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (*shape, 256)
    np.testing.assert_array_equal(_np(got), _np(kern))
    np.testing.assert_array_equal(_np(got), _np(jit))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    plain = K2.int8_dense_plain
    monkeypatch.setattr(K2, "int8_dense_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    before = K2.launches
    case = KC.int8_dense_case(300, 128, 64, device="cpu")
    K2.int8_dense(case["x"], case["wq"], case["w_scale"], case["bias"])
    assert calls == [1] and K2.launches == before


@pytest.mark.parametrize("bias", [True, False])
def test_card_check_rejects_planted_fault_on_cpu(bias):
    """The K2 check of the card run: bitwise at both output dtypes, and a
    row scale one ulp off changes the f32 output."""
    res = KC.check_int8_dense(KC.int8_dense_case(300, 256, 128, bias=bias,
                                                 device="cpu"))
    assert res["fault_elements"] > 0


_MODES = ["", "auto", "off", "ffn", "dense", "all", "on", "1", "true", "0",
          "none", "false"]


@pytest.mark.parametrize("env", _MODES)
def test_quant_mode_matches_jax(env, monkeypatch):
    """Every config value under every environment value. On the CPU the
    answer is JAX's off a TPU; on a CUDA device it is JAX's on a TPU where
    that is "all", and any mode that turns a kernel off raises (the port
    hands no card tensor to a plain version)."""
    monkeypatch.setenv("MISINFO_TPU_INT8_PALLAS", env)
    for cfg in _MODES[1:]:
        jp = JPolicy(JPrecision(quant_pallas=cfg))
        tp = TPolicy(TPrecision(quant_pallas=cfg))
        monkeypatch.setattr(j_pi, "_on_tpu", lambda: False)
        assert t_serving.quant_mode(tp, "cpu") == j_pi.quant_mode(jp)
        assert (t_serving.ffn_kernel_enabled(tp, "cpu")
                == j_pi.ffn_kernel_enabled(jp))
        assert (t_serving.dense_kernel_enabled(tp, "cpu")
                == j_pi.dense_kernel_enabled(jp))
        monkeypatch.setattr(j_pi, "_on_tpu", lambda: True)
        if j_pi.quant_mode(jp) == "all":
            assert t_serving.quant_mode(tp, "cuda") == "all"
            assert t_serving.ffn_kernel_enabled(tp, "cuda")
            assert t_serving.dense_kernel_enabled(tp, "cuda")
        else:
            for fn in (t_serving.quant_mode, t_serving.ffn_kernel_enabled,
                       t_serving.dense_kernel_enabled):
                with pytest.raises(ValueError, match="CUDA device"):
                    fn(tp, "cuda")


@pytest.mark.parametrize("value", ["al", "kernels", "yes"])
@pytest.mark.parametrize("source", ["env", "config"])
def test_quant_mode_rejects_unknown_values(value, source, monkeypatch):
    """A typo must not turn the kernels off in silence (JAX's returns it
    as it is, which enables neither)."""
    monkeypatch.setenv("MISINFO_TPU_INT8_PALLAS",
                       value if source == "env" else "")
    tp = TPolicy(TPrecision(quant_pallas=value if source == "config"
                            else "auto"))
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match=repr(value)):
            t_serving.quant_mode(tp, dev)


def _tree(rng):
    def d(k, n):
        return {"kernel": rng.normal(size=(k, n)).astype(np.float32),
                "bias": rng.normal(size=(n,)).astype(np.float32)}
    return {"layers": [{"attn": {n: d(8, 8) for n in "qkvo"},
                        "mlp_in": d(8, 16), "mlp_out": d(16, 8)}],
            "head": {"fc1": d(8, 4)},
            "emb": rng.normal(size=(10, 8)).astype(np.float32)}


def _assert_trees_equal(jtree, ttree):
    flat_a = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jtree))[0]
    flat_b = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: t.float().numpy() if t.is_floating_point() else t.numpy(),
        ttree))[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a, b.dtype), str(k))


@pytest.mark.parametrize("transform", ["quantize", "serving_int8"])
def test_serving_transforms_match_jax(transform):
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    if transform == "quantize":
        want = j_quant.quantize_params(tree, 1)
        got = t_quant.quantize_params(_t(tree), 1)
        _assert_trees_equal(want, t_quant.quantize_params(got, 1))
    else:
        big = {**tree, "layers": [{**tree["layers"][0], "attn": {
            n: {"kernel": rng.normal(size=(512, 512)).astype(np.float32)}
            for n in "qkvo"}}]}
        want = j_serving.optimize_for_serving(big, JPolicy(), quant="int8")
        got = t_serving.optimize_for_serving(_t(big), TPolicy(), "int8")
        assert "kernel_q" in got["layers"][0]["attn"]["q"]
    _assert_trees_equal(want, got)


def test_dense_routes_k2_from_256_rows(monkeypatch):
    """``dense`` on int8 params: below 256 rows, or with the dense kernel
    off, the plain dense_int8; from 256 rows with it on, K2."""
    calls = []
    plain = K2.int8_dense_plain
    monkeypatch.setattr(K2, "int8_dense_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    rng = np.random.default_rng(4)
    p = _t(_dense(rng, 64, 32))
    pol = TPolicy(TPrecision.highest())
    for env, rows, want in (("all", 255, 0), ("all", 256, 1),
                            ("ffn", 512, 0), ("dense", 512, 1),
                            ("", 512, 0)):
        monkeypatch.setenv("MISINFO_TPU_INT8_PALLAS", env)
        calls.clear()
        t_common.dense(p, torch.zeros(rows, 64), pol)
        assert len(calls) == want, (env, rows)
