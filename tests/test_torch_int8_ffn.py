"""The fused int8 FFN (TPU kernel K1) in the port: its plain version held
to the JAX package on the CPU (the CUDA kernel is held to the plain
version on the card by tests/test_torch_cuda.py).

Tolerances: bitwise equality with ``int8_ffn_xla`` on the integer grid
(every scale exactly 1); within 3 int8 levels (3·max|y|/127, the band of
tests/test_pallas_int8.py) on Gaussian data and against the chunked
Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.ops.common import DEFAULT_POLICY, F32_POLICY
from misinfo_tpu.ops.pallas_int8 import _pick, int8_ffn_pallas, int8_ffn_xla
from misinfo_tpu.ops.quant import quantize_dense

from misinfo_tpu_torch.checkpoints.from_jax import tensor_from_numpy
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.ops import int8_ffn as K1
from misinfo_tpu_torch.ops.common import Policy as TPolicy

T_F32 = TPolicy(TPrecision.highest())


def _gauss(rng, k, n):
    return quantize_dense({
        "kernel": jnp.asarray(rng.normal(size=(k, n)) * 0.05, jnp.float32),
        "bias": jnp.asarray(rng.normal(size=(n,)) * 0.01, jnp.float32)})


def _int_grid(rng, k, n):
    """Integer weights whose per-channel abs-max is 127: scales are 1."""
    w = rng.integers(-126, 127, (k, n)).astype(np.float32)
    w[0, :] = 127.0
    return quantize_dense({
        "kernel": jnp.asarray(w),
        "bias": jnp.asarray(rng.integers(-50, 50, (n,)), jnp.float32)})


def _port(x, p_in, p_out, mode, jc=None, dtype=torch.bfloat16):
    t = tensor_from_numpy
    return K1.int8_ffn(
        torch.from_numpy(np.asarray(x, np.float32)).to(dtype),
        t(p_in["kernel_q"]), t(p_in["w_scale"]), t(p_in["bias"]),
        t(p_out["kernel_q"]), t(p_out["w_scale"]), t(p_out["bias"]),
        mode=mode, jc=jc).float().numpy()


@pytest.mark.parametrize("mode", ["tanh", "erf", "quick"])
def test_plain_bitwise_on_integer_grid(mode):
    rng = np.random.default_rng(0)
    p_in, p_out = _int_grid(rng, 128, 256), _int_grid(rng, 256, 128)
    x = rng.integers(-126, 127, (37, 128)).astype(np.float32)
    x[:, 0] = 127.0
    want = np.asarray(int8_ffn_xla(p_in, p_out, jnp.asarray(x), F32_POLICY,
                                   mode))
    got = _port(x, p_in, p_out, mode, dtype=torch.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["tanh", "erf", "quick"])
@pytest.mark.parametrize("M", [1, 37, 70])
def test_plain_tracks_xla_chain(mode, M):
    rng = np.random.default_rng(M)
    p_in, p_out = _gauss(rng, 128, 256), _gauss(rng, 256, 128)
    x = rng.normal(size=(M, 128)).astype(np.float32)
    want = np.asarray(int8_ffn_xla(p_in, p_out, jnp.asarray(x, jnp.bfloat16),
                                   DEFAULT_POLICY, mode).astype(jnp.float32))
    got = _port(x, p_in, p_out, mode)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 3 * np.abs(want).max() / 127


def test_plain_tracks_chunked_pallas_interpret():
    rng = np.random.default_rng(7)
    p_in, p_out = _gauss(rng, 128, 384), _gauss(rng, 384, 128)
    x = rng.normal(size=(2, 21, 128)).astype(np.float32)
    want = np.asarray(int8_ffn_pallas(
        jnp.asarray(x, jnp.bfloat16), p_in["kernel_q"], p_in["w_scale"],
        p_in["bias"], p_out["kernel_q"], p_out["w_scale"], p_out["bias"],
        mode="tanh", interpret=True, jc=128).astype(jnp.float32))
    got = _port(x, p_in, p_out, "tanh", jc=128)
    assert got.shape == want.shape == (2, 21, 128)
    assert np.abs(got - want).max() < 3 * np.abs(want).max() / 127


@pytest.mark.parametrize("n", [3072, 2048, 192, 384, 640])
def test_default_chunk_matches_tpu_pick(n):
    assert K1.pick_chunk(n) == _pick(n, 512, 128)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    calls = []
    plain = K1.int8_ffn_plain
    monkeypatch.setattr(K1, "int8_ffn_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    rng = np.random.default_rng(8)
    before = K1.launches
    _port(rng.normal(size=(4, 128)), _gauss(rng, 128, 128),
          _gauss(rng, 128, 128), "quick")
    assert calls == [1] and K1.launches == before


@pytest.mark.parametrize("env,want_jc", [("off", 1024), ("dense", 1024),
                                         ("ffn", 512), ("all", 512)])
def test_apply_follows_quant_mode(env, want_jc, monkeypatch):
    """``int8_ffn_apply`` with the FFN kernel off takes the single-chunk
    chain (``jc = N``, JAX's ``int8_ffn_xla``: bit for bit on the integer
    grid); with it on, the kernel's chunked form (its plain version on the
    CPU, ``jc = 512``)."""
    from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
    monkeypatch.setenv("MISINFO_TPU_INT8_PALLAS", env)
    seen = []
    plain = K1.int8_ffn_plain
    monkeypatch.setattr(K1, "int8_ffn_plain", lambda *a, **kw: seen.append(
        kw["jc"]) or plain(*a, **kw))
    rng = np.random.default_rng(9)
    p_in, p_out = _int_grid(rng, 128, 1024), _int_grid(rng, 1024, 128)
    x = rng.integers(-126, 127, (5, 128)).astype(np.float32)
    x[:, 0] = 127.0
    tp = [params_from_jax(jax.tree.map(np.asarray, p)) for p in (p_in, p_out)]
    got = K1.int8_ffn_apply(*tp, torch.from_numpy(x), policy=T_F32,
                            mode="tanh")
    assert seen == [want_jc]
    if want_jc == 1024:
        want = int8_ffn_xla(p_in, p_out, jnp.asarray(x), F32_POLICY, "tanh")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
