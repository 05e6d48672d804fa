"""The fused int8 FFN (TPU kernel K1) in the port: its plain version held
to the JAX package on the CPU (the CUDA kernel is held to the plain
version on the card by tests/test_torch_cuda.py).

Tolerances: bitwise equality with the jitted ``int8_ffn_xla`` on the
integer grid (every scale of x and the weights exactly 1); within 3 int8
levels (3·max|y|/127, the band of tests/test_pallas_int8.py) on Gaussian
data against the eager chain; bitwise equality with the chunked Pallas
kernel in interpret mode (jitted, as the JAX engine runs it) in all three
activations.

The port follows jitted JAX, whose numerics differ from the eager
function's in three places: XLA folds ``/ 127.0`` into a multiply by
f32(1/127), fuses the multiply-adds (one rounding each), and keeps quick
GELU's bf16 product in f32 before the quantize (its excess precision,
``--xla_allow_excess_precision``, on by default). Measured on seeded
Gaussian data at jc = 128 (M = 512, K = 256, N = 512, K2 = 256) before
the port followed them: with eager scales 1.6% of outputs one bf16 step
off in tanh and erf; with folded scales and two roundings of
``acc + y·sg`` 0.0015% in erf (0 in tanh); quick 73% with either scale,
down to 0.00076% once the product is unrounded and 0 once the multiply-
adds are fused.
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
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops.common import Policy as TPolicy

T_F32 = TPolicy(TPrecision.highest())
_xla = jax.jit(int8_ffn_xla, static_argnums=(3, 4))   # as the engine runs it


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
    want = np.asarray(_xla(p_in, p_out, jnp.asarray(x), F32_POLICY, mode))
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


@pytest.mark.parametrize("mode", ["tanh", "erf", "quick"])
def test_plain_bitwise_equal_chunked_pallas_interpret(mode):
    """The port's K1 (plain version) against JAX's K1 in interpret mode at
    jc = 128 (four chunks), bf16: bit for bit in every activation."""
    rng = np.random.default_rng(11)
    p_in, p_out = _gauss(rng, 256, 512), _gauss(rng, 512, 256)
    x = rng.normal(size=(160, 256)).astype(np.float32)
    want = np.asarray(int8_ffn_pallas(
        jnp.asarray(x, jnp.bfloat16), p_in["kernel_q"], p_in["w_scale"],
        p_in["bias"], p_out["kernel_q"], p_out["w_scale"], p_out["bias"],
        mode=mode, interpret=True, jc=128).astype(jnp.float32))
    got = _port(x, p_in, p_out, mode, jc=128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M,K,N,mode", [(37, 256, 1024, "tanh"),
                                        (130, 256, 1024, "quick"),
                                        (1, 512, 2048, "erf")])
def test_k1_band_rejects_planted_faults(M, K, N, mode):
    """The card check of ops/kernel_checks.py run on the CPU (the wrapper
    takes the plain version): every planted fault (a chunk left out, the
    intermediate's scale per row, the next chunk's scale, the ragged last
    tile dropped) falls outside the 3-level band; the integer grid is bit
    for bit."""
    res = KC.check_int8_ffn(KC.int8_ffn_case(M, K, N, mode, device="cpu"))
    assert res["err"] == 0.0 and res["faults"] == 4
    assert res["nearest_fault"] > 1.0
    KC.check_int8_ffn(KC.int8_ffn_case(M, K, N, mode, device="cpu",
                                       grid=True))


def _round_f32(e):
    """The Fraction e rounded to the nearest float32, ties to even."""
    from fractions import Fraction
    f = np.float32(float(e))
    cands = (f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - e),
                                     int(c.view(np.uint32)) & 1))


def test_fma_rounds_once():
    """``_fma`` (the kernel's __fmaf_rn) is the exact a·b + c rounded to
    f32 once: on random operands, and on a sum that float64 rounds onto a
    float32 midpoint, where a float64 multiply-add rounds the wrong way."""
    from fractions import Fraction
    rng = np.random.default_rng(12)
    a, b, c = (rng.normal(size=3000).astype(np.float32)
               * np.float32(2.0) ** rng.integers(-20, 20, 3000)
               for _ in range(3))
    one, u = np.float32(1.0), np.float32(2.0 ** -23)
    a = np.append(a, one + u)
    b = np.append(b, (one - u) * np.float32(2.0 ** -24))
    c = np.append(c, one + u)
    got = K1._fma(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert twice[-1] != got[-1] == c[-1]


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
        want = _xla(p_in, p_out, jnp.asarray(x), F32_POLICY, "tanh")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
