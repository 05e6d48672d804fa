"""The whole-layer decode step (TPU kernel K9 ``_layer_step_kernel_i8``,
``pallas_layer``) in the port, on the CPU.

- The plain version is the self-attention step's plain version followed
  by the cross-attention + FFN step's: equal to that composition bit for
  bit, output and caches (the TPU kernel composes the two int8 bodies
  verbatim; the port composes, it keeps no third copy of the arithmetic).
- Against JAX's Pallas kernel in interpret mode (jitted), on the same
  numpy inputs: 2e-6 in f32 (sums in another order); in bf16 the band of
  tests/test_torch_decode_kernels.py for one step, 2^-6·max|y − x| plus
  one bf16 step of the residual at each of the layer's three roundings
  (x1, x2, y), and the written cache rows within one rounding.
- ``decode_transcript(pallas_layer=True)``: tokens equal to JAX's
  ``pallas_layer`` decode and to the port's two-call decode
  (``pallas_self_attn`` + ``pallas_cross``), whose avg_logprob and
  p(nospeech) it equals exactly; against JAX avg_logprob within 2e-3 (the
  int8 bar of tests/test_whisper_parity.py:518-519).
- JAX's refusals with JAX's words; CPU tensors take the plain version and
  count no launch; ``ops/decode_checks.py``'s whole-layer check rejects
  each planted fault at the chip smoke's shapes.

The CUDA kernel is held to the two-call route bit for bit, and to this
plain version, on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import whisper as jw
from misinfo_tpu.ops import serving as j_serving
from misinfo_tpu.ops.common import DEFAULT_POLICY as J_BF16
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.ops.pallas_layer import fused_layer_step as j_layer
from misinfo_tpu.ops.quant import quantize_dense as j_quantize_dense

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax as P
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.models import whisper as tw
from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import decode_checks as DC
from misinfo_tpu_torch.ops import layer_step as K9
from misinfo_tpu_torch.ops import self_attn_step as K6
from misinfo_tpu_torch.ops import serving as t_serving
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY as T_BF16
from misinfo_tpu_torch.ops.common import Policy as TPolicy

JP, TP = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())
MODES = {"f32": (JP, TP, jnp.float32, torch.float32),
         "bf16": (J_BF16, T_BF16, jnp.bfloat16, torch.bfloat16)}
B, D, H, S, F, T, TP_PAD = 3, 128, 2, 16, 256, 40, 128


def _dense(rng, k, n, int8=True):
    p = {"kernel": (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
         "bias": (rng.normal(size=n) * 0.1).astype(np.float32)}
    return jax.tree.map(np.asarray, j_quantize_dense(p)) if int8 else p


def _ln(rng):
    return {"scale": (1 + 0.1 * rng.normal(size=D)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=D)).astype(np.float32)}


def _block(rng, int8=True):
    return {"ln1": _ln(rng),
            "self_attn": {"qkv": _dense(rng, D, 3 * D, int8),
                          "o": _dense(rng, D, D, int8)},
            "ln_cross": _ln(rng),
            "cross_attn": {"q": _dense(rng, D, D, int8),
                           "o": _dense(rng, D, D, int8)},
            "ln2": _ln(rng), "mlp_in": _dense(rng, D, F, int8),
            "mlp_out": _dense(rng, F, D, int8)}


def _inputs(seed, tdt):
    rng = np.random.default_rng(seed)
    blk = _block(rng)
    x = rng.normal(size=(B, D)).astype(np.float32)
    ck, cv = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in "kv")
    xkv = rng.normal(size=(2, B, TP_PAD, D)).astype(np.float32)
    xkv[:, :, T:] = 0.0
    t = lambda a: torch.from_numpy(a.copy()).to(tdt)  # noqa: E731
    return blk, x, ck, cv, xkv, t


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 5, S - 1])
def test_layer_step_plain_is_the_two_plain_steps(mode, pos):
    _, tpol, _, tdt = MODES[mode]
    blk, x, ck, cv, xkv, t = _inputs(pos, tdt)
    tb = P(blk)
    k1, v1, k2, v2 = t(ck), t(cv), t(ck), t(cv)
    xk, xv = t(xkv[0, :, :T]), t(xkv[1, :, :T])
    before = (K9.launches, K6.launches, K7.launches)
    y, rk, rv = K9.fused_layer_step(t(x), tb, k1, v1, xk, xv, pos, T,
                                    n_heads=H, policy=tpol)
    assert rk is k1 and rv is v1                    # written in place
    x1, _, _ = K6.self_attn_step_plain(
        t(x), tb["ln1"], tb["self_attn"]["qkv"], tb["self_attn"]["o"], k2, v2,
        pos, n_heads=H, policy=tpol)
    want = K7.cross_ffn_step_plain(
        x1, tb["ln_cross"], tb["cross_attn"]["q"], tb["cross_attn"]["o"],
        tb["ln2"], tb["mlp_in"], tb["mlp_out"], xk, xv, T, n_heads=H,
        policy=tpol)
    assert torch.equal(y, want)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert not torch.equal(k1, t(ck))               # row pos was written
    assert (K9.launches, K6.launches, K7.launches) == before


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 5, S - 1])
def test_layer_step_plain_matches_pallas(mode, pos):
    jpol, tpol, jdt, tdt = MODES[mode]
    blk, x, ck, cv, xkv, t = _inputs(10 + pos, tdt)
    fn = jax.jit(lambda x, ck, cv, xk, xv: j_layer(
        x, blk, ck, cv, xk, xv, pos, T, n_heads=H, policy=jpol))
    with pltpu.force_tpu_interpret_mode():
        want, wk, wv = fn(*(jnp.asarray(a, jdt)
                            for a in (x, ck, cv, xkv[0], xkv[1])))
    xt, k1, v1 = t(x), t(ck), t(cv)
    got, _, _ = K9.fused_layer_step(xt, P(blk), k1, v1, t(xkv[0, :, :T]),
                                    t(xkv[1, :, :T]), pos, T, n_heads=H,
                                    policy=tpol)

    def check(got, want, x=None, roundings=1):
        want = torch.tensor(np.asarray(want, np.float32))
        err = (got.float() - want).abs()
        if mode == "f32":
            assert err.max() <= 2e-6, err.max()
            return
        x = torch.zeros_like(want) if x is None else x.float()
        tol = (2.0 ** -6 * (want - x).abs().max() + roundings
               * DC.bf16_ulp(torch.maximum(x.abs(), want.abs())))
        assert bool((err <= tol).all()), (err - tol).max()
    check(got, want, xt, roundings=3)
    check(k1, wk)
    check(v1, wv)


def test_layer_step_needs_int8_weights_as_jax():
    rng = np.random.default_rng(1)
    blk = _block(rng, int8=False)
    x = rng.normal(size=(B, D)).astype(np.float32)
    z = np.zeros((B, S, D), np.float32)
    xk = np.zeros((B, TP_PAD, D), np.float32)
    with pytest.raises(ValueError, match="needs int8 decode weights"):
        j_layer(jnp.asarray(x), blk, jnp.asarray(z), jnp.asarray(z),
                jnp.asarray(xk), jnp.asarray(xk), 0, T, n_heads=H, policy=JP)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="needs int8 decode weights"):
        K9.fused_layer_step(t(x), P(blk), t(z), t(z), t(xk), t(xk), 0, T,
                            n_heads=H, policy=TP)
    assert K9.MAX_BATCH == K6.MAX_BATCH == K7.MAX_BATCH


# ------------------------------------------------------------ whole decode

JCFG, TCFG = jw.WhisperConfig.tiny(), tw.WhisperConfig.tiny()


@pytest.fixture(scope="module")
def model():
    tp = tw.whisper_init(31, TCFG)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    jq = j_serving.quantize_whisper_decoder(jw.fuse_whisper_decoder_qkv(jp))
    tq = t_serving.quantize_whisper_decoder(tw.fuse_whisper_decoder_qkv(tp))
    enc = np.random.default_rng(32).normal(
        size=(2, JCFG.max_source_positions, JCFG.d_model)).astype(np.float32)
    return jp, tp, jq, tq, enc


@pytest.mark.parametrize("prompt", [None, np.array([[5, 6], [8, 9]],
                                                   np.int32)])
def test_pallas_layer_decode_matches_jax_and_the_two_call_decode(model,
                                                                 prompt):
    _, _, jq, tq, enc = model
    pj = None if prompt is None else jnp.asarray(prompt)
    pt = None if prompt is None else torch.from_numpy(prompt)
    with pltpu.force_tpu_interpret_mode():
        tj, lj, nj = jax.jit(lambda e: jw.decode_transcript(
            jq, None, JCFG, JP, enc_out=e, max_len=10, nospeech_id=7,
            prompt_tokens=pj, pallas_layer=True))(jnp.asarray(enc))
    seen = []
    real = tw.fused_layer_step
    tw.fused_layer_step = lambda *a, **kw: seen.append(1) or real(*a, **kw)
    try:
        got = tw.decode_transcript(tq, None, TCFG, TP, max_len=10,
                                   nospeech_id=7, prompt_tokens=pt,
                                   enc_out=torch.from_numpy(enc),
                                   pallas_layer=True)
    finally:
        tw.fused_layer_step = real
    assert seen and len(seen) % TCFG.decoder_layers == 0
    two = tw.decode_transcript(tq, None, TCFG, TP, max_len=10, nospeech_id=7,
                               prompt_tokens=pt,
                               enc_out=torch.from_numpy(enc),
                               pallas_self_attn=True, pallas_cross=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(tj))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(lj), atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(nj), atol=2e-3)
    for a, b in zip(got, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("int8,kw,msg", [
    (False, {}, "pallas_layer needs int8 decode weights"),
    (True, dict(pallas_self_attn=True), "pallas_layer subsumes"),
    (True, dict(pallas_cross=True), "pallas_layer subsumes"),
    (True, dict(pallas_ffn=True), "pallas_layer subsumes"),
    (True, dict(quant=True), "reads bf16 merged caches"),
    (True, dict(scan_layers=True), "drop scan_layers")])
def test_pallas_layer_refuses_what_jax_refuses(model, int8, kw, msg):
    jp, tp, jq, tq, enc = model
    jparams, tparams = (jq, tq) if int8 else (jp, tp)
    with pytest.raises(ValueError, match=msg):
        jw.decode_transcript(jparams, None, JCFG, JP,
                             enc_out=jnp.asarray(enc), max_len=4,
                             pallas_layer=True, **kw)
    with pytest.raises(ValueError, match=msg):
        tw.decode_transcript(tparams, None, TCFG, TP,
                             enc_out=torch.from_numpy(enc), max_len=4,
                             pallas_layer=True, **kw)


H100_SMS = 132          # sets the kernel's T chunks that the faults drop


@pytest.mark.parametrize("B,pos", [(1, 0), (1, 447), (4, 0), (4, 447),
                                   (32, 0), (32, 447)])
def test_layer_band_rejects_planted_faults(B, pos):
    """On the CPU the wrapper, the two-call route and the plain version
    are one computation (error 0, equal); what this shows is that every
    emulated wrong kernel, of either half, leaves the layer's band."""
    res = DC.check_layer(DC.layer_case(B, pos, device="cpu"), H100_SMS)
    assert res["err"] == 0.0
    assert res["faults"] >= 3 + (pos > 0)
    assert res["nearest_fault"] > 3.0


@pytest.mark.parametrize("B,pos", [(1, 447), (4, 447), (32, 0)])
def test_flash_layer_step_holds_the_band(B, pos):
    """The CUDA whole-layer step's arithmetic (the self-attention step's,
    then the cross step's flash-decoding attention over the card's T
    chunks, ops/decode_checks.py::cross_ffn_flash) keeps the band of the
    plain version with every planted fault outside it."""
    case = DC.layer_case(B, pos, device="cpu")
    cc, H = case["cross"], case["n_heads"]
    want = K9.layer_step_plain(*case["args"], n_heads=H)[0]
    res = DC.hold(DC.cross_ffn_flash(cc, H100_SMS), want, case["args"][0], 3,
                  DC.layer_faults(case, H100_SMS), f"flash layer B={B}")
    assert res["err"] <= res["band"] and res["nearest_fault"] > 3.0
