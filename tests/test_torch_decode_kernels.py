"""The fused decode-step kernels (TPU kernels K6a/K6b, K7a/K7b) in the
port: their plain versions held to the JAX package's Pallas kernels run in
interpret mode on the CPU, and the fused decode held to JAX's. The CUDA
kernels are held to these plain versions on the card by
tests/test_torch_cuda.py, through ops/decode_checks.py; here that
module's planted faults are shown to fall outside its band at the card
tests' and the chip smoke's shapes, and the arithmetic of the card's
designs, emulated in PyTorch at the card's split (K7's flash-decoding T
chunks, K6's cache-row chunks exchanged in a cluster), is held to it.

Tolerances, on the same numpy inputs:
- f32 compute: 2e-6 absolute on outputs of magnitude ~5 (sums run in
  another order; nothing else differs);
- bf16 compute: elementwise 2^-6·max|y − x|, two bf16 steps at the
  largest magnitude of what the step adds to its residual input x (an
  f32 sum in another order can move one bf16 rounding of an
  intermediate; taken against y, the residual would set the band), plus
  one bf16 step of the residual at each of its roundings (K6: y; K7: x2
  and y);
- the whole fused decode: tokens equal, avg_logprob within 1e-5 and
  p(nospeech) within 1e-6 in f32 (the bars of tests/test_whisper_parity.py
  :447-449); with int8 decoder weights tokens equal and avg_logprob within
  2e-3 (its bar at :518-519).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import whisper as j_whisper
from misinfo_tpu.ops.common import DEFAULT_POLICY as J_BF16
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.ops.pallas_cross_ffn import fused_cross_ffn_step as j_cross
from misinfo_tpu.ops.pallas_decode import fused_self_attn_step as j_self
from misinfo_tpu.ops.quant import quantize_dense as j_quantize_dense
from misinfo_tpu.ops.serving import quantize_whisper_decoder as j_quant_dec

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.models import whisper as t_whisper
from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import decode_checks as DC
from misinfo_tpu_torch.ops import self_attn_step as K6
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY as T_BF16
from misinfo_tpu_torch.ops.common import Policy as TPolicy
from misinfo_tpu_torch.ops.serving import quantize_whisper_decoder

J_F32, T_F32 = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())
MODES = {"f32": (J_F32, T_F32, jnp.float32, torch.float32),
         "bf16": (J_BF16, T_BF16, jnp.bfloat16, torch.bfloat16)}
B, D, H, S, F, T = 3, 128, 2, 16, 256, 40


def _dense(rng, k, n, int8):
    p = {"kernel": (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
         "bias": (rng.normal(size=n) * 0.1).astype(np.float32)}
    return jax.tree.map(np.asarray, j_quantize_dense(p)) if int8 else p


def _ln(rng):
    return {"scale": (1 + 0.1 * rng.normal(size=D)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=D)).astype(np.float32)}


def _check(got, want, mode, x=None, roundings=1):
    """The tolerances of the module docstring; x is the residual input
    (none for the cache rows)."""
    want = torch.tensor(np.asarray(want, np.float32))
    got = got.float()
    assert got.shape == want.shape
    err = (got - want).abs()
    if mode == "f32":
        assert err.max() <= 2e-6, err.max()
        return
    x = torch.zeros_like(want) if x is None else x.float()
    tol = (2.0 ** -6 * (want - x).abs().max()
           + roundings * DC.bf16_ulp(torch.maximum(x.abs(), want.abs())))
    assert bool((err <= tol).all()), (err - tol).max()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 5, S - 1])
def test_self_attn_step_plain_matches_pallas(int8, mode, pos):
    jpol, tpol, jdt, tdt = MODES[mode]
    rng = np.random.default_rng(pos + 10 * int8)
    x = rng.normal(size=(B, D)).astype(np.float32)
    ln, qkv = _ln(rng), _dense(rng, D, 3 * D, int8)
    o = _dense(rng, D, D, int8)
    ck, cv = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in "kv")
    with pltpu.force_tpu_interpret_mode():
        want, wk, wv = j_self(jnp.asarray(x, jdt), ln, qkv, o,
                              jnp.asarray(ck, jdt), jnp.asarray(cv, jdt), pos,
                              n_heads=H, policy=jpol)
    P = params_from_jax
    got, gk, gv = K6.fused_self_attn_step(
        torch.from_numpy(x).to(tdt), P(ln), P(qkv), P(o),
        torch.from_numpy(ck).to(tdt), torch.from_numpy(cv).to(tdt), pos,
        n_heads=H, policy=tpol)
    _check(got, want, mode, torch.from_numpy(x).to(tdt))
    _check(gk, wk, mode)
    _check(gv, wv, mode)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_cross_ffn_step_plain_matches_pallas(int8, mode):
    """JAX's kernel takes tile-padded planes (48 rows, 40 real); the port
    keeps them unpadded, and a padded plane gives the same result."""
    jpol, tpol, jdt, tdt = MODES[mode]
    rng = np.random.default_rng(3 + int8)
    x = rng.normal(size=(B, D)).astype(np.float32)
    lnc, q, o = _ln(rng), _dense(rng, D, D, int8), _dense(rng, D, D, int8)
    ln2, w1, w2 = _ln(rng), _dense(rng, D, F, int8), _dense(rng, F, D, int8)
    kv = rng.normal(size=(2, B, 48, D)).astype(np.float32)
    kv[:, :, T:] = 0.0
    with pltpu.force_tpu_interpret_mode():
        want = j_cross(jnp.asarray(x, jdt), lnc, q, o, ln2, w1, w2,
                       jnp.asarray(kv[0], jdt), jnp.asarray(kv[1], jdt), T,
                       n_heads=H, policy=jpol)
    P = params_from_jax
    xt = torch.from_numpy(x).to(tdt)
    for rows in (T, 48):
        ck, cv = (torch.from_numpy(kv[i, :, :rows].copy()).to(tdt)
                  for i in (0, 1))
        got = K7.fused_cross_ffn_step(xt, P(lnc), P(q), P(o), P(ln2), P(w1),
                                      P(w2), ck, cv, T, n_heads=H,
                                      policy=tpol)
        _check(got, want, mode, xt, roundings=2)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(5)
    P = params_from_jax
    x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    before = (K6.launches, K7.launches)
    K6.fused_self_attn_step(x, P(_ln(rng)), P(_dense(rng, D, 3 * D, False)),
                            P(_dense(rng, D, D, False)),
                            torch.zeros(B, S, D), torch.zeros(B, S, D), 0,
                            n_heads=H, policy=T_F32)
    K7.fused_cross_ffn_step(x, P(_ln(rng)), P(_dense(rng, D, D, True)),
                            P(_dense(rng, D, D, True)), P(_ln(rng)),
                            P(_dense(rng, D, F, True)),
                            P(_dense(rng, F, D, True)),
                            torch.ones(B, T, D), torch.ones(B, T, D), T,
                            n_heads=H, policy=T_F32)
    assert (K6.launches, K7.launches) == before
    # int8 planes take their plain version too, and need int8 weights
    d = lambda k, n, q: P(_dense(rng, k, n, q))  # noqa: E731
    planes = torch.ones(B, T, D, dtype=torch.int8)
    before = K7.launches_i8cc
    K7.fused_cross_ffn_step(x, P(_ln(rng)), d(D, D, True), d(D, D, True),
                            P(_ln(rng)), d(D, F, True), d(F, D, True), planes,
                            planes, T, n_heads=H, policy=T_F32,
                            k_scale=torch.ones(B, T), v_scale=torch.ones(B, T))
    assert K7.launches_i8cc == before
    with pytest.raises(ValueError, match="int8 cross caches require int8"):
        K7.fused_cross_ffn_step(x, P(_ln(rng)), d(D, D, False), None, None,
                                None, None, planes, planes, T, n_heads=H,
                                k_scale=torch.ones(B, T),
                                v_scale=torch.ones(B, T))


H100_SMS = 132          # sets the kernels' chunks that the faults drop


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,pos", [(1, 3), (1, 447), (4, 3), (4, 447),
                                   (20, 100)])
def test_self_attn_band_rejects_planted_faults(int8, B, pos):
    """On the CPU the wrapper is the plain version (error 0); what this
    shows is that every emulated wrong kernel leaves the band, each of
    the kernel's chunks left out among them."""
    res = DC.check_self_attn(DC.self_attn_case(B, pos, int8, device="cpu"),
                             H100_SMS)
    assert res["err"] == 0.0 and res["faults"] >= 1
    assert res["nearest_fault"] > 4.0


@pytest.mark.parametrize("B,H,pos,w_bytes,split", [
    (1, 8, 0, 1, (1, 1, 0)), (1, 8, 32, 1, (33, 1, 0)),
    (1, 8, 447, 1, (224, 2, 32)), (4, 8, 447, 1, (224, 2, 32)),
    (4, 6, 447, 1, (224, 2, 32)), (4, 8, 224, 2, (57, 4, 0)),
    (4, 8, 447, 2, (90, 5, 0)), (16, 8, 447, 1, (224, 2, 0)),
    (32, 8, 447, 2, (448, 1, 0)), (1, 16, 447, 1, (64, 7, 0)),
    (4, 20, 447, 1, (224, 2, 0)), (1, 20, 447, 2, (64, 7, 0))])
def test_self_split(B, H, pos, w_bytes, split):
    """The kernel's split of rows 0..pos on 132 SMs (rows per chunk,
    chunks, W_o columns per block where the o product is folded in):
    about one block per SM over B·H (row, head) pairs, at least 64 rows a
    chunk; with int8 W_o, C ≥ 2 chunks of at most 16 / H and the B·H·C
    blocks in one wave, each batch row's blocks one cluster with the o
    product folded in; else C ≤ 8 and a separate o product."""
    assert DC.self_split(B, H, pos, H100_SMS, w_bytes) == split


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("pos", [0, 3, 447])
def test_chunked_self_attention_holds_the_band(int8, B, pos):
    """The redesigned K6 attention (the rows split into the kernel's
    chunks, the chunks' maxima, exp-sums and PV partials exchanged in a
    cluster, every probability rounded after the global max and sum)
    keeps the unchanged band of its plain version, with every planted
    fault outside it: each chunk left out (every chunk holds a planted
    row), a block of rows left out, the row past pos attended."""
    case = DC.self_attn_case(B, pos, int8, device="cpu")
    x, ln, qkv, o, ck, cv, _ = case["args"]
    want = K6.self_attn_step_plain(x, ln, qkv, o, ck.clone(), cv.clone(),
                                   pos, n_heads=8)[0]
    faults = DC.self_attn_faults(case, H100_SMS)
    _, n = DC.self_chunks(B, 8, pos, H100_SMS, 1 if int8 else 2)
    assert sum(f[0].startswith("chunk ") for f in faults) == (
        n if n > 1 else 0)
    res = DC.hold(DC.self_attn_chunked(case, H100_SMS), want, x, 1, faults,
                  f"chunked self-attention B={B} pos={pos}")
    assert res["err"] <= res["band"] and res["nearest_fault"] > 4.0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,t_actual", [(1, 1500), (4, 1500), (20, 1000)])
def test_cross_ffn_band_rejects_planted_faults(int8, B, t_actual):
    case = DC.cross_ffn_case(B, t_actual, int8, device="cpu")
    res = DC.check_cross_ffn(case, H100_SMS)
    tc, n = DC.t_chunks(B, 8, 1500, H100_SMS)
    chunks = {r // tc for r in case["planted"]}
    assert res["err"] == 0.0 and res["faults"] == len(chunks) + 1 + (
        t_actual < 1500)
    if B * 8 >= n:                   # a planted row in every chunk
        assert chunks == set(range(-(-t_actual // tc)))
    assert res["nearest_fault"] > 4.0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,t_actual", [(1, 1500), (4, 1500), (20, 1000)])
def test_flash_cross_attention_holds_the_band(int8, B, t_actual):
    """The redesigned K7 (flash-decoding over the kernel's T chunks, the
    chunks combined in the o-product's prologue, probabilities never
    rounded) keeps the unchanged band of its plain version at the card's
    split, with every planted fault outside it."""
    case = DC.cross_ffn_case(B, t_actual, int8, device="cpu")
    want = K7.cross_ffn_step_plain(*case["args"], n_heads=8)
    res = DC.hold(DC.cross_ffn_flash(case, H100_SMS), want, case["args"][0],
                  2, DC.cross_ffn_faults(case, H100_SMS),
                  f"flash cross step B={B}")
    assert res["err"] <= res["band"] and res["nearest_fault"] > 4.0


# ------------------------------------------------------------ whole decode

TINY = j_whisper.WhisperConfig.tiny()
T_TINY = t_whisper.WhisperConfig.tiny()


@pytest.fixture(scope="module")
def decode_setup():
    tp = t_whisper.whisper_init(14, T_TINY)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(15)
    mel = rng.normal(size=(2, 2 * TINY.max_source_positions,
                           TINY.num_mel_bins)).astype(np.float32)
    enc = np.array(j_whisper.whisper_encode(jp, jnp.asarray(mel), TINY,
                                            J_F32))
    return jp, tp, enc


@pytest.mark.parametrize("int8", [False, True])
def test_fused_decode_matches_jax_fused_decode(decode_setup, int8):
    jp, tp, enc = decode_setup
    if int8:
        jp = j_quant_dec(j_whisper.fuse_whisper_decoder_qkv(jp))
        tp = quantize_whisper_decoder(t_whisper.fuse_whisper_decoder_qkv(tp))
    flags = dict(pallas_self_attn=True, pallas_cross=True)
    with pltpu.force_tpu_interpret_mode():
        tok_a, lp_a, ns_a = j_whisper.decode_transcript(
            jp, None, TINY, J_F32, max_len=10, nospeech_id=7,
            enc_out=jnp.asarray(enc), **flags)
    tok_b, lp_b, ns_b = t_whisper.decode_transcript(
        tp, None, T_TINY, T_F32, max_len=10, nospeech_id=7,
        enc_out=torch.from_numpy(enc), **flags)
    np.testing.assert_array_equal(tok_b.numpy(), np.asarray(tok_a))
    atol = 2e-3 if int8 else 1e-5
    np.testing.assert_allclose(lp_b.numpy(), np.asarray(lp_a), atol=atol)
    np.testing.assert_allclose(ns_b.numpy(), np.asarray(ns_a),
                               atol=atol if int8 else 1e-6)


def test_weight_pointers_checks_a_weight_set_once():
    """The decode wrappers' weight pointers are prepared once per weight
    set, prepared anew when a dict holds another leaf, and never kept for
    a set that needed a cast (a cast's memory lives only for its call)."""
    from misinfo_tpu_torch.ops import cuda_build as CB
    a = {"w": torch.zeros(4), "b": torch.ones(2)}
    calls = []

    def prepare():
        calls.append("as is")
        return [(0, "w", a["w"], a["w"]), (0, "b", a["b"], a["b"]),
                (0, "s", None, None)]
    p1, keep = CB.weight_pointers("test", (a,), "cpu", prepare)
    p2, _ = CB.weight_pointers("test", (a,), "cpu", prepare)
    assert p1 == p2 == (a["w"].data_ptr(), a["b"].data_ptr(), None)
    assert calls == ["as is"] and len(keep) == 3
    a["w"] = torch.zeros(4)
    p3, _ = CB.weight_pointers("test", (a,), "cpu", prepare)
    assert len(calls) == 2 and p3[0] == a["w"].data_ptr()

    def cast():
        calls.append("cast")
        return [(0, "w", a["w"], a["w"].double())]
    for _ in range(2):
        _, keep = CB.weight_pointers("cast", (a,), "cpu", cast)
        assert keep[0].dtype == torch.float64
    assert calls.count("cast") == 2
