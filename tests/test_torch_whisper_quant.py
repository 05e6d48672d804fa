"""The port's int8 decode modes held to the JAX package on the CPU: the
int8 streaming decode (``quant=True``) and the fused cross step over int8
merged planes (``cross_int8``, TPU kernel K8 ``_cross_ffn_kernel_i8cc``).

Tiny config, numpy inputs from a seed, every JAX call jitted (as the JAX
decode runs it; XLA then folds ``/ 127.0`` into a multiply by f32(1/127),
which the port's scales follow), Pallas kernels under
``pltpu.force_tpu_interpret_mode()``. Tolerances:

- the int8 caches of ``init_kv_cache`` (``quant`` and ``cross_int8``):
  planes and scales bit for bit, after dropping JAX's padding and the
  [Tp, B] transpose of the merged scales;
- the streaming step's logits within 1e-5 of JAX's in f32 (integer
  products are exact on both sides; f32 sums run in another order), and
  inside JAX's own bands against the exact step: 0.02·max|logit| with int8
  caches only, 0.06·max|logit| with int8 weights too
  (tests/test_whisper_quant.py:66-95);
- the plain K8 against the Pallas kernel: 2e-5 in f32; in bf16
  elementwise 2^-5·max|y − x| plus one bf16 step of the residual at each
  of its two roundings. That is the form of the band of
  tests/test_torch_decode_kernels.py with twice its first term: a bf16
  rounding of h that lands one step apart (the two LayerNorms sum in
  another order) here also moves int8 levels of the query and of the
  probabilities, which are two bf16 steps wide (1/127 against 2^-8). At
  two batch sizes whose V tiles differ (512 and 256 rows) over 1,100
  positions (three and five tiles) and over one ragged tile. The bf16
  scheme of the attention itself is held to one bf16 step of each entry,
  on inputs that take the amplifiers out: rows whose LayerNorm sums are
  exact, and a zero W2, so the output is x + o(ctx);
- whole decodes: tokens equal to JAX's, avg_logprob within 2e-3 (the int8
  bar of tests/test_whisper_parity.py:518-519);
- ``ops/decode_checks.py``'s K8 band rejects each planted fault on the
  CPU, and keeps an emulated right kernel whose probabilities are an ulp
  off.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import whisper as jw
from misinfo_tpu.ops import pallas_cross_ffn as j_k7
from misinfo_tpu.ops import serving as j_serving
from misinfo_tpu.ops.common import DEFAULT_POLICY as J_BF16
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.ops.quant import quantize_dense as j_quantize_dense

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax as P
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.models import whisper as tw
from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import decode_checks as DC
from misinfo_tpu_torch.ops import serving as t_serving
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY as T_BF16
from misinfo_tpu_torch.ops.common import Policy as TPolicy

JP, TP = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())
JCFG, TCFG = jw.WhisperConfig.tiny(), tw.WhisperConfig.tiny()
T_ENC = JCFG.max_source_positions


@pytest.fixture(scope="module")
def model():
    """(jax tree, port tree, their int8 forms, encoder states [2, 64, 64])."""
    tp = tw.whisper_init(21, TCFG)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    jq = j_serving.quantize_whisper_decoder(jw.fuse_whisper_decoder_qkv(jp))
    tq = t_serving.quantize_whisper_decoder(tw.fuse_whisper_decoder_qkv(tp))
    enc = np.random.default_rng(22).normal(
        size=(2, T_ENC, JCFG.d_model)).astype(np.float32)
    return jp, tp, jq, tq, enc


def _jit_cache(jparams, enc, **kw):
    return jax.jit(lambda e: jw.init_kv_cache(jparams, e, 6, JCFG, JP, **kw))(
        jnp.asarray(enc))


@pytest.mark.parametrize("int8_weights", [False, True])
def test_quant_cache_is_bitwise_jax(model, int8_weights):
    jp, tp, jq, tq, enc = model
    jparams, tparams = (jq, tq) if int8_weights else (jp, tp)
    jc = _jit_cache(jparams, enc, quant=True)
    tc = tw.init_kv_cache(tparams, torch.from_numpy(enc), 6, TCFG, TP,
                          quant=True)
    H, Dh = TCFG.num_heads, TCFG.d_model // TCFG.num_heads
    for li in range(TCFG.decoder_layers):
        for n in ("cross_k", "cross_v"):
            assert tc[n][li].dtype == torch.int8
            assert tuple(tc[n][li].shape) == (2, H, T_ENC, Dh)
            np.testing.assert_array_equal(tc[n][li].numpy(),
                                          np.asarray(jc[n][li]))
            sc = tc[f"{n}_scale"][li]
            assert sc.dtype == torch.float32
            assert tuple(sc.shape) == (2, H, T_ENC)
            np.testing.assert_array_equal(sc.numpy(),
                                          np.asarray(jc[f"{n}_scale"][li]))
        assert tuple(tc["self_k"][li].shape) == (2, H, 6, Dh)


def test_cross_int8_cache_is_bitwise_jax(model):
    """JAX pads T to 128 rows and keeps the scales [Tp, B]; the port keeps
    [B, T] and no padding."""
    _, _, jq, tq, enc = model
    jc = _jit_cache(jq, enc, merged_cross=True, cross_int8=True)
    tc = tw.init_kv_cache(tq, torch.from_numpy(enc), 6, TCFG, TP,
                          merged_cross=True, cross_int8=True)
    assert "cross_k_scale" not in tc
    for li in range(TCFG.decoder_layers):
        for n in ("cross_k", "cross_v"):
            plane, sc = tc[n][li], tc[f"{n}_mscale"][li]
            assert plane.dtype == torch.int8 and sc.dtype == torch.float32
            assert tuple(plane.shape) == (2, T_ENC, TCFG.d_model)
            assert tuple(sc.shape) == (2, T_ENC)
            want = np.asarray(jc[n][li])
            assert want.shape[1] == j_k7.cross_cache_pad(T_ENC)
            np.testing.assert_array_equal(plane.numpy(), want[:, :T_ENC])
            np.testing.assert_array_equal(
                sc.numpy(), np.asarray(jc[f"{n}_mscale"][li]).T[:, :T_ENC])


@pytest.mark.parametrize("int8_weights,band", [(False, 0.02), (True, 0.06)])
def test_streaming_step_matches_jax_and_stays_in_jax_bands(model,
                                                           int8_weights, band):
    jp, tp, jq, tq, enc = model
    jparams, tparams = (jq, tq) if int8_weights else (jp, tp)
    je, te = jnp.asarray(enc), torch.from_numpy(enc)
    step = jax.jit(lambda tok, pos, cache: jw._cached_decoder_step(
        jparams, tok, pos, je, cache, JCFG, JP))
    jc = _jit_cache(jparams, enc, quant=True)
    tc = tw.init_kv_cache(tparams, te, 6, TCFG, TP, quant=True)
    exact = tw.init_kv_cache(tw.fuse_whisper_decoder_qkv(tp), te, 6, TCFG, TP)
    toks = np.random.default_rng(23).integers(0, 250, (4, 2))
    for pos in range(4):
        tok = toks[pos].astype(np.int32)
        lj, jc = step(jnp.asarray(tok), jnp.int32(pos), jc)
        lt, tc = tw._cached_decoder_step(tparams, torch.from_numpy(tok), pos,
                                         te, tc, TCFG, TP)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                                   rtol=1e-5)
        l0, exact = tw._cached_decoder_step(
            tw.fuse_whisper_decoder_qkv(tp), torch.from_numpy(tok), pos, te,
            exact, TCFG, TP)
        if pos == 0:        # JAX's bands are stated for the first step
            assert (lt - l0).abs().max() < band * l0.abs().max()
            assert (lt - l0).abs().max() > 0


def _decodes(jparams, tparams, enc, **kw):
    with pltpu.force_tpu_interpret_mode():
        a = jax.jit(lambda e: jw.decode_transcript(
            jparams, None, JCFG, JP, enc_out=e, max_len=10, nospeech_id=7,
            **kw))(jnp.asarray(enc))
    b = tw.decode_transcript(tparams, None, TCFG, TP,
                             enc_out=torch.from_numpy(enc), max_len=10,
                             nospeech_id=7, **kw)
    return [np.asarray(x) for x in a], [x.numpy() for x in b]


@pytest.mark.parametrize("mode", ["quant", "quant_sampled", "cross_int8"])
def test_int8_decodes_match_jax(model, mode):
    _, _, jq, tq, enc = model
    kw = {"quant": dict(quant=True),
          "quant_sampled": dict(quant=True, temperature=0.8),
          "cross_int8": dict(pallas_self_attn=True, pallas_cross=True,
                             cross_int8=True)}[mode]
    if mode == "quant_sampled":
        key = jax.random.PRNGKey(5)
        draws = {i: torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(key, i), (2, JCFG.vocab_size))))
            for i in range(1, 10)}
        with pltpu.force_tpu_interpret_mode():
            a = jax.jit(lambda e: jw.decode_transcript(
                jq, None, JCFG, JP, enc_out=e, max_len=10, nospeech_id=7,
                rng=key, **kw))(jnp.asarray(enc))
        b = tw.decode_transcript(tq, None, TCFG, TP,
                                 enc_out=torch.from_numpy(enc), max_len=10,
                                 nospeech_id=7, gumbel=draws.__getitem__,
                                 **kw)
        (tj, lj, nj), (tt, lt, nt) = ([np.asarray(x) for x in a],
                                      [x.numpy() for x in b])
    else:
        (tj, lj, nj), (tt, lt, nt) = _decodes(jq, tq, enc, **kw)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(lt, lj, atol=2e-3)
    np.testing.assert_allclose(nt, nj, atol=2e-3)


@pytest.mark.parametrize("int8,kw,msg", [
    (False, dict(quant=True, scan_layers=True), "drop scan_layers"),
    (False, dict(quant=True, pallas_cross=True), "unrolled step"),
    (False, dict(quant=True, pallas_self_attn=True), "unrolled step"),
    (False, dict(quant=True, pallas_ffn=True), "unrolled step"),
    (True, dict(cross_int8=True), "requires pallas_cross AND"),
    (False, dict(cross_int8=True, pallas_cross=True), "requires pallas_cross"),
    (True, dict(pallas_cross=True, pallas_ffn=True), "unquantized FFN")])
def test_decode_refuses_what_jax_refuses(model, int8, kw, msg):
    jp, tp, jq, tq, enc = model
    jparams, tparams = (jq, tq) if int8 else (jp, tp)
    with pytest.raises(ValueError, match=msg):
        jw.decode_transcript(jparams, None, JCFG, JP,
                             enc_out=jnp.asarray(enc), max_len=4, **kw)
    with pytest.raises(ValueError, match=msg):
        tw.decode_transcript(tparams, None, TCFG, TP,
                             enc_out=torch.from_numpy(enc), max_len=4, **kw)


@pytest.mark.parametrize("stacked,kw,msg", [
    (False, dict(quant=True, merged_self=True), "unstacked, unmerged"),
    (False, dict(quant=True, merged_cross=True), "unstacked, unmerged"),
    (True, dict(quant=True), "unstacked, unmerged"),
    (False, dict(cross_int8=True), "requires the merged_cross layout")])
def test_init_kv_cache_refuses_what_jax_refuses(model, stacked, kw, msg):
    jp, tp, _, _, enc = model
    if stacked:
        jp, tp = jw.stack_whisper_decoder(jp), tw.stack_whisper_decoder(tp)
    with pytest.raises(ValueError, match=msg):
        jw.init_kv_cache(jp, jnp.asarray(enc), 4, JCFG, JP, **kw)
    with pytest.raises(ValueError, match=msg):
        tw.init_kv_cache(tp, torch.from_numpy(enc), 4, TCFG, TP, **kw)


# ------------------------------------------------------- K8, plain vs Pallas

D, H, F = 128, 2, 256
MODES = {"f32": (JP, TP, jnp.float32, torch.float32),
         "bf16": (J_BF16, T_BF16, jnp.bfloat16, torch.bfloat16)}


def _dense(rng, k, n):
    p = {"kernel": (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
         "bias": (rng.normal(size=n) * 0.1).astype(np.float32)}
    return jax.tree.map(np.asarray, j_quantize_dense(p))


def _ln(rng):
    return {"scale": (1 + 0.1 * rng.normal(size=D)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=D)).astype(np.float32)}


def jax_v_tile(B, T):
    """The tile JAX's wrapper takes for [B, Tp, D] planes (its rule,
    misinfo_tpu/ops/pallas_cross_ffn.py:529-535, on its own constants)."""
    Tp = j_k7.cross_cache_pad(T)
    tile = min(j_k7._TILE, Tp)
    while B * tile * D * 2 * 2 > 6 * 2 ** 20 and tile > 128 \
            and Tp % (tile // 2) == 0:
        tile //= 2
    return Tp, tile


I8CC_SHAPES = [(3, 1100, 1100, 512), (32, 1100, 1000, 256), (3, 200, 170, 256)]


def _plain_and_pallas(mode, B, T, t_actual, tile, attention_only=False):
    """(port's plain K8, JAX's Pallas K8, x) on the same seeded inputs.
    Row scales spread over a decade, so that the K scales, the V fold and
    the per-tile scale all matter; planes padded to JAX's Tp with zero
    rows there, unpadded here.

    ``attention_only`` leaves nothing between the attention and the output
    that amplifies a rounding: x rows are ±2^-6 in balanced numbers, so the
    first LayerNorm's sums are exact in any order and both sides quantize
    the same bf16 h, and W2 and its bias are zero, so the output is
    x + o(ctx) and the second LayerNorm reaches nothing."""
    jpol, tpol, jdt, tdt = MODES[mode]
    rng = np.random.default_rng(B + T)
    Tp, want_tile = jax_v_tile(B, T)
    assert K7.v_tile(B, D, T) == want_tile == tile
    x = rng.normal(size=(B, D)).astype(np.float32)
    lnc, q, o = _ln(rng), _dense(rng, D, D), _dense(rng, D, D)
    ln2, w1, w2 = _ln(rng), _dense(rng, D, F), _dense(rng, F, D)
    if attention_only:
        x = np.stack([rng.permutation(np.repeat([2.0 ** -6, -2.0 ** -6],
                                                D // 2))
                      for _ in range(B)]).astype(np.float32)
        w2 = {**w2, "kernel_q": np.zeros_like(w2["kernel_q"]),
              "bias": np.zeros_like(w2["bias"])}
    kv = (rng.normal(size=(2, B, Tp, D))
          * rng.uniform(0.3, 3.0, size=(2, B, Tp, 1))).astype(np.float32)
    kv[:, :, T:] = 0.0
    (kq, ks), (vq, vs) = (DC.row_quant(torch.from_numpy(p)) for p in kv)
    fn = jax.jit(lambda x, kq, vq, ks, vs: j_k7.fused_cross_ffn_step(
        x, lnc, q, o, ln2, w1, w2, kq, vq, t_actual, n_heads=H, policy=jpol,
        k_scale=ks, v_scale=vs))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(x, jdt), jnp.asarray(kq.numpy()),
                             jnp.asarray(vq.numpy()),
                             jnp.asarray(ks.numpy().T),
                             jnp.asarray(vs.numpy().T)), np.float32)
    xt = torch.from_numpy(x).to(tdt)
    got = K7.fused_cross_ffn_step(
        xt, P(lnc), P(q), P(o), P(ln2), P(w1), P(w2),
        kq[:, :T].contiguous(), vq[:, :T].contiguous(), t_actual, n_heads=H,
        policy=tpol, k_scale=ks[:, :T].contiguous(),
        v_scale=vs[:, :T].contiguous()).float()
    return got, torch.from_numpy(want.copy()), xt.float()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,t_actual,tile", I8CC_SHAPES)
def test_cross_ffn_step_i8cc_plain_matches_pallas(mode, B, T, t_actual, tile):
    got, want, x = _plain_and_pallas(mode, B, T, t_actual, tile)
    err = (got - want).abs()
    if mode == "f32":
        assert err.max() <= 2e-5, err.max()
    else:
        tol = (2.0 ** -5 * (want - x).abs().max()
               + 2 * DC.bf16_ulp(torch.maximum(x.abs(), want.abs())))
        assert bool((err <= tol).all()), (err - tol).max()


@pytest.mark.parametrize("B,T,t_actual,tile", I8CC_SHAPES)
def test_cross_ffn_step_i8cc_bf16_attention_within_one_step(B, T, t_actual,
                                                            tile):
    """The bf16 scheme of the attention itself, held tightly: with the
    amplifiers of the whole step taken out (``attention_only``), x + o(ctx)
    agrees with the Pallas kernel within one bf16 step of each entry (on
    these inputs: bit for bit). The query, the probabilities and their
    scales stay f32 up to their int8 levels in bf16 mode; a bf16 rounding
    of the query or of the probabilities before their quantization, or a
    probability scale per head, lands hundreds of steps away here."""
    got, want, x = _plain_and_pallas("bf16", B, T, t_actual, tile,
                                     attention_only=True)
    assert (want - x).abs().max() > 64 * x.abs().max()     # o(ctx) decides
    err = (got - want).abs()
    step = DC.bf16_ulp(torch.maximum(got.abs(), want.abs()))
    assert bool((err <= step).all()), (err / step).max()


@pytest.mark.parametrize("B,want", [(1, 512), (6, 512), (7, 256), (12, 256),
                                    (13, 128), (32, 128)])
def test_v_tile_is_the_jax_rule_at_whisper_base(B, want):
    assert K7.v_tile(B, 512, 1500) == want
    for T in (1, 100, 128, 300, 500, 512, 513, 1100, 1500, 3000):
        assert K7.cross_cache_pad(T) == j_k7.cross_cache_pad(T)
        Tp = j_k7.cross_cache_pad(T)
        tile = min(j_k7._TILE, Tp)
        while B * tile * 512 * 2 * 2 > 6 * 2 ** 20 and tile > 128 \
                and Tp % (tile // 2) == 0:
            tile //= 2
        assert K7.v_tile(B, 512, T) == tile


H100_SMS = 132          # sets the kernel's chunks and pieces the faults drop


# the chip smoke's K8 cases (B, t_actual, T, V tile), and the two whose last
# attended row is a loud V row too (``loud_last``), so that the kernel's V
# piece holding that row carries planted faults
I8CC_CASES = [pytest.param(B, ta, T, tile, False, id=f"{B}-{ta}-{T}-{tile}")
              for B, ta, T, tile in (
                  (1, 1500, 1500, 512), (4, 1500, 1500, 512),
                  (8, 1400, 1500, 256), (32, 1500, 1500, 128),
                  (3, 280, 300, 384))] + [
    pytest.param(B, ta, T, tile, True, id=f"{B}-{ta}-{T}-{tile}-loud_last")
    for B, ta, T, tile in ((4, 1500, 1500, 512), (3, 280, 300, 384))]


def _last_row_pieces(case, names):
    """The planted faults that leave out the kernel's V piece holding the
    last attended row (whole, or from its tile's s32 sum)."""
    last = case["args"][9] - 1
    out = []
    for n in names:
        m = re.fullmatch(r"V piece \d+ of tile \d+ \(rows (\d+)\.\.(\d+)\) "
                         r"left out.*", n)
        if m and int(m.group(1)) <= last <= int(m.group(2)):
            out.append(n)
    return out


@pytest.mark.parametrize("B,t_actual,T,tile,loud_last", I8CC_CASES)
def test_cross_i8cc_band_rejects_planted_faults(B, t_actual, T, tile,
                                                loud_last):
    """On the CPU the wrapper is the plain version (error 0); what this
    shows is that every emulated wrong kernel leaves the band, at the chip
    smoke's shapes, and that a right kernel whose probabilities are an ulp
    off stays inside it. In the loud_last cases the faults include the V
    piece that holds the last attended row, left out and left out of its
    tile's sum."""
    case = DC.cross_i8cc_case(B, t_actual, device="cpu", T=T,
                              loud_last=loud_last)
    assert case["tile"] == tile
    res = DC.check_cross_i8cc(case, H100_SMS)
    assert res["err"] == 0.0 and res["equal"] == 1.0
    assert res["faults"] >= 7 + (t_actual < T)
    assert res["nearest_fault"] > 3.0
    if loud_last:
        pieces = _last_row_pieces(case, [n for n, _ in DC.cross_i8cc_faults(
            case, H100_SMS)])
        assert len(pieces) == 2, pieces
    args, sc = case["args"], case["scales"]
    want = K7.cross_ffn_step_i8cc_plain(*args, n_heads=8, **sc)
    x, probs, tail = DC._i8cc_parts(case)
    slack, _ = DC.i8cc_level_slack(case)
    for nudge in (1 + 2.0 ** -22, 1 - 2.0 ** -22):
        near = DC._i8cc_finish(x, K7.i8cc_context(
            probs * nudge, args[8], sc["v_scale"], tile, 8), tail)
        DC.hold(near, want, x, 2, [], "probabilities an ulp off", slack)


@pytest.mark.parametrize("B,t_actual,T,tile,loud_last", I8CC_CASES)
def test_cross_i8cc_chunked_order_stays_in_the_band(B, t_actual, T, tile,
                                                    loud_last):
    """The CUDA kernel's order (``decode_checks.cross_i8cc_chunked``: the
    softmax's max and exp-sum merged from the T chunks in chunk order,
    each V tile's scale over the whole tile) against the plain version,
    within the unchanged band; and the kernel's new edges among the
    planted faults (a chunk left out of the merge, a piece's scale over
    its own rows, a piece left out of its tile's sum)."""
    case = DC.cross_i8cc_case(B, t_actual, device="cpu", T=T,
                              loud_last=loud_last)
    assert case["tile"] == tile
    args, sc = case["args"], case["scales"]
    want = K7.cross_ffn_step_i8cc_plain(*args, n_heads=8, **sc)
    slack, _ = DC.i8cc_level_slack(case)
    got = DC.cross_i8cc_chunked(case, H100_SMS)
    DC.hold(got, want, args[0], 2, [], "the chunked int8-plane order", slack)
    names = [n for n, _ in DC.cross_i8cc_faults(case, H100_SMS)]
    assert any("(m, l) merge" in n for n in names)
    assert any("over its own" in n for n in names)
    assert any("left out of the tile's sum" in n for n in names)


def test_level_slack_covers_a_probability_at_a_rounding_boundary():
    """One entry placed on a rounding boundary: an ulp moves its level,
    the slack is what that level moves y, and the nudged output stays in
    the widened band."""
    case = DC.cross_i8cc_case(2, 300, device="cpu", T=300)
    args, sc, tile = case["args"], case["scales"], case["tile"]
    x, probs, tail = DC._i8cc_parts(case)
    vs = sc["v_scale"]
    # a V row scale that puts position 3's largest entry on level 100.5
    # (the other heads' stay below it, so the tile's scale does not move)
    pv = probs[:, :, :tile] * vs[:, None, :tile]
    sp = K7.i8cc_tile_scale(pv)[0, 0, 0]
    vs[0, 3] = 100.5 * sp / probs[0, :, 3].max()
    slack, edges = DC.i8cc_level_slack(case)
    assert edges >= 1 and slack[0].max() > 0
    want = K7.cross_ffn_step_i8cc_plain(*args, n_heads=8, **sc)
    outs = [DC._i8cc_finish(x, K7.i8cc_context(
        probs * n, args[8], vs, tile, 8), tail)
        for n in (1 + 2.0 ** -21, 1 - 2.0 ** -21)]
    for near in outs:
        DC.hold(near, want, x, 2, [], "a level at its boundary", slack)
