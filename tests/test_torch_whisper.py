"""The port's Whisper (models/whisper.py) held to the JAX package in f32 at
the tiny config (``WhisperConfig.tiny()``, the ``TINY`` of
tests/test_whisper_parity.py).

The port's seeded init goes to both sides as the same numbers; inputs are
numpy arrays from a seed. Tolerances: encoder and decoder activations
and logits within 1e-4 (f32 sums in another order); decoded tokens equal,
avg_logprob within 1e-5 and p(nospeech) within 1e-6 (the JAX tests' own
bars, tests/test_whisper_parity.py:447-449); with int8 decoder weights
tokens equal and avg_logprob within 2e-3 (:518-519). The stacked-layer scan
decode is refused by name, with the flag or with stacked params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import whisper as jw
from misinfo_tpu.ops.common import DEFAULT_POLICY as J_BF16
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.ops import serving as j_serving

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.models import whisper as tw
from misinfo_tpu_torch.ops import serving as t_serving
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY as T_BF16
from misinfo_tpu_torch.ops.common import Policy as TPolicy

JP, TP = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())
JCFG, TCFG = jw.WhisperConfig.tiny(), tw.WhisperConfig.tiny()
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    """(jax tree, port tree, mel [2, 128, 16], encoder states [2, 64, 64])."""
    tp = tw.whisper_init(3, TCFG)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(4)
    mel = rng.normal(size=(2, 2 * JCFG.max_source_positions,
                           JCFG.num_mel_bins)).astype(np.float32)
    enc = np.array(jw.whisper_encode(jp, jnp.asarray(mel), JCFG, JP))
    return jp, tp, mel, enc


def _np(t):
    return t.float().numpy()


def test_whisper_config_and_tree_match_jax():
    for make in (lambda m: m.WhisperConfig(), lambda m: m.WhisperConfig.tiny()):
        assert make(tw).__dict__ == make(jw).__dict__
    np.testing.assert_array_equal(tw.sinusoidal_positions(50, 16),
                                  jw.sinusoidal_positions(50, 16))
    shapes = jax.eval_shape(lambda: jw.whisper_init(jax.random.PRNGKey(0),
                                                    JCFG))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tw.whisper_init(0, TCFG)))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [v.shape for _, v in got] == [v.shape for _, v in want]


def test_whisper_encoder_f32_matches_jax(model):
    jp, tp, mel, enc = model
    got = tw.whisper_encode(tp, torch.from_numpy(mel), TCFG, TP)
    np.testing.assert_allclose(_np(got), enc, atol=TOL, rtol=TOL)


def test_whisper_prefix_decoder_f32_matches_jax(model):
    jp, tp, _, enc = model
    toks = np.random.default_rng(5).integers(0, 250, (2, 9)).astype(np.int32)
    want = jw.whisper_decode_step(jp, jnp.asarray(toks), jnp.asarray(enc),
                                  JCFG, JP)
    got = tw.whisper_decode_step(tp, torch.from_numpy(toks),
                                 torch.from_numpy(enc), TCFG, TP)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_cached_step_f32_matches_jax(model, fused_qkv):
    jp, tp, _, enc = model
    if fused_qkv:
        jp, tp = jw.fuse_whisper_decoder_qkv(jp), tw.fuse_whisper_decoder_qkv(tp)
    jc = jw.init_kv_cache(jp, jnp.asarray(enc), 6, JCFG, JP)
    tc = tw.init_kv_cache(tp, torch.from_numpy(enc), 6, TCFG, TP)
    np.testing.assert_allclose(_np(tc["cross_k"][1]),
                               np.asarray(jc["cross_k"][1]), atol=TOL)
    toks = np.random.default_rng(6).integers(0, 250, (4, 2))
    for pos in range(4):
        tok = toks[pos].astype(np.int32)
        lj, jc = jw._cached_decoder_step(jp, jnp.asarray(tok), pos,
                                         jnp.asarray(enc), jc, JCFG, JP)
        lt, tc = tw._cached_decoder_step(tp, torch.from_numpy(tok), pos,
                                         torch.from_numpy(enc), tc, TCFG, TP)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=TOL,
                                   rtol=TOL)
    for n in ("self_k", "self_v"):
        np.testing.assert_allclose(_np(tc[n][0]), np.asarray(jc[n][0]),
                                   atol=TOL)


def _decodes(jp, tp, enc, prompt=None, rng=None, gumbel=None, **kw):
    """The same decode on both sides; ``rng`` is JAX's key, ``gumbel``
    the port's per-step noise."""
    pj = None if prompt is None else jnp.asarray(prompt)
    pt = None if prompt is None else torch.from_numpy(prompt)
    a = jw.decode_transcript(jp, None, JCFG, JP, enc_out=jnp.asarray(enc),
                             prompt_tokens=pj, rng=rng, **kw)
    b = tw.decode_transcript(tp, None, TCFG, TP, enc_out=torch.from_numpy(enc),
                             prompt_tokens=pt, gumbel=gumbel, **kw)
    return [np.asarray(x) for x in a], [x.numpy() for x in b]


@pytest.mark.parametrize("prompt", [None, np.array([[5, 6, 7], [8, 9, 10]],
                                                   np.int32)])
def test_greedy_decode_matches_jax(model, prompt):
    jp, tp, _, enc = model
    (tj, lj, nj), (tt, lt, nt) = _decodes(jp, tp, enc, prompt, max_len=14,
                                          nospeech_id=7)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    np.testing.assert_allclose(nt, nj, atol=1e-6)


def test_sampled_rung_with_jax_noise_matches(model):
    """The decode's noise is a tensor the step receives: handed JAX's
    gumbel draws (folded in per step index), it picks JAX's tokens."""
    jp, tp, _, enc = model
    key = jax.random.PRNGKey(11)
    V = JCFG.vocab_size
    draws = {i: torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.fold_in(key, i), (2, V)))) for i in range(1, 14)}
    (tj, lj), (tt, lt) = _decodes(jp, tp, enc, max_len=14, temperature=0.9,
                                  rng=key, gumbel=draws.__getitem__)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    assert len(set(tt[0].tolist())) > 3       # sampling, not a fixed point


def test_int8_decoder_weights_decode_matches_jax(model):
    """quant="kernels" params through the unfused step: every int8 dense
    takes the plain dense_int8 (B rows < 256), as JAX's dispatch does."""
    jp, tp, _, enc = model
    jq = j_serving.quantize_whisper_decoder(jw.fuse_whisper_decoder_qkv(jp))
    tq = t_serving.quantize_whisper_decoder(tw.fuse_whisper_decoder_qkv(tp))
    (tj, lj, nj), (tt, lt, nt) = _decodes(jq, tq, enc, max_len=12,
                                          nospeech_id=7)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(lt, lj, atol=2e-3)
    np.testing.assert_allclose(nt, nj, atol=2e-3)


def test_detect_language_and_no_speech_match_jax(model):
    jp, tp, _, enc = model
    ids = list(range(100, 140))
    for p_j, p_t in ((jp, tp),
                     (j_serving.quantize_whisper_decoder(
                         jw.fuse_whisper_decoder_qkv(jp)),
                      t_serving.quantize_whisper_decoder(
                          tw.fuse_whisper_decoder_qkv(tp)))):
        ij, pj = jw.detect_language(p_j, jnp.asarray(enc), 254,
                                    jnp.asarray(ids, jnp.int32), JCFG, JP)
        it, pt = tw.detect_language(p_t, torch.from_numpy(enc), 254, ids,
                                    TCFG, TP)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
        nj = jw.no_speech_prob(p_j, jnp.asarray(enc), 254, 7, JCFG, JP)
        nt = tw.no_speech_prob(p_t, torch.from_numpy(enc), 254, 7, TCFG, TP)
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)


@pytest.mark.parametrize("transform", ["serving_bf16", "int8_decoder",
                                       "int8_embedding"])
def test_weight_bridge_whisper_tree(transform):
    """A JAX Whisper tree — plain, after the bf16 serving cast, or with
    int8 leaves — crosses into the port leaf for leaf, and equals the
    port's own transform of the bridged plain tree."""
    jtree = jw.whisper_init(jax.random.PRNGKey(1), JCFG)
    if transform == "serving_bf16":
        fj = lambda t: j_serving.optimize_whisper_for_serving(  # noqa: E731
            t, J_BF16, min_elems=1)
        ft = lambda t: t_serving.optimize_whisper_for_serving(  # noqa: E731
            t, T_BF16, min_elems=1)
    elif transform == "int8_decoder":
        fj = lambda t: j_serving.quantize_whisper_decoder(  # noqa: E731
            jw.fuse_whisper_decoder_qkv(t))
        ft = lambda t: t_serving.quantize_whisper_decoder(  # noqa: E731
            tw.fuse_whisper_decoder_qkv(t))
    else:
        fj = j_serving.quantize_whisper_embedding
        ft = t_serving.quantize_whisper_embedding
    want = jax.tree.map(np.asarray, fj(jtree))
    bridged = params_from_jax(want)
    mine = ft(params_from_jax(jax.tree.map(np.asarray, jtree)))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for got in (bridged, mine):
        flat_g = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.float().numpy() if t.is_floating_point()
                         else t.numpy(), got))[0]
        assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
        for (k, a), (_, b) in zip(flat_w, flat_g):
            np.testing.assert_array_equal(b, np.asarray(a, b.dtype), str(k))
    if transform == "int8_decoder":
        blk = bridged["decoder"]["blocks"][0]
        assert blk["self_attn"]["qkv"]["kernel_q"].dtype == torch.int8
        assert blk["cross_attn"]["k"]["kernel"].dtype == torch.float32


def test_options_not_carried_are_refused(model):
    """What the port still refuses by name, and JAX's order rule for the
    qkv fuse. (``quant``, ``cross_int8`` and ``pallas_layer`` were
    refused here once; their parity cases are in
    tests/test_torch_whisper_quant.py and tests/test_torch_layer_step.py.)"""
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    _, tp, _, enc = model
    for kw, item in ((dict(checkpoint_dir="ckpt"), "M16"),
                     (dict(mesh=object()), "M17")):
        with pytest.raises(NotImplementedError, match=item):
            WhisperTranscriber(size="tiny", device="cpu", **kw)
    with pytest.raises(ValueError, match="AFTER"):
        tw.fuse_whisper_decoder_qkv(t_serving.quantize_whisper_decoder(tp))


def stacked_like(tp):
    """Port params in the stacked layout's shape: ``blocks_stacked`` in
    place of ``blocks`` (what the refusal looks at)."""
    dec = {k: v for k, v in tp["decoder"].items() if k != "blocks"}
    return {**tp, "decoder": {**dec, "blocks_stacked": {}}}


@pytest.mark.parametrize("how", ["flag", "stacked_params", "stacked_cache"])
def test_scan_layers_is_refused_by_name(model, how):
    """JAX's scan over stacked [L, ...] leaves runs no kernel, and the
    port's Python loop over the blocks is that decode already."""
    _, tp, _, enc = model
    e = torch.from_numpy(enc)
    with pytest.raises(NotImplementedError, match="scan_layers.*M13"):
        if how == "flag":
            tw.decode_transcript(tp, None, TCFG, TP, enc_out=e, max_len=4,
                                 scan_layers=True)
        elif how == "stacked_params":
            tw.decode_transcript(stacked_like(tp), None, TCFG, TP, enc_out=e,
                                 max_len=4)
        else:
            tw.init_kv_cache(stacked_like(tp), e, 4, TCFG, TP)
    assert not hasattr(tw, "stack_whisper_decoder")


@pytest.mark.parametrize("kw,msg", [
    (dict(scan_layers=True, pallas_cross=True), "scan_layers decoding does"),
    (dict(scan_layers=True, pallas_self_attn=True), "scan_layers decoding"),
    (dict(scan_layers=True, pallas_ffn=True), "scan_layers decoding does"),
    (dict(scan_layers=True, quant=True), "drop scan_layers"),
    (dict(scan_layers=True, int8=True), "drop scan_layers"),
    (dict(scan_layers=True, int8="embedding"), "int8 token embedding"),
    (dict(unroll=0), "unroll must be in"),
    (dict(unroll=5), "unroll must be in")])
def test_scan_and_unroll_refuse_what_jax_refuses(model, kw, msg):
    """Where JAX refuses a combination with ``scan_layers``, the port
    refuses too (it refuses ``scan_layers`` itself, by name); ``unroll``
    out of range raises JAX's ValueError."""
    jp, tp, _, enc = model
    kw = dict(kw)
    int8 = kw.pop("int8", False)
    if int8 == "embedding":
        jp = j_serving.quantize_whisper_embedding(jp)
        tp = t_serving.quantize_whisper_embedding(tp)
    elif int8:
        jp = j_serving.quantize_whisper_decoder(jw.fuse_whisper_decoder_qkv(jp))
        tp = t_serving.quantize_whisper_decoder(tw.fuse_whisper_decoder_qkv(tp))
    with pytest.raises(ValueError, match=msg):
        jw.decode_transcript(jp, None, JCFG, JP, enc_out=jnp.asarray(enc),
                             max_len=4, **kw)
    exc, match = port_refusal(kw, msg)
    with pytest.raises(exc, match=match):
        tw.decode_transcript(tp, None, TCFG, TP,
                             enc_out=torch.from_numpy(enc), max_len=4, **kw)


def port_refusal(kw, msg):
    """(exception, match) of the port for a combination JAX refuses with
    ``msg``: JAX's ValueError, except that ``scan_layers`` is refused by
    name before anything else."""
    if kw.get("scan_layers"):
        return NotImplementedError, "scan_layers"
    return ValueError, msg


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_unroll_is_accepted_and_changes_nothing(model, unroll):
    """JAX's contract for ``unroll`` is bit-identical outputs; the port's
    loop is Python, so the argument is validated and nothing else."""
    jp, tp, _, enc = model
    (tj, lj), (tt, lt) = _decodes(jp, tp, enc, max_len=9, unroll=unroll)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    base = tw.decode_transcript(tp, None, TCFG, TP, max_len=9,
                                enc_out=torch.from_numpy(enc))
    np.testing.assert_array_equal(tt, base[0].numpy())
    np.testing.assert_array_equal(lt, base[1].numpy())


def test_pallas_ffn_decode_matches_jax(model, monkeypatch):
    """``pallas_ffn=True``: every decoder layer's FFN through the fused FFN
    (K5; its plain version on the CPU, erf GELU in f32) against JAX's
    Pallas FFN in interpret mode: tokens equal, avg_logprob within 1e-5."""
    from jax.experimental.pallas import tpu as pltpu
    from misinfo_tpu_torch.ops import fused_ffn as K5
    calls = []
    plain = K5.fused_ffn_plain
    monkeypatch.setattr(K5, "fused_ffn_plain", lambda *a, **kw: calls.append(
        kw["mode"]) or plain(*a, **kw))
    jp, tp, _, enc = model
    with pltpu.force_tpu_interpret_mode():
        (tj, lj), (tt, lt) = _decodes(jp, tp, enc, max_len=10,
                                      pallas_ffn=True)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    assert calls and set(calls) == {"erf"}
    assert len(calls) % TCFG.decoder_layers == 0


def test_pallas_ffn_refuses_what_jax_refuses(model):
    jp, tp, _, enc = model
    jq = j_serving.quantize_whisper_decoder(jw.fuse_whisper_decoder_qkv(jp))
    tq = t_serving.quantize_whisper_decoder(tw.fuse_whisper_decoder_qkv(tp))
    for (p_j, p_t), kw, msg in (((jp, tp), dict(pallas_cross=True),
                                 "subsumes the FFN"),
                                ((jp, tp), dict(quant=True), "composes only"),
                                ((jq, tq), {}, "unquantized FFN")):
        with pytest.raises(ValueError, match=msg):
            jw.decode_transcript(p_j, None, JCFG, JP,
                                 enc_out=jnp.asarray(enc), max_len=4,
                                 pallas_ffn=True, **kw)
        with pytest.raises(ValueError, match=msg):
            tw.decode_transcript(p_t, None, TCFG, TP,
                                 enc_out=torch.from_numpy(enc), max_len=4,
                                 pallas_ffn=True, **kw)
