"""The port's transcriber (serve/transcript.py) held to the JAX package's.

- ``needs_fallback``: equal verdicts on the same inputs.
- The temperature ladder, best_of and the silence rule: both transcribers
  fed the same fixed decode outputs keep the same window texts.
- End to end: a tiny Whisper trained in JAX to say "hello world" for a
  two-tone WAV (as tests/test_transcript_e2e.py:43-109 trains it) crosses
  into the port through checkpoints/from_jax.py, and the port's
  ``transcribe(wav)`` returns exactly "hello world" — in the CPU default,
  through the fused-step plain kernels, with int8 decoder weights, and in
  the int8 streaming mode (``quant="int8"``: int8 weights, embedding and
  cross caches through the unfused step).
"""

import dataclasses
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.core.config import WhisperDecodeConfig as JDecodeConfig
from misinfo_tpu.models import whisper as jw
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.preprocess.audio import log_mel_spectrogram, pad_or_trim_mel
from misinfo_tpu.preprocess.whisper_tokenizer import ByteWhisperTokenizer
from misinfo_tpu.serve import transcript as j_tr

from misinfo_tpu_torch.core.config import WhisperDecodeConfig
from misinfo_tpu_torch.models import whisper as tw
from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import self_attn_step as K6
from misinfo_tpu_torch.serve import transcript as t_tr

TEXT = "hello world"
SR = 16000


@pytest.mark.parametrize("text,lp", [
    ("a normal varied sentence of words", -0.3),
    ("la la la la la la la la la la la la la la " * 20, -0.3),
    ("a normal varied sentence of words", -1.5),
    ("", -0.3), ("", -1.2), ("abcabcabcabcabcabcabcabcabcabcabcabc", -0.9)])
def test_needs_fallback_matches_jax(text, lp):
    assert t_tr.needs_fallback(text, lp) == j_tr.needs_fallback(text, lp)
    assert (t_tr.needs_fallback(text, lp, 1.5, -2.0)
            == j_tr.needs_fallback(text, lp, 1.5, -2.0))


def _ids(tok, texts, length=48):
    out = np.full((len(texts), length), tok.specials.eot, np.int32)
    for i, t in enumerate(texts):
        ids = [tok.specials.sot] + tok.encode(t)
        out[i, :len(ids)] = ids
    return out


# per call, in ladder order: (texts per window slot, avg_logprobs)
_CALLS = [
    (["hello world", "la " * 12, "quiet", "pad"], [-0.2, -0.2, -1.5, -0.1]),
    (["hi there", "la la la la la la la la", "still quiet", "pad"],
     [-0.5, -0.4, -1.4, -0.1]),
    (["hey", "one two three four", "nothing", "pad"], [-0.4, -0.6, -1.2, 0.0]),
    (["yo", "five six seven", "zero", "pad"], [-0.3, -0.7, -1.3, 0.0]),
] + [(["a b c d", "e f g h", "i j k l", "pad"], [-0.9, -0.9, -1.1, 0.0])] * 12
_NO_SPEECH = np.array([0.1, 0.9, 0.8, 0.0], np.float32)


def test_ladder_and_silence_rule_match_jax():
    """Window 0 passes greedily; window 1 loops (too compressible) and is
    retried with best_of = 2 draws, the better one kept; window 2 stays
    below the logprob threshold to the last rung and is dropped by the
    silence rule (p(nospeech) 0.8 > 0.6)."""
    tok = ByteWhisperTokenizer()
    calls = {"jax": 0, "torch": 0}

    def fake(side):
        texts, lp = _CALLS[calls[side]]
        calls[side] += 1
        return _ids(tok, texts), np.array(lp, np.float32), _NO_SPEECH

    dc = dict(best_of=2, fallback_temperatures=(0.0, 0.2, 0.5, 1.0))
    tr_j = j_tr.WhisperTranscriber(
        None, size="tiny",
        decode_cfg=dataclasses.replace(JDecodeConfig(), **dc))
    tr_j._fns = (lambda p, m: m, lambda p, e, pr: fake("jax"),
                 lambda p, e, pr, t, r: fake("jax"), None)
    tr_t = t_tr.WhisperTranscriber(
        size="tiny", device="cpu",
        decode_cfg=dataclasses.replace(WhisperDecodeConfig(), **dc))
    tr_t._encode = lambda mels: mels
    tr_t._decode = lambda enc, prompt, t=0.0, rng=None: tuple(
        torch.from_numpy(a) for a in fake("torch"))
    mels = np.zeros((3, 8, 80), np.float32)
    got = tr_t._decode_window_batch(mels, "en")
    want = tr_j._decode_window_batch(mels, "en")
    assert got == want == ["hello world", "la la la la la la la la"]
    assert calls["torch"] == calls["jax"] == 1 + 2 * 3


def test_mode_resolution_on_the_cpu():
    tr = t_tr.WhisperTranscriber(size="tiny", device="cpu")
    assert (tr.pallas, tr.quant_kernels, tr.quant_embedding) == (False,) * 3
    assert not tr.has_weights and tr.transcribe("/nonexistent.wav") == ""
    dcfg = WhisperDecodeConfig()
    for kw, err in ((dict(quant="in8"), "WHISPER_QUANT"),
                    (dict(pallas="yes"), "WHISPER_PALLAS"),
                    (dict(pallas="on", quant="int8"), "pallas")):
        with pytest.raises(ValueError, match=err):
            t_tr.WhisperTranscriber(size="tiny", device="cpu",
                                    decode_cfg=dataclasses.replace(dcfg, **kw))
    # the int8 streaming mode: "auto" kernels resolve off beside it
    tr = t_tr.WhisperTranscriber(size="tiny", device="cpu",
                                 decode_cfg=dataclasses.replace(
                                     dcfg, quant="int8"))
    assert (tr.quant, tr.pallas, tr.quant_kernels) == (True, False, False)
    assert tr.params["decoder"]["token_embedding_q"].dtype == torch.int8
    # a checkpoint path that holds nothing: no weights, as in JAX
    assert not t_tr.WhisperTranscriber(checkpoint_dir="ckpt", size="tiny",
                                       device="cpu").has_weights


def test_big_window_batches_decode_unfused(monkeypatch):
    """The fused-step kernels carry at most MAX_BATCH rows; a bigger
    window batch takes the unfused step, as the JAX transcriber's
    ``use_pallas`` sends big buckets to its XLA path."""
    tr = t_tr.WhisperTranscriber(size="tiny", device="cpu",
                                 decode_cfg=dataclasses.replace(
                                     WhisperDecodeConfig(), pallas="on"))
    seen = []
    monkeypatch.setattr(t_tr, "decode_transcript", lambda *a, **kw: seen.append(
        (kw["pallas_self_attn"], kw["pallas_cross"])))
    for b in (1, K6.MAX_BATCH, K6.MAX_BATCH + 1):
        tr._decode(torch.zeros(b, 4, tr.cfg.d_model), None)
    assert seen == [(True, True), (True, True), (False, False)]
    assert K6.MAX_BATCH == K7.MAX_BATCH


# ------------------------------------------------------------- end to end

def _make_audio() -> np.ndarray:
    t = np.arange(int(1.28 * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * 440.0 * t)
            + 0.3 * np.sin(2 * np.pi * 660.0 * t)).astype(np.float32)


def _write_wav(path, audio):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny Whisper trained in JAX to map the two-tone WAV to TEXT (the
    recipe of tests/test_transcript_e2e.py), as a numpy tree + config."""
    import optax

    f32 = JPolicy(JPrecision.highest())
    tok = ByteWhisperTokenizer()
    sp = tok.specials
    widths = dict(vocab_size=sp.vocab_size, num_mel_bins=80, d_model=64,
                  encoder_layers=2, decoder_layers=2, num_heads=4,
                  ffn_dim=128, max_source_positions=64,
                  max_target_positions=32, eos_token_id=sp.eot,
                  decoder_start_token_id=sp.sot)
    cfg = jw.WhisperConfig(**widths)
    audio = _make_audio()
    mel = jnp.asarray(pad_or_trim_mel(log_mel_spectrogram(audio),
                                      2 * cfg.max_source_positions)[None])
    target = tok.sot_sequence() + tok.encode(TEXT) + [sp.eot]
    toks = np.full((1, cfg.max_target_positions), sp.eot, np.int32)
    toks[0, :len(target)] = target
    inp, lbl = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    weight = jnp.asarray((np.arange(cfg.max_target_positions - 1)
                          < len(target) - 1)[None].astype(np.float32))
    params = jw.whisper_init(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(3e-3)
    state = opt.init(params)

    def loss_fn(p):
        logits = jw.whisper_decode_step(
            p, inp, jw.whisper_encode(p, mel, cfg, f32), cfg, f32)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1),
                                   lbl[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * weight) / jnp.sum(weight)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, loss

    for _ in range(250):
        params, state, loss = step(params, state)
        if float(loss) < 0.01:
            break
    assert float(loss) < 0.5, f"tiny whisper failed to memorize ({loss})"
    tmp = tmp_path_factory.mktemp("torch_transcript")
    wav = tmp / "speech.wav"
    _write_wav(wav, audio)
    long_wav = tmp / "speech_3x.wav"
    _write_wav(long_wav, np.tile(audio, 3))
    return (jax.tree.map(np.asarray, params), tw.WhisperConfig(**widths),
            str(wav), str(long_wav))


@pytest.mark.parametrize("decode", [
    {}, {"pallas": "on"}, {"pallas": "on", "quant": "kernels"},
    {"quant": "kernels"}, {"quant": "embedding", "pallas": "on"},
    {"quant": "int8"}])
def test_port_transcribes_the_jax_trained_model(trained, decode):
    params, cfg, wav, _ = trained
    tr = t_tr.WhisperTranscriber(
        params, config=cfg, device="cpu",
        decode_cfg=dataclasses.replace(WhisperDecodeConfig(), **decode))
    assert tr.has_weights and tr.tokenizer_compatible
    assert tr.pallas == (decode.get("pallas") == "on")
    assert tr.quant_kernels == (decode.get("quant") == "kernels")
    assert tr.quant == (decode.get("quant") == "int8")
    if tr.quant_kernels or tr.quant:
        blk = tr.params["decoder"]["blocks"][0]
        assert blk["self_attn"]["qkv"]["kernel_q"].dtype == torch.int8
    seen, int8_caches = [], []
    real = tw._cached_decoder_step

    def spy(*a, **kw):
        seen.append(kw.get("pallas_cross", False))
        int8_caches.append("cross_k_scale" in a[4]
                           and a[4]["cross_k"][0].dtype == torch.int8)
        return real(*a, **kw)
    tw._cached_decoder_step = spy
    try:
        before = (K6.launches, K7.launches)
        assert tr.transcribe(wav) == TEXT
    finally:
        tw._cached_decoder_step = real
    assert tr.last_language == "en"
    assert (K6.launches, K7.launches) == before     # CPU: plain versions
    # four heads of 16: the fused step's kernels take 64-wide heads only,
    # so even pallas="on" decodes unfused, as JAX's use_pallas sends this
    # model to its XLA path
    assert not t_tr._fused_step(cfg, 1)
    assert not any(seen)
    # the first call is detect_language's SOT step, on a cache of its own
    assert all(int8_caches[1:]) == any(int8_caches) == tr.quant
    assert not int8_caches[0] and len(int8_caches) > 1


def test_port_transcribes_every_window_and_merges_caption(trained):
    params, cfg, wav, long_wav = trained
    tr = t_tr.WhisperTranscriber(params, config=cfg, device="cpu")
    assert tr.transcribe(long_wav) == " ".join([TEXT] * 3)
    assert (t_tr.merge_into_caption("user caption", wav, tr)
            == f"user caption\n\n{TEXT}")
    assert t_tr.merge_into_caption("user caption", None, tr) == "user caption"
    mels = tr._window_mels(np.tile(_make_audio(), 5))
    assert mels.shape == (5, 2 * cfg.max_source_positions, 80)


def test_module_transcriber_without_weights_keeps_the_caption(trained,
                                                             monkeypatch):
    """The module-cached transcriber (reference _extract_transcript) is
    built on the card and has no weights until checkpoint loading is
    ported, so it transcribes to "" and the caption stays as it was — the
    reference's soft-fail. Here it is built on the CPU in its place; with
    no card at all its construction fails, and the caption stays too."""
    _, _, wav, _ = trained
    monkeypatch.setenv("WHISPER_MODEL", "tiny")
    real = t_tr.WhisperTranscriber
    asked = []

    def on_cpu(**kw):
        asked.append(kw.get("device", "cuda"))
        return real(**{**kw, "device": "cpu"})
    if not torch.cuda.is_available():
        t_tr.reset_transcriber()
        try:
            assert t_tr._get_engine() is None
            assert t_tr.merge_into_caption("caption", wav) == "caption"
        finally:
            t_tr.reset_transcriber()
    monkeypatch.setattr(t_tr, "WhisperTranscriber", on_cpu)
    t_tr.reset_transcriber()
    try:
        assert t_tr.extract_transcript(wav) == ""
        assert t_tr.merge_into_caption("caption", wav) == "caption"
        assert t_tr._get_engine().has_weights is False
        assert asked == ["cuda"]
        monkeypatch.setenv("WHISPER_CHECKPOINT", "ckpt")   # holds nothing
        t_tr.reset_transcriber()
        assert t_tr._get_engine().has_weights is False
        assert t_tr.extract_transcript(wav) == ""
    finally:
        t_tr.reset_transcriber()
