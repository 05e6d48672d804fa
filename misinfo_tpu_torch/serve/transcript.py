"""Whisper transcript extraction for the dashboard (C13, reference
forensics_dashboard.py:18-87), in PyTorch.

Counterpart of ``misinfo_tpu/serve/transcript.py``, with the same
soft-fail contract: the transcript text, ``""`` when the capability is
unavailable (no weights / no audio decoder / detected silence), or a
bracketed ``[transcript error: ...]`` string on failure.

End-to-end path: audio decode (ffmpeg, or the stdlib WAV reader) →
log-mel → one encoder pass per window batch → language resolution →
temperature-fallback ladder sharing that encoding, with the no-speech
probability captured from the first rung's position-0 step → byte-level
BPE decode. On a CUDA device the decode runs each decoder layer as the two
fused step kernels with int8 weights (``pallas="auto"`` → on,
``quant="auto"`` → ``"kernels"``); on the CPU both resolve off.
``quant="int8"`` is the int8 streaming decode: int8 decoder weights and
token embedding, int8 cross caches, the unfused step (``pallas="auto"``
resolves off with it, and ``pallas="on"`` refuses it).

Weights come as a JAX-layout parameter tree of numpy arrays
(checkpoints/from_jax.py); orbax checkpoints and HF ``.pt`` conversion
are not ported yet (ROADMAP.md M16), nor mesh sharding (M17), the AOT /
compile-cache plumbing and the isolated host-prep worker.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax, to_device
from misinfo_tpu_torch.core.config import WhisperDecodeConfig
from misinfo_tpu_torch.models.whisper import (
    WhisperConfig, decode_transcript, detect_language,
    fuse_whisper_decoder_qkv, whisper_encode, whisper_init)
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY, set_exact_f32
from misinfo_tpu_torch.ops.self_attn_step import MAX_BATCH
from misinfo_tpu_torch.ops.serving import (
    optimize_whisper_for_serving, quantize_whisper_decoder,
    quantize_whisper_embedding)
from misinfo_tpu_torch.preprocess.audio import (
    HOP_LENGTH, mel_windows, prep_mel_windows)
from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
    load_whisper_tokenizer)

_log = logging.getLogger(__name__)

_SIZES = {
    "tiny": dict(d_model=384, encoder_layers=4, decoder_layers=4, num_heads=6,
                 ffn_dim=1536),
    "base": dict(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8,
                 ffn_dim=2048),
    "small": dict(d_model=768, encoder_layers=12, decoder_layers=12,
                  num_heads=12, ffn_dim=3072),
    "medium": dict(d_model=1024, encoder_layers=24, decoder_layers=24,
                   num_heads=16, ffn_dim=4096),
    "large": dict(d_model=1280, encoder_layers=32, decoder_layers=32,
                  num_heads=20, ffn_dim=5120),
}

_DECODE_DEFAULTS = WhisperDecodeConfig()


def needs_fallback(text: str, avg_logprob: float,
                   compression_ratio_threshold: float =
                   _DECODE_DEFAULTS.compression_ratio_threshold,
                   logprob_threshold: float =
                   _DECODE_DEFAULTS.logprob_threshold) -> bool:
    """whisper/transcribe.py acceptance test: retry when the transcript
    compresses too well (token loops) or the mean token log-prob is low."""
    raw = text.encode("utf-8")
    if raw:
        ratio = len(raw) / max(len(zlib.compress(raw)), 1)
        if ratio > compression_ratio_threshold:
            return True
    return avg_logprob < logprob_threshold



class WhisperTranscriber:
    """Log-mel frontend + Whisper decoding with whisper's temperature-
    fallback ladder and no-speech gate, on one device: the CUDA card by
    default, the CPU when the caller asks for it (``device="cpu"``)."""

    def __init__(self, params=None, size: Optional[str] = None,
                 tokenizer_dir: Optional[str] = None,
                 decode_cfg: WhisperDecodeConfig = _DECODE_DEFAULTS,
                 config: Optional[WhisperConfig] = None, device="cuda",
                 checkpoint_dir: Optional[str] = None, mesh=None):
        if checkpoint_dir:
            not_ported("checkpoint loading (orbax / HF .pt)", "M16")
        if mesh is not None:
            not_ported("a device mesh (multi-GPU transcription)", "M17")
        self.device = torch.device(device)
        self.decode_cfg = decode_cfg
        self.policy = DEFAULT_POLICY
        set_exact_f32(parity=self.policy.compute == torch.float32)
        # tokenizer first: its special-token layout pins the decoder ids
        self.tokenizer = load_whisper_tokenizer(tokenizer_dir)
        sp = self.tokenizer.specials
        if config is None:
            size = size or os.getenv("WHISPER_MODEL", "base")
            config = WhisperConfig(**_SIZES.get(size, _SIZES["base"]),
                                   vocab_size=sp.vocab_size,
                                   eos_token_id=sp.eot,
                                   decoder_start_token_id=sp.sot)
        self.cfg = config
        self.has_weights = params is not None
        params = (params_from_jax(params, self.device) if self.has_weights
                  else to_device(whisper_init(0, self.cfg), self.device))
        # the decoder can only emit text the tokenizer can spell
        self.tokenizer_compatible = sp.vocab_size == self.cfg.vocab_size

        params = optimize_whisper_for_serving(params, self.policy)
        params = fuse_whisper_decoder_qkv(params)
        quant_req = decode_cfg.quant
        if quant_req not in ("auto", "", "none", "embedding", "int8",
                             "kernels"):
            raise ValueError(
                f"WhisperDecodeConfig.quant / WHISPER_QUANT: unknown value "
                f"{quant_req!r} (expected auto|none|embedding|int8|kernels)")
        if decode_cfg.pallas not in ("auto", "", "on", "off"):
            raise ValueError(
                f"WhisperDecodeConfig.pallas / WHISPER_PALLAS: unknown value "
                f"{decode_cfg.pallas!r} (expected auto|on|off)")
        on_card = self.device.type == "cuda"
        if decode_cfg.pallas in ("on", "off"):
            pallas = decode_cfg.pallas == "on"
        else:
            pallas = quant_req != "int8" and on_card
        if quant_req in ("auto", ""):
            quant_req = "kernels" if pallas and on_card else "none"
        # "int8": the streaming decode, int8 weights, embedding and (at
        # cache init) cross K/V; "kernels": the same weights inside the
        # fused kernels, bf16 caches, and the decode flag stays off
        self.quant = quant_req == "int8"
        if self.quant and pallas:
            raise ValueError("WhisperDecodeConfig: pallas='on' does not "
                             "compose with quant='int8' (pick one)")
        self.quant_embedding = quant_req == "embedding"
        self.quant_kernels = quant_req == "kernels"
        if self.quant or self.quant_kernels:
            params = quantize_whisper_decoder(params)
        elif self.quant_embedding:
            params = quantize_whisper_embedding(params)
        self.pallas = pallas
        self.params = params
        # language of the most recent transcribe(); None until the first
        self.last_language: Optional[str] = None

    # -------------------------------------------------------- device work

    def _encode(self, mels: np.ndarray) -> torch.Tensor:
        mel = torch.as_tensor(np.asarray(mels, np.float32), device=self.device)
        return whisper_encode(self.params, mel, self.cfg, self.policy)

    def _fused(self, enc) -> bool:
        """The fused step for this window batch. The kernels carry at most
        MAX_BATCH rows; bigger batches decode through the unfused step, as
        the JAX transcriber's ``use_pallas`` sends big window buckets to
        its XLA path."""
        return self.pallas and enc.shape[0] <= MAX_BATCH

    def _decode(self, enc, prompt, temperature: float = 0.0,
                rng: Optional[torch.Generator] = None):
        fused = self._fused(enc)
        return decode_transcript(
            self.params, None, self.cfg, self.policy, prompt_tokens=prompt,
            temperature=temperature, rng=rng, enc_out=enc,
            nospeech_id=self.tokenizer.specials.no_speech, quant=self.quant,
            pallas_self_attn=fused, pallas_cross=fused)

    # -------------------------------------------------------- transcribe

    def _window_mels(self, audio: np.ndarray) -> np.ndarray:
        """In-memory host prep: 30 s windows (preprocess/audio.mel_windows)
        with the max_windows cap applied and truncation logged."""
        frames = 2 * self.cfg.max_source_positions
        mels, full = mel_windows(audio, frames, self.decode_cfg.max_windows)
        if full > mels.shape[0]:
            _log.warning("transcribe: audio is %d windows but max_windows=%d",
                         full, self.decode_cfg.max_windows)
        return mels

    def _host_prep(self, media_path: str):
        frames = 2 * self.cfg.max_source_positions
        mels, full = prep_mel_windows(media_path, frames,
                                      self.decode_cfg.max_windows)
        if mels is not None and full > mels.shape[0]:
            _log.warning(
                "transcribe: audio is %d windows but max_windows=%d — "
                "transcript truncated to the first %.0f s",
                full, self.decode_cfg.max_windows,
                mels.shape[0] * frames * HOP_LENGTH / 16000)
        return mels

    def transcribe(self, media_path: str) -> str:
        """Transcribe a media file's audio track: successive 30 s windows
        (whisper/transcribe.py's seek loop) decoded as batches of at most
        the largest window bucket, the temperature ladder, acceptance
        checks and no-speech gate applied per window. Conscious divergence,
        as in the JAX package: no ``condition_on_previous_text`` prompt
        carry."""
        if not self.has_weights or not self.tokenizer_compatible:
            return ""    # capability absent (reference :32-34)
        mels = self._host_prep(media_path)
        if mels is None:
            return ""
        try:
            with torch.inference_mode():
                language = self._resolve_language(mels)
                step = max(self.decode_cfg.window_buckets)
                kept: list = []
                for off in range(0, mels.shape[0], step):
                    kept.extend(self._decode_window_batch(
                        mels[off:off + step], language))
            return " ".join(x for x in kept if x).strip()
        except Exception as e:
            return f"[transcript error: {e}]"

    def _resolve_language(self, mels: np.ndarray) -> str:
        """A pinned ``decode_cfg.language`` wins; English-only layouts are
        "en"; otherwise ``detect_language`` on the first 30 s window, once
        per clip (whisper/transcribe.py)."""
        sp = self.tokenizer.specials
        if self.decode_cfg.language:
            self.last_language = self.decode_cfg.language
            return self.decode_cfg.language
        if not sp.multilingual:
            self.last_language = "en"
            return "en"
        ids = [sp.language_ids[lang] for lang in sp.languages]
        idx, probs = detect_language(self.params, self._encode(mels[:1]),
                                     sp.sot, ids, self.cfg, self.policy)
        i = int(idx[0])
        lang = sp.languages[i]
        self.last_language = lang
        _log.info("whisper: detected language %r (p=%.2f)", lang,
                  float(probs[0, i]))
        return lang

    def _decode_window_batch(self, mels: np.ndarray,
                             language: Optional[str] = None) -> list:
        """Temperature ladder + acceptance + silence gate over ≤bucket-max
        windows in one batched decode; returns the per-window texts that
        survive whisper's silence rule."""
        dc = self.decode_cfg
        n_w = mels.shape[0]
        # round the window batch up to a bucket; padding windows repeat the
        # last real window (they decode like speech; outputs discarded)
        bucket = min(b for b in dc.window_buckets if b >= n_w)
        if bucket > n_w:
            mels = np.concatenate(
                [mels, np.repeat(mels[-1:], bucket - n_w, axis=0)])
        prompt = torch.tensor(
            [self.tokenizer.sot_sequence(language=language)[1:]] * bucket,
            dtype=torch.int64, device=self.device)
        enc = self._encode(mels)

        texts: list = [None] * n_w
        final_lp = np.zeros(n_w, np.float32)
        no_speech = None     # p(<|nospeech|>) rides along with the first rung
        for t in dc.fallback_temperatures:
            if t == 0.0:
                tokens, lp, ns = self._decode(enc, prompt)
                tokens, lp = tokens.cpu().numpy(), lp.cpu().numpy()
                if no_speech is None:
                    no_speech = ns.cpu().numpy()
            else:
                # whisper's best_of: independent candidates per window, the
                # highest-avg-logprob one kept; one generator per draw
                tokens, lp = None, None
                for draw in range(max(dc.best_of, 1)):
                    gen = torch.Generator(self.device).manual_seed(
                        int(t * 10) * 131 + draw)
                    dt, dlp, ns = self._decode(enc, prompt, float(t), gen)
                    dt, dlp = dt.cpu().numpy(), dlp.cpu().numpy()
                    if no_speech is None:
                        no_speech = ns.cpu().numpy()
                    if tokens is None:
                        tokens, lp = dt.copy(), dlp.copy()
                    else:
                        better = dlp > lp
                        tokens[better] = dt[better]
                        lp[better] = dlp[better]
            last_rung = t == dc.fallback_temperatures[-1]
            for w in range(n_w):
                if texts[w] is not None:
                    continue
                cand = self.tokenizer.decode(
                    [int(x) for x in tokens[w]]).strip()
                if last_rung or not needs_fallback(
                        cand, float(lp[w]), dc.compression_ratio_threshold,
                        dc.logprob_threshold):
                    texts[w] = cand
                    final_lp[w] = lp[w]
            if all(x is not None for x in texts):
                break
        # whisper's silence rule: a confidently no-speech window is dropped
        # unless its accepted result's avg_logprob clears the threshold
        return [texts[w] for w in range(n_w)
                if not (no_speech[w] > dc.no_speech_threshold
                        and final_lp[w] <= dc.logprob_threshold)]


def merge_into_caption(text: Optional[str], video_path: Optional[str],
                       transcriber: Optional[WhisperTranscriber] = None
                       ) -> Optional[str]:
    """Dashboard caption-merge rule (reference forensics_dashboard.py:
    160-162): caption + blank line + transcript, unless the transcript is
    empty or an error string. ``transcriber`` defaults to the module's
    cached one (``extract_transcript``)."""
    if not video_path:
        return text
    transcript = extract_transcript(video_path, transcriber)
    if transcript and not transcript.startswith("[transcript error"):
        return ((text or "") + "\n\n" + transcript).strip()
    return text


_lock = threading.Lock()
_engine = None
_engine_failed = False


def _get_engine() -> Optional[WhisperTranscriber]:
    """Lazily build (once) the module-cached transcriber from the
    environment, or None when construction failed (latched, like the
    reference's global whisper model cache). It is built on the card;
    without one its construction fails like any other. It has no weights
    until checkpoint loading is ported (M16), so it transcribes to ""."""
    global _engine, _engine_failed
    with _lock:
        if _engine is None and not _engine_failed:
            import dataclasses
            try:
                dc = dataclasses.replace(
                    _DECODE_DEFAULTS,
                    language=os.getenv("WHISPER_LANGUAGE") or None,
                    quant=os.getenv("WHISPER_QUANT", _DECODE_DEFAULTS.quant),
                    pallas=os.getenv("WHISPER_PALLAS",
                                     _DECODE_DEFAULTS.pallas))
                _engine = WhisperTranscriber(
                    checkpoint_dir=os.getenv("WHISPER_CHECKPOINT"),
                    decode_cfg=dc)
            except Exception:
                _log.warning("transcriber construction failed",
                             exc_info=True)
                _engine_failed = True
        return _engine


def extract_transcript(media_path: Optional[str],
                       transcriber: Optional[WhisperTranscriber] = None
                       ) -> str:
    """Transcript of a media file with the given transcriber, or the
    module-cached one (reference _extract_transcript)."""
    if not media_path:
        return ""
    engine = transcriber or _get_engine()
    if engine is None:
        return ""
    try:
        return engine.transcribe(media_path)
    except Exception as e:
        return f"[transcript error: {e}]"


def reset_transcriber() -> None:
    """Drop the module-cached transcriber (tests / configuration swaps)."""
    global _engine, _engine_failed
    with _lock:
        _engine = None
        _engine_failed = False
