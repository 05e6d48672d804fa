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

The device programs run through runners (ops/graphs.py): the encoder
and ``detect_language`` per window bucket, and the decode's step blocks
per (window bucket, prompt length) (models/whisper.py::DecodeRunner). On
the card each is captured as CUDA graphs (``cuda_graphs=False`` runs them
eagerly); ``warmup(buckets)`` makes them before the first request.

Weights come as a JAX-layout parameter tree of numpy arrays
(checkpoints/from_jax.py), from a Whisper torch file (``checkpoint_dir``
a ``.pt``/``.pth``/``.bin`` in HF or openai-whisper layout,
checkpoints/torch_convert.py) whose own shapes set the architecture, or
from a native checkpoint directory (checkpoints/io.py, written by
checkpoints/convert.py) whose metadata's ``whisper_config`` sets it and
whose ``tokenizer/`` holds the vocabulary.

The host half of a transcript (audio decode, windowing, log-mel) runs by
default in an isolated, low-priority worker process
(``MISINFO_TPU_TRANSCRIPT_ISOLATION=auto|1|0``; ``0``/``off``/``false``
run it inline), so that its CPU bursts do not starve the serving threads
through the GIL or a shared core. The worker is spawned, never forked
(the parent holds a live CUDA context), and imports
``preprocess/audio.py`` (numpy and the standard library) besides the
launching script, which a spawned child re-imports as ``__mp_main__``
(so a script keeps its work under ``if __name__ == "__main__"``); it
makes no CUDA context. Where it cannot start or fails, the prep runs
inline with a warning. With a ``mesh`` (core/mesh.py) the params
replicate on each data position and a window batch that the data axis
divides splits over it, each position encoding and decoding its windows
on its device; a sampled rung draws each step's noise for the whole
batch on every position and keeps its rows, so that a position's draws
are those of the same decode without the mesh. A split batch runs
eagerly (the captured decode blocks draw their own batch's noise, not a
slice of the whole batch's); a batch that is not split runs through the
runners, CUDA graphs on the card, as without a mesh. The AOT /
compile-cache plumbing is not carried (M15).
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax, to_device
from misinfo_tpu_torch.checkpoints.io import load_checkpoint, load_metadata
from misinfo_tpu_torch.checkpoints.torch_convert import (
    apply_updates, convert_whisper, whisper_config_from_torch,
    whisper_state_dict)
from misinfo_tpu_torch.core.config import WhisperDecodeConfig
from misinfo_tpu_torch.core.mesh import Mesh
from misinfo_tpu_torch.models.whisper import (
    DecodeRunner, WhisperConfig, decode_transcript, detect_language,
    fuse_whisper_decoder_qkv, gumbel_noise, whisper_encode, whisper_init)
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY, set_exact_f32
from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.graphs import Runner
from misinfo_tpu_torch.ops.self_attn_step import HEAD_DIM, MAX_BATCH
from misinfo_tpu_torch.ops.serving import (
    optimize_whisper_for_serving, quantize_whisper_decoder,
    quantize_whisper_embedding)
from misinfo_tpu_torch.preprocess.audio import (
    HOP_LENGTH, _isolation_worker_init, mel_windows, prep_mel_windows)
from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
    load_whisper_tokenizer, specials_for_vocab)

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


def _isolation_on() -> bool:
    """False when MISINFO_TPU_TRANSCRIPT_ISOLATION is 0, off or false (the
    default is auto: the isolated worker)."""
    return os.environ.get("MISINFO_TPU_TRANSCRIPT_ISOLATION",
                          "auto") not in ("0", "off", "false")


def _fused_step(cfg, batch: int) -> bool:
    """Whether the fused decode step's kernels take a window batch of
    ``batch`` rows of model ``cfg``: at most MAX_BATCH rows, and heads
    HEAD_DIM (64) wide. Bigger batches and other head widths (the tiny
    test config's 16) decode through the unfused step, as the JAX
    transcriber's ``use_pallas`` sends them to its XLA path
    (``pallas_decode_max_batch`` returns 0 for them)."""
    return batch <= MAX_BATCH and cfg.d_model == cfg.num_heads * HEAD_DIM


class WhisperTranscriber:
    """Log-mel frontend + Whisper decoding with whisper's temperature-
    fallback ladder and no-speech gate, on one device: the CUDA card by
    default, the CPU when the caller asks for it (``device="cpu"``). On
    the card its programs are captured CUDA graphs unless
    ``cuda_graphs=False``."""

    def __init__(self, params=None, size: Optional[str] = None,
                 tokenizer_dir: Optional[str] = None,
                 decode_cfg: WhisperDecodeConfig = _DECODE_DEFAULTS,
                 config: Optional[WhisperConfig] = None, device="cuda",
                 checkpoint_dir: Optional[str] = None, mesh=None,
                 cuda_graphs: bool = True):
        if checkpoint_dir and (params is not None or config is not None):
            raise ValueError("WhisperTranscriber: pass params/config or "
                             "checkpoint_dir, not both")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("WhisperTranscriber(mesh=...): expected a "
                            "misinfo_tpu_torch.core.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh is not None:
            mesh.require_local("WhisperTranscriber(mesh=...)")
        self.mesh = mesh
        self.device = (mesh.data_devices[0] if mesh is not None
                       else torch.device(device))
        self.decode_cfg = decode_cfg
        self.policy = DEFAULT_POLICY
        set_exact_f32(parity=self.policy.compute == torch.float32)
        ckpt_is_dir = bool(checkpoint_dir) and os.path.isdir(
            str(checkpoint_dir))
        # tokenizer first: its special-token layout pins the decoder ids
        if tokenizer_dir is None and ckpt_is_dir and os.path.isdir(
                os.path.join(str(checkpoint_dir), "tokenizer")):
            tokenizer_dir = os.path.join(str(checkpoint_dir), "tokenizer")
        self.tokenizer = load_whisper_tokenizer(tokenizer_dir)
        sp = self.tokenizer.specials
        sd = None
        if config is None:
            size = size or os.getenv("WHISPER_MODEL", "base")
            kw = dict(_SIZES.get(size, _SIZES["base"]))
            meta = load_metadata(str(checkpoint_dir)) if ckpt_is_dir else {}
            if isinstance(meta.get("whisper_config"), dict):
                # native checkpoints self-describe their architecture
                kw = {k: v for k, v in meta["whisper_config"].items()
                      if k in WhisperConfig.__dataclass_fields__}
            if checkpoint_dir and os.path.isfile(str(checkpoint_dir)):
                # a Whisper torch file: the checkpoint's own shapes pin the
                # architecture (a fallback tokenizer's vocab would
                # shape-skip the real token embedding while the rest
                # applies: a 'loaded' model that decodes garbage)
                try:
                    sd = whisper_state_dict(str(checkpoint_dir))
                    kw.update(whisper_config_from_torch(sd))
                except Exception:
                    sd = None
            kw.setdefault("vocab_size", sp.vocab_size)
            # a checkpoint vocab other than the tokenizer's: the decoder
            # ids follow the canonical layout for that vocab (transcribe()
            # stays off through tokenizer_compatible below)
            csp = (sp if kw["vocab_size"] == sp.vocab_size
                   else specials_for_vocab(kw["vocab_size"]))
            kw.setdefault("eos_token_id", csp.eot)
            kw.setdefault("decoder_start_token_id", csp.sot)
            config = WhisperConfig(**kw)
        self.cfg = config
        if checkpoint_dir:
            params = whisper_init(0, self.cfg)
            self.has_weights = False
            if sd is not None:
                try:
                    applied, skipped = apply_updates(params,
                                                     convert_whisper(sd))
                    # the token embedding is load-bearing for decode: a
                    # conversion that skipped it is not a usable model
                    emb_skipped = any(p == ("decoder", "token_embedding")
                                      for p, _ in skipped)
                    self.has_weights = applied > 0 and not emb_skipped
                except Exception:
                    pass    # an unusable file: no weights, as in JAX
            elif ckpt_is_dir:
                restored = load_checkpoint(str(checkpoint_dir), params)
                if restored is not None:
                    params = restored
                    self.has_weights = True
            params = to_device(params, self.device)
        else:
            self.has_weights = params is not None
            params = (params_from_jax(params, self.device)
                      if self.has_weights
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
            # off under a mesh, as JAX's "auto"
            pallas = quant_req != "int8" and on_card and mesh is None
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
        # runners by signature; the lock covers a whole program's copy-in,
        # run (every decode block) and copy-out
        self.cuda_graphs = bool(cuda_graphs) and on_card
        # the params on each data position (one copy per distinct device)
        self._pos_params = ([to_device(params, d)
                             for d in mesh.data_devices]
                            if mesh is not None else None)
        self._stream = (torch.cuda.Stream(self.device) if self.cuda_graphs
                        else None)
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        self._runners: dict = {}
        self._runner_lock = threading.Lock()
        # the sampled rungs' generator, seeded per draw (the graphs draw
        # from it), and the language block's ids, made once
        self._generator = torch.Generator(self.device)
        self._language_ids = torch.tensor(
            [sp.language_ids[lang] for lang in sp.languages],
            dtype=torch.int64, device=self.device)

    # -------------------------------------------------------- device work

    def _run(self, sig: tuple, program, inputs: dict) -> torch.Tensor:
        """``program`` over ``inputs`` through the runner of ``sig``, made
        (and on the card captured) at first use."""
        return graphs.run(lambda: self._runners, self._runner_lock, sig,
                          inputs, lambda: Runner(sig, program, inputs,
                                                 device=self.device,
                                                 capture=self.cuda_graphs,
                                                 stream=self._stream,
                                                 pool=self._graph_pool))

    def _split(self, n: int) -> bool:
        """Split an ``n``-window batch over the mesh's data axis: when
        there is one of more than one position and it divides ``n`` (JAX's
        rule; else the batch runs replicated, on the first position)."""
        return (self.mesh is not None and self.mesh.data > 1
                and n % self.mesh.data == 0)

    def _encode(self, mels: np.ndarray):
        """The window batch's encoding: a tensor, or under a split mesh one
        piece per data position, on its device."""
        mel = torch.from_numpy(np.ascontiguousarray(mels, np.float32))
        if self._split(mel.shape[0]):
            return [whisper_encode(p, c.to(d), self.cfg, self.policy)
                    for p, c, d in zip(self._pos_params,
                                       torch.chunk(mel, self.mesh.data),
                                       self.mesh.data_devices)]

        def encode(b):
            with torch.inference_mode():
                return whisper_encode(self.params, b["mel"], self.cfg,
                                      self.policy)
        return self._run(("encode", mel.shape[0]), encode, {"mel": mel})

    def _detect_language(self, mels: np.ndarray):
        """``detect_language`` on the first window's encoding → (argmax
        [1] into the language block, probs [1, L])."""
        sot = self.tokenizer.specials.sot

        def detect(b):
            with torch.inference_mode():
                return detect_language(self.params, b["enc"], sot,
                                       self._language_ids, self.cfg,
                                       self.policy)
        return self._run(("detect_language", 1), detect,
                         {"enc": self._encode(mels[:1])})

    def _fused(self, enc) -> bool:
        """The fused step for this window batch (``_fused_step``)."""
        return self.pallas and _fused_step(self.cfg, enc.shape[0])

    def _decode_split(self, encs, prompt, temperature, seed):
        """``_decode`` of window pieces, one per data position, each on its
        device; the outputs are gathered on the first. A sampled rung
        draws each step's noise for the WHOLE batch from a generator per
        position seeded as the transcriber's, and keeps its rows: the
        draws of the decode without the mesh."""
        total = sum(e.shape[0] for e in encs)
        outs, lo = [], 0
        for p, e, d in zip(self._pos_params, encs, self.mesh.data_devices):
            n, gumbel = e.shape[0], None
            if temperature != 0:
                gen = torch.Generator(d)
                gen.manual_seed(0 if seed is None else seed)

                def gumbel(i, gen=gen, lo=lo, n=n, d=d):
                    return gumbel_noise((total, self.cfg.vocab_size), gen,
                                        d)[lo:lo + n]
            fused = self._fused(e)
            outs.append(decode_transcript(
                p, None, self.cfg, self.policy,
                prompt_tokens=prompt[lo:lo + n].to(d),
                temperature=temperature, enc_out=e,
                nospeech_id=self.tokenizer.specials.no_speech,
                quant=self.quant, pallas_self_attn=fused,
                pallas_cross=fused, gumbel=gumbel))
            lo += n
        dev0 = self.device
        return tuple(torch.cat([o[i].to(dev0) for o in outs])
                     for i in range(len(outs[0])))

    def _decode(self, enc, prompt, temperature: float = 0.0,
                seed: Optional[int] = None):
        """One decode of the window batch ``enc`` through the runner of its
        (window batch, prompt length); a sampled one draws from the
        transcriber's generator seeded with ``seed``. Window pieces (a
        list, under a split mesh) decode on their positions."""
        if isinstance(enc, list):
            return self._decode_split(enc, prompt, temperature, seed)
        fused = self._fused(enc)
        sig = ("decode", enc.shape[0],
               0 if prompt is None else prompt.shape[1])
        with self._runner_lock:
            runner = self._runners.get(sig)
            if runner is None:
                runner = self._runners[sig] = DecodeRunner(
                    sig, device=self.device, capture=self.cuda_graphs,
                    stream=self._stream, pool=self._graph_pool,
                    generator=self._generator)
            rng = None
            if temperature != 0:
                rng = self._generator.manual_seed(0 if seed is None
                                                  else seed)
            return decode_transcript(
                self.params, None, self.cfg, self.policy,
                prompt_tokens=prompt, temperature=temperature, rng=rng,
                enc_out=enc, nospeech_id=self.tokenizer.specials.no_speech,
                quant=self.quant, pallas_self_attn=fused, pallas_cross=fused,
                runner=runner)

    # -------------------------------------------------------- warmup

    def warmup(self, buckets=(1,)) -> list:
        """Make the transcription programs' runners for the given window
        buckets before the first request: the encoder, the greedy decode
        and the sampled decode (one set of step blocks serves every rung),
        and ``detect_language`` on a 1-window encoding when no language is
        pinned. On the card each is captured as CUDA graphs after one
        eager pass of zero inputs. Unless isolation is off, the host-prep
        worker process is started here too, so that the first request
        does not pay the process start. Returns the warmed buckets, ``[]``
        when the capability is degraded (no weights / tokenizer
        mismatch)."""
        if not self.has_weights or not self.tokenizer_compatible:
            return []
        if _isolation_on():
            self._start_host_worker()
        frames = 2 * self.cfg.max_source_positions
        shape = (frames, self.cfg.num_mel_bins)
        language = self.decode_cfg.language or "en"
        warmed = []
        with torch.inference_mode():
            for b in buckets:
                enc = self._encode(np.zeros((b, *shape), np.float32))
                prompt = torch.tensor(
                    [self.tokenizer.sot_sequence(language=language)[1:]] * b,
                    dtype=torch.int64, device=self.device)
                self._decode(enc, prompt)
                self._decode(enc, prompt, 1.0, seed=0)
                warmed.append(b)
            if (self.tokenizer.specials.multilingual
                    and not self.decode_cfg.language):
                self._detect_language(np.zeros((1, *shape), np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

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

    def _start_host_worker(self) -> None:
        """Make the host-prep pool and start its worker process: the
        executor spawns it at its first task, so one empty task is sent
        and waited for. A pool that fails is given up, as in
        ``_host_prep``."""
        pool = self._host_pool()
        if pool is not None:
            try:
                pool.submit(int).result()
            except Exception:
                self._give_up_pool("failed to start")

    def _host_prep(self, media_path: str):
        """Audio decode → windowing → log-mel (preprocess/audio.py::
        prep_mel_windows): in the isolated worker process unless
        ``MISINFO_TPU_TRANSCRIPT_ISOLATION`` is 0/off/false, inline where
        the worker cannot start or fails (with a warning; the pool is then
        given up for the process)."""
        frames = 2 * self.cfg.max_source_positions
        max_w = self.decode_cfg.max_windows
        pool = self._host_pool() if _isolation_on() else None
        if pool is not None:
            try:
                mels, full = pool.submit(
                    prep_mel_windows, media_path, frames, max_w).result()
            except Exception:
                self._give_up_pool("failed")
                mels, full = prep_mel_windows(media_path, frames, max_w)
        else:
            mels, full = prep_mel_windows(media_path, frames, max_w)
        if mels is not None and full > mels.shape[0]:
            _log.warning(
                "transcribe: audio is %d windows but max_windows=%d — "
                "transcript truncated to the first %.0f s",
                full, self.decode_cfg.max_windows,
                mels.shape[0] * frames * HOP_LENGTH / 16000)
        return mels

    _POOL = None
    _POOL_BROKEN = False

    @classmethod
    def _host_pool(cls):
        """The shared one-worker process pool of the host prep, made at
        first use: the spawn context (a forked child cannot use the
        parent's CUDA context), ``_isolation_worker_init`` as initializer.
        None once it could not be made."""
        if cls._POOL is None and not cls._POOL_BROKEN:
            try:
                import concurrent.futures as cf
                import multiprocessing as mp
                cls._POOL = cf.ProcessPoolExecutor(
                    max_workers=1, mp_context=mp.get_context("spawn"),
                    initializer=_isolation_worker_init)
            except Exception:
                cls._POOL_BROKEN = True
        return cls._POOL

    @classmethod
    def _give_up_pool(cls, what: str) -> None:
        """Log the worker's failure (with its traceback) and run the host
        prep inline from now on."""
        _log.warning("transcript host worker %s; running inline", what,
                     exc_info=True)
        cls._POOL = None
        cls._POOL_BROKEN = True

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
        idx, probs = self._detect_language(mels)
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
                # highest-avg-logprob one kept; one seed per draw
                tokens, lp = None, None
                for draw in range(max(dc.best_of, 1)):
                    dt, dlp, ns = self._decode(enc, prompt, float(t),
                                               int(t * 10) * 131 + draw)
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
_default_device = "cuda"
_default_mesh = None


def set_transcriber_device(device) -> None:
    """Build the module-cached transcriber on ``device`` (the serving
    surfaces' ``--device``, so that transcription runs where the engine
    does). Applies to the next ``_get_engine`` build; call
    ``reset_transcriber()`` first if one exists already."""
    global _default_device
    with _lock:
        _default_device = str(device)


def set_transcriber_mesh(mesh) -> None:
    """Make the lazily-built module transcriber ride the given device mesh
    (the CLI/API ``--mesh`` path sets it, so that transcription shards
    alongside the engine). Applies to the next ``_get_engine`` build; call
    ``reset_transcriber()`` first if one exists already."""
    global _default_mesh
    with _lock:
        _default_mesh = mesh


def _get_engine() -> Optional[WhisperTranscriber]:
    """Lazily build (once) the module-cached transcriber from the
    environment, or None when construction failed (latched, like the
    reference's global whisper model cache). It is built on the device
    that ``set_transcriber_device`` named, the card by default (without
    one its construction fails like any other), from the Whisper torch
    file that ``WHISPER_CHECKPOINT`` names; without one it has no weights
    and transcribes to ""."""
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
                    decode_cfg=dc, device=_default_device,
                    mesh=_default_mesh)
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


def warmup_transcriber(buckets=(1,)) -> list:
    """Build the module-cached transcriber and warm its programs (the
    serving surfaces' ``--warmup`` path, beside the engine's
    ``warmup()``). Returns the warmed buckets, ``[]`` when the transcript
    capability is degraded or could not be built."""
    engine = _get_engine()
    return engine.warmup(buckets) if engine is not None else []


def reset_transcriber() -> None:
    """Drop the module-cached transcriber, its device choice AND its mesh
    (tests / configuration swaps): a mesh set once must not leak into
    every later build."""
    global _engine, _engine_failed, _default_device, _default_mesh
    with _lock:
        _engine = None
        _engine_failed = False
        _default_device = "cuda"
        _default_mesh = None
