"""Single dataclass config tree for the whole framework.

Host copy of ``misinfo_tpu/core/config.py`` (the JAX package's ``core``
imports JAX on import), including ``WhisperDecodeConfig`` for the
transcript path. Defaults are held identical to the original by
tests/test_torch_host.py, and ``from_env``'s fields under
``MISINFO_TPU_HOST_POLICY=auto`` by tests/test_torch_host_policy.py (the
link probe runs where the engine's card is CUDA, JAX's where it is a TPU).

Replaces the reference's three ad-hoc config mechanisms — hardcoded
constants (incl. Windows absolute paths, reference misinfo_forensics.py:123),
argparse flags, and env vars — with one typed tree plus env/CLI overrides
(SURVEY.md §5 "Config / flag system").

All behavioral constants of the reference are centralized here with their
source citations so parity is auditable:
  * vault image-reuse gate 0.85      (reference misinfo_forensics.py:464)
  * fusion FAKE decision gate 0.5    (reference misinfo_forensics.py:605)
  * CLIP match threshold 0.25        (reference clip_similarity_engine.py:18)
  * explanation rule gates 0.7/0.3   (reference misinfo_forensics.py:747-760)
  * video: max 12 frames, 1 s stride (reference misinfo_forensics.py:497-498)
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class Thresholds:
    """Behavioral decision constants (values match the reference exactly)."""

    vault_reuse: float = 0.85          # misinfo_forensics.py:464
    fake_decision: float = 0.5         # misinfo_forensics.py:605
    clip_match: float = 0.25           # clip_similarity_engine.py:18
    explain_vault: float = 0.7         # misinfo_forensics.py:747
    explain_deepfake: float = 0.7      # misinfo_forensics.py:751
    explain_ai: float = 0.7            # misinfo_forensics.py:754
    explain_misinfo: float = 0.7       # misinfo_forensics.py:757
    explain_clip_low: float = 0.3      # misinfo_forensics.py:760
    vault_prompt_gate: float = 0.5     # misinfo_forensics.py:678


@dataclass(frozen=True)
class VideoConfig:
    max_frames: int = 12               # misinfo_forensics.py:497
    stride_seconds: float = 1.0        # misinfo_forensics.py:498
    fps_fallback: float = 25.0         # misinfo_forensics.py:513-514


@dataclass(frozen=True)
class WhisperDecodeConfig:
    """openai-whisper ``transcribe()`` defaults, inherited verbatim by the
    reference's transcript call (forensics_dashboard.py:80-83 →
    whisper/transcribe.py): the temperature-fallback ladder, the
    compression-ratio / avg-logprob acceptance checks, and the no-speech
    silence gate. serve/transcript.py consumes these.

    Sampled retry rungs draw ``best_of`` independent candidates per window
    (whisper's GreedyDecoder best_of=5) and keep the highest-avg-logprob
    candidate. Known divergence (documented, conscious): no cross-window
    ``condition_on_previous_text`` prompt carry."""

    fallback_temperatures: Tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    best_of: int = 5
    # whisper/transcribe.py: language=None on a multilingual model triggers
    # detect_language() on the first 30 s mel window; English-only (.en)
    # layouts pin "en" without detection. A language code here ("en", "de",
    # …) pins the decoder prompt and skips the detection step.
    language: Optional[str] = None
    compression_ratio_threshold: float = 2.4
    logprob_threshold: float = -1.0
    no_speech_threshold: float = 0.6
    # whisper/transcribe.py loops `while seek < content_frames` over 30 s
    # windows; windows decode as batches here. The cap bounds total work
    # per clip: 120 windows = 1 hour of audio (logged when it binds —
    # openai-whisper itself has no cap).
    max_windows: int = 120
    # window-batch buckets: the window count is rounded up and padding
    # windows repeat the last real window so they decode-and-exit like
    # normal speech; clips with more windows than the largest bucket are
    # processed in chunks of that size.
    window_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 20)
    # Decode-weight quantization (no reference counterpart — the reference
    # decodes f32 torch). "auto" (default) resolves to "kernels" when the
    # fused decode step is on, exact decode otherwise. "embedding": int8
    # token embedding + logits product only. "none" disables. "int8": the
    # full int8 streaming decode (dense kernels + embedding + cross-K/V
    # caches stored int8). "kernels": the decoder dense weights int8 inside
    # the two fused decode-step kernels, plus the int8 embedding; caches
    # stay bf16 merged-lane. Env: WHISPER_QUANT.
    quant: str = "auto"
    # Fused decode step: the whole decoder layer as TWO kernels —
    # self-attention and cross-attention+FFN. "auto" (default) enables it
    # on the accelerator and leaves it off on the CPU; "on"/"off" force.
    # Env: WHISPER_PALLAS=auto|on|off. Numerics: in bf16 serving mode the
    # fused FFN's GELU is the tanh form; f32 parity mode keeps erf.
    pallas: str = "auto"


@dataclass(frozen=True)
class ModelPaths:
    """Checkpoint / asset locations. All relative by default (the reference
    bakes in Windows absolute paths; we consciously fix that, SURVEY.md §5)."""

    fusion_weights: str = "forensics_master_final.pth"
    ai_head_weights: str = "ai_head_best.pth"
    misinfo_head_weights: str = "roberta_detective_best.pth"
    efficientnet_weights: str = "efficientnet_cifake_best.pth"
    clip_weights: str = "clip_detective_best.pth"
    vault_path: str = "guardian_embeddings.pkl"
    roberta_tokenizer_dir: Optional[str] = None   # dir with vocab.json+merges.txt
    clip_tokenizer_dir: Optional[str] = None
    orbax_dir: Optional[str] = None               # native checkpoint format


@dataclass(frozen=True)
class PrecisionConfig:
    """Dtype policy. `bfloat16` activations ride the MXU at full rate;
    `float32` is used for parity validation (≤1e-3 divergence target)."""

    compute_dtype: str = "bfloat16"    # activations / matmul inputs
    param_dtype: str = "float32"       # master weights
    accum_dtype: str = "float32"       # matmul accumulation (MXU native)
    softmax_dtype: str = "float32"     # score softmaxes always f32
    # Attention score materialization dtype. "auto" → bf16 in bf16 serving
    # mode (halves the [B,H,S,S] memory traffic, which grows with S²), f32
    # in parity mode. Softmax math stays f32 inside the fusion either way.
    score_dtype: str = "auto"
    # Detector serving quantization (ops/serving.resolve_quant):
    # "auto" (default) → "int8_ffn" on a single-card bf16 serving
    # deployment, "none" everywhere else (f32 parity mode, CPU, mesh).
    # "int8_ffn" quantizes ONLY the tower FFN pairs, served by the fused
    # int8 FFN kernel (K1) while attention stays bf16. "int8" quantizes
    # ALL large dense kernels (more kernel boundaries per layer; kept for
    # weight-memory-constrained deployments); "none" keeps bf16
    # everywhere.
    quant: str = "auto"
    # Which int8 kernels serve the quantized denses (ops/int8_ffn.py,
    # ops/int8_dense.py): "auto" → fused FFN + dense kernels on a CUDA
    # card (the activation quantized inside the kernel), the plain
    # numerics elsewhere; "off"/"ffn"/"dense"/"all" force.
    # MISINFO_TPU_INT8_PALLAS overrides for A/B.
    quant_pallas: str = "auto"
    # GELU flavor. "auto" → tanh approximation in bf16 serving mode (its
    # divergence from erf sits below bf16 matmul noise) and HF-exact erf
    # in f32 parity mode.
    gelu_mode: str = "auto"

    @staticmethod
    def highest() -> "PrecisionConfig":
        return PrecisionConfig(compute_dtype="float32")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh topology. 1-D `data` axis batch-shards the serving
    program; an optional `model` axis tensor-shards transformer weights
    (attention heads / FFN hidden) via GSPMD PartitionSpecs."""

    data: int = -1                     # -1 → all remaining devices
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class SequenceConfig:
    """Static sequence lengths — jit signatures are fixed per modality
    combination (SURVEY.md §7 'Ragged/optional modalities under jit')."""

    roberta_max_len: int = 512         # inference (misinfo_forensics.py:329)
    roberta_train_len: int = 256       # training (train_roberta_detective.py:160)
    clip_max_len: int = 77
    image_size: int = 224
    vault_top_k: int = 5               # misinfo_forensics.py:410


@dataclass(frozen=True)
class ServingConfig:
    """Batched engine knobs: request queue → padded batch → pjit."""

    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    # video requests batch too (V videos → one [V·max_frames]-frame
    # program); smaller buckets because each video carries ≤12 frames, so
    # V = 16 already sends 192 frames through the image towers at once.
    video_batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    max_wait_ms: float = 5.0           # micro-batching window
    donate_buffers: bool = True
    # Sequence packing for text traffic: pack ragged requests into shared
    # rows with block-diagonal attention (preprocess/packing.py). RoBERTa
    # FLOPs then scale with total tokens, not requests × bucket. True =
    # always pack; "auto" (default) packs only when the packed row count
    # beats the bucketed dense layout by >25% (scores match the dense
    # layout's within the f32 parity tolerance); False disables.
    pack_text: object = "auto"  # False | True | "auto"
    # Vault row storage: "float32" (exact, default), "bfloat16" (2× the
    # articles per chip, ~0.2% sim error), "int8" (4× capacity, MXU
    # double-rate matmul, ~0.5-1% sim error) — vault/search.py vault_sims —
    # or "int4" (8× capacity via packed nibbles + per-row scales + a Pallas
    # unpack-in-VMEM kernel, ~1% sim error; composes with row-sharding,
    # mutually exclusive with vault_ivf; vault/int4.py)
    vault_dtype: str = "float32"
    # IVF vault search (vault/ivf.py): sub-linear probed-cluster kNN for
    # vaults far beyond the reference's 2,170 rows. Exact search stays the
    # default; nprobe trades recall for speed.
    vault_ivf: bool = False
    ivf_nprobe: int = 8
    # bf16 copy for the IVF candidate gather (half the scattered-read
    # bytes; final top-k re-scored from the f32 rows — see vault/ivf.py)
    ivf_bf16_gather: bool = False
    # On-device image resize (ops/resize.py): host ships ONE padded uint8
    # frame per image and the program derives both 224px flavors as two
    # batched f32 matmuls with PIL-faithful antialiased weights (within a
    # uint8 level of PIL on a small share of pixels, where the cv2 host
    # path diverges far more). Saves the two host resizes per image at the
    # cost of a larger host→device transfer (staged S² vs 2·224² bytes);
    # off by default, as in the reference.
    device_resize: bool = False
    # Reduced JPEG decode (libjpeg DCT-domain 1/2^n scaled decode) for
    # path inputs whose short side stays ≥448 px after reduction — on a
    # host with few cores the serving ceiling can be the JPEG decode. Exact
    # full decode stays the default (reference behavior).
    fast_decode: bool = False
    # Square staging sizes for device_resize; frames beyond the last
    # bucket are host-shrunk into it.
    image_staging_buckets: Tuple[int, ...] = (320, 640, 1280)
    # The JAX package's AOT-serialized executable cache (its
    # engine/aotcache.py; `MISINFO_TPU_AOT=1`). Kept so that a shared
    # configuration parses; the port refuses it (an XLA compile cache has
    # no counterpart here).
    aot_cache: bool = False
    # Mesh serving: vaults at/above this row count are ROW-SHARDED across
    # the data axis (vault/search.py vault_search_sharded — local matmul +
    # per-shard top-k + O(K·devices) candidate merge) instead of being
    # replicated per device. Default 4M rows of 512-d f32 (8 GiB); only
    # applies when the engine is constructed with a mesh.
    vault_shard_min_rows: int = 1 << 22


def _load_dotenv() -> None:
    """Reference parity: `load_dotenv()` at import (misinfo_forensics.py:
    18-19) lets users keep GOOGLE_API_KEY in a repo-root `.env`. Uses
    python-dotenv when installed, else a minimal KEY=VALUE parser of the
    cwd's `.env`; existing environment always wins."""
    try:
        from dotenv import load_dotenv
        # explicit cwd path: bare load_dotenv() walks up from the INSTALLED
        # package dir, not the user's project; any failure degrades to
        # no-key like the reference
        load_dotenv(".env")
        return
    except ImportError:
        pass
    except Exception:
        return
    try:
        with open(".env") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                os.environ.setdefault(k.strip(), v.strip().strip("'\""))
    except OSError:
        pass


@dataclass(frozen=True)
class ForensicsConfig:
    paths: ModelPaths = field(default_factory=ModelPaths)
    thresholds: Thresholds = field(default_factory=Thresholds)
    video: VideoConfig = field(default_factory=VideoConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seq: SequenceConfig = field(default_factory=SequenceConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    gemini_api_key: Optional[str] = None
    gemini_model: str = "gemini-2.5-flash"   # misinfo_forensics.py:155
    seed: int = 0
    verbose: bool = True

    @staticmethod
    def from_env(**overrides) -> "ForensicsConfig":
        """Environment overrides mirror the reference's env usage:
        GOOGLE_API_KEY (misinfo_forensics.py:150), WHISPER_MODEL
        (forensics_dashboard.py:48)."""
        cfg = ForensicsConfig(**overrides)
        _load_dotenv()   # reference loads .env for the key (:18-19)
        key = os.getenv("GOOGLE_API_KEY")
        if key and cfg.gemini_api_key is None:
            cfg = dataclasses.replace(cfg, gemini_api_key=key)
        # asset-path overrides for flagless surfaces (dashboard):
        path_env = {"MISINFO_TPU_VAULT": "vault_path",
                    "MISINFO_TPU_CHECKPOINT": "orbax_dir"}
        updates = {field: os.getenv(var)
                   for var, field in path_env.items() if os.getenv(var)}
        if updates:
            cfg = dataclasses.replace(
                cfg, paths=dataclasses.replace(cfg.paths, **updates))
        _pt = os.getenv("MISINFO_TPU_PACK_TEXT")
        if _pt in ("1", "true", "on", "auto", "0", "false", "off"):
            val = ("auto" if _pt == "auto"
                   else _pt in ("1", "true", "on"))
            cfg = dataclasses.replace(
                cfg, serving=dataclasses.replace(cfg.serving, pack_text=val))
        _dr = os.getenv("MISINFO_TPU_DEVICE_RESIZE")
        if _dr in ("1", "true", "on", "0", "false", "off"):
            cfg = dataclasses.replace(
                cfg, serving=dataclasses.replace(
                    cfg.serving, device_resize=_dr in ("1", "true", "on")))
        _q = os.getenv("MISINFO_TPU_QUANT")
        if _q in ("auto", "none", "int8", "int8_ffn"):
            cfg = dataclasses.replace(
                cfg, precision=dataclasses.replace(cfg.precision, quant=_q))
        _aot = os.getenv("MISINFO_TPU_AOT")
        if _aot in ("1", "true", "on", "0", "false", "off"):
            cfg = dataclasses.replace(
                cfg, serving=dataclasses.replace(
                    cfg.serving, aot_cache=_aot in ("1", "true", "on")))
        _fd = os.getenv("MISINFO_TPU_FAST_DECODE")
        if _fd in ("1", "true", "on", "0", "false", "off"):
            cfg = dataclasses.replace(
                cfg, serving=dataclasses.replace(
                    cfg.serving, fast_decode=_fd in ("1", "true", "on")))
        if os.getenv("MISINFO_TPU_HOST_POLICY") == "auto" and (
                _fd is None or _dr is None):
            # measure THIS host's image-prep ceiling (and, on a CUDA card,
            # the host→card link) once and apply the knobs it justifies
            # (explicit MISINFO_TPU_FAST_DECODE / MISINFO_TPU_DEVICE_RESIZE
            # always win per knob)
            from misinfo_tpu_torch.preprocess.hostprobe import auto_policy
            updates = auto_policy(allow_fast_decode=_fd is None,
                                  allow_device_resize=_dr is None)
            if updates:
                import logging
                logging.getLogger("misinfo_tpu_torch.config").warning(
                    "MISINFO_TPU_HOST_POLICY=auto: applying %s (host-bound "
                    "image prep; see /metrics host_prep for the probe)",
                    updates)
                cfg = dataclasses.replace(
                    cfg, serving=dataclasses.replace(cfg.serving, **updates))
        vd = os.getenv("MISINFO_TPU_VAULT_DTYPE")
        if vd in ("float32", "bfloat16", "int8", "int4"):
            cfg = dataclasses.replace(
                cfg, serving=dataclasses.replace(cfg.serving, vault_dtype=vd))
        # nprobe / bf16-gather parse independently of the VAULT_IVF env:
        # vault_ivf may be enabled programmatically while its tuning knobs
        # come from the environment
        ivf_updates = {}
        if os.getenv("MISINFO_TPU_VAULT_IVF") in ("1", "true", "on"):
            ivf_updates["vault_ivf"] = True
        if os.getenv("MISINFO_TPU_IVF_NPROBE"):
            ivf_updates["ivf_nprobe"] = int(os.environ["MISINFO_TPU_IVF_NPROBE"])
        if os.getenv("MISINFO_TPU_IVF_BF16") in ("1", "true", "on"):
            ivf_updates["ivf_bf16_gather"] = True
        if os.getenv("MISINFO_TPU_VAULT_SHARD_ROWS"):
            ivf_updates["vault_shard_min_rows"] = int(
                os.environ["MISINFO_TPU_VAULT_SHARD_ROWS"])
        if ivf_updates:
            cfg = dataclasses.replace(
                cfg, serving=dataclasses.replace(cfg.serving, **ivf_updates))
        return cfg

    def replace(self, **kw) -> "ForensicsConfig":
        return dataclasses.replace(self, **kw)
