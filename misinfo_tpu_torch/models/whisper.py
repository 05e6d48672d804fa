"""Whisper encoder-decoder for video transcript extraction, in PyTorch.

Counterpart of ``misinfo_tpu/models/whisper.py``, with its parameter-tree
names and ``[in, out]`` kernel layouts (conv kernels ``[K, Cin, Cout]``),
so a JAX tree crosses over through checkpoints/from_jax.py. Semantics of
HF ``WhisperModel``: pre-LN blocks, erf GELU, sinusoidal encoder
positions, learned decoder positions.

The KV-cached decode (``decode_transcript``) is a Python loop over
``_cached_decoder_step``. Its serving form on the card runs each decoder
layer as two hand-written kernels: the self-attention step
(ops/self_attn_step.py, TPU kernels K6a/K6b) and the cross-attention +
FFN step (ops/cross_ffn_step.py, K7a/K7b); the flags keep the JAX names
``pallas_self_attn`` / ``pallas_cross``.

``pallas_ffn`` runs the unfused step's FFN through the fused FFN kernel
(ops/fused_ffn.py, TPU kernel K5): erf GELU in f32 parity mode, tanh in
bf16, as the JAX package does.

The other decode modes, with the JAX names and JAX's refusals:
``quant=True`` is the int8 streaming decode (int8 head-major cross caches
with a scale per (batch row, head, position); q and the probabilities
quantized per (batch row, head) in the step; plain PyTorch with exact
integer products, as it is XLA's work in JAX); ``cross_int8`` gives the
fused cross step int8 merged planes with a scale per (batch row,
position) (ops/cross_ffn_step.py, K8); ``pallas_layer`` runs each layer
as one kernel (ops/layer_step.py, K9); ``unroll`` is accepted and
validated, and changes nothing: the decode loop is Python and has nothing
to unroll. ``scan_layers`` and stacked params (JAX's scan over [L, ...]
block leaves, which runs no kernel) are refused by name: in eager PyTorch
the loop over the blocks is that decode already.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.ops.attention import (
    attention_init, multi_head_attention)
from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, dense_init, gelu_exact, layer_norm,
    layer_norm_init, matmul_f32)
from misinfo_tpu_torch.ops.cross_ffn_step import fused_cross_ffn_step
from misinfo_tpu_torch.ops.fused_ffn import ffn_apply
from misinfo_tpu_torch.ops.layer_step import fused_layer_step
from misinfo_tpu_torch.ops.quant import (
    int_einsum, int_matmul, quantize_rows, quantize_rows_folded, times_r127)
from misinfo_tpu_torch.ops.self_attn_step import fused_self_attn_step


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 512            # base
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258

    @staticmethod
    def tiny() -> "WhisperConfig":
        return WhisperConfig(vocab_size=256, num_mel_bins=16, d_model=64,
                             encoder_layers=2, decoder_layers=2, num_heads=4,
                             ffn_dim=128, max_source_positions=64,
                             max_target_positions=32, eos_token_id=255,
                             decoder_start_token_id=254)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper's fixed sinusoid table (interleaved sin/cos halves)."""
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def _enc_block_init(gen, cfg):
    return {"ln1": layer_norm_init(cfg.d_model),
            "attn": attention_init(gen, cfg.d_model),
            "ln2": layer_norm_init(cfg.d_model),
            "mlp_in": dense_init(gen, cfg.d_model, cfg.ffn_dim),
            "mlp_out": dense_init(gen, cfg.ffn_dim, cfg.d_model)}


def _dec_block_init(gen, cfg):
    return {"ln1": layer_norm_init(cfg.d_model),
            "self_attn": attention_init(gen, cfg.d_model),
            "ln_cross": layer_norm_init(cfg.d_model),
            "cross_attn": attention_init(gen, cfg.d_model),
            "ln2": layer_norm_init(cfg.d_model),
            "mlp_in": dense_init(gen, cfg.d_model, cfg.ffn_dim),
            "mlp_out": dense_init(gen, cfg.ffn_dim, cfg.d_model)}


def whisper_init(seed: int = 0, cfg: WhisperConfig = WhisperConfig()) -> Dict:
    """Seeded random weights in the JAX tree's structure and scales
    (normal·0.02 convs and embeddings, U(±1/√in) dense kernels), drawn
    from an explicit ``torch.Generator``. They are not JAX's numbers for
    the same seed: tests hand one tree to both packages."""
    gen = torch.Generator().manual_seed(seed)
    s, D = 0.02, cfg.d_model

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * s

    return {
        "encoder": {
            "conv1": {"kernel": normal(3, cfg.num_mel_bins, D),
                      "bias": torch.zeros(D)},
            "conv2": {"kernel": normal(3, D, D), "bias": torch.zeros(D)},
            "positions": torch.from_numpy(
                sinusoidal_positions(cfg.max_source_positions, D)),
            "blocks": [_enc_block_init(gen, cfg)
                       for _ in range(cfg.encoder_layers)],
            "final_ln": layer_norm_init(D),
        },
        "decoder": {
            "token_embedding": normal(cfg.vocab_size, D),
            "positions": normal(cfg.max_target_positions, D),
            "blocks": [_dec_block_init(gen, cfg)
                       for _ in range(cfg.decoder_layers)],
            "final_ln": layer_norm_init(D),
        },
    }


def _conv1d(p: Dict, x: torch.Tensor, stride: int,
            policy: Policy) -> torch.Tensor:
    """1-D conv over time, x [B, T, Cin] and kernel [K, Cin, Cout] (the JAX
    layout), padding 1; output in the compute dtype, bias added there."""
    w = p["kernel"].to(policy.compute).permute(2, 1, 0)      # [Cout, Cin, K]
    y = F.conv1d(x.to(policy.compute).transpose(1, 2), w, stride=stride,
                 padding=1).transpose(1, 2)
    return y + p["bias"].to(policy.compute)


def whisper_encode(params: Dict, mel: torch.Tensor,
                   cfg: WhisperConfig = WhisperConfig(),
                   policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """mel [B, T, n_mels] → encoder states [B, T//2, D]."""
    enc = params["encoder"]
    x = gelu_exact(_conv1d(enc["conv1"], mel, 1, policy))
    x = gelu_exact(_conv1d(enc["conv2"], x, 2, policy))
    x = x + enc["positions"][: x.shape[1]].to(policy.compute)
    for blk in enc["blocks"]:
        h = layer_norm(blk["ln1"], x, policy=policy)
        x = x + multi_head_attention(blk["attn"], h, cfg.num_heads,
                                     policy=policy)
        h = layer_norm(blk["ln2"], x, policy=policy)
        x = x + dense(blk["mlp_out"],
                      gelu_exact(dense(blk["mlp_in"], h, policy)), policy)
    return layer_norm(enc["final_ln"], x, policy=policy)


def whisper_decode_step(params: Dict, tokens: torch.Tensor,
                        enc_out: torch.Tensor,
                        cfg: WhisperConfig = WhisperConfig(),
                        policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """Full-prefix decoder forward → logits [B, S, V] f32 (no KV cache)."""
    dec = params["decoder"]
    S = tokens.shape[1]
    x = (dec["token_embedding"][tokens.long()]
         + dec["positions"][:S]).to(policy.compute)
    for blk in dec["blocks"]:
        h = layer_norm(blk["ln1"], x, policy=policy)
        x = x + multi_head_attention(blk["self_attn"], h, cfg.num_heads,
                                     causal=True, policy=policy)
        h = layer_norm(blk["ln_cross"], x, policy=policy)
        x = x + multi_head_attention(blk["cross_attn"], h, cfg.num_heads,
                                     kv=enc_out, policy=policy)
        h = layer_norm(blk["ln2"], x, policy=policy)
        x = x + dense(blk["mlp_out"],
                      gelu_exact(dense(blk["mlp_in"], h, policy)), policy)
    x = layer_norm(dec["final_ln"], x, policy=policy)
    return matmul_f32(x, dec["token_embedding"].to(policy.compute).T)


def _attend(q, k, v, mask, policy: Policy, Dh: int):
    """softmax(q·kᵀ/√Dh [+ mask]) · v with head-major [B, H, S, Dh] planes:
    f32 scores and softmax, probabilities and context in compute dtype."""
    scores = (torch.einsum("bhd,bhsd->bhs", q.float(), k.float())
              / math.sqrt(Dh))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(policy.compute)
    ctx = torch.einsum("bhs,bhsd->bhd", probs.float(), v.float())
    return ctx.to(policy.compute)


def _attend_int8(q, k, v, sk, sv, policy: Policy, Dh: int):
    """The int8 streaming cross-attention: int8 planes [B, H, T, Dh] with
    row scales sk/sv [B, H, T]; q and the probabilities are quantized per
    (batch row, head) here, both products are exact integer sums. The K
    row scales multiply onto the scores; the V row scales fold into the
    probabilities before their quantization. The scales multiply by
    f32(1/127), JAX's ``/ 127.0`` under jit (``quant.times_r127``)."""
    qq, sq = quantize_rows_folded(q.float())
    si = int_einsum("bhd,bhsd->bhs", qq, k)
    scores = (si * sq * sk) / math.sqrt(Dh)
    pv = torch.softmax(scores, dim=-1) * sv
    sp = times_r127(pv.amax(dim=-1, keepdim=True)).clamp_min(1e-30)
    pq = torch.clamp(torch.round(pv / sp), 0, 127).to(torch.int8)
    ci = int_einsum("bhs,bhsd->bhd", pq, v)
    return (ci * sp).to(policy.compute)


def _embed(dec: Dict, token: torch.Tensor, pos: int, policy: Policy):
    tok = token.long()
    if "token_embedding_q" in dec:
        emb = (dec["token_embedding_q"][tok].float()
               * dec["emb_scale"][tok][:, None])
    else:
        emb = dec["token_embedding"][tok]
    return (emb + dec["positions"][pos]).to(policy.compute)       # [B, D]


def _logits(dec: Dict, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    x = layer_norm(dec["final_ln"], x, policy=policy)
    if "token_embedding_q" in dec:
        xq, sx = quantize_rows(x.float())
        return (int_matmul(xq, dec["token_embedding_q"].T) * sx
                * dec["emb_scale"][None, :])
    return matmul_f32(x, dec["token_embedding"].to(policy.compute).T)


def _self_attn_unfused(blk: Dict, x, ck, cv, pos: int, mask, H: int,
                       policy: Policy):
    """x + o(attn(LN(x))) over head-major caches [B, H, S, Dh], row ``pos``
    written in place."""
    B, D = x.shape
    Dh = D // H
    h = layer_norm(blk["ln1"], x, policy=policy)
    sa = blk["self_attn"]
    if "qkv" in sa:
        q, k_new, v_new = dense(sa["qkv"], h, policy).split(D, -1)
    else:
        q, k_new, v_new = (dense(sa[n], h, policy) for n in ("q", "k", "v"))
    ck[:, :, pos] = k_new.reshape(B, H, Dh).to(ck.dtype)
    cv[:, :, pos] = v_new.reshape(B, H, Dh).to(cv.dtype)
    ctx = _attend(q.reshape(B, H, Dh), ck, cv, mask, policy, Dh)
    return x + dense(sa["o"], ctx.reshape(B, D), policy)


def _cross_ffn_unfused(blk: Dict, x, ck_x, cv_x, H: int, policy: Policy,
                       pallas_ffn: bool = False, sk=None, sv=None):
    """The unfused second half of a layer over head-major cross planes
    (int8 with row scales sk/sv in the streaming mode)."""
    B, D = x.shape
    Dh = D // H
    h = layer_norm(blk["ln_cross"], x, policy=policy)
    q = dense(blk["cross_attn"]["q"], h, policy).reshape(B, H, Dh)
    if sk is not None:
        ctx = _attend_int8(q, ck_x, cv_x, sk, sv, policy, Dh)
    else:
        ctx = _attend(q, ck_x, cv_x, None, policy, Dh)
    x = x + dense(blk["cross_attn"]["o"], ctx.reshape(B, D), policy)
    h = layer_norm(blk["ln2"], x, policy=policy)
    if pallas_ffn:
        mode = "erf" if policy.compute == torch.float32 else "tanh"
        return x + ffn_apply(blk["mlp_in"], blk["mlp_out"], h,
                             policy=policy, mode=mode)
    return x + dense(blk["mlp_out"],
                     gelu_exact(dense(blk["mlp_in"], h, policy)), policy)


def _cached_decoder_step(params: Dict, token: torch.Tensor, pos: int,
                         enc_out: torch.Tensor, kv_cache: Dict,
                         cfg: WhisperConfig, policy: Policy,
                         pallas_ffn: bool = False,
                         pallas_self_attn: bool = False,
                         pallas_cross: bool = False,
                         pallas_layer: bool = False):
    """One decoder step with KV caching: token [B] → (logits [B, V] f32,
    kv_cache). The self-attention caches are written in place at row
    ``pos`` (JAX returns updated copies). Unfused caches are head-major
    [B, H, S, Dh]; the fused kernels take merged [B, S, D] self caches
    (``pallas_self_attn``, ``pallas_layer``) and merged [B, T, D] cross
    planes (``pallas_cross``, ``pallas_layer``). A cache with
    ``cross_k_scale`` holds the streaming mode's int8 cross planes, one
    with ``cross_k_mscale`` the fused cross step's."""
    dec = params["decoder"]
    H = cfg.num_heads
    x = _embed(dec, token, pos, policy)

    merged = pallas_self_attn or pallas_layer
    S_max = kv_cache["self_k"][0].shape[1 if merged else 2]
    mask = ((torch.arange(S_max, device=x.device) > pos).float()
            * -1e9)                                            # [S]
    T = enc_out.shape[1]
    msc = kv_cache.get("cross_k_mscale")
    for li, blk in enumerate(dec["blocks"]):
        ck, cv = kv_cache["self_k"][li], kv_cache["self_v"][li]
        ck_x, cv_x = kv_cache["cross_k"][li], kv_cache["cross_v"][li]
        if pallas_layer:
            x, _, _ = fused_layer_step(x, blk, ck, cv, ck_x, cv_x, pos, T,
                                       n_heads=H, policy=policy)
            continue
        if pallas_self_attn and "qkv" in blk["self_attn"]:
            x, _, _ = fused_self_attn_step(
                x, blk["ln1"], blk["self_attn"]["qkv"], blk["self_attn"]["o"],
                ck, cv, pos, n_heads=H, policy=policy)
        else:
            x = _self_attn_unfused(blk, x, ck, cv, pos, mask, H, policy)

        if pallas_cross:
            x = fused_cross_ffn_step(
                x, blk["ln_cross"], blk["cross_attn"]["q"],
                blk["cross_attn"]["o"], blk["ln2"], blk["mlp_in"],
                blk["mlp_out"], ck_x, cv_x, T, n_heads=H, policy=policy,
                k_scale=None if msc is None else msc[li],
                v_scale=(None if msc is None
                         else kv_cache["cross_v_mscale"][li]))
            continue
        streaming = "cross_k_scale" in kv_cache
        x = _cross_ffn_unfused(
            blk, x, ck_x, cv_x, H, policy, pallas_ffn,
            sk=kv_cache["cross_k_scale"][li] if streaming else None,
            sv=kv_cache["cross_v_scale"][li] if streaming else None)
    return _logits(dec, x, policy), kv_cache


def fuse_whisper_decoder_qkv(params: Dict) -> Dict:
    """Fuse each decoder block's self-attention q/k/v into one [D, 3D]
    projection (exact: every output column is its own dot product); the
    cross-attention is left alone. Idempotent; raises on int8 params
    (quantize after fusing)."""
    def fuse_block(blk: Dict) -> Dict:
        sa = blk["self_attn"]
        if "qkv" in sa:
            return blk
        if "kernel_q" in sa["q"]:
            raise ValueError(
                "fuse_whisper_decoder_qkv on int8-quantized params — apply "
                "quantize_whisper_decoder AFTER fusing")
        q, k, v = sa["q"], sa["k"], sa["v"]
        zeros = torch.zeros(q["kernel"].shape[1], dtype=q["kernel"].dtype,
                            device=q["kernel"].device)
        qkv = {"kernel": torch.cat([q["kernel"], k["kernel"], v["kernel"]],
                                   dim=1),
               "bias": torch.cat([p.get("bias", zeros) for p in (q, k, v)])}
        return {**blk, "self_attn": {"qkv": qkv, "o": sa["o"]}}

    dec = params["decoder"]
    if "blocks" in dec:
        dec = {**dec, "blocks": [fuse_block(b) for b in dec["blocks"]]}
    return {**params, "decoder": dec}


def _refuse_scan():
    not_ported("the stacked-layer scan decode (scan_layers)", "M13")


def init_kv_cache(params: Dict, enc_out: torch.Tensor, max_len: int,
                  cfg: WhisperConfig, policy: Policy,
                  merged_self: bool = False, quant: bool = False,
                  merged_cross: bool = False,
                  cross_int8: bool = False) -> Dict:
    """Zeroed self-attention caches and the precomputed cross K/V of every
    decoder layer. Head-major [B, H, S, Dh] by default; ``merged_self``
    keeps the self caches [B, S, D] and ``merged_cross`` the cross planes
    [B, T, D] (the fused kernels' layouts; unpadded, where the TPU padded T
    to its tile). Stacked params are refused (``scan_layers``).

    ``quant`` stores the head-major cross planes int8 with one f32 scale
    per (batch row, head, position) (``cross_k_scale``/``cross_v_scale``
    [B, H, T]), the streaming decode's caches. ``cross_int8`` (merged
    cross planes only) stores the merged planes int8 with one scale per
    (batch row, position) over all D lanes (``cross_k_mscale``/
    ``cross_v_mscale``), the fused cross step's cache quantization; the
    port keeps these scales [B, T] and the planes unpadded, where the TPU
    kept [Tp, B] and padded T to its tile."""
    dec = params["decoder"]
    B, T = enc_out.shape[0], enc_out.shape[1]
    H, Dh = cfg.num_heads, cfg.d_model // cfg.num_heads

    def cross_kv(blk, which):
        y = dense(blk["cross_attn"][which], enc_out, policy)
        if merged_cross:
            return y.contiguous()
        return y.reshape(B, T, H, Dh).transpose(1, 2).contiguous()

    if "blocks_stacked" in dec:
        _refuse_scan()
    if quant and (merged_self or merged_cross):
        raise ValueError("quant=True supports only the unstacked, "
                         "unmerged cache layout (no scan_layers / "
                         "pallas_self_attn / pallas_cross)")
    if cross_int8 and not merged_cross:
        raise ValueError("cross_int8 requires the merged_cross layout "
                         "(it is the fused kernel's cache quantization)")
    dev = enc_out.device
    shape = ((B, max_len, cfg.d_model) if merged_self
             else (B, H, max_len, Dh))
    cache = {"self_k": [], "self_v": [], "cross_k": [], "cross_v": []}
    scales = ("mscale" if cross_int8 else "scale" if quant else None)
    if scales:
        cache[f"cross_k_{scales}"] = []
        cache[f"cross_v_{scales}"] = []
    for blk in dec["blocks"]:
        for n in ("self_k", "self_v"):
            cache[n].append(torch.zeros(shape, dtype=policy.compute,
                                        device=dev))
        for which in ("k", "v"):
            y = cross_kv(blk, which)
            if scales:
                # one scale per row over the last axis (jitted JAX's)
                y, sc = quantize_rows_folded(y.float())
                cache[f"cross_{which}_{scales}"].append(
                    sc[..., 0].contiguous())
            cache[f"cross_{which}"].append(y)
    return cache


# Steps between host reads of `done`: each read waits for the device, and
# the steps run after every row has finished change no output.
_DONE_EVERY = 4


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise −log(−log U), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def decode_transcript(params: Dict, mel: Optional[torch.Tensor],
                      cfg: WhisperConfig = WhisperConfig(),
                      policy: Policy = DEFAULT_POLICY,
                      max_len: Optional[int] = None,
                      prompt_tokens: Optional[torch.Tensor] = None,
                      temperature: float = 0.0,
                      rng: Optional[torch.Generator] = None,
                      enc_out: Optional[torch.Tensor] = None,
                      nospeech_id: Optional[int] = None,
                      scan_layers: bool = False,
                      pallas_ffn: bool = False,
                      pallas_self_attn: bool = False,
                      pallas_cross: bool = False,
                      pallas_layer: bool = False,
                      quant: bool = False,
                      cross_int8: bool = False,
                      unroll: int = 1,
                      gumbel: Optional[Callable[[int], torch.Tensor]] = None):
    """KV-cached transcript decoding with an early exit once every row has
    emitted EOS (post-EOS rows stay EOS and stop scoring, so the outputs
    equal a run of all ``max_len`` steps; ``done`` is read on the host only
    every ``_DONE_EVERY`` steps).

    ``temperature == 0`` is greedy argmax; > 0 samples by gumbel-max over
    logits/T. The noise of step ``i`` (the step that predicts token i) is
    ``gumbel(i)`` when given (tests hand in JAX's draws), else drawn from
    ``rng``. Returns ``(tokens [B, max_len], avg_logprob [B])``, plus
    ``p(<|nospeech|>)`` [B] from the position-0 step when ``nospeech_id``
    is set.

    The step variants and what they refuse are the JAX package's (module
    docstring). ``unroll`` (1..4) is validated and changes nothing."""
    if not 1 <= unroll <= 4:
        raise ValueError(f"unroll must be in [1, 4], got {unroll}")
    dec_p = params["decoder"]
    if scan_layers or "blocks_stacked" in dec_p:
        _refuse_scan()
    blocks_q = bool(dec_p.get("blocks")) and any(
        isinstance(v, dict) and "kernel_q" in v
        for v in dec_p["blocks"][0]["self_attn"].values())
    if pallas_layer:
        if not blocks_q:
            raise ValueError("pallas_layer needs int8 decode weights "
                             "(quant='kernels') — the bf16 layer does not "
                             "fit the VMEM budget")
        if pallas_ffn or pallas_self_attn or pallas_cross:
            raise ValueError("pallas_layer subsumes pallas_self_attn / "
                             "pallas_cross / pallas_ffn — drop them")
        if quant:
            raise ValueError("pallas_layer reads bf16 merged caches — it "
                             "does not compose with quant=True cache "
                             "streaming")
    if quant and (pallas_ffn or pallas_self_attn or pallas_cross):
        raise ValueError("int8 streaming decode (quant=True) composes only "
                         "with the default unrolled step — drop pallas_ffn "
                         "/ pallas_self_attn / pallas_cross")
    if blocks_q and pallas_ffn:
        raise ValueError("pallas_ffn reads unquantized FFN kernels — with "
                         "int8 decode weights use pallas_cross (its fused "
                         "step carries the int8 FFN)")
    if cross_int8 and not (pallas_cross and blocks_q):
        raise ValueError("cross_int8 is the fused kernel's cache "
                         "quantization — it requires pallas_cross AND "
                         "int8 decode weights (quant='kernels')")
    if pallas_cross and pallas_ffn:
        raise ValueError("pallas_cross subsumes the FFN — drop pallas_ffn")
    max_len = max_len or cfg.max_target_positions
    if enc_out is None:
        enc_out = whisper_encode(params, mel, cfg, policy)
    if pallas_self_attn:
        params = fuse_whisper_decoder_qkv(params)      # the kernel's layout
    dev = enc_out.device
    B = enc_out.shape[0]
    sampled = temperature != 0
    tokens = torch.full((B, max_len), cfg.eos_token_id, dtype=torch.int64,
                        device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    start = 1
    if prompt_tokens is not None:
        P = prompt_tokens.shape[1]
        tokens[:, 1:1 + P] = prompt_tokens.to(device=dev, dtype=torch.int64)
        start = 1 + P
    cache = init_kv_cache(
        params, enc_out, max_len, cfg, policy,
        merged_self=pallas_self_attn or pallas_layer, quant=quant,
        merged_cross=pallas_cross or pallas_layer,
        cross_int8=cross_int8)

    def step(tok, pos):
        # looked up by name on every call, so a caller can wrap the step
        logits, _ = _cached_decoder_step(
            params, tok, pos, enc_out, cache, cfg, policy,
            pallas_ffn=pallas_ffn, pallas_self_attn=pallas_self_attn,
            pallas_cross=pallas_cross, pallas_layer=pallas_layer)
        return logits.float()

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(B, device=dev)
    cnt = torch.zeros(B, device=dev)
    ns = torch.zeros(B, device=dev)
    for i in range(start - 1):                       # prompt prefill
        logits = step(tokens[:, i], i)
        if nospeech_id is not None and i == 0:
            ns = torch.softmax(logits, dim=-1)[:, nospeech_id]
    for i in range(start, max_len):
        if (i - start) % _DONE_EVERY == 0 and bool(done.all()):
            break
        logits = step(tokens[:, i - 1], i - 1)
        if sampled:
            g = (gumbel(i) if gumbel is not None
                 else gumbel_noise(logits.shape, rng, dev))
            nxt = torch.argmax(logits / temperature + g.to(dev), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        if nospeech_id is not None and start == 1 and i == 1:
            ns = torch.exp(logp[:, nospeech_id])
        tok_lp = logp.gather(1, nxt[:, None])[:, 0]
        active = ~done
        sum_lp = sum_lp + torch.where(active, tok_lp, 0.0)
        cnt = cnt + active.float()
        nxt = torch.where(active, nxt, cfg.eos_token_id)
        done = done | (nxt == cfg.eos_token_id)
        tokens[:, i] = nxt
    avg_lp = sum_lp / cnt.clamp_min(1.0)
    if nospeech_id is not None:
        return tokens, avg_lp, ns
    return tokens, avg_lp


def _sot_logits(params, enc_out, sot_id, cfg, policy):
    B = enc_out.shape[0]
    cache = init_kv_cache(params, enc_out, 1, cfg, policy)
    token = torch.full((B,), sot_id, dtype=torch.int64, device=enc_out.device)
    logits, _ = _cached_decoder_step(params, token, 0, enc_out, cache, cfg,
                                     policy)
    return logits.float()


def no_speech_prob(params: Dict, enc_out: torch.Tensor, sot_id: int,
                   nospeech_id: int, cfg: WhisperConfig = WhisperConfig(),
                   policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """P(<|nospeech|>) from the logits at the SOT position — openai-whisper's
    silence gate. One unfused cached step. Returns [B] f32."""
    logits = _sot_logits(params, enc_out, sot_id, cfg, policy)
    return torch.softmax(logits, dim=-1)[:, nospeech_id]


def detect_language(params: Dict, enc_out: torch.Tensor, sot_id: int,
                    language_token_ids, cfg: WhisperConfig = WhisperConfig(),
                    policy: Policy = DEFAULT_POLICY):
    """Spoken-language identification from the SOT-position logits,
    restricted to the language-token block (openai-whisper's
    ``detect_language``). Returns ``(argmax [B] indices into
    language_token_ids, probs [B, L] f32)``."""
    logits = _sot_logits(params, enc_out, sot_id, cfg, policy)
    ids = torch.as_tensor(language_token_ids, dtype=torch.int64,
                          device=logits.device)
    lang = logits[:, ids]
    return torch.argmax(lang, dim=-1), torch.softmax(lang, dim=-1)

