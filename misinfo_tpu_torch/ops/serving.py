"""Serving-time parameter-tree transforms (inference only).

Counterpart of ``misinfo_tpu/ops/serving.py``: ``quant="int8_ffn"``
(tower FFNs to int8, served by the fused int8 FFN kernel K1),
``quant="int8"`` (every large dense to int8, K1 for the FFNs and the
int8 dense kernel K2 for the rest), ``cast_big_kernels`` (large dense
kernels stored in bf16), and Whisper's bf16 storage and int8
decoder/embedding transforms. All are pure tree rewrites; models are
unchanged. (The JAX package's QKV fuse and its inverses have no caller
here: its engine keeps the fuse off, and the port has no trainer yet.)

``quant_mode`` says which int8 kernels serve quantized denses (the JAX
package's ``pallas_int8.quant_mode``): ``PrecisionConfig.quant_pallas``,
overridden by ``MISINFO_TPU_INT8_PALLAS`` (auto | off | ffn | dense |
all, and JAX's aliases); "auto" is "all" on a CUDA device and "off"
elsewhere. On the CPU the mode picks the numerics as in JAX: with the
FFN kernel off an int8 FFN runs the single-chunk chain
(``int8_ffn.int8_ffn_apply``), with the dense kernel off every int8 dense
runs ``quant.dense_int8``. On a CUDA device both kernels always run, so a
mode that turns one off raises there.
"""

from __future__ import annotations

import os

import torch

from misinfo_tpu_torch.ops.quant import (
    MIN_KERNEL_ELEMS, int8_scale, quantize_dense, quantize_ffn_params,
    quantize_params)


_ALIASES = {"": "auto", "1": "all", "on": "all", "true": "all",
            "0": "off", "none": "off", "false": "off"}
_QUANT_MODES = ("auto", "off", "ffn", "dense", "all")


def quant_mode(policy, device) -> str:
    """'off', 'ffn', 'dense' or 'all' for tensors on ``device``. The
    environment wins over the policy. Raises ValueError for a value
    outside ``_QUANT_MODES`` and its aliases, and on a CUDA device for any
    mode but "all": the port hands no card tensor to a plain version."""
    raw = os.getenv("MISINFO_TPU_INT8_PALLAS", "") or getattr(
        policy, "quant_pallas", "auto")
    m = _ALIASES.get(raw, raw)
    if m not in _QUANT_MODES:
        raise ValueError(f"MISINFO_TPU_INT8_PALLAS / quant_pallas {raw!r}: "
                         f"expected one of {', '.join(_QUANT_MODES)}")
    on_card = torch.device(device).type == "cuda"
    if m == "auto":
        return "all" if on_card else "off"
    if on_card and m != "all":
        raise ValueError(
            f"MISINFO_TPU_INT8_PALLAS / quant_pallas {raw!r} turns an int8 "
            "kernel off, which only CPU tensors allow: on a CUDA device the "
            "int8 FFN (K1) and int8 dense (K2) kernels always run (use "
            "'auto' or 'all')")
    return m


def ffn_kernel_enabled(policy, device) -> bool:
    return quant_mode(policy, device) in ("ffn", "all")


def dense_kernel_enabled(policy, device) -> bool:
    return quant_mode(policy, device) in ("dense", "all")


def cast_big_kernels(tree, dtype=torch.bfloat16,
                     min_elems: int = MIN_KERNEL_ELEMS):
    """Cast large 2-D dense kernels to the serving dtype (storage only)."""
    if isinstance(tree, dict):
        return {key: (v.to(dtype) if key == "kernel"
                      and getattr(v, "ndim", 0) == 2
                      and v.numel() >= min_elems
                      else cast_big_kernels(v, dtype, min_elems))
                for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_big_kernels(v, dtype, min_elems) for v in tree)
    return tree


def resolve_quant(quant: str, policy, device) -> str:
    """"auto" (the default) → "int8_ffn" for bf16 serving on one CUDA
    device, "none" on the CPU and in f32 parity mode (as the JAX package
    resolves it for a single TPU chip)."""
    if quant != "auto":
        return quant
    if policy.compute != torch.bfloat16:
        return "none"
    return "int8_ffn" if torch.device(device).type == "cuda" else "none"


def optimize_for_serving(params, policy, quant: str):
    """The engine's serving pipeline: quantize every large dense
    (``quant="int8"``; nothing big is left to cast) or the tower FFNs
    (``"int8_ffn"``), and in bf16 mode store the remaining big kernels in
    bf16. ``quant`` is resolved (``resolve_quant``)."""
    if quant not in ("none", "int8", "int8_ffn"):
        raise ValueError(f"optimize_for_serving: unknown quant {quant!r}")
    if quant == "int8":
        return quantize_params(params)
    if quant == "int8_ffn":
        params = quantize_ffn_params(params)
    if policy.compute == torch.bfloat16:
        params = cast_big_kernels(params, torch.bfloat16)
    return params


def optimize_whisper_for_serving(params, policy,
                                 min_elems: int = MIN_KERNEL_ELEMS):
    """Whisper's serving transform: bf16 storage for the big dense kernels
    and the decoder token embedding (a memory transform: ``dense`` casts
    to bf16 before the product anyway). Never fuses QKV: the
    cross-attention shares the {q,k,v,o} shape. No-op in f32 parity
    mode."""
    if policy.compute != torch.bfloat16:
        return params
    params = cast_big_kernels(params, torch.bfloat16, min_elems)
    dec = params.get("decoder", {})
    emb = dec.get("token_embedding")
    if emb is not None and emb.numel() >= min_elems:
        params = {**params, "decoder": {
            **dec, "token_embedding": emb.to(torch.bfloat16)}}
    return params


def quantize_whisper_decoder(params):
    """int8 decoder weights: every block's self-attention projections (the
    fused qkv after ``fuse_whisper_decoder_qkv``) and o, the
    cross-attention q and o, both FFN kernels — per-output-channel scales
    — plus the int8 token embedding (``quantize_whisper_embedding``). The
    cross-attention k/v kernels (used once per utterance), the encoder,
    LayerNorms, biases and positions stay as they are. Apply after the
    qkv fuse; idempotent."""
    dec = params.get("decoder")
    if dec is None or "token_embedding" not in dec:
        return params

    def q8(p):
        return quantize_dense(p) if "kernel" in p else p

    def quant_block(blk):
        out = dict(blk)
        out["self_attn"] = {k: q8(v) for k, v in blk["self_attn"].items()}
        out["cross_attn"] = {k: (q8(v) if k in ("q", "o") else v)
                             for k, v in blk["cross_attn"].items()}
        out["mlp_in"] = q8(blk["mlp_in"])
        out["mlp_out"] = q8(blk["mlp_out"])
        return out

    new_dec = {**dec, "blocks": [quant_block(b) for b in dec["blocks"]]}
    return quantize_whisper_embedding({**params, "decoder": new_dec})


def quantize_whisper_embedding(params):
    """int8 token embedding only: ``token_embedding_q`` int8 [V, D] with
    per-row ``emb_scale`` f32 [V]; the input lookup dequantizes the
    gathered rows and the logits product runs int8 × int8. Idempotent."""
    dec = params.get("decoder")
    if dec is None or "token_embedding" not in dec:
        return params
    new_dec = dict(dec)
    emb = dec["token_embedding"].float()
    se = int8_scale(emb.abs().amax(dim=1))
    new_dec["token_embedding_q"] = torch.clamp(
        torch.round(emb / se[:, None]), -127, 127).to(torch.int8)
    new_dec["emb_scale"] = se
    del new_dec["token_embedding"]
    return {**params, "decoder": new_dec}
