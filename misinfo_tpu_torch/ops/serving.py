"""Serving-time parameter-tree transforms (inference only).

Counterpart of ``misinfo_tpu/ops/serving.py``: ``quant="int8_ffn"``
(tower FFNs to int8, served by the fused int8 FFN kernel K1),
``quant="int8"`` (every large dense to int8, K1 for the FFNs and the
int8 dense kernel K2 for the rest), ``cast_big_kernels`` (large dense
kernels stored in bf16), and Whisper's bf16 storage and int8
decoder/embedding transforms. All are pure tree rewrites; models are
unchanged. ``fuse_qkv_params`` concatenates each self-attention block's
q/k/v kernels into one [D, 3D] product (``optimize_for_serving(...,
fuse=True)``; off by default, as in the JAX package, whose engine never
fuses); ``deoptimize_params`` undoes every transform for a checkpoint.

On a CUDA device the detector's int8 kernels are stored K-major
(``kmajor``): each ``kernel_q`` keeps JAX's name, [in, out] shape and
values, as the [in, out] transposed view of a contiguous [out, in]
buffer, the operand layout that the tensor cores' int8 products read
(K1 and K2 refuse any other). No weight byte is stored twice. Whisper's
transforms leave their int8 weights [in, out] contiguous: the decode-step
kernels read them so.

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
from typing import Dict

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


def _is_attn_params(d: Dict) -> bool:
    return (isinstance(d, dict) and all(k in d for k in ("q", "k", "v", "o"))
            and isinstance(d.get("q"), dict) and "kernel" in d["q"])


def fuse_qkv_params(tree):
    """Rewrite every attention param dict {q,k,v,o} → {qkv,o}: the q, k
    and v kernels concatenated along their output dimension into one
    [D, 3D] kernel (biases likewise). Each output column is still its own
    dot product, so the math is unchanged.

    SELF-ATTENTION ONLY: a fused dict is invalid for cross-attention
    (k/v project the other operand; ops.attention asserts this). Safe on
    the detector tree (all towers are self-attention); do NOT apply to
    Whisper decoder params, whose cross-attention blocks share the same
    {q,k,v,o} shape."""
    if isinstance(tree, dict):
        if _is_attn_params(tree):
            q, k, v = tree["q"], tree["k"], tree["v"]
            qkv = {"kernel": torch.cat(
                [q["kernel"], k["kernel"], v["kernel"]], dim=1)}
            if "bias" in q:
                qkv["bias"] = torch.cat([q["bias"], k["bias"], v["bias"]])
            return {"qkv": qkv, "o": tree["o"]}
        return {key: fuse_qkv_params(v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fuse_qkv_params(v) for v in tree)
    return tree


def unfuse_qkv_params(tree):
    """Inverse of ``fuse_qkv_params``: {qkv,o} → {q,k,v,o}, each leaf a
    contiguous [in, out] tensor (as a checkpoint writes it)."""
    if isinstance(tree, dict):
        if "qkv" in tree and isinstance(tree["qkv"], dict) and "o" in tree:
            qkv = tree["qkv"]
            ks = qkv["kernel"].chunk(3, dim=1)
            out = {n: {"kernel": k.contiguous()}
                   for n, k in zip(("q", "k", "v"), ks)}
            if "bias" in qkv:
                for n, b in zip(("q", "k", "v"), qkv["bias"].chunk(3)):
                    out[n]["bias"] = b.contiguous()
            out["o"] = tree["o"]
            return out
        return {key: unfuse_qkv_params(v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unfuse_qkv_params(v) for v in tree)
    return tree


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


def resolve_quant(quant: str, policy, mesh=None, device=None) -> str:
    """"auto" (the default) → "int8_ffn" for bf16 serving on one CUDA
    device, "none" on the CPU, in f32 parity mode and under a mesh, as the
    JAX package resolves it for a single TPU chip and for a mesh. The
    device defaults to the card when there is one; a ``str`` or
    ``torch.device`` in the third position is read as the device (the
    port's older positional form)."""
    if isinstance(mesh, (str, torch.device)):
        mesh, device = None, mesh
    if quant != "auto":
        return quant
    if policy.compute != torch.bfloat16 or mesh is not None:
        return "none"
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return "int8_ffn" if torch.device(device).type == "cuda" else "none"


def kmajor(wq: torch.Tensor) -> torch.Tensor:
    """The [in, out] int8 kernel as the transposed view of a contiguous
    [out, in] copy: the same shape and values, ``.t()`` contiguous."""
    return wq.t().contiguous().t()


def kmajor_kernels(tree):
    """Every ``kernel_q`` of a tree laid out by ``kmajor``."""
    if isinstance(tree, dict):
        return {key: (kmajor(v) if key == "kernel_q" else kmajor_kernels(v))
                for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(kmajor_kernels(v) for v in tree)
    return tree


def _first_tensor(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
        return None
    return tree if isinstance(tree, torch.Tensor) else None


def optimize_for_serving(params, policy, quant: str = "none",
                         fuse: bool = False, cast: bool = True, mesh=None):
    """The engine's serving pipeline, in the JAX package's order: resolve
    ``quant`` ("auto" against the tree's device, ``resolve_quant``),
    optionally fuse QKV (``fuse_qkv_params``), then quantize every large
    dense (``quant="int8"``: nothing big is left to cast) or the tower
    FFNs (``"int8_ffn"``), and with ``cast`` in bf16 mode store the
    remaining big kernels in bf16. The fuse comes first, so that a fused
    [D, 3D] kernel is quantized with one scale per output column: the
    three unfused kernels' scales. On a CUDA device the int8 kernels are
    laid out K-major (``kmajor_kernels``), as K1 and K2 read them.

    The fuse is off by default, as in the JAX package: the attention
    layer copies q, k and v apart again from the [B, S, 3D] output
    (PERF.md §6 has both timed on the card). With a ``mesh``, "auto"
    resolves to "none", as JAX's; the engine shards the tree afterwards
    (parallel/sharding.py)."""
    t = _first_tensor(params)
    quant = resolve_quant(quant, policy, mesh,
                          t.device if t is not None else "cpu")
    if quant not in ("none", "int8", "int8_ffn"):
        raise ValueError(f"optimize_for_serving: unknown quant {quant!r}")
    if fuse:
        params = fuse_qkv_params(params)
    if quant == "int8":
        params = quantize_params(params)
    elif quant == "int8_ffn":
        params = quantize_ffn_params(params)
    if quant != "none" and t is not None and t.is_cuda:
        params = kmajor_kernels(params)
    if quant != "int8" and cast and policy.compute == torch.bfloat16:
        params = cast_big_kernels(params, torch.bfloat16)
    return params


def deoptimize_params(tree):
    """The tree in the canonical checkpoint layout (``detector_init``'s
    structure, f32 kernels), for persisting params that went through
    ``optimize_for_serving``: int8 kernels dequantized (``kernel_q`` ·
    ``w_scale`` in f32, lossy: the quantization error stays), bf16 leaves
    upcast, QKV unfused, every leaf contiguous in [in, out] order.
    Dequantization runs before the unfuse (a fused int8 dict carries
    ``kernel_q``, which the unfuse expects as ``kernel``)."""

    def walk(t):
        if isinstance(t, dict):
            if "kernel_q" in t:
                out = {"kernel": (t["kernel_q"].float()
                                  * t["w_scale"]).contiguous()}
                if "bias" in t:
                    out["bias"] = t["bias"]
                return out
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            return t.float()
        return t

    return unfuse_qkv_params(walk(tree))


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
