"""Serving-time parameter-tree transforms (inference only).

Counterpart of ``misinfo_tpu/ops/serving.py`` for the transforms the
serving default runs: ``quant="int8_ffn"`` (tower FFNs to int8, served by
the fused int8 FFN kernel) and ``cast_big_kernels`` (large dense kernels
stored in bf16). Both are pure tree rewrites; models are unchanged.
"""

from __future__ import annotations

import torch

from misinfo_tpu_torch.ops.quant import MIN_KERNEL_ELEMS, quantize_ffn_params


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
    """Quantize the tower FFNs (``quant="int8_ffn"``) and, in bf16 mode,
    store big kernels in bf16. ``quant`` is resolved (``resolve_quant``);
    ``"int8"`` (every large dense in int8, TPU kernel K2) and fused QKV
    are not ported yet."""
    if quant not in ("none", "int8_ffn"):
        raise NotImplementedError(
            f"optimize_for_serving(quant={quant!r}): only 'none' and "
            "'int8_ffn' are ported (ROADMAP.md M10, K2)")
    if quant == "int8_ffn":
        params = quantize_ffn_params(params)
    if policy.compute == torch.bfloat16:
        params = cast_big_kernels(params, torch.bfloat16)
    return params
