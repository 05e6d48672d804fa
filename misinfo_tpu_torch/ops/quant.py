"""int8 weight format and the plain int8 dense layer.

Counterpart of ``misinfo_tpu/ops/quant.py``: symmetric per-output-channel
int8 weights (``kernel_q`` int8 [K, N] + ``w_scale`` f32 [N], the same
meaning on both sides) and symmetric per-row dynamic int8 activations.

Integer products must be exact, and no torch matmul gives that directly:
int8 @ int8 returns int8 and overflows, CUDA has no int32 matmul, and f32
is exact only below 2^24 (127² · 3072 ≈ 4.9e7 is not). ``int_matmul``
therefore runs in int32 on the CPU and in float64 on the card, where every
partial sum is an integer below 2^53.

Scales divide by a 0-d tensor of 127, not by the Python number: PyTorch's
CUDA division by a CPU scalar multiplies by its reciprocal, which is one
ulp off for some abs-max values and moves quantization levels. (These
are the eager JAX function's scales. Under ``jit`` XLA folds JAX's
``/ 127.0`` into a multiply by f32(1/127); the int8 dense kernel K2
follows that form, ops/int8_dense.py.)
"""

from __future__ import annotations

from typing import Dict

import torch

# Quantize only kernels with at least this many elements (as the JAX
# package): the 768×3072 / 512×2048 tower FFNs, not the heads or fusion.
MIN_KERNEL_ELEMS = 262_144


def quantize_dense(p: Dict) -> Dict:
    """{kernel[f32 in×out], bias?} → {kernel_q[int8], w_scale[f32 out], bias?}."""
    w = p["kernel"].float()
    s = int8_scale(w.abs().amax(dim=0))
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    out = {"kernel_q": wq, "w_scale": s}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_params(tree, min_elems: int = MIN_KERNEL_ELEMS):
    """Replace every large dense-param dict ({kernel: 2-D, bias?}) with
    its int8 form: the serving mode ``quant="int8"``. Idempotent."""
    if isinstance(tree, dict):
        k = tree.get("kernel")
        if getattr(k, "ndim", 0) == 2 and k.numel() >= min_elems:
            return quantize_dense(tree)
        return {key: quantize_params(v, min_elems) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_params(v, min_elems) for v in tree)
    return tree


def quantize_ffn_params(tree, min_elems: int = MIN_KERNEL_ELEMS):
    """Quantize ONLY the tower FFN pairs (dicts carrying both `mlp_in` and
    `mlp_out` with large 2-D kernels); attention and heads stay as they
    are. This is the serving mode ``quant="int8_ffn"``."""
    if isinstance(tree, dict):
        out = {}
        for key, v in tree.items():
            if (key in ("mlp_in", "mlp_out") and isinstance(v, dict)
                    and getattr(v.get("kernel"), "ndim", 0) == 2
                    and v["kernel"].numel() >= min_elems
                    and "mlp_in" in tree and "mlp_out" in tree):
                out[key] = quantize_dense(v)
            else:
                out[key] = quantize_ffn_params(v, min_elems)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_ffn_params(v, min_elems) for v in tree)
    return tree


R127 = 0.007874015718698502         # f32(1/127), exactly representable


def times_r127(t: torch.Tensor) -> torch.Tensor:
    """t · f32(1/127): what ``t / 127.0`` is in a jitted JAX function,
    where XLA folds the division (also inside an interpret-mode Pallas
    kernel). The decode modes that are held to jitted JAX take their
    scales so; ``int8_scale`` is the eager function's division."""
    return t * t.new_full((), R127)


def quantize_rows_folded(xf: torch.Tensor):
    """Per-row int8 of an f32 [..., K]: (xq int8, sx f32 [..., 1]) with the
    scale max(amax · f32(1/127), 1e-8) and an IEEE division x / sx."""
    sx = times_r127(xf.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-8) with an IEEE division on every device."""
    return (amax / amax.new_full((), 127.0)).clamp_min(1e-8)


def quantize_rows(xf: torch.Tensor):
    """Per-row symmetric int8 of an f32 tensor: (xq int8, sx f32 [..., 1])
    with an f32 abs-max / 127 floored at 1e-8 and round-half-to-even."""
    sx = int8_scale(xf.abs().amax(dim=-1, keepdim=True))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int_matmul(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int8 product as f32 (the int32 result widened once)."""
    if aq.is_cuda:
        return (aq.double() @ bq.double()).float()
    return (aq.to(torch.int32) @ bq.to(torch.int32)).float()


def int_einsum(eq: str, aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """``int_matmul`` in batched form: an exact int8 × int8 einsum as f32,
    by the same device rule (int32 on the CPU, float64 on the card)."""
    wide = torch.float64 if aq.is_cuda else torch.int32
    return torch.einsum(eq, aq.to(wide), bq.to(wide)).float()


def dense_int8(params: Dict, x: torch.Tensor, out_dtype) -> torch.Tensor:
    """y = dequant(quant(x) @ kernel_q) + bias, per-row activation scales
    and per-channel weight scales (``ops/quant.py::dense_int8``)."""
    xq, sx = quantize_rows(x.float())
    y = int_matmul(xq, params["kernel_q"]) * sx * params["w_scale"]
    if "bias" in params:
        y = y + params["bias"]
    return y.to(out_dtype)
