"""Shared compute primitives with an explicit dtype policy.

Counterpart of ``misinfo_tpu/ops/common.py``. Models are plain functions
over nested-dict parameter trees that keep the JAX package's names and
``[in, out]`` kernel layouts, so weights cross between the two packages
as copies (checkpoints/from_jax.py).

The casts mirror the JAX functions one for one: a dense layer's product
comes out in f32, the bias is added in f32 and the sum is rounded once to
the compute dtype; LayerNorm statistics are f32; GELU is the tanh form in
bf16 serving and erf in f32 parity mode.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops.quant import dense_int8
from misinfo_tpu_torch.ops.serving import dense_kernel_enabled

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class Policy:
    """Resolved dtype policy, JAX's attributes: ``compute`` (bf16 serving /
    f32 parity), ``param`` (master weights), ``accum`` (the dtype a dense
    product and the attention context come out in, the bias added in it),
    ``softmax``, the attention-score dtype ``score``, the GELU flavor and
    ``precision`` ("highest" in f32 parity mode, else "default": the name
    of JAX's ``jax.lax.Precision`` member; the card's f32 products are
    exact whatever it says, ``set_exact_f32``)."""

    def __init__(self, cfg: Optional[PrecisionConfig] = None):
        cfg = cfg or PrecisionConfig()
        self.compute = _DTYPES[cfg.compute_dtype]
        self.param = _DTYPES[cfg.param_dtype]
        self.accum = _DTYPES[cfg.accum_dtype]
        self.softmax = _DTYPES[cfg.softmax_dtype]
        if cfg.score_dtype == "auto":
            self.score = (torch.bfloat16 if self.compute == torch.bfloat16
                          else torch.float32)
        else:
            self.score = _DTYPES[cfg.score_dtype]
        gm = cfg.gelu_mode
        if gm == "auto":
            gm = "tanh" if self.compute == torch.bfloat16 else "erf"
        self.gelu_mode = gm
        self.precision = ("highest" if self.compute == torch.float32
                          else "default")
        # which int8 kernels serve quantized denses (ops/serving.quant_mode)
        self.quant_pallas = cfg.quant_pallas

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute)


def check_accum(policy: Policy, what: str) -> None:
    """Refuse a non-f32 ``accum`` where a hand-written kernel sums in f32
    and cannot round its products to another dtype."""
    if policy.accum != torch.float32:
        raise NotImplementedError(
            f"{what} accumulates in float32 only; accum_dtype="
            f"{str(policy.accum).removeprefix('torch.')} is served by the "
            "plain products (use_pallas=False, quant='none')")


DEFAULT_POLICY = Policy()
F32_POLICY = Policy(PrecisionConfig.highest())

# From this many rows an int8 dense runs the TPU kernel K2 in the JAX
# package (``pallas_int8._DENSE_MIN_ROWS``); below it, the plain product.
INT8_DENSE_MIN_ROWS = 256


def set_exact_f32(parity: bool) -> None:
    """Keep f32 products in full f32 on the card. Matmuls never use TF32
    (the vault's 0.85 gate needs exact f32 sims in every mode); cuDNN
    convolutions, which default to TF32, are made exact in f32 parity
    mode — the torch analogue of ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if parity:
        torch.backends.cudnn.allow_tf32 = False


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mm(a, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """The card's low-precision product with an f32 result, for training:
    each gradient is an f32-accumulated product of operands in the
    forward's dtype, rounded to its input's dtype (JAX's transpose of a
    ``preferred_element_type=f32`` dot)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = _mm_f32(g, b.t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = _mm_f32(a.t(), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result whatever the input dtype: the
    ``preferred_element_type=f32`` of the JAX dots. On the card a bf16
    product keeps its f32 accumulator (``out_dtype``; under autograd
    through ``_MatmulF32``); on the CPU the inputs widen exactly and the
    product runs in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        lead = a.shape[:-1]
        a2 = a.reshape(-1, a.shape[-1])
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            y = _MatmulF32.apply(a2, b)
        else:
            y = _mm_f32(a2, b)
        return y.reshape(*lead, b.shape[-1])
    return a.float() @ b.float()


def dense(params: Dict, x: torch.Tensor,
          policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """y = x @ W + b: the product summed in f32 and rounded to
    ``policy.accum``, the bias added in ``accum``, then one rounding to the
    compute dtype (with the default f32 ``accum``: one rounding in all).

    int8 params ({kernel_q, w_scale, bias?}) route as the JAX package's
    ``dense_int8_dispatch``: from 256 rows, with the dense kernel enabled
    (``serving.quant_mode``; always on a CUDA device, where a mode that
    turns it off raises), the int8 dense kernel K2 (ops/int8_dense.py);
    otherwise the plain ``quant.dense_int8``."""
    if "kernel_q" in params:
        rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
        if (rows >= INT8_DENSE_MIN_ROWS
                and dense_kernel_enabled(policy, x.device)):
            return K2.int8_dense(x, params["kernel_q"], params["w_scale"],
                                 params.get("bias"), out_dtype=policy.compute)
        return dense_int8(params, x, policy.compute)
    w = params["kernel"].to(policy.compute)
    y = matmul_f32(x.to(policy.compute), w).to(policy.accum)
    if "bias" in params:
        y = y + params["bias"].to(policy.accum)
    return y.to(policy.compute)


def layer_norm(params: Dict, x: torch.Tensor, eps: float = 1e-5,
               policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """LayerNorm with f32 statistics: single-pass E[x²]−E[x]² variance in
    bf16 serving mode, two-pass in f32 parity mode (as the JAX function;
    hence not ``F.layer_norm``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    if policy.compute == torch.bfloat16:
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        var = var.clamp_min(0.0)
    else:
        d = xf - mean
        var = (d * d).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(policy.compute)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU in f32, rounded back to x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def gelu(x: torch.Tensor, policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """Policy-dispatched GELU in f32: tanh approximation or erf."""
    approx = "tanh" if policy.gelu_mode == "tanh" else "none"
    return F.gelu(x.float(), approximate=approx).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick_gelu: x * sigmoid(1.702 x), the multiply in x's dtype."""
    return x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.float()).to(x.dtype)


def softmax_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=dim)


class RowShare(NamedTuple):
    """Data position ``index`` of ``parts``' share of a draw over the
    global batch: ``rand_rows`` draws the whole batch's numbers from
    ``gen`` and keeps the position's rows, so that positions with copies
    of one generator state draw the single-device masks
    (parallel/collectives.py)."""
    gen: torch.Generator
    index: int
    parts: int


def rand_rows(gen, shape, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen`` (a generator or a ``RowShare``,
    whose leading axis is the batch's)."""
    if isinstance(gen, RowShare):
        n = shape[0]
        full = torch.rand((n * gen.parts, *shape[1:]), generator=gen.gen,
                          device=device)
        return full[gen.index * n:(gen.index + 1) * n]
    return torch.rand(shape, generator=gen, device=device)


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (JAX's ``ops/common.dropout``): each element kept
    with probability 1 − rate and scaled by 1/(1 − rate), the mask drawn
    from ``gen`` (a generator on x's device, or a data position's
    ``RowShare``). The identity when ``deterministic`` or at rate 0."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = rand_rows(gen, x.shape, x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    return xf / n.clamp_min(eps)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               bias: bool = True, scale: Optional[float] = None) -> Dict:
    """Seeded init with the JAX package's scale (U(±1/√in), zero bias)."""
    bound = scale if scale is not None else 1.0 / in_dim ** 0.5
    p = {"kernel": (torch.rand(in_dim, out_dim, generator=gen) * 2 - 1)
         * bound}
    if bias:
        p["bias"] = torch.zeros(out_dim)
    return p


def layer_norm_init(dim: int) -> Dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}
