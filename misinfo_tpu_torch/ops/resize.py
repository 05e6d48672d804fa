"""On-device image resize: PIL-faithful antialiased resampling as two
batched f32 matmuls.

Counterpart of ``misinfo_tpu/ops/resize.py``. The reference resizes every
image twice on the host CPU — torchvision ``Resize((224,224))`` bilinear
for the EfficientNet branch (reference misinfo_forensics.py:249-253) and
CLIPProcessor's shortest-edge-bicubic + center-crop for the CLIP towers
(invoked at reference :386). With ``ServingConfig.device_resize`` the
host ships ONE padded uint8 frame per image
(``preprocess/image.py::stage_image_batch``) and the signal program
derives both 224×224 flavors here, from four scalars per flavor and image.

PIL's convolution resampler is a SEPARABLE weighted sum: one horizontal
pass then one vertical pass, each a small dense contraction. The
per-image filter planes are built on the device and applied as two
batched matmuls (``torch.matmul``, no hand kernel: the JAX package
computes this with two XLA einsums outside any Pallas kernel).

Faithfulness:
  * identical tap geometry to PIL — center ``(o + off + 0.5)·scale``,
    filterscale ``max(scale, 1)``, window clamped to the valid extent and
    renormalized (PIL ImagingResampleHorizontal semantics);
  * same filters — triangle (support 1) for bilinear, Keys cubic a=-0.5
    (support 2) for bicubic;
  * same pass order (horizontal → vertical) INCLUDING PIL's uint8
    rounding of the intermediate image between passes;
  * same round-half-up uint8 quantization (PIL's fixed-point
    ``(ss + (1<<21)) >> 22`` is floor(x+0.5)), with a clamp;
  * the CLIP center crop folds into the weights as an output-grid offset.
Residual divergence from PIL, and from the JAX function, is the order of
the f32 sums at exact rounding ties: at most one uint8 level on a small
share of pixels (tests/test_torch_resize.py measures it).

All math here is f32 whatever the serving policy, so that bf16 serving and
f32 parity mode see the same pixels; on the card the products need TF32
off (``ops.common.set_exact_f32``, which the engine calls).
"""

from __future__ import annotations

import torch

# Most share of output pixels that two f32 sum orders of the same resize
# (the JAX function's on the CPU, this one's on the CPU or the card) may
# put one uint8 level apart: a sum that lands within an ulp of a rounding
# tie. tests/test_torch_resize.py measures the share against jitted JAX;
# chip_smoke.py holds the card's result to the CPU's with it.
TIE_SHARE = 1e-3

# resize_params row layout (preprocess/image.py::resize_param_row):
#   [h, w, eff_scale_v, eff_scale_h, clip_scale_v, clip_off_v,
#    clip_scale_h, clip_off_h]
PARAM_FIELDS = 8


def _keys_cubic(t: torch.Tensor) -> torch.Tensor:
    """Keys bicubic kernel, a = -0.5 (PIL's bicubic_filter)."""
    w1 = (1.5 * t - 2.5) * t * t + 1.0
    w2 = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    return torch.where(t <= 1.0, w1,
                       torch.where(t < 2.0, w2, torch.zeros_like(t)))


def _axis_weights(out_size: int, staged: int, extent: torch.Tensor,
                  scale: torch.Tensor, offset: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """Per-image separable filter plane ``[B, out_size, staged]``.

    ``extent``/``scale``/``offset`` are [B] f32: the valid source length
    inside the staged buffer, the in/out scale, and the output-grid offset
    (0 for a plain resize; the crop origin for the folded center crop).
    """
    dev = scale.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = torch.arange(staged, dtype=torch.float32, device=dev)
    center = (o[None, :] + offset[:, None] + 0.5) * scale[:, None]  # [B,O]
    fscale = torch.clamp_min(scale, 1.0)[:, None, None]              # [B,1,1]
    x = (i[None, None, :] + 0.5 - center[:, :, None]).abs() / fscale
    w = (torch.clamp_min(1.0 - x, 0.0) if kind == "bilinear"
         else _keys_cubic(x))
    w = w * (i[None, None, :] < extent[:, None, None])
    return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-12)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL clip8: clamp + round-half-up (fixed-point ``+0.5`` then floor)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def _resample(x_f32: torch.Tensor, wv: torch.Tensor,
              wh: torch.Tensor) -> torch.Tensor:
    """Horizontal then vertical pass with PIL's uint8 intermediate:
    [B, H, W, C] f32 → [B, O, O, C] uint8."""
    B, H, W, C = x_f32.shape
    O = wh.shape[1]
    if x_f32.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the device resize needs TF32 matmuls off "
                           "(ops.common.set_exact_f32)")
    rows = x_f32.permute(0, 1, 3, 2).reshape(B, H * C, W)
    hi = _round_u8(torch.matmul(rows, wh.transpose(1, 2)))        # [B,HC,O]
    hi = hi.reshape(B, H, C * O)
    out = _round_u8(torch.matmul(wv, hi))                         # [B,O,CO]
    return out.reshape(B, O, C, O).permute(0, 1, 3, 2).to(torch.uint8)


def device_resize_pair(staged_u8: torch.Tensor, params: torch.Tensor,
                       out_size: int = 224):
    """Staged frames → (effnet_u8, clip_u8), both ``[B, out, out, 3]``.

    ``staged_u8`` is ``[B, S_h, S_w, 3]`` uint8 with each image in the
    top-left corner and zero padding elsewhere; ``params`` is ``[B, 8]``
    f32 (see PARAM_FIELDS). The effnet flavor is the torchvision
    ``Resize((224,224))`` bilinear squash; the clip flavor is HF
    CLIPProcessor's shortest-edge-224 bicubic + center crop with the crop
    folded into the weight planes.
    """
    sh, sw = staged_u8.shape[1], staged_u8.shape[2]
    x = staged_u8.float()
    params = params.float()
    h, w = params[:, 0], params[:, 1]
    zero = torch.zeros_like(h)
    eff = _resample(
        x,
        _axis_weights(out_size, sh, h, params[:, 2], zero, "bilinear"),
        _axis_weights(out_size, sw, w, params[:, 3], zero, "bilinear"))
    clp = _resample(
        x,
        _axis_weights(out_size, sh, h, params[:, 4], params[:, 5], "bicubic"),
        _axis_weights(out_size, sw, w, params[:, 6], params[:, 7], "bicubic"))
    return eff, clp
