"""CLIP ViT-B/32 dual tower.

Counterpart of ``misinfo_tpu/models/clip.py``: text tower with pre-LN
blocks, causal + padding mask, quick_gelu, pooling at the first EOS and a
bias-free ``text_projection``; vision tower with a 32×32 patch conv (no
bias, NHWC at the public function), class token, learned positions,
pre/post LayerNorm and a bias-free ``visual_projection``. Int8-quantized
FFNs run through the fused int8 FFN (ops/int8_ffn.py, quick mode);
``use_pallas`` selects the fused FFN (``"ffn"``) or fused attention
(``True``) kernels as in models/roberta.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from misinfo_tpu_torch.ops.attention import attention_init, multi_head_attention
from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, dense_init, layer_norm, layer_norm_init,
    quick_gelu)
from misinfo_tpu_torch.ops.fused_ffn import ffn_apply
from misinfo_tpu_torch.ops.int8_ffn import int8_ffn_apply


@dataclass(frozen=True)
class ClipConfig:
    # text tower
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp: int = 2048
    max_text_len: int = 77
    eos_token_id: int = 49407
    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    # shared
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    logit_scale_init: float = 2.6592

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def tiny() -> "ClipConfig":
        return ClipConfig(vocab_size=512, text_width=64, text_layers=2,
                          text_heads=4, text_mlp=128, max_text_len=32,
                          eos_token_id=511, image_size=64, patch_size=16,
                          vision_width=96, vision_layers=2, vision_heads=4,
                          vision_mlp=192, projection_dim=64)


def _block_init(gen: torch.Generator, width: int, mlp: int) -> Dict:
    return {"ln1": layer_norm_init(width), "attn": attention_init(gen, width),
            "ln2": layer_norm_init(width),
            "mlp_in": dense_init(gen, width, mlp),
            "mlp_out": dense_init(gen, mlp, width)}


def _encoder_apply(blocks, x, num_heads, *, mask=None, causal=False,
                   eps=1e-5, policy=DEFAULT_POLICY, use_pallas=False):
    ffn_fused = use_pallas == "ffn"
    attn_pallas = False if ffn_fused else use_pallas
    for blk in blocks:
        h = layer_norm(blk["ln1"], x, eps, policy)
        x = x + multi_head_attention(blk["attn"], h, num_heads, mask=mask,
                                     causal=causal, policy=policy,
                                     use_pallas=attn_pallas)
        h = layer_norm(blk["ln2"], x, eps, policy)
        if "kernel_q" in blk["mlp_in"]:
            h = int8_ffn_apply(blk["mlp_in"], blk["mlp_out"], h,
                               policy=policy, mode="quick")
        elif ffn_fused:
            h = ffn_apply(blk["mlp_in"], blk["mlp_out"], h, policy=policy,
                          mode="quick")
        else:
            h = dense(blk["mlp_out"],
                      quick_gelu(dense(blk["mlp_in"], h, policy)), policy)
        x = x + h
    return x


def clip_init(gen: torch.Generator, cfg: ClipConfig = ClipConfig()) -> Dict:
    s = 0.02

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * s

    text = {
        "token_embedding": normal(cfg.vocab_size, cfg.text_width),
        "position_embedding": normal(cfg.max_text_len, cfg.text_width),
        "blocks": [_block_init(gen, cfg.text_width, cfg.text_mlp)
                   for _ in range(cfg.text_layers)],
        "final_ln": layer_norm_init(cfg.text_width),
    }
    vision = {
        "class_embedding": normal(cfg.vision_width),
        "patch_embedding": normal(cfg.patch_size, cfg.patch_size, 3,
                                  cfg.vision_width),
        "position_embedding": normal(cfg.num_patches + 1, cfg.vision_width),
        "pre_ln": layer_norm_init(cfg.vision_width),
        "blocks": [_block_init(gen, cfg.vision_width, cfg.vision_mlp)
                   for _ in range(cfg.vision_layers)],
        "post_ln": layer_norm_init(cfg.vision_width),
    }
    return {
        "text": text,
        "vision": vision,
        "text_projection": {"kernel": normal(cfg.text_width,
                                             cfg.projection_dim)},
        "visual_projection": {"kernel": normal(cfg.vision_width,
                                               cfg.projection_dim)},
        "logit_scale": torch.tensor(cfg.logit_scale_init),
    }


def clip_text_features(params: Dict, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       cfg: ClipConfig = ClipConfig(),
                       policy: Policy = DEFAULT_POLICY,
                       use_pallas=False) -> torch.Tensor:
    """→ unnormalized text_embeds [B, proj] f32."""
    t = params["text"]
    S = input_ids.shape[1]
    x = t["token_embedding"][input_ids.long()] + t["position_embedding"][:S]
    x = _encoder_apply(t["blocks"], x.to(policy.compute), cfg.text_heads,
                       mask=attention_mask, causal=True,
                       eps=cfg.layer_norm_eps, policy=policy,
                       use_pallas=use_pallas)
    x = layer_norm(t["final_ln"], x, cfg.layer_norm_eps, policy)
    # pool at the first EOS (argmax returns the first maximum)
    eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32),
                           dim=1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
    return dense(params["text_projection"], pooled, policy).float()


def clip_image_features(params: Dict, images: torch.Tensor,
                        cfg: ClipConfig = ClipConfig(),
                        policy: Policy = DEFAULT_POLICY,
                        use_pallas=False) -> torch.Tensor:
    """images [B, H, W, 3] normalized NHWC → unnormalized image_embeds
    [B, proj] f32."""
    v = params["vision"]
    B = images.shape[0]
    w = v["patch_embedding"].to(policy.compute).permute(3, 2, 0, 1)  # OIHW
    patches = F.conv2d(images.to(policy.compute).permute(0, 3, 1, 2), w,
                       stride=cfg.patch_size)                     # NCHW
    patches = patches.permute(0, 2, 3, 1).reshape(B, -1, cfg.vision_width)
    cls = v["class_embedding"].to(policy.compute).expand(B, 1,
                                                         cfg.vision_width)
    x = torch.cat([cls, patches], dim=1)
    x = x + v["position_embedding"].to(policy.compute)
    x = layer_norm(v["pre_ln"], x, cfg.layer_norm_eps, policy)
    x = _encoder_apply(v["blocks"], x, cfg.vision_heads,
                       eps=cfg.layer_norm_eps, policy=policy,
                       use_pallas=use_pallas)
    pooled = layer_norm(v["post_ln"], x[:, 0], cfg.layer_norm_eps, policy)
    return dense(params["visual_projection"], pooled, policy).float()
