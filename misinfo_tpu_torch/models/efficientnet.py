"""EfficientNet-B0 visual forensics branch, inference only.

Counterpart of ``misinfo_tpu/models/efficientnet.py`` with BatchNorm on
running statistics. Parameters keep the JAX layout (HWIO conv kernels,
NHWC at the public function); the body runs NCHW through cuDNN
convolutions with symmetric (k-1)//2 padding, as torchvision.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, dense_init, silu)

# (expand_ratio, kernel, stride, in_ch, out_ch, num_blocks) — B0 stages
B0_STAGES = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)
STEM_CH = 32
HEAD_CH = 1280
BN_EPS = 1e-5


def _block_cfgs() -> List[Dict]:
    cfgs = []
    for e, k, s, cin, cout, n in B0_STAGES:
        for b in range(n):
            cfgs.append({"expand": e, "kernel": k,
                         "stride": s if b == 0 else 1,
                         "cin": cin if b == 0 else cout, "cout": cout})
    return cfgs


BLOCK_CFGS = _block_cfgs()


def _bn_init(ch: int) -> Dict:
    return {"scale": torch.ones(ch), "bias": torch.zeros(ch),
            "mean": torch.zeros(ch), "var": torch.ones(ch)}


def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int,
               groups: int = 1) -> torch.Tensor:
    std = (2.0 / (k * k * cout)) ** 0.5       # torchvision kaiming fan_out
    return torch.randn(k, k, cin // groups, cout, generator=gen) * std


def effnet_b0_init(gen: torch.Generator, num_classes: int = 2) -> Dict:
    params: Dict = {"stem": {"conv": _conv_init(gen, 3, 3, STEM_CH),
                             "bn": _bn_init(STEM_CH)},
                    "blocks": []}
    for c in BLOCK_CFGS:
        cin, cout, e, k = c["cin"], c["cout"], c["expand"], c["kernel"]
        exp_ch, sq_ch = cin * e, max(1, cin // 4)
        blk: Dict = {}
        if e != 1:
            blk["expand"] = {"conv": _conv_init(gen, 1, cin, exp_ch),
                             "bn": _bn_init(exp_ch)}
        blk["dw"] = {"conv": _conv_init(gen, k, exp_ch, exp_ch, exp_ch),
                     "bn": _bn_init(exp_ch)}
        blk["se"] = {
            "fc1": {"kernel": _conv_init(gen, 1, exp_ch, sq_ch)
                    .reshape(exp_ch, sq_ch), "bias": torch.zeros(sq_ch)},
            "fc2": {"kernel": _conv_init(gen, 1, sq_ch, exp_ch)
                    .reshape(sq_ch, exp_ch), "bias": torch.zeros(exp_ch)},
        }
        blk["project"] = {"conv": _conv_init(gen, 1, exp_ch, cout),
                          "bn": _bn_init(cout)}
        params["blocks"].append(blk)
    params["head"] = {"conv": _conv_init(gen, 1, 320, HEAD_CH),
                      "bn": _bn_init(HEAD_CH)}
    params["classifier"] = dense_init(gen, HEAD_CH, num_classes)
    return params


def _conv(x, kernel, stride: int, groups: int = 1, policy=DEFAULT_POLICY):
    """NCHW conv of an HWIO kernel, output in the compute dtype."""
    k = kernel.shape[0]
    w = kernel.to(policy.compute).permute(3, 2, 0, 1)             # OIHW
    return F.conv2d(x.to(policy.compute), w, stride=stride,
                    padding=(k - 1) // 2, groups=groups)


def _bn(bn: Dict, x, policy=DEFAULT_POLICY):
    """Running-stat BatchNorm, math in f32 (channels on dim 1)."""
    c = (-1, 1, 1)
    y = ((x.float() - bn["mean"].view(c)) * torch.rsqrt(bn["var"].view(c)
                                                         + BN_EPS)
         * bn["scale"].view(c) + bn["bias"].view(c))
    return y.to(policy.compute)


def _se(se: Dict, x, policy=DEFAULT_POLICY):
    """Squeeze-excitation: global avg pool → fc1 → SiLU → fc2 → sigmoid."""
    pooled = x.float().mean(dim=(2, 3))
    h = silu(dense(se["fc1"], pooled.to(policy.compute), policy))
    gate = torch.sigmoid(dense(se["fc2"], h, policy).float())
    return x * gate[:, :, None, None].to(x.dtype)


def effnet_apply(params: Dict, images: torch.Tensor,
                 policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """images [B,H,W,3] normalized NHWC → logits [B, num_classes] f32."""
    x = images.permute(0, 3, 1, 2)
    x = silu(_bn(params["stem"]["bn"],
                 _conv(x, params["stem"]["conv"], 2, policy=policy), policy))
    for blk, cfg in zip(params["blocks"], BLOCK_CFGS):
        inp = x
        if "expand" in blk:
            x = silu(_bn(blk["expand"]["bn"],
                         _conv(x, blk["expand"]["conv"], 1, policy=policy),
                         policy))
        x = _conv(x, blk["dw"]["conv"], cfg["stride"], groups=x.shape[1],
                  policy=policy)
        x = _se(blk["se"], silu(_bn(blk["dw"]["bn"], x, policy)), policy)
        x = _bn(blk["project"]["bn"],
                _conv(x, blk["project"]["conv"], 1, policy=policy), policy)
        if cfg["stride"] == 1 and cfg["cin"] == cfg["cout"]:
            x = x + inp
    x = silu(_bn(params["head"]["bn"],
                 _conv(x, params["head"]["conv"], 1, policy=policy), policy))
    pooled = x.float().mean(dim=(2, 3))
    return dense(params["classifier"], pooled.to(policy.compute),
                 policy).float()
