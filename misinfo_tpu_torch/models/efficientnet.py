"""EfficientNet-B0 visual forensics branch.

Counterpart of ``misinfo_tpu/models/efficientnet.py``. Parameters keep
the JAX layout (HWIO conv kernels, NHWC at the public function); the body
runs NCHW through cuDNN convolutions with symmetric (k-1)//2 padding, as
torchvision. ``effnet_apply`` normalizes with the running statistics;
``effnet_train_apply`` with the batch's (f32 over N·H·W), returning the
BatchNorm state (running statistics updated with the unbiased variance
at momentum 0.1), which ``merge_bn_updates`` writes back after the
update; with a generator it also applies stochastic depth and the
classifier's dropout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from misinfo_tpu_torch.ops.common import (
    DEFAULT_POLICY, Policy, dense, dense_init, dropout, silu)

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
BN_MOMENTUM = 0.1
STOCHASTIC_DEPTH_P = 0.2  # torchvision default, linearly scaled per block


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


def _bn(bn: Dict, x, policy=DEFAULT_POLICY, stats: Optional[list] = None):
    """BatchNorm, math in f32 (channels on dim 1): on the running
    statistics, or with ``stats`` (a list) on the batch's, appending the
    updated running statistics to it."""
    c = (-1, 1, 1)
    xf = x.float()
    if stats is None:
        mean, var = bn["mean"], bn["var"]
    else:
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf - mean.view(c)).square().mean(dim=(0, 2, 3))
        stats.append(_update_bn_state(bn, mean.detach(), var.detach(),
                                      x.shape[0] * x.shape[2] * x.shape[3]))
    y = ((xf - mean.view(c)) * torch.rsqrt(var.view(c) + BN_EPS)
         * bn["scale"].view(c) + bn["bias"].view(c))
    return y.to(policy.compute)


def _update_bn_state(bn: Dict, mean, var, n_elem: int) -> Dict:
    """JAX's ``{**bn, mean, var}``: the running statistics updated
    (unbiased variance), scale and bias as they are before the step."""
    unbiased = var * (n_elem / max(1, n_elem - 1))
    return {"scale": bn["scale"].detach().clone(),
            "bias": bn["bias"].detach().clone(),
            "mean": (1 - BN_MOMENTUM) * bn["mean"].detach()
            + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * bn["var"].detach()
            + BN_MOMENTUM * unbiased}


def _se(se: Dict, x, policy=DEFAULT_POLICY):
    """Squeeze-excitation: global avg pool → fc1 → SiLU → fc2 → sigmoid."""
    pooled = x.float().mean(dim=(2, 3))
    h = silu(dense(se["fc1"], pooled.to(policy.compute), policy))
    gate = torch.sigmoid(dense(se["fc2"], h, policy).float())
    return x * gate[:, :, None, None].to(x.dtype)


def _forward(params: Dict, images: torch.Tensor, policy: Policy,
             stats: Optional[list], gen: Optional[torch.Generator],
             dropout_rate: float) -> torch.Tensor:
    """The network; ``stats`` is None at inference, else the list that
    collects each BatchNorm's updated running statistics in tree order
    (stem, each block's expand/dw/project, head)."""
    x = images.permute(0, 3, 1, 2)
    x = silu(_bn(params["stem"]["bn"],
                 _conv(x, params["stem"]["conv"], 2, policy=policy), policy,
                 stats))
    num_blocks = len(params["blocks"])
    for bi, (blk, cfg) in enumerate(zip(params["blocks"], BLOCK_CFGS)):
        inp = x
        if "expand" in blk:
            x = silu(_bn(blk["expand"]["bn"],
                         _conv(x, blk["expand"]["conv"], 1, policy=policy),
                         policy, stats))
        x = _conv(x, blk["dw"]["conv"], cfg["stride"], groups=x.shape[1],
                  policy=policy)
        x = _se(blk["se"], silu(_bn(blk["dw"]["bn"], x, policy, stats)),
                policy)
        x = _bn(blk["project"]["bn"],
                _conv(x, blk["project"]["conv"], 1, policy=policy), policy,
                stats)
        if cfg["stride"] == 1 and cfg["cin"] == cfg["cout"]:
            if gen is not None:
                # stochastic depth (row mode), survival linearly decayed
                sd_p = STOCHASTIC_DEPTH_P * bi / num_blocks
                keep = torch.rand((x.shape[0], 1, 1, 1), generator=gen,
                                  device=x.device) < 1.0 - sd_p
                x = torch.where(keep, x / (1.0 - sd_p), 0.0).to(x.dtype)
            x = x + inp
    x = silu(_bn(params["head"]["bn"],
                 _conv(x, params["head"]["conv"], 1, policy=policy), policy,
                 stats))
    pooled = dropout(gen, x.float().mean(dim=(2, 3)), dropout_rate,
                     gen is None)
    return dense(params["classifier"], pooled.to(policy.compute),
                 policy).float()


def effnet_apply(params: Dict, images: torch.Tensor, *,
                 train: bool = False,
                 rng: Optional[torch.Generator] = None,
                 policy: Policy = DEFAULT_POLICY,
                 dropout_rate: float = 0.2
                 ) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
    """images [B,H,W,3] normalized NHWC → (logits [B, num_classes] f32,
    None), BatchNorm on the running statistics: JAX's call form. With
    ``train=True`` it is ``effnet_train_apply`` (``rng`` a generator on the
    images' device) and the second element holds the updated running
    statistics for ``merge_bn_updates``."""
    if train:
        return effnet_train_apply(params, images, policy, gen=rng,
                                  dropout_rate=dropout_rate)
    return _forward(params, images, policy, None, None, 0.0), None


def effnet_train_apply(params: Dict, images: torch.Tensor,
                       policy: Policy = DEFAULT_POLICY, *,
                       gen: Optional[torch.Generator] = None,
                       dropout_rate: float = 0.2
                       ) -> Tuple[torch.Tensor, List[Dict]]:
    """Training forward (JAX's ``effnet_apply(train=True, rng=...)``):
    BatchNorm on batch statistics → (logits, the updated running
    statistics for ``merge_bn_updates``). Stochastic depth and the
    classifier dropout run only with ``gen``."""
    stats: List[Dict] = []
    logits = _forward(params, images, policy, stats, gen, dropout_rate)
    return logits, stats


def _bn_leaves(params: Dict) -> List[Dict]:
    """Every BatchNorm dict of the tree in ``_forward``'s order."""
    out = [params["stem"]["bn"]]
    for blk in params["blocks"]:
        out += [blk[k]["bn"] for k in ("expand", "dw", "project")
                if k in blk]
    return out + [params["head"]["bn"]]


@torch.no_grad()
def merge_bn_updates(params: Dict, new_state: List[Dict]) -> Dict:
    """Write the state of a training forward over the tree's ``bn``
    leaves, in place (the leaves stay the optimizer's tensors); every
    other leaf is untouched. Returns ``params``. As in JAX, each ``bn``
    dict is replaced whole: the updated running statistics, and scale and
    bias as they were before the step, so that an optimizer update of
    those two is undone (the JAX package's EfficientNet step never trains
    BatchNorm's affine parameters; the port keeps that)."""
    leaves = _bn_leaves(params)
    assert len(leaves) == len(new_state)
    for bn, st in zip(leaves, new_state):
        for k in ("scale", "bias", "mean", "var"):
            bn[k].copy_(st[k])
    return params
