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
    DEFAULT_POLICY, Policy, dense, dense_init, dropout, rand_rows, silu)

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


def _bn(bns: List[Dict], xs: List[torch.Tensor], policy=DEFAULT_POLICY,
        stats: Optional[List[list]] = None, axis=None) -> List[torch.Tensor]:
    """BatchNorm of each data position's piece ``xs[i]`` with its own
    ``bns[i]``, math in f32 (channels on dim 1): on the running
    statistics, or with ``stats`` (a list a position) on the batch's,
    appending the updated running statistics to each. Without ``axis``
    (one position) the batch is ``xs[0]``; with it (a training mesh,
    parallel/collectives.py) over more than one data position, the
    statistics are the global batch's, as
    JAX's two-pass ``jnp.var`` over it: the global mean, then the global
    mean of squared deviations, both through ``axis.sum``."""
    c = (-1, 1, 1)
    xfs = [x.float() for x in xs]
    if stats is None:
        means = [bn["mean"] for bn in bns]
        vars_ = [bn["var"] for bn in bns]
    elif axis is None or axis.size == 1:
        xf = xfs[0]
        n = xf.shape[0] * xf.shape[2] * xf.shape[3]
        mean = xf.mean(dim=(0, 2, 3))
        means = [mean]
        vars_ = [(xf - mean.view(c)).square().mean(dim=(0, 2, 3))]
    else:
        n = xfs[0].shape[0] * xfs[0].shape[2] * xfs[0].shape[3] * axis.size
        means = [t / n for t in axis.sum([xf.sum(dim=(0, 2, 3))
                                          for xf in xfs])]
        vars_ = [t / n for t in axis.sum(
            [(xf - m.view(c)).square().sum(dim=(0, 2, 3))
             for xf, m in zip(xfs, means)])]
    if stats is not None:
        for st, bn, m, v in zip(stats, bns, means, vars_):
            st.append(_update_bn_state(bn, m.detach(), v.detach(), n))
    return [((xf - m.view(c)) * torch.rsqrt(v.view(c) + BN_EPS)
             * bn["scale"].view(c) + bn["bias"].view(c)).to(policy.compute)
            for xf, bn, m, v in zip(xfs, bns, means, vars_)]


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


def _forward(params: List[Dict], images: List[torch.Tensor],
             policy: Policy, stats: Optional[List[list]], gens: list,
             dropout_rate: float, axis=None) -> List[torch.Tensor]:
    """The network over the data positions' pieces (one without a mesh),
    layer by layer, so that BatchNorm can take global statistics
    (``_bn``); ``params[i]``, ``images[i]`` and ``gens[i]`` are position
    i's. ``stats`` is None at inference, else a list a position that
    collects each BatchNorm's updated running statistics in tree order
    (stem, each block's expand/dw/project, head)."""
    def conv_bn(key, xs, blks, stride=1, groups=False):
        ys = [_conv(x, b[key]["conv"], stride,
                    groups=x.shape[1] if groups else 1, policy=policy)
              for x, b in zip(xs, blks)]
        return _bn([b[key]["bn"] for b in blks], ys, policy, stats, axis)

    xs = [silu(y) for y in conv_bn(
        "stem", [im.permute(0, 3, 1, 2) for im in images], params, 2)]
    num_blocks = len(params[0]["blocks"])
    for bi, cfg in enumerate(BLOCK_CFGS[:num_blocks]):
        blks = [p["blocks"][bi] for p in params]
        inp = xs
        if "expand" in blks[0]:
            xs = [silu(y) for y in conv_bn("expand", xs, blks)]
        xs = [_se(b["se"], silu(y), policy) for b, y in zip(
            blks, conv_bn("dw", xs, blks, cfg["stride"], groups=True))]
        xs = conv_bn("project", xs, blks)
        if cfg["stride"] == 1 and cfg["cin"] == cfg["cout"]:
            if gens[0] is not None:
                # stochastic depth (row mode), survival linearly decayed
                sd_p = STOCHASTIC_DEPTH_P * bi / num_blocks
                xs = [torch.where(
                    rand_rows(g, (x.shape[0], 1, 1, 1), x.device)
                    < 1.0 - sd_p, x / (1.0 - sd_p), 0.0).to(x.dtype)
                    for x, g in zip(xs, gens)]
            xs = [x + i for x, i in zip(xs, inp)]
    xs = [silu(y) for y in conv_bn("head", xs, params)]
    return [dense(p["classifier"],
                  dropout(g, x.float().mean(dim=(2, 3)), dropout_rate,
                          g is None).to(policy.compute), policy).float()
            for p, x, g in zip(params, xs, gens)]


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
    return _forward([params], [images], policy, None, [None], 0.0)[0], None


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
    logits, = _forward([params], [images], policy, [stats], [gen],
                       dropout_rate)
    return logits, stats


def effnet_train_apply_shards(params: List[Dict],
                              images: List[torch.Tensor], policy: Policy,
                              gens: list, axis, dropout_rate: float = 0.2
                              ) -> Tuple[List[torch.Tensor], List[List]]:
    """``effnet_train_apply`` over a training mesh's local data positions
    (``params[i]`` position i's replica, ``images[i]`` its rows,
    ``gens[i]`` its ``RowShare`` or None): BatchNorm on the global
    batch's statistics through ``axis`` (parallel/collectives.py), the
    global ``n_elem`` in the unbiased running variance. Returns each
    position's logits and BatchNorm state."""
    stats = [[] for _ in params]
    return (_forward(params, images, policy, stats, gens, dropout_rate,
                     axis), stats)


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
