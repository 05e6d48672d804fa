"""Holding the decode-step kernels to their plain versions.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card,
and run on the CPU by ``tests/test_torch_decode_kernels.py`` (where the
wrappers take their plain versions): seeded inputs at a given shape, the
band that a kernel's output must keep from its plain version's, and
planted faults that the band must reject.

The band is elementwise:

    |kernel − plain| ≤ 2^-5·max|plain − x| + n·ulp(max(|x|, |plain|))

The first term is four bf16 steps at the largest magnitude of what the
sub-layer adds to its residual input x. The kernels sum in another order
than cuBLAS and PyTorch's softmax, so a bf16 rounding of h, q, a
probability or the context can land one step apart, and with int8
weights one quantization level. Taken against y itself, the residual
would set the band. The second term is one bf16 step of the residual
stream at each of its n roundings (K6: y; K7: x2 and y).

The band must also fail a wrong kernel. Random keys spread each head's
attention thinly over every row, so a kernel that left rows out would
move y by less than any band. The inputs therefore plant, for every
(batch row, head), one key aimed at that head's query, the planted rows
spread evenly over the attended range: its score is ``PLANT`` against
the random keys' N(0, ~1), so each head attends almost only to its
planted row. The last attended row and the first masked one hold aimed
keys for every head as well. The faults are the plain version run on
inputs that reproduce what a wrong kernel computes: a block of cache
rows or one of the kernel's T chunks left out, the mask one row short or
one row long. Each must fall outside the band.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from misinfo_tpu_torch.ops import cross_ffn_step as K7
from misinfo_tpu_torch.ops import self_attn_step as K6
from misinfo_tpu_torch.ops.common import layer_norm
from misinfo_tpu_torch.ops.quant import quantize_dense

BAND = 2.0 ** -5        # × max|plain − x|
PLANT = 16.0            # score of a planted key


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.exp2((e - 8).float())


def allowed(want: torch.Tensor, x: torch.Tensor,
            roundings: int) -> torch.Tensor:
    """The band around ``want`` elementwise (module docstring)."""
    want, x = want.float(), x.float()
    return (BAND * (want - x).abs().max()
            + roundings * bf16_ulp(torch.maximum(x.abs(), want.abs())))


def hold(got, want, x, roundings: int,
         faults: List[Tuple[str, torch.Tensor]], what: str) -> Dict:
    """Raise unless ``got`` keeps the band around ``want`` and every
    fault leaves it. Returns the largest error, the band's largest
    width, and the nearest fault's distance in bands."""
    band = allowed(want, x, roundings)
    err = (got.float() - want.float()).abs()
    if not bool((err <= band).all()):           # NaN fails here too
        raise AssertionError(
            f"{what} disagrees with its plain version: max error "
            f"{err.max().item()}, band at that element "
            f"{band.expand_as(err).flatten()[err.argmax()].item()}")
    nearest = math.inf
    for name, f in faults:
        r = ((f.float() - want.float()).abs() / band).max().item()
        if not r > 1.0:
            raise AssertionError(f"{what}: the band does not reject the "
                                 f"planted fault '{name}' ({r} bands)")
        nearest = min(nearest, r)
    return {"err": err.max().item(), "band": band.max().item(),
            "faults": len(faults), "nearest_fault": nearest}


# ------------------------------------------------------------------ inputs

def _proj(gen, n_in: int, n_out: int, int8: bool, device) -> Dict:
    p = {"kernel": torch.randn(n_in, n_out, generator=gen) / n_in ** 0.5,
         "bias": torch.randn(n_out, generator=gen) * 0.1}
    if int8:
        p = quantize_dense(p)
    else:
        p["kernel"] = p["kernel"].to(torch.bfloat16)
    return {k: v.to(device) for k, v in p.items()}


def _ln(gen, d: int, device) -> Dict:
    return {"scale": (1 + 0.1 * torch.randn(d, generator=gen)).to(device),
            "bias": (0.1 * torch.randn(d, generator=gen)).to(device)}


def _bf16(gen, shape, device) -> torch.Tensor:
    return torch.randn(*shape, generator=gen).to(torch.bfloat16).to(device)


def _query(ln: Dict, p: Dict, x: torch.Tensor, D: int) -> torch.Tensor:
    """W_q·LN(x) + b in f32 (int8 weights dequantized): near enough to
    the kernel's query to aim a key at it."""
    w = (p["kernel_q"].float() * p["w_scale"] if "kernel_q" in p
         else p["kernel"].float())
    return layer_norm(ln, x).float() @ w[:, :D] + p["bias"][:D].float()


def _spread(n: int, lo: int, hi: int) -> List[int]:
    """n rows spread evenly over [lo, hi)."""
    return [lo + (2 * i + 1) * (hi - lo) // (2 * n) for i in range(n)]


def _plant(cache_k, q, rows, n_heads: int) -> None:
    """cache_k[b, rows[b][h], head h] = PLANT·√Dh·q/|q|², a key whose
    score q·k/√Dh is PLANT."""
    B, D = q.shape
    Dh = D // n_heads
    qh = q.reshape(B, n_heads, Dh)
    key = PLANT * math.sqrt(Dh) * qh / (qh * qh).sum(-1, keepdim=True)
    for b in range(B):
        for h in range(n_heads):
            cache_k[b, rows[b][h], h * Dh:(h + 1) * Dh] = key[b, h].to(
                cache_k.dtype)


def _per_head(rows: List[int], B: int, H: int) -> List[List[int]]:
    return [rows[b * H:(b + 1) * H] for b in range(B)]


def self_attn_case(B: int, pos: int, int8: bool, device="cuda",
                   seed: int = 0, D: int = 512, H: int = 8,
                   S: int = 448) -> Dict:
    """Inputs of one self-attention step: ``args`` for the wrapper and
    its plain version, the planted rows, and ``n_heads``."""
    gen = torch.Generator().manual_seed(seed * 100_003 + B * 1000 + pos)
    x, ln = _bf16(gen, (B, D), device), _ln(gen, D, device)
    qkv, o = _proj(gen, D, 3 * D, int8, device), _proj(gen, D, D, int8,
                                                       device)
    ck, cv = _bf16(gen, (B, S, D), device), _bf16(gen, (B, S, D), device)
    q = _query(ln, qkv, x, D)
    planted = _spread(B * H, 0, pos) if pos > 0 else []
    if planted:
        _plant(ck, q, _per_head(planted, B, H), H)
    if pos + 1 < S:             # the first masked row: a kernel skips it
        _plant(ck, q, [[pos + 1] * H] * B, H)
    return {"args": (x, ln, qkv, o, ck, cv, pos), "n_heads": H,
            "planted": sorted(set(planted))}


def _drop(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return torch.cat([t[:, :lo], t[:, hi:]], dim=1)


def self_attn_faults(case: Dict) -> List[Tuple[str, torch.Tensor]]:
    """Plain outputs of wrong self-attention kernels: a block of old
    cache rows left out; the row past ``pos`` attended."""
    x, ln, qkv, o, ck, cv, pos = case["args"]
    H, S = case["n_heads"], ck.shape[1]

    def plain(k, v, p):
        return K6.self_attn_step_plain(x, ln, qkv, o, k.clone(), v.clone(),
                                       p, n_heads=H)[0]
    out = []
    if pos > 0:
        lo = pos // 2
        hi = min(pos, lo + max(1, pos // 8))
        out.append((f"cache rows {lo}..{hi - 1} left out",
                    plain(_drop(ck, lo, hi), _drop(cv, lo, hi),
                          pos - (hi - lo))))
    if pos + 1 < S:
        # rows 0..pos-1, the stale row pos+1 and the new row: the plain
        # version at pos+1 over caches whose row pos holds row pos+1
        k, v = ck.clone(), cv.clone()
        k[:, pos], v[:, pos] = ck[:, pos + 1], cv[:, pos + 1]
        out.append(("row pos+1 attended", plain(k, v, pos + 1)))
    return out


def check_self_attn(case: Dict) -> Dict:
    """The wrapper (the kernel on CUDA tensors) against the plain version:
    the output in the band, every fault outside it, the written cache row
    in the band and every other row untouched."""
    x, ln, qkv, o, ck, cv, pos = case["args"]
    H = case["n_heads"]
    y, ck1, cv1 = K6.fused_self_attn_step(x, ln, qkv, o, ck.clone(),
                                          cv.clone(), pos, n_heads=H)
    want, ck2, cv2 = K6.self_attn_step_plain(x, ln, qkv, o, ck.clone(),
                                             cv.clone(), pos, n_heads=H)
    res = hold(y, want, x, 1, self_attn_faults(case),
               f"self_attn_step B={x.shape[0]} pos={pos}")
    keep = torch.arange(ck.shape[1], device=ck.device) != pos
    for name, got, ref, orig in (("cache_k", ck1, ck2, ck),
                                 ("cache_v", cv1, cv2, cv)):
        row = ref[:, pos]
        hold(got[:, pos], row, torch.zeros_like(row), 1, [],
             f"self_attn_step {name} row {pos}")
        if not torch.equal(got[:, keep], orig[:, keep]):
            raise AssertionError(f"self_attn_step wrote {name} rows other "
                                 f"than {pos}")
    return res


def cross_ffn_case(B: int, t_actual: int, int8: bool, device="cuda",
                   seed: int = 0, D: int = 512, H: int = 8, T: int = 1500,
                   F: int = 2048) -> Dict:
    """Inputs of one cross-attention + FFN step (``args`` as for
    ``self_attn_case``)."""
    gen = torch.Generator().manual_seed(seed * 100_003 + B * 7 + t_actual)
    x = _bf16(gen, (B, D), device)
    ln_cross, q = _ln(gen, D, device), _proj(gen, D, D, int8, device)
    o, ln2 = _proj(gen, D, D, int8, device), _ln(gen, D, device)
    mlp_in = _proj(gen, D, F, int8, device)
    mlp_out = _proj(gen, F, D, int8, device)
    ck, cv = _bf16(gen, (B, T, D), device), _bf16(gen, (B, T, D), device)
    qv = _query(ln_cross, q, x, D)
    planted = _spread(B * H, 0, t_actual)
    _plant(ck, qv, _per_head(planted, B, H), H)
    _plant(ck, qv, [[t_actual - 1] * H] * B, H)   # the last attended row
    if t_actual < T:                              # the first masked row
        _plant(ck, qv, [[t_actual] * H] * B, H)
    return {"args": (x, ln_cross, q, o, ln2, mlp_in, mlp_out, ck, cv,
                     t_actual),
            "n_heads": H, "planted": sorted(set(planted + [t_actual - 1]))}


def t_chunks(B: int, H: int, T: int, sms: int) -> Tuple[int, int]:
    """The kernel's split of T (``cross_ffn_step.cu::t_chunks``): rows per
    chunk and chunk count, about two attention blocks per SM."""
    ch = min(max(-(-2 * sms // (B * H)), 1), -(-T // 32))
    tc = -(-T // ch)
    return tc, -(-T // tc)


def cross_ffn_faults(case: Dict, sms: int) -> List[Tuple[str, torch.Tensor]]:
    """Plain outputs of wrong cross kernels: each of the kernel's T chunks
    that holds a planted row left out; the mask one row short; one row
    long where the planes have a masked row."""
    x, lnc, q, o, ln2, w1, w2, ck, cv, t_actual = case["args"]
    H, T = case["n_heads"], ck.shape[1]

    def plain(k, v, t):
        return K7.cross_ffn_step_plain(x, lnc, q, o, ln2, w1, w2, k, v, t,
                                       n_heads=H)
    tc, n = t_chunks(x.shape[0], H, T, sms)
    out = []
    for j in range(n):
        lo, hi = j * tc, min(T, (j + 1) * tc)
        if lo >= t_actual or not any(lo <= r < hi for r in case["planted"]):
            continue
        out.append((f"T chunk {j} (rows {lo}..{hi - 1}) left out",
                    plain(_drop(ck, lo, hi), _drop(cv, lo, hi),
                          t_actual - (min(hi, t_actual) - lo))))
    out.append(("mask one row short", plain(ck, cv, t_actual - 1)))
    if t_actual < T:
        out.append(("mask one row long", plain(ck, cv, t_actual + 1)))
    return out


def check_cross_ffn(case: Dict, sms: int) -> Dict:
    """The wrapper (the kernel on CUDA tensors) against the plain version:
    the output in the band and every fault outside it."""
    args, H = case["args"], case["n_heads"]
    y = K7.fused_cross_ffn_step(*args, n_heads=H)
    want = K7.cross_ffn_step_plain(*args, n_heads=H)
    return hold(y, want, args[0], 2, cross_ffn_faults(case, sms),
                f"cross_ffn_step B={args[0].shape[0]} t_actual={args[-1]}")
