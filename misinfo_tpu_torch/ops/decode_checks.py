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
from misinfo_tpu_torch.ops import layer_step as K9
from misinfo_tpu_torch.ops import self_attn_step as K6
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY, layer_norm
from misinfo_tpu_torch.ops.quant import (
    int_einsum, quantize_dense, quantize_rows_folded, times_r127)

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
         faults: List[Tuple[str, torch.Tensor]], what: str,
         slack=None) -> Dict:
    """Raise unless ``got`` keeps the band around ``want`` (widened
    elementwise by ``slack``, where a check derives one) and every fault
    leaves it. Returns the largest error, the band's largest width, and
    the nearest fault's distance in bands."""
    band = allowed(want, x, roundings)
    if slack is not None:
        band = band + slack
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
                   F: int = 2048, x=None) -> Dict:
    """Inputs of one cross-attention + FFN step (``args`` as for
    ``self_attn_case``); ``x`` replaces the seeded residual input."""
    gen = torch.Generator().manual_seed(seed * 100_003 + B * 7 + t_actual)
    x = _bf16(gen, (B, D), device) if x is None else x
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


# ------------------------------------------- int8 cross planes (TPU K8)
#
# The int8-plane step quantizes the probabilities with one scale per
# (batch row, V tile), taken over all heads. Peaked attention alone cannot
# show a kernel that takes that scale per head, or over another tile:
# every head's largest probability is about 1, so all those scales agree.
# The inputs therefore make the heads differ: in every batch row the first
# SPREAD heads attend evenly over the second half of V tile 0 (every key
# there aimed at their queries, identical V lanes), where each position's
# folded probability is 1/n of a loud peak's; the other heads attend one
# planted row each, whose V row is LOUD times louder, one of them in the
# first half of tile 0. With the right scale the spread heads' levels
# round to 0 and their context over tile 0 is nothing; a scale per head,
# or per half tile, resolves them and moves y by their whole context.
# A planted row's K row is K_NOISE times louder outside its head and each
# has a quiet decoy of score DECOY beside it (zeros elsewhere, so a small
# row scale): without the K row scales the decoy outscores the planted
# row. One unattended V row per tile is SHOUT times louder: a kernel that
# applied the V row scales per tile after the quantization would be off by
# that factor.
#
# The band is the bf16-plane step's plus one level of the quantized
# probabilities for every entry that sits at a rounding boundary: expf on
# the card is an ulp or two off PyTorch's, which moves such an entry by
# one level, that is the context by s_p·|v_q| in its head's lanes, and
# through the output projection x2 and y by Σ_d Δctx_d·|W_o[d, n]|
# (taken twice: once for the residual path, once for the FFN, whose gain
# on these seeded weights is below 1).

SPREAD = 4              # heads with spread attention
LOUD = 8.0              # V loudness of a peaked row
K_NOISE = 3.0           # K loudness of a planted row outside its head
DECOY = 10.0            # score of a decoy key
SHOUT = 32.0            # V loudness of the unattended row of every tile
EDGE = 2.0 ** -20       # relative distance from a rounding boundary


def _key(q, score: float, n_heads: int) -> torch.Tensor:
    """[B, H, Dh] keys whose score against q [B, D] is ``score``."""
    B, D = q.shape
    Dh = D // n_heads
    qh = q.reshape(B, n_heads, Dh)
    return score * math.sqrt(Dh) * qh / (qh * qh).sum(-1, keepdim=True)


def row_quant(y: torch.Tensor):
    """int8 rows with one scale per row over the last axis, as
    ``init_kv_cache(cross_int8=True)`` stores the planes."""
    q, s = quantize_rows_folded(y.float())
    return q, s[..., 0]


def cross_i8cc_case(B: int, t_actual: int, device="cuda", seed: int = 0,
                    D: int = 512, H: int = 8, T: int = 1500,
                    F: int = 2048) -> Dict:
    """Inputs of one int8-plane step (comment above): ``args`` and
    ``scales`` for the wrapper and its plain version, the V tile, the
    planted rows."""
    gen = torch.Generator().manual_seed(seed * 100_003 + B * 11 + t_actual)
    Dh = D // H
    x = _bf16(gen, (B, D), device)
    ln_cross, q = _ln(gen, D, device), _proj(gen, D, D, True, device)
    o, ln2 = _proj(gen, D, D, True, device), _ln(gen, D, device)
    mlp_in = _proj(gen, D, F, True, device)
    mlp_out = _proj(gen, F, D, True, device)
    ck, cv = _bf16(gen, (B, T, D), device), _bf16(gen, (B, T, D), device)
    vb = _bf16(gen, (B, SPREAD * Dh), device)
    key = _key(_query(ln_cross, q, x, D), 1.0, H)            # score 1
    tile = K7.v_tile(B, D, T)
    last = t_actual - 1
    lo, hi = tile // 2, min(tile, last)          # the spread region
    assert hi - lo >= 16 and lo >= 8, (tile, t_actual)
    # spread heads: every key of the region aimed, identical V lanes
    ck[:, lo:hi, :SPREAD * Dh] = (PLANT * key[:, None, :SPREAD]).reshape(
        B, 1, SPREAD * Dh).to(ck.dtype)
    cv[:, lo:hi, :SPREAD * Dh] = vb[:, None, :]
    # peaked heads: one loud row each outside the region, leaving room for
    # the decoy behind it; the first of every batch row in tile 0's first
    # half
    free = [t for t in range(0, last - 1, 2) if not lo - 1 <= t < hi]
    n_peak = H - SPREAD
    rows = [free[i] for i in _spread(B * n_peak, 0, len(free))]
    planted = []
    for b in range(B):
        for i, h in enumerate(range(SPREAD, H)):
            t = rows[b * n_peak + i] if i else 2 * (b % (lo // 2 - 1))
            sl = slice(h * Dh, (h + 1) * Dh)
            ck[b, t] = ck[b, t] * K_NOISE
            ck[b, t, sl] = (PLANT * key[b, h]).to(ck.dtype)
            cv[b, t] = cv[b, t] * LOUD
            ck[b, t + 1] = 0
            ck[b, t + 1, sl] = (DECOY * key[b, h]).to(ck.dtype)
            planted.append(t)
    # the last attended row and the first masked one, aimed for every head
    for t in [last] + ([t_actual] if t_actual < T else []):
        ck[:, t] = (PLANT * key).reshape(B, D).to(ck.dtype)
    # one unattended shout per V tile
    used = set(planted) | {t + 1 for t in planted} | {last, t_actual}
    for t0 in range(0, T, tile):
        t = next(t for t in range(min(T, t0 + tile) - 1, t0 - 1, -1)
                 if t not in used and not lo <= t < hi)
        cv[:, t] = cv[:, t] * SHOUT
    (kq, ks), (vq, vs) = row_quant(ck), row_quant(cv)
    return {"args": (x, ln_cross, q, o, ln2, mlp_in, mlp_out, kq, vq,
                     t_actual),
            "scales": {"k_scale": ks, "v_scale": vs}, "n_heads": H,
            "tile": tile, "spread": (lo, hi),
            "planted": sorted(set(planted + [last]))}


def _i8cc_parts(case: Dict, t_actual=None, k_scales: bool = True,
                skip=None):
    """x, the f32 probabilities [B, H, T] and what follows, from the
    plain version's pieces; ``skip`` masks positions [lo, hi) as well."""
    x, lnc, q, o, ln2, w1, w2, kq, vq, ta = case["args"]
    ks = case["scales"]["k_scale"]
    qf = K7._q_f32(q, layer_norm(lnc, x))
    scores = K7.i8cc_scores(qf, kq, ks if k_scales else torch.ones_like(ks),
                            ta if t_actual is None else t_actual,
                            case["n_heads"])
    if skip is not None:
        scores[:, :, skip[0]:skip[1]] = -1e9
    return x, torch.softmax(scores, dim=-1), (o, ln2, w1, w2)


def _i8cc_finish(x, ctx, tail):
    return K7._after_attention(x, ctx.to(x.dtype), *tail, DEFAULT_POLICY)


def _wrong_context(case: Dict, probs, kind: str, piece=None):
    """The context of an emulated wrong V pass: ``per_head`` (a scale per
    head), ``late`` (the probabilities quantized without the V row scales,
    which are applied per tile afterwards as the tile's largest), ``tile``
    (tiles of half the size), ``piece`` (positions [lo, hi) left out)."""
    vq, vs = case["args"][8], case["scales"]["v_scale"]
    B, T, D = vq.shape
    H = case["n_heads"]
    tile = case["tile"] // 2 if kind == "tile" else case["tile"]
    ctx = torch.zeros(B, D, device=probs.device)
    for t0 in range(0, T, tile):
        t1 = min(T, t0 + tile)
        pv = probs[:, :, t0:t1] * (1.0 if kind == "late"
                                   else vs[:, None, t0:t1])
        if kind == "piece":
            pv = pv.clone()
            pv[:, :, max(piece[0] - t0, 0):max(piece[1] - t0, 0)] = 0.0
        sp = (times_r127(pv.amax(dim=2, keepdim=True).clamp_min(1e-30))
              if kind == "per_head" else K7.i8cc_tile_scale(pv))
        pq = torch.clamp(torch.round(pv / sp), 0, 127).to(torch.int8)
        ci = int_einsum("bht,bthd->bhd", pq,
                        vq[:, t0:t1].reshape(B, t1 - t0, H, D // H))
        if kind == "late":
            sp = sp * vs[:, t0:t1].amax(dim=1)[:, None, None]
        ctx = ctx + (ci * sp).reshape(B, D)
    return ctx


def tile_pieces(B: int, H: int, tile: int, nt: int, sms: int):
    """The int8-plane kernel's split of a V tile
    (``cross_ffn_step_i8cc.cu::tile_pieces``): rows per piece, pieces."""
    pp = min(max(-(-2 * sms // (B * H * nt)), 1), -(-tile // 32))
    pc = -(-tile // pp)
    return pc, -(-tile // pc)


def cross_i8cc_faults(case: Dict, sms: int) -> List[Tuple[str, torch.Tensor]]:
    """Plain outputs of wrong int8-plane kernels (comment above)."""
    kq, t_actual = case["args"][7], case["args"][9]
    B, T, _ = kq.shape
    H, tile = case["n_heads"], case["tile"]
    x, probs, tail = _i8cc_parts(case)
    out = [(name, _i8cc_finish(x, _wrong_context(case, probs, kind), tail))
           for name, kind in (
               ("V scales applied after the quantization, per tile", "late"),
               ("the probabilities' scale per head", "per_head"),
               (f"V tiles of {tile // 2} rows for {tile}", "tile"))]

    def right(p):
        return K7.i8cc_context(p, case["args"][8],
                               case["scales"]["v_scale"], tile, H)
    _, p, _ = _i8cc_parts(case, k_scales=False)
    out.append(("K row scales dropped", _i8cc_finish(x, right(p), tail)))
    tc, n = t_chunks(B, H, T, sms)
    for j in range(n):
        lo, hi = j * tc, min(T, (j + 1) * tc)
        if lo < t_actual and any(lo <= r < hi for r in case["planted"]):
            _, p, _ = _i8cc_parts(case, skip=(lo, hi))
            out.append((f"score chunk {j} (rows {lo}..{hi - 1}) left out",
                        _i8cc_finish(x, right(p), tail)))
    nt = -(-T // tile)
    pc, pp = tile_pieces(B, H, tile, nt, sms)
    for j in range(nt):
        for k in range(pp):
            lo = j * tile + k * pc
            hi = min(lo + pc, (j + 1) * tile, T)
            if lo < t_actual and any(lo <= r < hi for r in case["planted"]):
                out.append((
                    f"V piece {k} of tile {j} (rows {lo}..{hi - 1}) left out",
                    _i8cc_finish(x, _wrong_context(case, probs, "piece",
                                                   (lo, hi)), tail)))
    for name, t in (("mask one row short", t_actual - 1),
                    ("mask one row long", t_actual + 1)):
        if t <= T:
            _, p, _ = _i8cc_parts(case, t_actual=t)
            out.append((name, _i8cc_finish(x, right(p), tail)))
    return out


def i8cc_level_slack(case: Dict):
    """What one level of every quantized probability at a rounding
    boundary may move y (comment above), [B, D], and how many entries sit
    at one."""
    o, vq, vs = case["args"][3], case["args"][8], case["scales"]["v_scale"]
    B, T, D = vq.shape
    H, tile = case["n_heads"], case["tile"]
    _, probs, _ = _i8cc_parts(case)
    dctx = torch.zeros(B, D, device=probs.device)
    count = 0
    for t0 in range(0, T, tile):
        t1 = min(T, t0 + tile)
        pv = probs[:, :, t0:t1] * vs[:, None, t0:t1]
        sp = K7.i8cc_tile_scale(pv)
        r = pv / sp
        edge = (((r - torch.floor(r) - 0.5).abs() <= EDGE * (1.0 + r))
                & (r < 127.5))
        count += int(edge.sum())
        v = vq[:, t0:t1].reshape(B, t1 - t0, H, D // H).float().abs()
        dctx += (torch.einsum("bht,bthd->bhd", edge.float(), v)
                 * sp).reshape(B, D)
    wo = (o["kernel_q"].float() * o["w_scale"]).abs()
    return 2.0 * (dctx @ wo), count


def check_cross_i8cc(case: Dict, sms: int) -> Dict:
    """The wrapper (the kernel on CUDA tensors) against the plain version
    on int8 planes: the output in the band and every fault outside it.
    Also returns the share of outputs that are bit for bit the plain
    version's and the count of boundary entries."""
    args, H, sc = case["args"], case["n_heads"], case["scales"]
    y = K7.fused_cross_ffn_step(*args, n_heads=H, **sc)
    want = K7.cross_ffn_step_i8cc_plain(*args, n_heads=H, **sc)
    x, probs, tail = _i8cc_parts(case)
    again = _i8cc_finish(x, K7.i8cc_context(probs, args[8], sc["v_scale"],
                                            case["tile"], H), tail)
    if not torch.equal(again, want):
        raise AssertionError("the faults' pieces do not rebuild the plain "
                             "version")
    slack, edges = i8cc_level_slack(case)
    res = hold(y, want, x, 2, cross_i8cc_faults(case, sms),
               f"cross_ffn_step_i8cc B={x.shape[0]} t_actual={args[-1]}",
               slack)
    res.update(equal=(y == want).float().mean().item(), edges=edges)
    return res


# --------------------------------------------------- whole layer (TPU K9)

def layer_case(B: int, pos: int, device="cuda", seed: int = 0,
               t_actual: int = 1500, **dims) -> Dict:
    """Inputs of one whole-layer step with int8 weights: a self-attention
    case, and a cross case whose keys are aimed at the queries of the
    self-attention step's plain output."""
    sc = self_attn_case(B, pos, True, device, seed,
                        **{k: v for k, v in dims.items() if k != "T"
                           and k != "F"})
    x, ln1, qkv, o1, ck, cv, _ = sc["args"]
    H = sc["n_heads"]
    x1 = K6.self_attn_step_plain(x, ln1, qkv, o1, ck.clone(), cv.clone(),
                                 pos, n_heads=H)[0]
    cc = cross_ffn_case(B, t_actual, True, device, seed + 1, x=x1,
                        **{k: v for k, v in dims.items() if k != "S"})
    _, lnc, q, o2, ln2, w1, w2, xk, xv, _ = cc["args"]
    blk = {"ln1": ln1, "self_attn": {"qkv": qkv, "o": o1}, "ln_cross": lnc,
           "cross_attn": {"q": q, "o": o2}, "ln2": ln2, "mlp_in": w1,
           "mlp_out": w2}
    return {"args": (x, blk, ck, cv, xk, xv, pos, t_actual), "n_heads": H,
            "self": sc, "cross": cc}


def layer_faults(case: Dict, sms: int) -> List[Tuple[str, torch.Tensor]]:
    """Plain outputs of wrong whole-layer kernels: the self-attention
    step's faults carried through the cross step, and the cross step's."""
    cc, H = case["cross"], case["n_heads"]
    out = [(name, K7.cross_ffn_step_plain(x1, *cc["args"][1:], n_heads=H))
           for name, x1 in self_attn_faults(case["self"])]
    return out + cross_ffn_faults(cc, sms)


def check_layer(case: Dict, sms: int) -> Dict:
    """The whole-layer wrapper (the kernel on CUDA tensors): bit for bit
    the two-call route's output and caches, within the band of its plain
    version (three roundings of the residual stream) with every fault
    outside it, rows other than ``pos`` untouched."""
    x, blk, ck, cv, xk, xv, pos, ta = case["args"]
    H = case["n_heads"]
    sa, ca = blk["self_attn"], blk["cross_attn"]
    y, k9, v9 = K9.fused_layer_step(x, blk, ck.clone(), cv.clone(), xk, xv,
                                    pos, ta, n_heads=H)
    x1, k2, v2 = K6.fused_self_attn_step(x, blk["ln1"], sa["qkv"], sa["o"],
                                         ck.clone(), cv.clone(), pos,
                                         n_heads=H)
    y2 = K7.fused_cross_ffn_step(x1, blk["ln_cross"], ca["q"], ca["o"],
                                 blk["ln2"], blk["mlp_in"], blk["mlp_out"],
                                 xk, xv, ta, n_heads=H)
    for name, a, b in (("output", y, y2), ("cache_k", k9, k2),
                       ("cache_v", v9, v2)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"layer_step B={x.shape[0]} pos={pos}: {name} differs from "
                f"the two-call route's by up to "
                f"{(a.float() - b.float()).abs().max().item()}")
    want, kp, vp = K9.layer_step_plain(x, blk, ck.clone(), cv.clone(), xk, xv,
                                       pos, ta, n_heads=H)
    res = hold(y, want, x, 3, layer_faults(case, sms),
               f"layer_step B={x.shape[0]} pos={pos}")
    keep = torch.arange(ck.shape[1], device=ck.device) != pos
    for name, got, ref, orig in (("cache_k", k9, kp, ck),
                                 ("cache_v", v9, vp, cv)):
        row = ref[:, pos]
        hold(got[:, pos], row, torch.zeros_like(row), 1, [],
             f"layer_step {name} row {pos}")
        if not torch.equal(got[:, keep], orig[:, keep]):
            raise AssertionError(f"layer_step wrote {name} rows other than "
                                 f"{pos}")
    return res
