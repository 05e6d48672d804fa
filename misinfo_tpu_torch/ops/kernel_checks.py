"""Holding the detector's kernels (K1 int8 FFN, K2 int8 dense, K3 fused
attention, K4 LayerNorm, K5 fused FFN) to their plain versions.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card,
and run on the CPU by the ``tests/test_torch_{int8_dense,fused_attention,
fused_ffn}.py`` files, where the wrappers take their plain versions: each
``*_case`` makes seeded inputs at a given shape, each ``check_*`` runs the
wrapper and the plain version, raises unless the output keeps its band,
and raises unless every planted fault (the plain version on inputs that
reproduce what a wrong kernel computes) falls outside it.

Bands, elementwise (ulp: one step of the output dtype at |plain|):

* K1, 3 int8 levels of the output (3·max|y|/127, the band of the JAX
  package's tests/test_pallas_int8.py): the kernel's activations
  (tanhf, erfcf, expf) may differ from PyTorch's by an ulp, which can
  move a quantization level of the intermediate. On the integer grid
  (every scale 1, so the first product and its dequantization are exact)
  bit for bit. The inputs plant a chunk of small activations: chunk 0's
  W1 columns and bias are scaled by 2^-4, and its W2 rows by 2^4, so that
  its share of y stays that of the others while its own scale sg is
  16 times smaller than its row's largest. Faults: chunk 0 left out; the
  intermediate's scale per row instead of per (row, chunk) (chunk 0 then
  loses 4 bits); each chunk's sums scaled by the next chunk's sg; the
  ragged last 128-row tile left unwritten (zeros).
* K2, bit for bit. Its plain version repeats the kernel's arithmetic
  operation for operation (integer sums, IEEE scales, one rounding of the
  epilogue's multiply-add). Fault: one row's scale one ulp high. On a
  fused QKV weight (N = 3D) the one launch also equals the three unfused
  launches bit for bit.
* K3, per element ``Σ_j ulp(p_j)·|v_j| + 2·ε·Σ_j p_j·|v_j| + ulp``, p
  the plain version's probabilities. The output is Σ_j p_j·v_j. The
  kernel sums scores, softmax and PV in other orders than PyTorch: a
  D-term f32 score is off by at most (D + 2)·2^-24·Σ_d|q_d·k_d|/√D, which
  moves each probability by at most twice that of itself, and the softmax
  sum and the PV sum add S_kv·2^-24 each, so ε = 2·(D + 2)·2^-24·A +
  (2·S_kv + 4)·2^-24 with A the largest Σ_d|q_d·k_d|/√D, and a factor 2
  of margin. In bf16 each probability rounded to bf16 can land one step
  of its own apart (the first term; ulp(p_j) ≤ 2^-7·p_j); in f32 that
  term is 0. The inputs plant keys aimed at queries (score 16 against the
  random keys' N(0, 1)), so that every 64-key tile holds a key that some
  query attends almost alone, and in each tile pairs of keys with
  opposite values that one query splits its attention between, at scores
  40.125 ∓ 1/16, either side of a bf16 rounding boundary. Faults: each
  64-key tile left out, the padding mask one column short, the causal
  mask one column late, and in bf16 the scores rounded to bf16 (the
  einsum path's numerics), which the pairs show: rounding moves a pair's
  score difference from 1/8 to 1/4 and its output by about 2^-4·|v|,
  sixteen times the band's two probability steps there (2^-9·|v| each).
* K4, ``|scale|·rstd·8·√D·2^-24·(|mean| + max|x − mean|) + 2^-20·|y| +
  ulp`` per row: the two sides sum the row and its squared deviations in
  other orders (√D·2^-24 relative at the magnitude of the summands, ×8),
  and rsqrtf is within 2 ulp. Rows of three kinds: N(0, 1); a mean of
  1,000 with unit deviation, where a single-pass
  variance E[x²] − E[x]² cancels away; a deviation of 0.003, where eps
  (1e-5) is half the denominator. Faults: the single-pass variance, eps
  dropped.
* K5, per element ``2^-16·(Σ_n |g_n|·|W2_nc| + |b2_c|) + ulp`` in f32 and
  ``2^-12·(Σ_n (|h_n| + |g_n|)·|W2_nc| + |b2_c|) + ulp`` in bf16, h the
  f32 pre-activation and g the intermediate. f32: the sides sum K + N
  products in other orders (the kernel in sequential FMA chains);
  rounding errors of 2^-24 of the partial sums add up like a random
  walk, √(K + N)·2^-24 ≈ 2^-18 of the summands' magnitude, ×4. bf16: the two sides' f32 pre-activations and
  activations differ by a few 2^-24 of themselves, so about one element
  in 2^13 straddles a bf16 rounding, and there h or g lands one step
  (≤ 2^-7 of itself) apart, which moves g by at most 2^-7·(2|h| + |g|);
  the band allows such steps at one element in 2^5 (2^8 times the
  expected rate). Faults: each N chunk left out (its W2 rows zeroed), b2
  dropped, the kernel's last intermediate column tile left out (its W2
  rows zeroed; the up product's tile width in bf16, the chunk in f32), the
  ragged last output row tile left unwritten (zeros; where M is not a
  multiple of the kernel's row tile: ``fused_ffn.tiles``), and for tanh
  the erf GELU in its place, on inputs whose W2
  column 0 carries, for row 0, the difference erf − tanh of the two
  activations in the compute dtype where h > 0 (so that it adds up there;
  in bf16 it is zero where the two round alike) and b2_0 cancelling the
  rest of y_00 (so that its rounding step does not hide the fault).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from misinfo_tpu_torch.ops import fused_attention as K3
from misinfo_tpu_torch.ops import flash_attention as K11
from misinfo_tpu_torch.ops import fused_ffn as K5
from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops import int8_ffn as K1
from misinfo_tpu_torch.ops.common import matmul_f32
from misinfo_tpu_torch.ops.int8_ffn import _act, _act_q, _fma, pick_chunk
from misinfo_tpu_torch.ops.quant import (
    int_matmul, quantize_dense, quantize_rows_folded)
from misinfo_tpu_torch.ops.serving import kmajor

PLANT = 16.0            # score of a planted key
PAIR = 40.125           # a bf16 rounding boundary: 40.0 and 40.25 round apart
FLASH_PAIR = (24.0, 1.1)    # K11's pairs: a key at 24, its partner 1.1 lower
KEY_TILE = 64           # keys per tile of csrc/fused_attention.cu
BAND_K5 = {torch.bfloat16: 2.0 ** -12, torch.float32: 2.0 ** -16}


def out_ulp(t: torch.Tensor, dtype) -> torch.Tensor:
    """One step of ``dtype`` at |t| (8 significant bits for bf16, 24 for
    f32); 0 at t = 0, where every band has another term."""
    m, e = torch.frexp(t.float())
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.where(m == 0, 0.0, torch.exp2((e - bits).float()))


def hold(got, want, band, faults: List[Tuple[str, torch.Tensor]],
         what: str) -> Dict:
    """Raise unless ``got`` keeps ``band`` (elementwise) around ``want``
    and every fault leaves it. Returns the largest error, the band's
    largest width and the nearest fault's distance in bands."""
    err = (got.float() - want.float()).abs()
    band = band.expand_as(err)
    if not bool((err <= band).all()):           # NaN fails here too
        i = int(torch.argmax(err - band))
        raise AssertionError(
            f"{what} disagrees with its plain version: error "
            f"{err.flatten()[i].item()} against a band of "
            f"{band.flatten()[i].item()} (largest error {err.max().item()})")
    nearest = math.inf
    for name, f in faults:
        r = ((f.float() - want.float()).abs() / band).max().item()
        if not r > 1.0:
            raise AssertionError(f"{what}: the band does not reject the "
                                 f"planted fault '{name}' ({r} bands)")
        nearest = min(nearest, r)
    return {"err": err.max().item(), "band": band.max().item(),
            "worst": (err / band).max().item(), "faults": len(faults),
            "nearest_fault": nearest}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# -------------------------------------------------------------- K1 int8 FFN

K1_TILE = 128           # rows of an output tile of csrc/int8_ffn.cu


def int8_ffn_case(M: int, K: int, N: int, mode: str, seed: int = 0,
                  device="cuda", grid: bool = False) -> Dict:
    """Seeded x [M, K] bf16 and the two int8 FFN layers, K-major as the
    engine serves them: Gaussian with chunk 0 planted (module note), or
    (``grid``) integers whose abs-max is 127 per row and per channel, so
    that every scale of x and of the weights is 1."""
    gen = _gen(seed)
    jc = pick_chunk(N)
    if grid:
        x = torch.randint(-126, 127, (M, K), generator=gen).float()
        x[:, 0] = 127.0
        ws = []
        for k, n in ((K, N), (N, K)):
            w = torch.randint(-126, 127, (k, n), generator=gen).float()
            w[0] = 127.0
            ws.append(quantize_dense({"kernel": w, "bias": torch.randint(
                -50, 50, (n,), generator=gen).float()}))
    else:
        x = torch.randn(M, K, generator=gen)
        w1 = torch.randn(K, N, generator=gen) * 0.03
        b1 = torch.randn(N, generator=gen) * 0.01
        w2 = torch.randn(N, K, generator=gen) * 0.03
        w1[:, :jc] *= 2.0 ** -4
        b1[:jc] *= 2.0 ** -4
        w2[:jc] *= 2.0 ** 4
        ws = [quantize_dense({"kernel": w1, "bias": b1}),
              quantize_dense({"kernel": w2, "bias": torch.randn(
                  K, generator=gen) * 0.01})]
    args = [x.to(torch.bfloat16).to(device)]
    for p in ws:
        args += [kmajor(p["kernel_q"].to(device)), p["w_scale"].to(device),
                 p["bias"].to(device)]
    return {"args": tuple(args), "mode": mode, "jc": jc, "grid": grid}


def _ffn_variant(args, mode: str, jc: int, fault: str) -> torch.Tensor:
    """``int8_ffn_plain`` with one fault planted (see the module note)."""
    x, w1q, s1, b1, w2q, s2, b2 = args
    N = w1q.shape[1]
    xq, sx = quantize_rows_folded(x.float())
    gs = [_act_q(_fma(int_matmul(xq, w1q[:, j:j + jc]) * sx, s1[j:j + jc],
                      b1[j:j + jc]), x.dtype, mode)
          for j in range(0, N, jc)]
    qs = [quantize_rows_folded(g) for g in gs]
    if fault == "row_scale":
        sg = quantize_rows_folded(torch.cat(gs, dim=1))[1]
        qs = [(torch.clamp(torch.round(g / sg), -127, 127).to(torch.int8),
               sg) for g in gs]
    acc = torch.zeros(x.shape[0], w2q.shape[1], device=x.device)
    for c, (gq, sg) in enumerate(qs):
        if fault == "chunk" and c == 0:
            continue
        if fault == "next_scale":
            sg = qs[(c + 1) % len(qs)][1]
        acc = _fma(int_matmul(gq, w2q[c * jc:(c + 1) * jc]), sg, acc)
    y = _fma(acc, s2, b2).to(x.dtype)
    if fault == "ragged":
        y[x.shape[0] // K1_TILE * K1_TILE:] = 0
    return y


def int8_ffn_faults(case: Dict) -> List[Tuple[str, torch.Tensor]]:
    """The planted faults that differ from the kernel's function at this
    case: the scale faults need two chunks, the tile fault a ragged M."""
    x, w1q = case["args"][:2]
    names = ["chunk"]
    if w1q.shape[1] > case["jc"]:
        names += ["row_scale", "next_scale"]
    if x.shape[0] % K1_TILE:
        names.append("ragged")
    return [(n, _ffn_variant(case["args"], case["mode"], case["jc"], n))
            for n in names]


def check_int8_ffn(case: Dict) -> Dict:
    """K1 within 3 int8 levels of its plain version, every planted fault
    outside; on the integer grid bit for bit. Counts one launch."""
    a, mode = case["args"], case["mode"]
    what = (f"int8_ffn M={a[0].shape[0]} K={a[0].shape[1]} "
            f"N={a[1].shape[1]} {mode}")
    got = K1.int8_ffn(*a, mode=mode)
    want = K1.int8_ffn_plain(*a, mode=mode)
    if case["grid"]:
        if not torch.equal(got, want):
            d = (got.float() - want.float()).abs()
            raise AssertionError(
                f"{what} differs on the integer grid from its plain version "
                f"in {int((d > 0).sum())} elements (max {d.max()})")
        return {"err": 0.0, "band": 0.0, "worst": 0.0, "faults": 0,
                "nearest_fault": math.inf}
    band = torch.full_like(want, 3 * want.float().abs().max().item() / 127,
                           dtype=torch.float32)
    return hold(got, want, band, int8_ffn_faults(case), what)


# ------------------------------------------------------------ K2 int8 dense

def int8_dense_case(M: int, K: int, N: int, x_dtype=torch.bfloat16,
                    bias: bool = True, seed: int = 0, device="cuda") -> Dict:
    """Seeded x [M, K] and an int8 dense {kernel_q, w_scale, bias?}."""
    gen = _gen(seed)
    p = quantize_dense({"kernel": torch.randn(K, N, generator=gen) * 0.03,
                        "bias": torch.randn(N, generator=gen) * 0.01})
    x = torch.randn(M, K, generator=gen).to(x_dtype)
    return {"x": x.to(device), "wq": kmajor(p["kernel_q"].to(device)),
            "w_scale": p["w_scale"].to(device),
            "bias": p["bias"].to(device) if bias else None}


def check_int8_dense(case: Dict) -> Dict:
    """K2 bit for bit against its plain version with bf16 and with f32
    output; the fault (row 0's scale one ulp high) must differ at f32
    output. (At bf16 output a one-ulp scale moves almost no element.)"""
    x, wq, ws, b = case["x"], case["wq"], case["w_scale"], case["bias"]
    what = f"int8_dense M={x.shape[0]} K={wq.shape[0]} N={wq.shape[1]}"
    for out_dtype in (torch.bfloat16, torch.float32):
        got = K2.int8_dense(x, wq, ws, b, out_dtype=out_dtype)
        want = K2.int8_dense_plain(x, wq, ws, b, out_dtype=out_dtype)
        if not torch.equal(got, want):
            d = (got.float() - want.float()).abs()
            raise AssertionError(
                f"{what} ({out_dtype} out) differs from its plain version "
                f"in {int((d > 0).sum())} elements (max {d.max()})")
    xq, sx = K2.quantize_rows_folded(x.float())
    sx[0] = torch.nextafter(sx[0], torch.full_like(sx[0], math.inf))
    fault = K2.int8_dense_rows(xq, sx, wq, ws, b, torch.float32)
    if torch.equal(fault, want):
        raise AssertionError(f"{what}: a one-ulp scale fault goes unseen")
    return {"err": 0.0, "band": 0.0, "faults": 1,
            "fault_elements": int((fault != want).sum())}


def split_qkv_case(case: Dict) -> List[Dict]:
    """A fused QKV case (N = 3D, as ``serving.fuse_qkv_params`` makes it)
    as its three unfused denses: each third of the weight K-major in a
    buffer of its own, its scales and bias contiguous copies."""
    wq, ws, b = case["wq"], case["w_scale"], case["bias"]
    D = wq.shape[1] // 3
    return [{"x": case["x"], "wq": kmajor(wq[:, i * D:(i + 1) * D]),
             "w_scale": ws[i * D:(i + 1) * D].contiguous(),
             "bias": None if b is None else b[i * D:(i + 1) * D].contiguous()}
            for i in range(3)]


def check_int8_dense_fused(case: Dict) -> Dict:
    """K2 on a fused QKV weight (N = 3D): ``check_int8_dense``, and the
    fused launch equal bit for bit to the three unfused launches side by
    side (per-column weight scales, one activation scale per row, exact
    integer sums and a per-element epilogue), with bf16 and f32 output."""
    res = check_int8_dense(case)
    parts = split_qkv_case(case)
    for out_dtype in (torch.bfloat16, torch.float32):
        fused = K2.int8_dense(case["x"], case["wq"], case["w_scale"],
                              case["bias"], out_dtype=out_dtype)
        three = torch.cat([K2.int8_dense(c["x"], c["wq"], c["w_scale"],
                                         c["bias"], out_dtype=out_dtype)
                           for c in parts], dim=-1)
        if not torch.equal(fused, three):
            d = (fused.float() - three.float()).abs()
            raise AssertionError(
                f"int8_dense fused N={case['wq'].shape[1]} differs from its "
                f"three unfused launches in {int((d > 0).sum())} elements "
                f"(max {d.max()}, {out_dtype} out)")
    return res


# -------------------------------------------------------- K3 fused attention

def attention_case(B: int, S: int, H: int, mask: bool, causal: bool,
                   dtype=torch.bfloat16, seed: int = 0, device="cuda",
                   D: int = 64) -> Dict:
    """Seeded q, k, v [B, S, H, D], a padding mask with a different valid
    length per row (or None), and planted keys: in every 64-key tile of
    the valid range one key aimed at the query of the same index, and
    pairs of keys o − 1 and o aimed at query o at scores PAIR ∓ 1/16,
    with opposite values, for o = t0 + 20, t0 + 30, t0 + 40;
    the last valid key aimed at its query; and (causal) key 2 aimed at
    query 1."""
    gen = _gen(seed * 7919 + S)
    q, k, v = (torch.randn(B, S, H, D, generator=gen) for _ in range(3))
    valid = [S - (b * 37) % max(S // 3, 1) for b in range(B)] if mask \
        else [S] * B
    m = None
    if mask:
        m = torch.zeros(B, S)
        for b, n in enumerate(valid):
            m[b, :n] = 1.0

    def aim(b, key, query, score=PLANT):
        qv = q[b, query]                              # [H, D]
        k[b, key] = (score * math.sqrt(D) * qv
                     / (qv * qv).sum(-1, keepdim=True))

    for b, n in enumerate(valid):
        for t0 in range(0, n, KEY_TILE):
            j = min(t0 + 10, n - 1)
            aim(b, j, j)
            for o in range(t0 + 20, min(t0 + 50, n - 1), 10):
                aim(b, o - 1, o, PAIR - 1 / 16)
                aim(b, o, o, PAIR + 1 / 16)
                v[b, o - 1] = -v[b, o]
        aim(b, n - 1, n - 1)          # the last valid key, seen by its query
        if causal and n >= 3:
            aim(b, 2, 1)              # visible to query 1 one column late
    cast = (lambda t: t.to(dtype).to(device))
    return {"q": cast(q), "k": cast(k), "v": cast(v),
            "mask": None if m is None else m.to(device), "causal": causal,
            "valid": valid}


def attention_faults(case: Dict) -> List[Tuple[str, torch.Tensor]]:
    q, k, v, m, causal = (case[n] for n in ("q", "k", "v", "mask", "causal"))
    B, S = q.shape[:2]
    base = m if m is not None else torch.ones(B, S, device=q.device)
    out = []
    for t0 in range(0, S, KEY_TILE):
        mt = base.clone()
        mt[:, t0:t0 + KEY_TILE] = 0.0
        out.append((f"keys {t0}..{min(S, t0 + KEY_TILE) - 1} left out",
                    K3.fused_attention_plain(q, k, v, mt, causal)))
    if m is not None:
        short = m.clone()
        for b, n in enumerate(case["valid"]):
            short[b, n - 1] = 0.0
        out.append(("mask one column short",
                    K3.fused_attention_plain(q, k, v, short, causal)))
    if causal:
        scores = K3.attention_scores_plain(q, k, m, causal=False)
        idx = torch.arange(S, device=q.device)
        late = idx[:, None] + 1 >= idx[None, :]
        scores = torch.where(late, scores, torch.full_like(scores, -1e9))
        out.append(("causal mask one column late",
                    K3.attention_from_scores_plain(scores, v, q.dtype)))
    if q.dtype == torch.bfloat16:
        scores = K3.attention_scores_plain(q, k, m, causal)
        out.append(("scores rounded to bf16", K3.attention_from_scores_plain(
            scores.to(torch.bfloat16).float(), v, q.dtype)))
    return out


def attention_band(case: Dict, want: torch.Tensor) -> torch.Tensor:
    """The K3 band of the module docstring, elementwise [B, S, H, D]."""
    q, k, v, m, causal = (case[n] for n in ("q", "k", "v", "mask", "causal"))
    D, S_kv = q.shape[-1], k.shape[1]
    probs = torch.softmax(K3.attention_scores_plain(q, k, m, causal), -1)
    va = v.float().abs().permute(0, 2, 1, 3)                # [B, H, S_kv, D]
    A = torch.matmul(q.float().abs().permute(0, 2, 1, 3),
                     k.float().abs().permute(0, 2, 3, 1)).max() / D ** 0.5
    eps = (2 * (D + 2) * A + 2 * S_kv + 4) * 2.0 ** -24
    band = 2 * eps * torch.matmul(probs, va)
    if q.dtype != torch.float32:
        band = band + torch.matmul(out_ulp(probs, q.dtype), va)
    return band.permute(0, 2, 1, 3) + out_ulp(want, q.dtype)


def check_attention(case: Dict) -> Dict:
    q, k, v, m, causal = (case[n] for n in ("q", "k", "v", "mask", "causal"))
    got = K3.fused_attention(q, k, v, m, causal)
    want = K3.fused_attention_plain(q, k, v, m, causal)
    B, S, H, _ = q.shape
    return hold(got, want, attention_band(case, want), attention_faults(case),
                f"fused_attention B={B} S={S} H={H} {q.dtype} "
                f"mask={m is not None} causal={causal}")


# -------------------------------------------------------------- K4 LayerNorm

def layer_norm_case(rows: int, D: int, dtype=torch.bfloat16, seed: int = 0,
                    device="cuda") -> Dict:
    """Seeded rows: a third N(0, 1), a third at a mean of 1,000 with unit
    deviation, a third with deviation 0.003;
    scale 1 + 0.1·N(0, 1), bias 0.1·N(0, 1)."""
    gen = _gen(seed + rows)
    x = torch.randn(rows, D, generator=gen)
    third = rows // 3
    x[third:2 * third] += 1000.0
    x[2 * third:] *= 0.003
    return {"x": x.to(dtype).to(device),
            "scale": (1 + 0.1 * torch.randn(D, generator=gen)).to(device),
            "bias": (0.1 * torch.randn(D, generator=gen)).to(device)}


def _single_pass(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def check_layer_norm(case: Dict, eps: float = 1e-5) -> Dict:
    x, s, b = case["x"], case["scale"], case["bias"]
    got = K3.fused_layer_norm(x, s, b, eps)
    want = K3.fused_layer_norm_plain(x, s, b, eps)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    dev = (xf - mean).abs().amax(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(dim=-1, keepdim=True) + eps)
    D = x.shape[-1]
    band = (s.abs() * rstd * 8 * math.sqrt(D) * 2.0 ** -24
            * (mean.abs() + dev) + 2.0 ** -20 * want.float().abs()
            + out_ulp(want, x.dtype))
    faults = [("single-pass variance", _single_pass(x, s, b, eps)),
              ("eps dropped", K3.fused_layer_norm_plain(x, s, b, 0.0))]
    return hold(got, want, band, faults,
                f"fused_layer_norm rows={x.shape[0]} D={D} {x.dtype}")


# ------------------------------------------------------------- K5 fused FFN

def ffn_case(M: int, K: int, N: int, mode: str, dtype=torch.bfloat16,
             seed: int = 0, device="cuda") -> Dict:
    """Seeded x [M, K] ~ N(0, 1), W1/W2 ~ 0.03·N(0, 1), b1 ~ 0.1·N(0, 1),
    b2 ~ N(0, 1); for tanh, W2's column 0 planted with 0.03·d/max|d|, d
    the difference erf GELU − tanh GELU in ``dtype`` at row 0's positive
    pre-activations (0 elsewhere), and b2_0 = −y_00 without it, so that
    y_00 and its rounding step are small."""
    gen = _gen(seed * 31 + M)
    x = torch.randn(M, K, generator=gen).to(dtype)
    w1 = (0.03 * torch.randn(K, N, generator=gen)).to(dtype)
    b1 = 0.1 * torch.randn(N, generator=gen)
    w2 = 0.03 * torch.randn(N, K, generator=gen)
    b2 = torch.randn(K, generator=gen)
    if mode == "tanh":
        h = x[:1].float() @ w1.float() + b1
        d = (_act(h, dtype, "erf") - _act(h, dtype, "tanh")).float()[0]
        d = torch.where(h[0] > 0, d, 0.0)
        w2[:, 0] = 0.03 * d / d.abs().max()
        g = _act(h, dtype, "tanh").float()[0]
        b2[0] = -(g @ w2[:, 0].to(dtype).float())
    return {"args": tuple(t.to(device) for t in (x, w1, b1, w2.to(dtype),
                                                 b2)),
            "mode": mode}


def ffn_faults(case: Dict) -> List[Tuple[str, torch.Tensor]]:
    x, w1, b1, w2, b2 = case["args"]
    mode = case["mode"]
    M, (N, K2) = x.shape[0], w2.shape
    jc = pick_chunk(N)
    out = []
    for j0 in range(0, N, jc):
        w2j = w2.clone()
        w2j[j0:j0 + jc] = 0
        out.append((f"chunk {j0 // jc} left out",
                    K5.fused_ffn_plain(x, w1, b1, w2j, b2, mode=mode)))
    out.append(("b2 dropped", K5.fused_ffn_plain(
        x, w1, b1, w2, torch.zeros_like(b2), mode=mode)))
    rows, cols = K5.tiles(M, N, K2, x.dtype, K5.sm_count(x.device))
    j0 = (N - 1) // cols * cols
    w2j = w2.clone()
    w2j[j0:] = 0
    out.append((f"intermediate columns {j0}..{N - 1} (the last "
                f"{cols}-column tile) left out",
                K5.fused_ffn_plain(x, w1, b1, w2j, b2, mode=mode)))
    if M % rows:
        y = K5.fused_ffn_plain(x, w1, b1, w2, b2, mode=mode)
        y[M // rows * rows:] = 0
        out.append((f"the ragged last {rows}-row tile dropped", y))
    if mode == "tanh":
        out.append(("erf in place of tanh",
                    K5.fused_ffn_plain(x, w1, b1, w2, b2, mode="erf")))
    return out


def check_ffn(case: Dict) -> Dict:
    x, w1, b1, w2, b2 = case["args"]
    mode = case["mode"]
    got = K5.fused_ffn(x, w1, b1, w2, b2, mode=mode)
    want = K5.fused_ffn_plain(x, w1, b1, w2, b2, mode=mode)
    h = matmul_f32(x.reshape(-1, x.shape[-1]), w1) + b1
    hg = _act(h, x.dtype, mode).float().abs()
    if x.dtype != torch.float32:
        hg = hg + h.abs()
    band = (BAND_K5[x.dtype] * (hg @ w2.float().abs() + b2.abs())
            + out_ulp(want, x.dtype))
    return hold(got, want, band, ffn_faults(case),
                f"fused_ffn M={x.shape[0]} K={w1.shape[0]} N={w1.shape[1]} "
                f"{x.dtype} mode={mode}")


# ------------------------------------------------------ K11 flash attention

def flash_case(B: int, S: int, H: int, layout: str, causal: bool,
               dtype=torch.bfloat16, seed: int = 0, device="cuda",
               D: int = 64, blank_row: bool = False) -> Dict:
    """Seeded q, k, v [B, S, H, D] and segment ids in one of three
    layouts: "packed" (ragged requests of 16-200 tokens with ids 1, 2, ...
    and a padding tail of segment 0, a different length per row, none in
    row 0), "padded" (the padded form: q_seg all 1, kv_seg a padding mask
    with a different valid length per row) or "none" (no segment ids).
    Planted, in every 128-key tile of each row: key t0 + 10 (the last
    seen key where that is padding) aimed at its own query (score PLANT);
    pairs of keys o − 1, o aimed at query o at scores 22.9 and 24 with
    value o − 1 zeroed, for o = t0 + 30, 50, 70 (the output is then
    v_o·1/l, l ≈ 1.33, whose bf16 rounding sits anywhere between two
    steps); causal, key t0 + 91 aimed at query t0 + 90 (visible one
    column late). ``blank_row`` (padded only): the last row all padding,
    so that its queries see no key (JAX's p is then uniform there)."""
    gen = _gen(seed * 7919 + S + 1)
    q, k, v = (torch.randn(B, S, H, D, generator=gen) for _ in range(3))
    q_seg = kv_seg = None
    seen = torch.ones(B, S)            # keys some query sees
    if layout == "packed":
        seg = torch.zeros(B, S, dtype=torch.int32)
        for b in range(B):
            end = S - (b * 53) % max(S // 4, 1)
            pos, sid = 0, 1
            while pos < end:
                n = int(torch.randint(16, 201, (1,), generator=gen))
                seg[b, pos:min(end, pos + n)] = sid
                pos, sid = pos + n, sid + 1
        q_seg = kv_seg = seg
    elif layout == "padded":
        valid = [S - (b * 37) % max(S // 3, 1) for b in range(B)]
        if blank_row:
            valid[-1] = 0
        kv_seg = torch.zeros(B, S, dtype=torch.int32)
        for b, n in enumerate(valid):
            kv_seg[b, :n] = 1
            seen[b, n:] = 0
        q_seg = torch.ones(B, S, dtype=torch.int32)
    elif layout != "none":
        raise ValueError(f"flash_case: layout {layout!r}")

    def aim(b, key, query, score=PLANT):
        qv = q[b, query]                              # [H, D]
        k[b, key] = (score * math.sqrt(D) * qv
                     / (qv * qv).sum(-1, keepdim=True))

    hi, gap = FLASH_PAIR
    for b in range(B):
        n = int(seen[b].sum())
        for t0 in range(0, S, K11.BLOCK):
            j = min(t0 + 10, n - 1) if layout == "padded" else t0 + 10
            if j >= 0:
                aim(b, j, j)
            for o in (t0 + 30, t0 + 50, t0 + 70):
                aim(b, o - 1, o, hi - gap)
                aim(b, o, o, hi)
                v[b, o - 1] = 0.0
            if causal:
                aim(b, t0 + 91, t0 + 90)
    cast = (lambda t: t.to(dtype).to(device))
    seg = (lambda t: None if t is None else t.to(device))
    return {"q": cast(q), "k": cast(k), "v": cast(v), "q_seg": seg(q_seg),
            "kv_seg": seg(kv_seg), "causal": causal, "layout": layout,
            "seen": seen.to(device)}


def _flash_args(case: Dict):
    return tuple(case[n] for n in ("q", "k", "v", "q_seg", "kv_seg",
                                   "causal"))


def flash_faults(case: Dict) -> List[Tuple[str, torch.Tensor]]:
    """The wrong kernels that differ from K11's function at this case:
    each key tile that holds a key some query sees, left out; the einsum
    path's ``kv_seg > 0`` rule (where some query is in segment 0); alpha
    taken as 1 (more than one key tile); in bf16, p rounded on the other
    side of the 1/l multiply; causal, the mask one column late; sm_scale
    dropped."""
    q, k, v, qs, ks, causal = _flash_args(case)
    S_kv = k.shape[1]
    nt = S_kv // K11.BLOCK

    def run(**fault):
        return K11.flash_core(q, k, v, qs, ks, causal, fault=fault)["out"]
    out = []
    seen = case["seen"].amax(0)
    for t in range(nt):
        t0 = t * K11.BLOCK
        if bool(seen[t0:t0 + K11.BLOCK].any()):
            out.append((f"key tile {t0}..{t0 + K11.BLOCK - 1} left out",
                        run(skip=(t,))))
    if qs is not None and bool((qs == 0).any()):
        out.append(("the einsum path's kv_seg > 0 rule", run(rule="einsum")))
    if nt > 1:
        out.append(("alpha rescale dropped", run(no_alpha=True)))
    if q.dtype == torch.bfloat16:
        out.append(("p rounded before the divide" if nt == 1 else
                    "p rounded after the 1/l multiply",
                    run(swap_round=True)))
    if causal:
        out.append(("causal mask one column late", run(shift=1)))
    out.append(("sm_scale dropped", run(no_scale=True)))
    return out


def flash_band(case: Dict, r=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the plain output, K11's band around it), elementwise [B, S, H, D];
    ``r``: the case's ``flash_core(..., keep=True)``, if already taken.

    The kernel's f32 accumulator differs from the plain version's by at
    most E (below); its output is that accumulator rounded to q's dtype,
    so it lies between the roundings of acc ± E, and the band is the
    distance from the plain output to the farther of the two. Where E is
    far from a rounding boundary of the output the band is (nearly) 0:
    the kernel must then give the plain output exactly.

    E = 2·Σ_j p_j·|v_j|·(γ·(A_j + A*) + (2·S_kv + 8·nt + 8)·2^-24
    + 2^-7·[p_j near a bf16 boundary]), p_j the weight of key j in the
    output, A_j = Σ_d|q_d·k_jd|·scale (A* its row's largest) and
    γ = (D + 2)·2^-24: a D-term f32 score is off by at most γ·A_j, which
    moves exp(s − m) by γ·(A_j + A*) of itself with the max's error; the
    softmax and P·V sums (any order, tensor-core sums included), the
    rescale at each of the nt key tiles (and at each tile the kernel
    leaves out, l·(1/l)) and exp's last bits add the second term. In bf16
    each p is rounded to bf16 before it meets V (after the divide in the
    single-step form), and where the plain p lies within its own error
    bound of a rounding boundary the kernel's may round to the other
    side: one bf16 step, at most 2^-7 of p. The factor 2 is margin. The
    band takes the kernel's key tile to be JAX's block of 128: with
    another tile the running max, and with it the rounding of every p,
    would move by more than these bounds."""
    q, k, v, qs, ks, causal = _flash_args(case)
    D, S_kv = q.shape[-1], k.shape[1]
    nt = S_kv // K11.BLOCK
    scale = 1.0 / math.sqrt(D)
    if r is None:
        r = K11.flash_core(q, k, v, qs, ks, causal, keep=True)
    u = 2.0 ** -24
    gamma = (D + 2) * u
    A = torch.matmul(q.float().abs().permute(0, 2, 1, 3),
                     k.float().abs().permute(0, 2, 3, 1)) * scale
    mask = K11.visible(qs, ks, causal, q.shape[1], S_kv, q.device)
    if mask is not None:
        A = torch.where(mask[:, None], A, 0.0)
    a_max = A.amax(-1, keepdim=True)
    p = r["p"]
    va = v.float().abs().permute(0, 2, 1, 3)                # [B, H, S_kv, D]
    pv = torch.matmul(p, va)
    E = gamma * (torch.matmul(p * A, va) + a_max * pv) \
        + (2 * S_kv + 8 * nt + 8) * u * pv
    if q.dtype == torch.bfloat16:
        pre = r["p_pre"]
        delta = 2 * (gamma * (A + a_max)
                     + u * ((r["s"] - r["m_run"]).abs() + S_kv + 8))
        near = ((pre * (1 - delta)).to(torch.bfloat16)
                != (pre * (1 + delta)).to(torch.bfloat16))
        E = E + 2.0 ** -7 * torch.matmul(p * near, va)
    E = 2 * E
    acc, want = r["acc"], r["out"].float()
    gap = torch.maximum(
        ((acc + E).to(q.dtype).float().permute(0, 2, 1, 3) - want).abs(),
        ((acc - E).to(q.dtype).float().permute(0, 2, 1, 3) - want).abs())
    return r["out"], gap + torch.finfo(torch.float32).tiny


def flash_residual_band(case: Dict, r=None) -> Dict:
    """The plain forward's residuals and K11's bands around them: {"l",
    "m", "l_band", "m_band"}, [B, H, S] f32 (``r`` as ``flash_band``'s).

    m is the row's largest masked score: the kernel's lies within its
    score's error, 2·(γ·A* + 2^-23·|m|) (A* and γ as in ``flash_band``),
    where the row sees a key; a row that sees none has m = MASK_VALUE
    exactly on both sides (s + MASK_VALUE rounds to MASK_VALUE), band 0.
    l = Σ_j e_j over the walked keys, e_j = exp(s_j − m):
    E_l = 2·(Σ_j e_j·(γ·(A_j + A*) + 2^-23·(|s_j| + |m|) + 4·2^-24)
    + (2·S_kv + 8·nt + 8)·2^-24·l), the first sum over the visible keys
    (an invisible key's e_j is exp(0) or 0 on both sides, exactly), the
    second the sums in any order and the rescale at every tile."""
    q, k, v, qs, ks, causal = _flash_args(case)
    D, S, S_kv = q.shape[-1], q.shape[1], k.shape[1]
    nt = S_kv // K11.BLOCK
    scale = 1.0 / math.sqrt(D)
    if r is None:
        r = K11.flash_core(q, k, v, qs, ks, causal, keep=True)
    l, m, s = r["l"], r["m"], r["s"]
    u = 2.0 ** -24
    gamma = (D + 2) * u
    A = torch.matmul(q.float().abs().permute(0, 2, 1, 3),
                     k.float().abs().permute(0, 2, 3, 1)) * scale
    mask = K11.visible(qs, ks, causal, S, S_kv, q.device)
    vis = (torch.ones_like(A, dtype=torch.bool) if mask is None
           else mask[:, None].expand_as(A))
    if causal:                          # the walked key blocks only
        blk = torch.arange(S_kv, device=q.device) // K11.BLOCK
        vis = vis & (blk[None, :]
                     <= torch.arange(S, device=q.device)[:, None]
                     // K11.BLOCK)
    A = torch.where(vis, A, 0.0)
    a_max = A.amax(-1)
    sees = vis.any(-1)
    e = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    rel = gamma * (A + a_max[..., None]) + 2 * u * (s.abs()
                                                    + m.abs()[..., None])
    e_err = (e * torch.where(vis, rel, 0.0)).sum(-1) + 4 * u * e.sum(-1)
    tiny = torch.finfo(torch.float32).tiny
    return {"l": l, "m": m,
            "l_band": 2 * (e_err + (2 * S_kv + 8 * nt + 8) * u * l) + tiny,
            "m_band": torch.where(sees, 2 * (gamma * a_max
                                             + 2 * u * m.abs()), 0.0) + tiny}


def _flash_what(case: Dict) -> str:
    B, S, H, _ = case["q"].shape
    return (f"B={B} S={S} H={H} {case['q'].dtype} {case['layout']} "
            f"causal={case['causal']}")


def check_flash_residuals(case: Dict, out=None, r=None) -> Dict:
    """K11's launch with residuals: its l and m within
    ``flash_residual_band`` (``r`` as ``flash_band``'s) and, given the
    launch without them (``out``), the same output bit for bit."""
    q, k, v, qs, ks, causal = _flash_args(case)
    what = f"flash_attention {_flash_what(case)}"
    out_r, l, m = K11.flash_forward(q, k, v, qs, ks, causal)
    if out is not None and not torch.equal(out_r, out):
        raise AssertionError(f"{what}: the launch with residuals gives "
                             "another output")
    rb = flash_residual_band(case, r)
    return hold(torch.stack([l, m]), torch.stack([rb["l"], rb["m"]]),
                torch.stack([rb["l_band"], rb["m_band"]]), [],
                f"{what} residuals l, m")


def check_flash(case: Dict) -> Dict:
    """K11 against its plain version (``flash_band``, ``flash_faults``),
    and its residuals (``check_flash_residuals``)."""
    q, k, v, qs, ks, causal = _flash_args(case)
    got = K11.flash_attention(q, k, v, qs, ks, causal)
    r = K11.flash_core(q, k, v, qs, ks, causal, keep=True)
    want, band = flash_band(case, r)
    res = hold(got, want, band, flash_faults(case),
               f"flash_attention {_flash_what(case)}")
    res["residual_worst"] = check_flash_residuals(case, got, r)["worst"]
    return res


# ------------------------------------------------- K11-bwd, its backward

def flash_bwd_case(B: int, S: int, H: int, layout: str, causal: bool,
                   dtype=torch.bfloat16, seed: int = 0,
                   device="cuda") -> Dict:
    """``flash_case`` (the padded form with its last row all padding) plus
    what the backward takes: the plain forward's output "o" and residuals
    "l", "m", and a seeded N(0, 1) output gradient "do" in q's dtype."""
    c = flash_case(B, S, H, layout, causal, dtype, seed, device,
                   blank_row=layout == "padded")
    r = K11.flash_core(c["q"], c["k"], c["v"], c["q_seg"], c["kv_seg"],
                       causal)
    gen = _gen(seed * 104729 + S + 2)
    do = torch.randn(c["q"].shape, generator=gen).to(dtype).to(device)
    c.update(o=r["out"], l=r["l"], m=r["m"], do=do)
    return c


def _bwd_args(case: Dict):
    return (*(case[n] for n in ("q", "k", "v", "q_seg", "kv_seg", "o", "l",
                                "m", "do")), case["causal"])


def _flat(*ts) -> torch.Tensor:
    return torch.cat([t.float().flatten() for t in ts])


def flash_bwd_faults(case: Dict) -> List[Tuple[str, torch.Tensor]]:
    """The wrong backward kernels, as (dQ, dK, dV) flattened: each query
    tile left out of dK/dV; each key tile that some query sees left out of
    dQ; di left out; in bf16, p not rounded to dO's dtype before dV;
    sm_scale dropped from ds; causal, the mask one column late; the einsum
    path's ``kv_seg > 0`` rule (where some query is in segment 0); each
    row's l taken from the row before."""
    q, k, v, qs, ks, o, l, m, do, causal = _bwd_args(case)
    S, S_kv = q.shape[1], k.shape[1]
    di = K11.flash_di(o, do)
    args = (q, k, v, qs, ks, l, m, do, di, causal)
    dq = K11.flash_dq_plain(*args)
    dk, dv = K11.flash_dkv_plain(*args)
    out = []
    for t in range(S // K11.BLOCK):
        out.append((f"query tile {t} left out of dK/dV",
                    _flat(dq, *K11.flash_dkv_plain(
                        *args, fault={"skip_q": (t,)}))))
    seen = case["seen"].amax(0)
    for t in range(S_kv // K11.BLOCK):
        if bool(seen[t * K11.BLOCK:(t + 1) * K11.BLOCK].any()):
            out.append((f"key tile {t} left out of dQ",
                        _flat(K11.flash_dq_plain(
                            *args, fault={"skip_k": (t,)}), dk, dv)))

    def run(**fault):
        return _flat(K11.flash_dq_plain(*args, fault=fault),
                     *K11.flash_dkv_plain(*args, fault=fault))
    out.append(("di left out", run(no_di=True)))
    if q.dtype == torch.bfloat16:
        out.append(("p not rounded before dV",
                    _flat(dq, *K11.flash_dkv_plain(
                        *args, fault={"unrounded_p": True}))))
    out.append(("sm_scale dropped from ds", run(no_ds_scale=True)))
    if causal:
        out.append(("causal mask one column late", run(shift=1)))
    if qs is not None and bool((qs == 0).any()):
        out.append(("the einsum path's kv_seg > 0 rule", run(rule="einsum")))
    out.append(("l from the row before", run(l_roll=True)))
    return out


def flash_bwd_band(case: Dict, o_err=None, l_err=None,
                   m_err=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the plain (dQ, dK, dV) flattened, K11-bwd's band around it).

    Both sides take the same residuals and di, so they part only where
    they sum in other orders and, in bf16, where p or ds rounds to the
    other side of a bf16 boundary. With u = 2^-24 and γ = (D + 2)·u:
    p_ij = exp(s_ij − m_i)·(1/l_i) is off by at most δp_ij = p_ij·(γ·A_ij
    + 2u·(|s_ij| + |m_i|) + 4u) at a visible key (A_ij = Σ_d|q_d·k_jd|
    ·scale; the score's sum, the scale, the subtraction and exp's last
    bits), by 4u·p_ij at an invisible one (exp(0) or 0 on both sides);
    dp_ij = dO_i·v_j by γ·Σ_d|dO_d·v_jd|; so ds_ij = (dp_ij − di_i)·p_ij
    ·scale by E_ij = scale·(γ·Σ|dO·v|·(p + δp) + |dp − di|·δp) + 6u·|ds|.
    In bf16 a p (a ds) whose interval p ± δp (ds ± E) straddles a bf16
    boundary may round one step apart: 2^-7·(p + δp) (2^-7·(|ds| + E)).
    Each gradient's f32 sum then carries those errors times |dO|, |q| or
    |k| and its own rounding, (2·n + 8)·u of its terms' magnitude over n
    terms; the factor 2 is margin, and the band is the distance from the
    plain output to the farther rounding of its f32 sum ± that bound.
    ``o_err`` ([B, S, H, D]), ``l_err`` and ``m_err`` ([B, H, S]) widen it
    for a side whose forward output and residuals are only known within
    those bands (a JAX run on the same inputs): di by Σ_d o_err·|dO|, each
    p by m_err + l_err/l of itself."""
    q, k, v, qs, ks, o, l, m, do, causal = _bwd_args(case)
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    u = 2.0 ** -24
    gamma = (D + 2) * u
    bf16 = q.dtype == torch.bfloat16
    di = K11.flash_di(o, do)
    r = K11.bwd_parts(q, k, v, qs, ks, l, m, do, di, causal, scale)
    p, dp, ds, s = r["p"], r["dp"], r["ds"], r["s"]
    qa, ka, va, doa = (t.float().abs().permute(0, 2, 1, 3)
                       for t in (q, k, v, do))
    mask = K11.visible(qs, ks, causal, S, S_kv, q.device)
    rel = (gamma * torch.matmul(qa, ka.transpose(-1, -2)) * scale
           + 2 * u * (s.abs() + m.abs()[..., None]))
    if mask is not None:
        rel = torch.where(mask[:, None], rel, 0.0)
    rel = rel + 4 * u
    if m_err is not None:
        rel = rel + m_err[..., None]
    if l_err is not None:
        rel = rel + (l_err / l)[..., None]
    dP = p * rel
    e_ds = scale * (gamma * torch.matmul(doa, va.transpose(-1, -2))
                    * (p + dP) + (dp - di[..., None]).abs() * dP)
    if o_err is not None:
        ddi = (o_err.float() * do.float().abs()).sum(-1).permute(0, 2, 1)
        e_ds = e_ds + scale * ddi[..., None] * (p + dP)
    e_ds = e_ds + 6 * u * ds.abs()
    pd, dsd = p, ds
    if bf16:
        def flips(x, e):
            return ((x - e).to(torch.bfloat16)
                    != (x + e).to(torch.bfloat16)).float()
        dP = dP + 2.0 ** -7 * flips(p, dP) * (p + dP)
        e_ds = e_ds + 2.0 ** -7 * flips(ds, e_ds) * (ds.abs() + e_ds)
        pd, dsd = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    pa, dsa = p + dP, ds.abs() + e_ds
    qf, kf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, do))
    accs = (torch.matmul(dsd, kf),                           # dQ
            torch.matmul(dsd.transpose(-1, -2), qf),         # dK
            torch.matmul(pd.transpose(-1, -2), dof))         # dV
    errs = (torch.matmul(e_ds, ka) + (2 * S_kv + 8) * u
            * torch.matmul(dsa, ka),
            torch.matmul(e_ds.transpose(-1, -2), qa) + (2 * S + 8) * u
            * torch.matmul(dsa.transpose(-1, -2), qa),
            torch.matmul(dP.transpose(-1, -2), doa) + (2 * S + 8) * u
            * torch.matmul(pa.transpose(-1, -2), doa))
    wants, bands = [], []
    for acc, err in zip(accs, errs):
        want = acc.to(q.dtype).float()
        gap = torch.maximum(
            ((acc + 2 * err).to(q.dtype).float() - want).abs(),
            ((acc - 2 * err).to(q.dtype).float() - want).abs())
        wants.append(want.permute(0, 2, 1, 3))
        bands.append(gap.permute(0, 2, 1, 3) + torch.finfo(torch.float32)
                     .tiny)
    return _flat(*wants), _flat(*bands)


def check_flash_bwd(case: Dict) -> Dict:
    """K11-bwd's two kernels (through ``flash_attention_bwd``) against
    their plain version, fed the same residuals: (dQ, dK, dV) within
    ``flash_bwd_band`` with every fault of ``flash_bwd_faults`` outside.
    Also "err_dq" and "err_dkv", each kernel's largest error."""
    got = K11.flash_attention_bwd(*_bwd_args(case))
    want, band = flash_bwd_band(case)
    res = hold(_flat(*got), want, band, flash_bwd_faults(case),
               f"flash_attention backward {_flash_what(case)}")
    n = got[0].numel()
    err = (_flat(*got) - want).abs()
    res.update(err_dq=err[:n].max().item(), err_dkv=err[n:].max().item())
    return res
