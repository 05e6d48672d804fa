"""Holding the detector's opt-in kernels (K2 int8 dense, K3 fused
attention, K4 LayerNorm, K5 fused FFN) to their plain versions.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card,
and run on the CPU by the ``tests/test_torch_{int8_dense,fused_attention,
fused_ffn}.py`` files, where the wrappers take their plain versions: each
``*_case`` makes seeded inputs at a given shape, each ``check_*`` runs the
wrapper and the plain version, raises unless the output keeps its band,
and raises unless every planted fault (the plain version on inputs that
reproduce what a wrong kernel computes) falls outside it.

Bands, elementwise (ulp: one step of the output dtype at |plain|):

* K2, bit for bit. Its plain version repeats the kernel's arithmetic
  operation for operation (integer sums, IEEE scales, one rounding of the
  epilogue's multiply-add). Fault: one row's scale one ulp high.
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
  dropped, and for tanh the erf GELU in its place, on inputs whose W2
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
from misinfo_tpu_torch.ops import fused_ffn as K5
from misinfo_tpu_torch.ops import int8_dense as K2
from misinfo_tpu_torch.ops.common import matmul_f32
from misinfo_tpu_torch.ops.int8_ffn import _act, pick_chunk
from misinfo_tpu_torch.ops.quant import quantize_dense

PLANT = 16.0            # score of a planted key
PAIR = 40.125           # a bf16 rounding boundary: 40.0 and 40.25 round apart
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


# ------------------------------------------------------------ K2 int8 dense

def int8_dense_case(M: int, K: int, N: int, x_dtype=torch.bfloat16,
                    bias: bool = True, seed: int = 0, device="cuda") -> Dict:
    """Seeded x [M, K] and an int8 dense {kernel_q, w_scale, bias?}."""
    gen = _gen(seed)
    p = quantize_dense({"kernel": torch.randn(K, N, generator=gen) * 0.03,
                        "bias": torch.randn(N, generator=gen) * 0.01})
    x = torch.randn(M, K, generator=gen).to(x_dtype)
    return {"x": x.to(device), "wq": p["kernel_q"].to(device),
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
    N = w1.shape[1]
    jc = pick_chunk(N)
    out = []
    for j0 in range(0, N, jc):
        w2j = w2.clone()
        w2j[j0:j0 + jc] = 0
        out.append((f"chunk {j0 // jc} left out",
                    K5.fused_ffn_plain(x, w1, b1, w2j, b2, mode=mode)))
    out.append(("b2 dropped", K5.fused_ffn_plain(
        x, w1, b1, w2, torch.zeros_like(b2), mode=mode)))
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
