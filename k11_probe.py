"""K11's bf16 design, measured by parts on one NVIDIA card.

    python3 k11_probe.py steps [--parent DIR]   # the design's build steps
    python3 k11_probe.py ablate                 # one part of the work out
    python3 k11_probe.py bwd_ablate             # the same for K11-bwd
    python3 k11_probe.py bwd_clocks             # K11-bwd's consumer time

Each variant is a scratch copy of misinfo_tpu_torch/csrc/flash_attention.cu
(with the headers beside it) written under build/k11_probe/, built with
this tree's nvcc flags and timed through chip_smoke's helpers: device µs
(chip_smoke.device_us over 20 calls), the median of four readings taken
in turns with this tree's kernel, at chip_smoke.FLASH_TIMES' shapes (and,
for steps, two causal ones). ``steps``: (a) the TMA ring, wgmma and two
consumer warpgroups with one unit a block and no overlap, (b) + the turns
and the overlap inside a warpgroup, (c0) + the persistent grid with the
units in plain order; the final source is (c), and ``--parent`` adds
another tree's K11 (e.g. an earlier commit's misinfo_tpu_torch/csrc
unpacked by ``git archive``). Every step's output is compared with the
final's. ``ablate``: timing only
(outputs wrong by design): no expf, no scale-and-mask pass, no softmax,
no products, no turns, and the row max and sum split four ways.
``bwd_ablate``: the same for K11-bwd's two bf16 kernels
(csrc/flash_attention_bwd.cu) at chip_smoke.FLASH_BWD_TIMES' shapes,
timing only: no expf, no elementwise pass (p and ds), no products, no
turns. ``bwd_clocks``: a copy with clock64() readings around each part
of a consumer warpgroup's step (the turn, the issue, the waits for the
products, the elementwise pass, the waits for a stage), each part's share
of the warpgroup's time.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

import chip_smoke as C

SRC = os.path.join("misinfo_tpu_torch", "csrc")
OUT = os.path.join("build", "k11_probe")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"k11_probe: the source no longer holds {old[:60]!r}")
    return text.replace(old, new)


def _steps(final: str) -> dict:
    c0 = _sub(final, "(u - bh * nq + bh) % nq * TQ", "(u - bh * nq) * TQ")
    b = _sub(c0, "const int grid = (int)(units < sms ? units : sms);",
             "const int grid = (int)units;")
    start = b.index("      // the first tile\n")
    end = b.index("      // out: each row's 64 values")
    in_turn = """      int s;
      bool last;
      do {
        s = it % STAGES;
        i8g::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        last = hdr[s].y;
        bf16w::fence_acc<64>(sc);
        i8g::wgmma_fence();
        const uint64_t dk = i8g::sw128_desc(base + OFF_K + s * TILE_BYTES);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          bf16w::wgmma_bf16<128, 0>(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
        i8g::wgmma_commit();
        i8g::wgmma_wait<0>();
        bf16w::fence_acc<64>(sc);
        step(s, last);
#pragma unroll
        for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
        bf16w::fence_acc<32>(o);
        bf16w::fence_words<32>(p);
        i8g::wgmma_fence();
        issue_pv(o, p, base + OFF_V + s * TILE_BYTES);
        i8g::wgmma_commit();
        i8g::wgmma_wait<0>();
        bf16w::fence_acc<32>(o);
        bf16w::fence_words<32>(p);
        fold(acc, o, cc, ic, single);
        if (lane == 0) i8g::mbar_arrive(empty0 + 8 * s);
        ++it;
      } while (!last);

"""
    a = _sub(b[:start] + in_turn + b[end:],
             "    if (c == 1) named_arrive(TURN_BAR, 256);  // consumer 0 issues"
             " first\n", "")
    return {"a": a, "b": b, "c0": c0}


def _ablations(final: str) -> dict:
    v = {"no_expf": _sub(
        final, "const float p = expf(__fsub_rn(sc[i], mn[(i >> 1) & 1]));",
        "const float p = __fsub_rn(sc[i], mn[(i >> 1) & 1]);")}
    v["no_mask"] = _sub(final, """      float x = sc[4 * i + e];
      if (scale != 1.f) x = __fmul_rn(x, scale);""", """      float x = sc[4 * i + e];
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
      continue;""")
    v["no_softmax"] = _sub(final, """  const int q4 = threadIdx.x & 3;
  float mx[2] = {neg_inf(), neg_inf()};""", """  const int q4 = threadIdx.x & 3;
  if (q4 < 4) { c[0] = c[1] = inv[0] = inv[1] = 1.f; return; }
  float mx[2] = {neg_inf(), neg_inf()};""")
    nog = _sub(final, """#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          bf16w::wgmma_bf16<128, 0>(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);""",
               "")
    v["no_products"] = _sub(nog, """#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    bf16w::wgmma_bf16_rs64(o, p + 4 * kk, dv + 128 * kk, kk > 0);""",
                            "  if (dv == 1) o[0] = p[0];")
    v["no_turns"] = _sub(
        _sub(final, "        i8g::named_sync(TURN_BAR + c, 256);\n", ""),
        "        named_arrive(TURN_BAR + 1 - c, 256);\n", "")
    split = _sub(final, """  const int q4 = threadIdx.x & 3;
  float mx[2] = {neg_inf(), neg_inf()};""", """  const int q4 = threadIdx.x & 3;
  float mx4[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) mx4[0][j] = mx4[1][j] = neg_inf();""")
    split = _sub(split, """      sc[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);""", """      sc[4 * i + e] = x;
      mx4[e >> 1][i & 3] = fmaxf(mx4[e >> 1][i & 3], x);""")
    split = _sub(split, """  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = fmaxf(mx[r],""", """  float mn[2], mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = fmaxf(mx[r],""")
    v["split_chains"] = _sub(split, """  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = expf(__fsub_rn(sc[i], mn[(i >> 1) & 1]));
    sc[i] = p;
    sum[(i >> 1) & 1] = __fadd_rn(sum[(i >> 1) & 1], p);
  }""", """  float s4[2][4] = {};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = expf(__fsub_rn(sc[i], mn[(i >> 1) & 1]));
    sc[i] = p;
    s4[(i >> 1) & 1][(i >> 2) & 3] =
        __fadd_rn(s4[(i >> 1) & 1][(i >> 2) & 3], p);
  }
  float sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    sum[r] = __fadd_rn(__fadd_rn(s4[r][0], s4[r][1]),
                       __fadd_rn(s4[r][2], s4[r][3]));""")
    return v


def _bwd_ablations(final: str) -> dict:
    """Scratch copies of csrc/flash_attention_bwd.cu with one part of the
    bf16 kernels' work taken out (timing only: the outputs are wrong)."""
    v = {"no_expf": _sub(
        final, "p = __fmul_rn(expf(__fsub_rn(x, m)), inv_l);",
        "p = __fmul_rn(__fsub_rn(x, m), inv_l);")}
    v["no_elementwise"] = _sub(final, """    int lim, float scale, float mask_value) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {""", """    int lim, float scale, float mask_value) {
  if (lim != 0x7fffffff) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {""")
    nog = _sub(final, """#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          bf16w::wgmma_bf16<64, 0>(sc, da0 + 2 * kk, db0 + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          bf16w::wgmma_bf16<64, 0>(dp, da1 + 2 * kk, db1 + 2 * kk, kk > 0);""",
               "        if (db0 == db1) sc[0] = dp[0] = 0.f;")
    nog = _sub(nog, """      bf16w::wgmma_bf16_rs64(acc1, pw + 4 * kk, b1 + 128 * kk, 1);""",
               """      if (b1 == 1) acc1[kk] = __uint_as_float(pw[kk]);""")
    v["no_products"] = _sub(nog, """    bf16w::wgmma_bf16_rs64(acc0, dw + 4 * kk, b0 + 128 * kk, 1);""",
                            """    if (b0 == 1) acc0[kk] = __uint_as_float(dw[kk]);""")
    v["no_turns"] = _sub(_sub(_sub(
        final, "        i8g::named_sync(TURN_BAR + c, 256);\n", ""),
        "        named_arrive(TURN_BAR + 1 - c, 256);\n", ""),
        "    if (c == 1) named_arrive(TURN_BAR, 256);  // consumer 0 issues "
        "first\n", "")
    return v


CLOCK_PARTS = ("turn", "issue", "wait_ss", "elementwise", "wait_grads",
               "stage_wait", "unit_wait", "total")


def _bwd_clocks(final: str) -> str:
    """K11-bwd's source with clock64() readings around each part of a
    consumer warpgroup's step, summed per warpgroup into bwd_clk[8·c + x]
    (x: CLOCK_PARTS) by its first thread; bwd_clk_zero / bwd_clk_read reach
    them from the host. Timing only."""
    v = _sub(final, '#include "wgmma_bf16.cuh"\n', """#include "wgmma_bf16.cuh"
__device__ unsigned long long bwd_clk[16];
extern "C" int bwd_clk_read(void* h) {
  return (int)cudaMemcpyFromSymbol(h, bwd_clk, sizeof(bwd_clk));
}
extern "C" int bwd_clk_zero() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(bwd_clk, z, sizeof(z));
}
""")
    v = _sub(v, "    if (c == 1) named_arrive(TURN_BAR, 256);  // consumer 0 issues "
             "first\n", "    if (c == 1) named_arrive(TURN_BAR, 256);\n"
             "    long long ck[8] = {};\n"
             "    const long long ck0 = clock64();\n")
    v = _sub(v, "        i8g::named_sync(TURN_BAR + c, 256);\n",
             "        const long long q0 = clock64();\n"
             "        i8g::named_sync(TURN_BAR + c, 256);\n"
             "        const long long q1 = clock64();\n"
             "        ck[0] += q1 - q0;\n")
    v = _sub(v, """        named_arrive(TURN_BAR + 1 - c, 256);
        if constexpr (GRADS)
          i8g::wgmma_wait<1>();
        else
          i8g::wgmma_wait<0>();
""", """        named_arrive(TURN_BAR + 1 - c, 256);
        const long long q2 = clock64();
        ck[1] += q2 - q1;
        if constexpr (GRADS)
          i8g::wgmma_wait<1>();
        else
          i8g::wgmma_wait<0>();
        const long long q3 = clock64();
        ck[2] += q3 - q2;
""")
    v = _sub(v, """                                    mask_value);
        if constexpr (GRADS) {""", """                                    mask_value);
        bf16w::fence_acc<32>(sc);
        bf16w::fence_acc<32>(dp);
        const long long q4 = clock64();
        ck[3] += q4 - q3;
        if constexpr (GRADS) {""")
    v = _sub(v, "        // p (dK/dV) and ds rounded to bf16",
             "        ck[4] += clock64() - q4;\n"
             "        // p (dK/dV) and ds rounded to bf16")
    v = _sub(v, """        i8g::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const int j = hdr[s];""", """        const long long f0 = clock64();
        i8g::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        ck[5] += clock64() - f0;
        const int j = hdr[s];""")
    v = _sub(v, """      i8g::mbar_wait(ofull0 + 8 * kb, (k >> 1) & 1);
      const int n = count[kb];""", """      const long long f1 = clock64();
      i8g::mbar_wait(ofull0 + 8 * kb, (k >> 1) & 1);
      ck[6] += clock64() - f1;
      const int n = count[kb];""")
    return _sub(v, """      if (DKV) store_acc(out1, acc1, row + g, H, w.h);
    }
  }
}""", """      if (DKV) store_acc(out1, acc1, row + g, H, w.h);
    }
    ck[7] = clock64() - ck0;
    if (t == 0)
      for (int x = 0; x < 8; ++x)
        atomicAdd(&bwd_clk[8 * c + x], (unsigned long long)ck[x]);
  }
}""")


def bwd_clocks(card: str) -> None:
    """Where a consumer warpgroup's time goes in K11-bwd's bf16 kernels:
    the _bwd_clocks variant run once a kernel at chip_smoke.FLASH_BWD_TIMES'
    shapes; each part's share of the warpgroup's time, summed over blocks."""
    import ctypes
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import kernel_checks as KC
    with open(os.path.join(SRC, "flash_attention_bwd.cu")) as f:
        text = _bwd_clocks(f.read())
    fns = C._parent_flash_bwd(_tree("bwd_clocks", text,
                                    "flash_attention_bwd.cu"))
    lib = fns["lib"]
    for name, B, S, H, layout in C.FLASH_BWD_TIMES:
        c = KC.flash_bwd_case(B, S, H, layout, False, torch.bfloat16)
        args = (c["q"], c["k"], c["v"], c["q_seg"], c["kv_seg"], c["l"],
                c["m"], c["do"], K11.flash_di(c["o"], c["do"]), False)
        for which in ("dkv", "dq"):
            fns[which](*args)               # warm
            torch.cuda.synchronize()
            lib.bwd_clk_zero()
            fns[which](*args)
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * 16)()
            lib.bwd_clk_read(raw)
            row = {}
            for wg in range(2):
                got = list(raw[8 * wg:8 * wg + 8])
                row[f"consumer{wg}"] = {k: got[i] / got[-1]
                                        for i, k in enumerate(CLOCK_PARTS)}
            print(json.dumps({"kernel": f"flash_attention_bwd_{which}",
                              "shape": name, "share_of_time": row,
                              "card": card}), flush=True)
        del c, args
        C.gc_cuda()


def _tree(name: str, text: str, source: str = "flash_attention.cu") -> str:
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    d = os.path.join(root, SRC)
    os.makedirs(d)
    for f in os.listdir(SRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(SRC, f), d)
    with open(os.path.join(d, source), "w") as f:
        f.write(text)
    return root


def bwd_ablate(card: str) -> None:
    """Each _bwd_ablations variant's dK/dV and dQ kernels timed in turn with
    this tree's at chip_smoke.FLASH_BWD_TIMES' shapes: device µs over 10
    calls, the median of four readings a kernel."""
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import kernel_checks as KC
    with open(os.path.join(SRC, "flash_attention_bwd.cu")) as f:
        final = f.read()
    fns = {"final": {"dkv": K11.flash_dkv, "dq": K11.flash_dq}}
    for name, text in _bwd_ablations(final).items():
        fns[name] = C._parent_flash_bwd(
            _tree(f"bwd_{name}", text, "flash_attention_bwd.cu"))
    for name, B, S, H, layout in C.FLASH_BWD_TIMES:
        c = KC.flash_bwd_case(B, S, H, layout, False, torch.bfloat16)
        args = (c["q"], c["k"], c["v"], c["q_seg"], c["kv_seg"], c["l"],
                c["m"], c["do"], K11.flash_di(c["o"], c["do"]), False)
        for which in ("dkv", "dq"):
            us = {k: [] for k in fns}
            order = list(fns)
            for r in range(4):
                for k in (order if r % 2 == 0 else order[::-1]):
                    us[k].append(C.device_us(
                        lambda: fns[k][which](*args), 10)[0])
            print(json.dumps({"kernel": f"flash_attention_bwd_{which}",
                              "shape": name, "device_us": {
                                  k: C._median(v) for k, v in us.items()},
                              "runs": us, "card": card}), flush=True)
        del c, args
        C.gc_cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["steps", "ablate", "bwd_ablate",
                                     "bwd_clocks"])
    ap.add_argument("--parent", metavar="DIR",
                    help="steps: also time the K11 of the tree at DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k11_probe: no CUDA device", file=sys.stderr)
        return 1
    from misinfo_tpu_torch.ops import flash_attention as K11
    from misinfo_tpu_torch.ops import kernel_checks as KC
    card = C.card_line()
    print(card, flush=True)
    if args.what in ("bwd_ablate", "bwd_clocks"):
        (bwd_ablate if args.what == "bwd_ablate" else bwd_clocks)(card)
        return 0
    with open(os.path.join(SRC, "flash_attention.cu")) as f:
        final = f.read()
    variants = _steps(final) if args.what == "steps" else _ablations(final)
    fns = {"final": K11.flash_attention}
    if args.parent:
        fns["parent"] = C._parent_flash(args.parent)
    for name, text in variants.items():
        fns[name] = C._parent_flash(_tree(name, text))
    shapes = list(C.FLASH_TIMES)
    if args.what == "steps":
        shapes += [("b32_s512_packed_causal", 32, 512, 12, "packed", True),
                   ("b3_s384_h5_packed_causal", 3, 384, 5, "packed", True)]
    for name, B, S, H, layout, causal in shapes:
        c = KC.flash_case(B, S, H, layout, causal, torch.bfloat16)
        args_ = [c[n] for n in ("q", "k", "v", "q_seg", "kv_seg")] + [causal]
        row = {"shape": name}
        if args.what == "steps":
            ref = K11.flash_attention(*args_).float()
            row["max_abs_diff_to_final"] = {
                k: (f(*args_).float() - ref).abs().max().item()
                for k, f in fns.items()}
        us = {k: [] for k in fns}
        order = list(fns)
        for r in range(4):
            for k in (order if r % 2 == 0 else order[::-1]):
                us[k].append(C.device_us(lambda: fns[k](*args_), 20)[0])
        row["device_us"] = {k: C._median(v) for k, v in us.items()}
        row["runs"] = us
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
