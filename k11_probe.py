"""K11's bf16 design, measured by parts on one NVIDIA card.

    python3 k11_probe.py steps [--parent DIR]   # the design's build steps
    python3 k11_probe.py ablate                 # one part of the work out

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


def _tree(name: str, text: str) -> str:
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    d = os.path.join(root, SRC)
    os.makedirs(d)
    for f in os.listdir(SRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(SRC, f), d)
    with open(os.path.join(d, "flash_attention.cu"), "w") as f:
        f.write(text)
    return root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["steps", "ablate"])
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
