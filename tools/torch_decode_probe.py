"""Device time of the port's whole-layer decode kernel K9
(``csrc/layer_step.cu``) and of its int8-plane cross step K8
(``csrc/cross_ffn_step_i8cc.cu``) on one NVIDIA card, for this tree's
sources and for variants of them.

    python3 tools/torch_decode_probe.py [--variants base,k9_no_self,...]

A variant is this tree's ``csrc/`` with text substitutions (VARIANTS),
built with the same nvcc flags into ``build/misinfo_tpu_torch/probe_*``
and swapped in for the wrapper's library: an ablation that skips a phase
shows what that phase costs (its results are wrong and not checked). A
variant whose text is not in the source is reported as skipped, so one
list serves the trees before and after a redesign. One JSON line per
(variant, kernel, B): device µs per call (``chip_smoke.device_us``: CUDA
events around calls queued behind a sleeping kernel) at whisper-base, pos
447, T = 1,500, with the card's name and power limit. A ``*_clocks``
variant's kernel prints its own phase clocks instead (five calls).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS                                       # noqa: E402
from misinfo_tpu_torch.ops import cross_ffn_step as K7        # noqa: E402
from misinfo_tpu_torch.ops import decode_checks as DC         # noqa: E402
from misinfo_tpu_torch.ops import layer_step as K9            # noqa: E402
from tools.torch_int8_probe import build_variant              # noqa: E402

# A phase is skipped by a condition the compiler cannot fold (p.B is never
# negative); the grid barriers stay.
NEVER = "p.B < 0 && "
_GEMM = "for (int vb = blockIdx.x; vb < tiles * ks; vb += gridDim.x) {"
_SELF = "for (int vb = blockIdx.x; vb < B * H * p.sc; vb += gridDim.x) {"
_CROSS = ("for (int vb = blockIdx.x + team * gridDim.x; vb < nvb;\n"
          "         vb += 2 * gridDim.x) {")


_COOP_LAUNCH = (
    "  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layer_step),\n"
    "                                  dim3(blocks), dim3(THREADS), args, smem,\n"
    "                                  static_cast<cudaStream_t>(stream));\n")


def _cluster_launch(n: int) -> str:
    return (
        "  (void)args;\n"
        "  e = cudaFuncSetAttribute(\n"
        "      layer_step, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
        "  if (e != cudaSuccess) return e;\n"
        "  cudaLaunchConfig_t cfg_ = {};\n"
        f"  cfg_.gridDim = dim3(blocks / {n} * {n});\n"
        "  cfg_.blockDim = dim3(THREADS);\n"
        "  cfg_.dynamicSmemBytes = smem;\n"
        "  cfg_.stream = static_cast<cudaStream_t>(stream);\n"
        "  cudaLaunchAttribute at_[2];\n"
        "  at_[0].id = cudaLaunchAttributeCooperative;\n"
        "  at_[0].val.cooperative = 1;\n"
        "  at_[1].id = cudaLaunchAttributeClusterDimension;\n"
        f"  at_[1].val.clusterDim.x = {n};\n"
        "  at_[1].val.clusterDim.y = 1;\n"
        "  at_[1].val.clusterDim.z = 1;\n"
        "  cfg_.attrs = at_;\n"
        "  cfg_.numAttrs = 2;\n"
        "  e = cudaLaunchKernelEx(&cfg_, layer_step, p);\n")


def _skip(loop: str) -> tuple:
    head, cond = loop.split("; ", 1)
    return loop, f"{head}; {NEVER}{cond}"


# (source, substitutions)
VARIANTS = {
    "base": (None, []),
    # K9's phases skipped: every product, the self-attention, the
    # cross-attention, all of them (the barriers alone)
    "k9_no_products": ("layer_step", [_skip(_GEMM)]),
    "k9_no_self": ("layer_step", [_skip(_SELF)]),
    "k9_no_cross": ("layer_step", [
        (_CROSS, _CROSS.replace("vb < nvb", NEVER + "vb < nvb"))]),
    "k9_barriers_only": ("layer_step", [
        _skip(_GEMM), _skip(_SELF),
        (_CROSS, _CROSS.replace("vb < nvb", NEVER + "vb < nvb"))]),
    # the o1 product as a phase of its own, not folded into the
    # self-attention
    "k9_no_fold": ("layer_step", [
        ("  p.fw = HD % sp.C == 0", "  p.fw = 0 && HD % sp.C == 0")]),
    # no bound on registers (one block an SM where it needs more than 128)
    "k9_free_registers": ("layer_step", [
        ("__launch_bounds__(THREADS, 2) layer_step",
         "__launch_bounds__(THREADS) layer_step")]),
    # the cooperative launch as cudaLaunchKernelEx with the cooperative
    # attribute and thread-block clusters of 16 (8) blocks beside it, on a
    # grid cut to a multiple of the cluster: does the runtime take it?
    "k9_cluster16_launch": ("layer_step", [(_COOP_LAUNCH, _cluster_launch(16))]),
    "k9_cluster8_launch": ("layer_step", [(_COOP_LAUNCH, _cluster_launch(8))]),
    # one block an SM
    "k9_one_per_sm": ("layer_step", [
        ("const int blocks = (per_sm > 2 ? 2 : per_sm) * sms;",
         "const int blocks = sms;")]),
    # block 0's globaltimer (ns) at the kernel's start, after each grid
    # barrier and at its end, printed as the ns of each phase (with its
    # barrier)
    "k9_phase_clocks": ("layer_step", [
        ("#include <mutex>\n", "#include <cstdio>\n#include <mutex>\n"),
        ("  // ---- the self-attention step (self_attn_step.cu's launches)\n",
         "  unsigned long long t_[16];\n  int n_ = 0;\n"
         "  auto gt_ = [] {\n    unsigned long long t;\n"
         '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         "    return t;\n  };\n  t_[n_++] = gt_();\n"),
        ("grid.sync();", "grid.sync();\n  t_[n_++] = gt_();"),
        ("Ep{p.s2, p.b2, p.x2, p.out}, p);\n}",
         "Ep{p.s2, p.b2, p.x2, p.out}, p);\n  t_[n_++] = gt_();\n"
         "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
         "    printf(\"K9_PHASE_NS B=%d\", p.B);\n"
         "    for (int i = 1; i < n_; ++i) printf(\" %llu\", t_[i] - t_[i - 1]);\n"
         "    printf(\"\\n\");\n  }\n}")]),
    # the globaltimer (ns) of K8 attention roles at their steps (scores:
    # taken, q ready, q quantized, scores taken, before the fence, end; V:
    # taken, copies issued, the row's scores seen, merged, the piece's pv
    # taken, sums added, ticket taken, end), printed at B = 4 for the first
    # two and last scores roles and the first two and last V roles
    "k8_step_clocks": ("cross_ffn_step_i8cc", [
        ('#include "self_attn_phases.cuh"\n',
         '#include "self_attn_phases.cuh"\n#include <cstdio>\n'
         "__device__ __forceinline__ unsigned long long gt_() {\n"
         "  unsigned long long t;\n"
         '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
         "  return t;\n}\n__shared__ unsigned long long ts_[8];\n"),
        ("  wait_prior_grid();                                  // the q partials\n",
         "  wait_prior_grid();\n  if (threadIdx.x == 0) ts_[1] = gt_();\n"),
        ("  // the chunk's scores: four lanes of 16 bytes per K row\n",
         "  if (threadIdx.x == 0) ts_[2] = gt_();\n"),
        ("  m = block_max(m, scr, whole_block());         // its barriers publish scs\n",
         "  if (threadIdx.x == 0) ts_[3] = gt_();\n  m = block_max(m, scr, whole_block());\n"),
        ("  __threadfence();\n  __syncthreads();\n  if (tid == 0) atomicAdd(a.done",
         "  if (threadIdx.x == 0) ts_[4] = gt_();\n  __threadfence();\n  __syncthreads();\n"
         "  if (tid == 0) atomicAdd(a.done"),
        ("  wait_prior_grid();\n  if (tid == 0)\n    while",
         "  if (threadIdx.x == 0) ts_[1] = gt_();\n  wait_prior_grid();\n  if (tid == 0)\n    while"),
        ("  // every head's chunk stats in one round trip, then each head's merge\n",
         "  if (threadIdx.x == 0) ts_[2] = gt_();\n"),
        ("  // pv of the piece's rows and every head, and their max; the tile's\n",
         "  if (threadIdx.x == 0) ts_[3] = gt_();\n"),
        ("  const float sp = __fmul_rn(fmaxf(mx, 1e-30f), R127);\n",
         "  if (threadIdx.x == 0) ts_[4] = gt_();\n  const float sp = __fmul_rn(fmaxf(mx, 1e-30f), R127);\n"),
        ("  if (k == 0 && tid == 0) a.sp[",
         "  if (threadIdx.x == 0) ts_[5] = gt_();\n  if (k == 0 && tid == 0) a.sp["),
        ("  if (!last) return;\n",
         "  if (threadIdx.x == 0) ts_[6] = gt_();\n  if (!last) return;\n"),
        ("    if (r >= total) return;\n",
         "    if (r >= total) return;\n"
         "    if (threadIdx.x == 0) ts_[0] = gt_();\n"),
        ("      v_role(smem, a, b, jk / a.pp, jk % a.pp);\n    }\n",
         "      v_role(smem, a, b, jk / a.pp, jk % a.pp);\n    }\n"
         "    __syncthreads();\n"
         "    if (threadIdx.x == 0 && a.B == 4 && (r < 2 || r == ns - 1 ||\n"
         "        r == ns || r == ns + 1 || r == total - 1))\n"
         '      printf("K8_STEPS %d %d %llu %llu %llu %llu %llu %llu %llu'
         ' %llu %llu\\n", r, ns, ts_[0], ts_[1], ts_[2], ts_[3], ts_[4],'
         " ts_[5], ts_[6], ts_[7], gt_());\n")]),
    # the globaltimer (ns) at which K8's attention roles are taken and
    # finished, every 16th role and the last, printed at B = 4
    "k8_role_clocks": ("cross_ffn_step_i8cc", [
        ('#include "self_attn_phases.cuh"\n',
         '#include "self_attn_phases.cuh"\n#include <cstdio>\n'
         "__device__ __forceinline__ unsigned long long gt_() {\n"
         "  unsigned long long t;\n"
         '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
         "  return t;\n}\n"),
        ("    if (r >= total) return;\n",
         "    if (r >= total) return;\n    const unsigned long long t0_ = gt_();\n"),
        ("      v_role(smem, a, b, jk / a.pp, jk % a.pp);\n    }\n",
         "      v_role(smem, a, b, jk / a.pp, jk % a.pp);\n    }\n"
         "    if (threadIdx.x == 0 && a.B == 4 && (r % 16 == 0 || r == total - 1))\n"
         '      printf("K8_ROLE %d %d %d %llu %llu\\n", r, ns, (int)blockIdx.x,'
         " t0_, gt_());\n")]),
    # K8's V pieces of 64 rows (not 16-64 rows from about two blocks an SM)
    "k8_piece64": ("cross_ffn_step_i8cc", [
        ("constexpr int MIN_PIECE = 16;", "constexpr int MIN_PIECE = 64;")]),
    # K8's attention grid capped at two blocks an SM
    "k8_two_per_sm": ("cross_ffn_step_i8cc", [
        ("  *blocks = last_per_sm * sms;",
         "  *blocks = (last_per_sm < 2 ? last_per_sm : 2) * sms;")]),
}
BATCHES = (1, 4, 32)


def install(mod, so: str, cname: str) -> None:
    """Swap the library at ``so`` in for ``mod``'s own."""
    import ctypes
    ref = mod._library() if cname == "layer_step" else mod._library_i8cc()
    lib = ctypes.CDLL(so)
    for fn in ("launch", "workspace", "tickets", "kernel_launches",
               "error_string"):
        f, g = getattr(lib, f"{cname}_{fn}"), getattr(ref, f"{cname}_{fn}")
        f.restype, f.argtypes = g.restype, g.argtypes
    if cname == "layer_step":
        mod._lib = lib
    else:
        mod._lib_i8cc = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_probe: no CUDA device", file=sys.stderr)
        return 1
    card = CS.card_line()
    layer = {B: DC.layer_case(B, 447)["args"] for B in BATCHES}
    i8cc = {B: DC.cross_i8cc_case(B, 1500) for B in BATCHES}
    for name in args.variants.split(","):
        src, subs = VARIANTS[name]
        K9._lib, K7._lib_i8cc = None, None
        if src is not None:
            try:
                so = build_variant(name, src, subs)
            except subprocess.CalledProcessError as e:
                err = (e.stderr or b"").decode(errors="replace")
                print(json.dumps({"variant": name,
                                  "build_failed": err[-2000:]}), flush=True)
                continue
            if so is None:
                print(json.dumps({"variant": name, "skipped": True}))
                continue
            install(K9 if src == "layer_step" else K7, so, src)
        runs = []
        if src in (None, "layer_step"):
            runs += [("layer_step", B,
                      lambda a=layer[B]: K9.fused_layer_step(*a, n_heads=8))
                     for B in BATCHES]
        if src in (None, "cross_ffn_step_i8cc"):
            runs += [("cross_ffn_step_i8cc", B,
                      lambda c=i8cc[B]: K7.fused_cross_ffn_step(
                          *c["args"], n_heads=8, **c["scales"]))
                     for B in BATCHES]
        for kernel, B, fn in runs:
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError as e:        # a launch the runtime refused
                print(json.dumps({"variant": name, "kernel": kernel, "B": B,
                                  "refused": str(e)[-300:]}), flush=True)
                continue
            if name.endswith("_clocks"):     # its kernel prints; few calls
                for _ in range(2 if kernel == "cross_ffn_step_i8cc" else 5):
                    fn()
                torch.cuda.synchronize()
                continue
            us = [CS.device_us(fn)[0] for _ in range(3)]
            print(json.dumps({"variant": name, "kernel": kernel, "B": B,
                              "pos": 447, "T": 1500, "device_us": us,
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
