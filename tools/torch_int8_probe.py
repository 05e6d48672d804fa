"""Device time of each CUDA kernel of the port's int8 kernels K1
(``int8_ffn``: quantize, up, down, reduce) and K2 (``int8_dense``:
quantize, product) on one NVIDIA card, for this tree's sources and for
variants of them.

    python3 tools/torch_int8_probe.py [--variants base,up_wg2,...]

A variant is this tree's ``csrc/`` with text substitutions (VARIANTS),
built with the same nvcc flags into ``build/misinfo_tpu_torch/probe_*``
and swapped in for the wrapper's library: an ablation that drops part of
a kernel's work shows what that part costs (its results are wrong and
not checked). A variant whose text is no longer in the source is
reported as skipped. One JSON line per (variant, kernel, shape): µs per
call of each CUDA kernel (torch.profiler's kernel intervals over 20
calls), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from misinfo_tpu_torch.ops import cuda_build as CB            # noqa: E402
from misinfo_tpu_torch.ops import int8_dense as K2           # noqa: E402
from misinfo_tpu_torch.ops import int8_ffn as K1             # noqa: E402
from misinfo_tpu_torch.ops import kernel_checks as KC        # noqa: E402

# (source, substitutions): each drops or changes one part of a kernel
VARIANTS = {
    "base": (None, []),
    # the up kernel with two consumer warpgroups (64 × jc/2) instead of four
    "up_wg2": ("int8_ffn", [("return jc >= 256 ? 4 : 2;", "return 2;")]),
    # the up kernel's epilogue without activation and requantize
    "up_noepi": ("int8_ffn", [
        ("const float2 g = act<MODE>(", "const float2 g = make_float2("),
        ("i8g::quant(__int_as_float(acc[k]), s, r)", "(int8_t)acc[k]"),
        ("i8g::quant(__int_as_float(acc[k + 1]), s, r)",
         "(int8_t)acc[k + 1]")]),
    # the down kernel summing all chunks in s32 (no per-chunk fold)
    "down_nofold": ("int8_ffn", [("i8g::BK, ck, acc,",
                                  "i8g::BK, N / i8g::BK, acc,")]),
    # the down kernel's ring at 4 stages instead of 6
    "down_4stages": ("int8_ffn", [("DN_STAGES = 6;", "DN_STAGES = 4;")]),
    # K2's grid with every row tile of a column tile first
    "dense_rows_first": ("int8_dense", [
        ("const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;",
         "const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;"),
        ("grid((N + BN - 1) / BN, (M + BM - 1) / BM);",
         "grid((M + BM - 1) / BM, (N + BN - 1) / BN);")]),
    # K2's epilogue without scales and bias
    "dense_noepi": ("int8_dense", [(
        "b ? __double2float_rn(__fma_rn(p, wd, bd))\n"
        "                      : __fmul_rn(p, wf)", "p")]),
}
FFN_SHAPES = ((32 * 512, 768, 3072, "tanh"), (3 * 512, 768, 3072, "tanh"),
              (32 * 77, 512, 2048, "quick"), (32 * 50, 768, 3072, "quick"),
              (512, 768, 3072, "tanh"))
DENSE_SHAPES = ((32 * 512, 768, 768), (32 * 77, 512, 512),
                (32 * 50, 768, 768), (512, 768, 768))


def build_variant(name: str, src: str, subs) -> str | None:
    """This tree's csrc/ with ``subs`` applied to ``src``.cu, built into a
    library of its own; None if a substitution no longer applies."""
    d = CB.BUILD_DIR / f"probe_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CB.CSRC, d)
    text = (d / f"{src}.cu").read_text()
    for old, new in subs:
        if old not in text:
            return None
        text = text.replace(old, new)
    (d / f"{src}.cu").write_text(text)
    so = d / f"{src}.so"
    subprocess.run([shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
                    *CB.NVCC_FLAGS, "-I", str(d), "-o", str(so),
                    str(d / f"{src}.cu")], check=True, capture_output=True)
    return str(so)


def install(mod, so: str, cname: str) -> None:
    """Swap the library at ``so`` in for ``mod``'s own."""
    ref = mod._library()
    lib = ctypes.CDLL(so)
    for fn in ("launch", "workspace", "error_string"):
        f, g = getattr(lib, f"{cname}_{fn}"), getattr(ref, f"{cname}_{fn}")
        f.restype, f.argtypes = g.restype, g.argtypes
    mod._lib = lib


def kernel_us(fn, calls: int = 20):
    """µs per call of each CUDA kernel of ``fn`` (profiler intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n = (e.name.replace("(anonymous namespace)::", "")
                 .replace("void ", "").split("(")[0])
            total[n] = total.get(n, 0.0) + e.time_range.end - e.time_range.start
    return {k: round(v / calls, 2) for k, v in total.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ffn = {s: KC.int8_ffn_case(*s)["args"] for s in FFN_SHAPES}
    dense = {s: KC.int8_dense_case(*s) for s in DENSE_SHAPES}
    for name in args.variants.split(","):
        src, subs = VARIANTS[name]
        for mod, cname in ((K1, "int8_ffn"), (K2, "int8_dense")):
            mod._lib = None
            if src == cname:
                so = build_variant(name, src, subs)
                if so is None:
                    print(json.dumps({"variant": name, "skipped": True}))
                    break
                install(mod, so, cname)
        else:
            if src in (None, "int8_ffn"):
                for s, a in ffn.items():
                    us = kernel_us(lambda: K1.int8_ffn(*a, mode=s[3]))
                    print(json.dumps({"variant": name, "kernel": "int8_ffn",
                                      "M_K_N_mode": s, "us": us,
                                      "card": card}), flush=True)
            if src in (None, "int8_dense"):
                for s, c in dense.items():
                    a = (c["x"], c["wq"], c["w_scale"], c["bias"])
                    us = kernel_us(lambda: K2.int8_dense(*a))
                    print(json.dumps({"variant": name, "kernel": "int8_dense",
                                      "M_K_N": s, "us": us, "card": card}),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
