"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the fused int8 FFN kernel (misinfo_tpu_torch/csrc/int8_ffn.cu);
  3. the kernel against its plain PyTorch version on the card at the
     main path's three shapes (RoBERTa, CLIP text, CLIP vision; B = 3,
     the kernel's split form) and at RoBERTa b32/S512 (its one-block-per-
     row-tile form), within 3 int8 levels of the plain output, and bit for
     bit on an integer grid where every quantization scale is 1;
  4. the engine at full width (RoBERTa-base, CLIP ViT-B/32,
     EfficientNet-B0; seeded random weights, bf16, quant="auto" →
     int8_ffn) with a 2,176-row vault: one analyze() and one mixed
     analyze_batch(), the kernel's launch count per program, the same
     batch with the plain FFN swapped in (scores within 0.05), then the
     single-request latency and b32/S512 verdicts/s, with the kernel and
     with the plain FFN (printed only).
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors and times. ``--profile FILE``
also writes a torch.profiler table of the b32 batch to FILE.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SHAPES = (("roberta", 3 * 512, 768, 3072, "tanh"),
          ("clip_text", 3 * 77, 512, 2048, "quick"),
          ("clip_vision", 3 * 50, 768, 3072, "quick"),
          ("roberta_b32", 32 * 512, 768, 3072, "tanh"))
REPORT_KEYS = {"verdict", "verdict_text", "confidence", "scores",
               "vault_matches", "explanation"}
SCORE_KEYS = {"ai_score", "misinfo_score", "deepfake_score",
              "clip_similarity", "vault_discrepancy", "text_similarity",
              "verdict", "confidence", "fake_probability",
              "real_probability"}
PER_PROGRAM = {"full": 36, "text_only": 12, "visual_only": 12}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(K1, quantize_dense):
    """Phase 3: kernel vs plain on the card at the main-path shapes."""
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for name, M, K, N, mode in SHAPES:
        p_in = quantize_dense({"kernel": torch.randn(K, N, generator=gen) * .03,
                               "bias": torch.randn(N, generator=gen) * .01})
        p_out = quantize_dense({"kernel": torch.randn(N, K, generator=gen) * .03,
                                "bias": torch.randn(K, generator=gen) * .01})
        args = [torch.randn(M, K, generator=gen).to(torch.bfloat16)]
        for p in (p_in, p_out):
            args += [p["kernel_q"], p["w_scale"], p["bias"]]
        args = [a.cuda() for a in args]
        y = K1.int8_ffn(*args, mode=mode)
        y_plain = K1.int8_ffn_plain(*args, mode=mode)
        torch.cuda.synchronize()
        err = (y.float() - y_plain.float()).abs().max().item()
        band = 3 * y_plain.float().abs().max().item() / 127
        ms = cuda_ms(lambda: K1.int8_ffn(*args, mode=mode), 20)
        plain_ms = cuda_ms(lambda: K1.int8_ffn_plain(*args, mode=mode), 5)
        print(f"K1 {name} M={M} K={K} N={N} mode={mode}: max_abs_err={err} "
              f"(band {band}) kernel_ms={ms} plain_ms={plain_ms}", flush=True)
        if not (math.isfinite(err) and err < band):
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{name}: {err} >= {band}")
        rows[name] = {"err": err, "ms": ms, "plain_ms": plain_ms}
    # integer grid: x and weights whose abs-max is 127, so every scale is 1
    # and the first int8 product is exact on both sides
    M, K, N = 37, 768, 3072
    args = [torch.randint(-126, 127, (M, K), generator=gen).to(torch.bfloat16)]
    for k, n in ((K, N), (N, K)):
        w = torch.randint(-126, 127, (k, n), generator=gen).float()
        w[0] = 127.0
        p = quantize_dense({"kernel": w, "bias": torch.randint(
            -50, 50, (n,), generator=gen).float()})
        args += [p["kernel_q"], p["w_scale"], p["bias"]]
    args[0][:, 0] = 127.0
    args = [a.cuda() for a in args]
    exact = torch.equal(K1.int8_ffn(*args, mode="tanh"),
                        K1.int8_ffn_plain(*args, mode="tanh"))
    print(f"K1 integer grid M={M} K={K} N={N}: bitwise equal {exact}",
          flush=True)
    if not exact:
        raise AssertionError("K1 differs from its plain version on the "
                             "integer grid")
    return rows


def make_vault(path: str, n: int = 2176, d: int = 512) -> None:
    from misinfo_tpu_torch.vault.store import TruthVault
    rng = np.random.default_rng(1)
    TruthVault(rng.normal(size=(n, d)).astype(np.float32),
               [{"title": f"Guardian article {i}", "url": f"u{i}",
                 "date": "2024-01-01"} for i in range(n)],
               rng.normal(size=(n, d)).astype(np.float32)).save(path)


def check_reports(reports, what: str) -> None:
    for r in reports:
        if set(r) != REPORT_KEYS or set(r["scores"]) != SCORE_KEYS:
            raise AssertionError(f"{what}: report keys {sorted(r)}")
        for k, v in r["scores"].items():
            if not math.isfinite(v):
                raise AssertionError(f"{what}: {k} = {v}")
        for k in ("ai_score", "misinfo_score", "deepfake_score",
                  "fake_probability", "real_probability", "confidence"):
            if not 0.0 <= r["scores"][k] <= 1.0:
                raise AssertionError(f"{what}: {k} = {r['scores'][k]}")
        if not -1.0 - 1e-5 <= r["scores"]["clip_similarity"] <= 1.0 + 1e-5:
            raise AssertionError(f"{what}: clip_similarity out of range")


@contextlib.contextmanager
def plain_ffn(K1):
    """Serve the engine's FFNs with the kernel's plain version (on the
    card) for the duration of the block."""
    kernel_fn = K1.int8_ffn
    K1.int8_ffn = lambda *a, **kw: K1.int8_ffn_plain(*a, **kw)
    try:
        yield
    finally:
        K1.int8_ffn = kernel_fn


def verdicts_per_s(engine, requests, reps: int = 3) -> float:
    engine.analyze_batch(requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.analyze_batch(requests)
    torch.cuda.synchronize()
    return reps * len(requests) / (time.perf_counter() - t0)


def words(rng, n: int) -> str:
    return " ".join(f"w{int(i)}" for i in rng.integers(0, 10_000, n))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="write a torch.profiler table of the b32 batch here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops.quant import quantize_dense

    card = card_line()
    print(card, flush=True)                                   # phase 1
    t0 = time.perf_counter()
    K1._library()                                             # phase 2
    print(f"K1 build: {time.perf_counter() - t0:.2f} s", flush=True)
    print("\n".join(line for line in K1.build_log.splitlines()
                    if "registers" in line or "spill" in line))
    kernel_rows = check_kernel(K1, quantize_dense)            # phase 3

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    vault_path = os.path.join(tmp, "vault.npz")
    make_vault(vault_path)
    cfg = ForensicsConfig(verbose=True)
    cfg = cfg.replace(paths=cfg.paths.__class__(vault_path=vault_path))
    engine = MisinfoForensics(cfg, DetectorConfig(), device="cuda")
    if engine.quant != "int8_ffn":
        raise AssertionError(f"quant='auto' resolved to {engine.quant}")
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
    batch = ([{"text": words(rng, n), "image": image}
              for n in (270, 300, 330, 380)]                  # full, dense
             + [{"text": words(rng, n)} for n in (5, 9, 14, 20, 31, 40)]
             + [{"image": image}, {"image": image}])          # packed text

    K1.launches = 0           # the main path's run starts here
    report = engine.analyze(words(rng, 30), image, verbose=False)
    torch.cuda.synchronize()
    after_single = K1.launches
    reports = engine.analyze_batch(batch)
    torch.cuda.synchronize()
    main_launches = K1.launches     # read just after the main path
    check_reports([report], "analyze")
    check_reports(reports, "analyze_batch")
    want_batch = sum(PER_PROGRAM.values())    # full + packed text + visual
    print(f"K1 launches: analyze {after_single} (want {PER_PROGRAM['full']})"
          f", analyze_batch {main_launches - after_single} "
          f"(want {want_batch})", flush=True)
    if (after_single != PER_PROGRAM["full"]
            or main_launches - after_single != want_batch):
        raise AssertionError("K1 launch count off the expected per-program "
                             "counts")

    full = batch[:4]
    with_kernel = engine.analyze_batch(full)
    with plain_ffn(K1):
        with_plain = engine.analyze_batch(full)
    drift = max(abs(a["scores"][k] - b["scores"][k])
                for a, b in zip(with_kernel, with_plain)
                for k in ("ai_score", "misinfo_score", "deepfake_score",
                          "clip_similarity", "fake_probability"))
    print(f"engine kernel vs plain FFN: max score drift {drift} "
          "(limit 0.05)", flush=True)
    if not drift < 0.05:
        raise AssertionError(f"engine scores drift {drift} >= 0.05")

    text = words(rng, 30)
    engine.analyze(text, image, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        engine.analyze(text, image, verbose=False)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / 5 * 1e3
    b32 = [{"text": words(rng, 400 + i), "image": image} for i in range(32)]
    vps = verdicts_per_s(engine, b32)
    with plain_ffn(K1):
        vps_plain = verdicts_per_s(engine, b32)
    vps_again = verdicts_per_s(engine, b32)
    print(f"single analyze latency: {single_ms} ms; full b32/S512: {vps} "
          f"verdicts/s, plain FFN {vps_plain}, kernel again {vps_again} "
          f"[{card}]", flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.analyze_batch(b32)
            torch.cuda.synchronize()
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        with open(args.profile, "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40))

    rob = kernel_rows["roberta"]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "int8_ffn", "route": "cuda",
        "source": "misinfo_tpu_torch/csrc/int8_ffn.cu",
        "replaces": "misinfo_tpu/ops/pallas_int8.py:237",
        "launches": main_launches,
        "max_abs_err": max(r["err"] for r in kernel_rows.values()),
        "ms": rob["ms"], "plain_ms": rob["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
