"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the ten kernel sources in parallel, one nvcc each
     (misinfo_tpu_torch/csrc/{int8_ffn,int8_dense,fused_attention,
     layer_norm,fused_ffn,self_attn_step,cross_ffn_step,
     cross_ffn_step_i8cc,layer_step,int4_sims}.cu);
  3. K1 (fused int8 FFN) against its plain PyTorch version on the card at
     the main path's three shapes (RoBERTa, CLIP text, CLIP vision; B = 3,
     the kernel's split form) and at RoBERTa b32/S512 (its one-block-per-
     row-tile form), within 3 int8 levels of the plain output, and bit for
     bit on an integer grid where every quantization scale is 1;
  4. the engine at full width (RoBERTa-base, CLIP ViT-B/32,
     EfficientNet-B0; seeded random weights, bf16, quant="auto" →
     int8_ffn) with a 2,176-row vault: one analyze() and one mixed
     analyze_batch(), the kernel's launch count per program, the same
     batch with the plain FFN swapped in (scores within 0.05), then the
     single-request latency and b32/S512 verdicts/s, with the kernel and
     with the plain FFN (printed only);
  5. the decode-step kernels K6 (self-attention) and K7 (cross-attention +
     FFN), each with bf16 and with int8 weights, against their plain
     versions at whisper-base shapes (B = 1 and 4; pos = 3 and 447;
     T = 1,500) through misinfo_tpu_torch/ops/decode_checks.py: within
     2^-5·max|y − x| plus one bf16 step per residual rounding (the
     kernels sum in another order than cuBLAS), with keys planted so that
     emulated wrong kernels (rows or a T chunk left out, the mask one row
     off) fall outside that band, which the check also requires;
  6. the Whisper transcriber at whisper-base widths (byte tokenizer,
     seeded weights through the JAX-layout bridge, device="cuda"):
     pallas on and quant="kernels" (K6/K7 int8 bodies, the whole
     temperature ladder: 26 decodes), then quant="embedding" (the bf16
     bodies, the ladder cut to its greedy rung); each transcribes a 20 s
     two-tone-plus-noise WAV (wall time printed), and K6 and K7 must each
     launch once per decoder layer per fused decode step, every launch
     with the weight type of that transcriber's body;
  7. a teacher-forced comparison: the greedy tokens fed through the step
     with the kernels and with their plain versions, per-step logits
     within TF_BAND (argmax agreement printed: with random weights
     near-ties make free-running token equality a coin toss);
  8. merge_into_caption → engine.analyze(merged caption, image), report
     checked; then the encoder's time for one 30 s window and decode ms
     per step with the kernels and with the plain versions (printed
     only);
  9. the int4 vault similarity kernels K10a (bf16 query) and K10b (int8
     query) against their plain versions at 1,048,576 rows × 512 (B = 1,
     8, 32) and at a ragged row count (B = 3) through
     misinfo_tpu_torch/vault/int4_checks.py: K10b bit for bit, K10a within
     (D + 1)·2^-23·Σ|q·nib|·scale with planted faults (a tile or the
     ragged edge left out, nibbles swapped or read unsigned, the scale
     dropped) outside that band; CUDA-event times, kernel and plain, and
     the kernels' share of 3.35 TB/s;
 10. the engine at full width with vault_dtype="int4" and a 1,048,576-row
     vault (seeded random rows; the CLIP image embeddings of six requests
     planted with noise at known rows, the captions' text embeddings as
     their title rows; weights seeded, vision class and position
     embeddings zeroed so that images differ): the first boot quantizes
     and writes <vault>.int4.npz, the second loads it (re-quantizing
     fails the run); one analyze() and an analyze_batch() of 32 — planted
     requests at top-1 with their title and the gate open, the others at
     0, K10b launched once per visual program;
 11. the same vault with vault_dtype float32 (the reference: same top-1,
     sims within 0.05 for the planted requests), bfloat16 and int8;
     memory_report() and vault_search ms at B = 32 of each (printed);
 12. vault_ivf=True over the f32 vault: the index built on the card
     (time printed) and an analyze_batch that finds every planted row;
 13. reload_vault(drop_first=True) onto the vault with 4,096 rows
     appended, one of them planted: the new row is found;
 14. an int4 engine over phase 4's 2,176-row vault (below 65,536 rows the
     dispatcher runs K10a): K10a launched once per visual program;
 15. (after phase 3) the detector's opt-in kernels against their plain
     versions at the main path's b32/S512 shapes, bf16 and f32, through
     misinfo_tpu_torch/ops/kernel_checks.py: K2 (int8 dense) bit for bit,
     K3 (fused attention), K4 (LayerNorm, driven once on its own: no model
     calls it) and K5 (fused FFN; also at the Whisper tiny, medium and
     large decode widths) within that module's bands with its planted
     faults outside; CUDA-event times at the RoBERTa shape, with
     the bound and, for K3 and K4, scaled_dot_product_attention and
     layer_norm as the library's time;
 16. (after phase 4) engine I at full width, quant="int8" and
     use_pallas=True (phase 4's weights, vault and b32 requests): one
     analyze() and the b32/S512 batch with exact K2/K1/K3 launch counts
     (144/36/36 for the batch), scores within 0.05 of the plain versions,
     verdicts/s beside the default engine's, params bytes;
 17. engine II likewise with use_pallas="ffn": K5 36 times per batch;
 18. (after phase 8) one whisper-base greedy decode_transcript(
     pallas_ffn=True) with bf16 weights and the fused steps off: K5 once
     per decoder layer per step, tokens equal to the plain version's,
     teacher-forced logits within FFN_TF_BAND;
 19. (after phase 5) K8, the cross-attention + FFN step over int8 cross
     planes, against its plain version at whisper-base shapes, T = 1,500:
     B = 1 and 4 (V tiles of 512 rows), 8 (256, t_actual 1,400) and 32
     (128), and B = 3 at T = 300, t_actual 280 (one ragged tile), through
     decode_checks.py: within the bf16-plane band plus one level of every
     quantized probability that sits at a rounding boundary, with planted
     faults outside (V scales applied after the quantization, K scales
     dropped, the probabilities' scale per head, tiles of half the size,
     a score chunk or a V piece left out, the mask one row off);
 20. K9, the whole-layer step in one cooperative launch, at B = 1, 4, 32
     and pos = 0, 447: output and both caches torch.equal to K6b followed
     by K7b on clones of the same inputs, inside the band of its plain
     version with the faults of both steps outside, and exactly one
     __global__ launch per call by the library's own count;
 21. (after phase 8) whisper-base greedy decode_transcript with int8
     weights and the two fused steps, on bf16 cross planes and with
     cross_int8=True: K8 launched once per decoder layer per step, K7
     never, K6b once per layer per step; teacher-forced logits of the
     kernels and the plain versions within I8CC_TF_BAND; ms per step of
     both decodes;
 22. the same decode with pallas_layer=True: K9 once per layer per step
     (and as many __global__ launches), K6 and K7 never; tokens,
     avg_logprob and the no-speech probability equal to phase 21's
     bf16-plane decode; ms per step of both;
 23. WhisperTranscriber(quant="int8") (the int8 streaming decode: plain
     PyTorch, no decode kernel) on the 20 s WAV with the ladder cut to its
     greedy rung: int8 token embedding, every kernel count unchanged, the
     position-0 logits within 0.06·max|logit| of the unquantized step;
     wall time and ms per step.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors, times and bounds. ``--profile FILE``
also writes torch.profiler tables of the b32 batch (default engine and
engines I and II) and of one greedy transcript decode to FILE.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import wave

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


def append_profile(path: str, title: str, fn, rows: int = 30) -> None:
    """Append torch.profiler's table of one call of fn to path."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with open(path, "a") as f:
        f.write(f"\n\n# {title}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=rows))


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


# ---------------------------------------------------------------- transcript

WB = dict(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8,
          ffn_dim=2048, max_source_positions=1500, max_target_positions=448)
# phase 7: |Δlogit| allowed between the kernels' and the plain versions'
# teacher-forced decode, three times the largest measured on an H100
# (0.045, against a logit range of 3.4)
TF_BAND = 0.135
# phase 18: the same for K5 in the unfused step, three times the largest
# measured on an H100 (0.0131)
FFN_TF_BAND = 0.04
# phase 21: the same for K6b + K8 over int8 cross planes (0.0412)
I8CC_TF_BAND = 0.125
# phase 23: |Δlogit| / max|logit| allowed between the int8 streaming step
# and the unquantized step at position 0 (the JAX package's own bar)
STREAM_BAND = 0.06


def build_all(builds) -> None:
    """Phase 2: one nvcc per kernel source, all started together. builds:
    (module, the name of its build function, the name of its build log)."""
    def one(b):
        t0 = time.perf_counter()
        getattr(b[0], b[1])()
        return time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        secs = list(pool.map(one, builds))
    for (m, fn, log), sec in zip(builds, secs):
        print(f"build {m.__name__}.{fn}: {sec:.2f} s", flush=True)
        print("\n".join(line for line in getattr(m, log).splitlines()
                        if "registers" in line or "spill" in line))


def check_decode_kernels(K6, K7):
    """Phase 5: the four decode-step bodies against their plain versions
    at whisper-base shapes; returns {body: {err, ms, plain_ms}} at B = 4
    (pos 447) and prints every case."""
    from misinfo_tpu_torch.ops import decode_checks as DC
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        for B in (1, 4):
            cases = [("self_attn_step", f"pos={pos}", DC.check_self_attn,
                      DC.self_attn_case(B, pos, int8)) for pos in (3, 447)]
            cases.append(("cross_ffn_step", "T=1500",
                          lambda c: DC.check_cross_ffn(c, sms),
                          DC.cross_ffn_case(B, 1500, int8)))
            for name, where, check, case in cases:
                res = check(case)           # raises if out of band
                torch.cuda.synchronize()
                fn, plain = ((K6.fused_self_attn_step, K6.self_attn_step_plain)
                             if name == "self_attn_step" else
                             (K7.fused_cross_ffn_step, K7.cross_ffn_step_plain))
                args, H = case["args"], case["n_heads"]
                ms = cuda_ms(lambda: fn(*args, n_heads=H), 50)
                plain_ms = cuda_ms(lambda: plain(*args, n_heads=H), 10)
                print(f"{name}{sfx} B={B} {where}: max_abs_err={res['err']} "
                      f"(band up to {res['band']}; {res['faults']} planted "
                      f"faults, nearest at {res['nearest_fault']:.2f} bands) "
                      f"kernel_ms={ms} plain_ms={plain_ms}", flush=True)
                if B == 4 and where != "pos=3":
                    rows[name + sfx] = {"err": res["err"], "ms": ms,
                                        "plain_ms": plain_ms,
                                        **decode_bound(name, case, int8)}
    return rows


def decode_work(name, case, scales=()):
    """(bytes moved, operations) of one decode-step body: each input read
    once (the weights, the attended cache rows and, over int8 planes,
    their ``scales``), the output written once; 2 operations per weight
    per row and 4·D per attended cache row."""
    args = case["args"]
    x = args[0]
    B, D = x.shape
    tensors = [t for a in args for t in (a.values() if isinstance(a, dict)
                                         else [a])
               if isinstance(t, torch.Tensor)]
    weights = sum(t.numel() for t in tensors if t.dim() == 2 and t is not x)
    caches = [t for t in tensors if t.dim() == 3]
    rows = args[-1] + (1 if name == "self_attn_step" else 0)
    moved = (nbytes(*[t for t in tensors if t.dim() < 3]) + nbytes(x)
             + sum(B * rows * D * c.element_size() for c in caches)
             + sum(B * rows * s.element_size() for s in scales))
    return moved, 2 * B * weights + 4 * B * rows * D


def decode_bound(name, case, int8: bool, scales=()):
    """bound_ms of one decode-step body from ``decode_work``."""
    return bound(*decode_work(name, case, scales), "int8" if int8 else "bf16")


I8CC_CASES = ((1, 1500, 1500), (4, 1500, 1500), (8, 1400, 1500),
              (32, 1500, 1500), (3, 280, 300))      # B, t_actual, T
I8CC_TILES = {1: 512, 4: 512, 8: 256, 32: 128, 3: 384}


def check_i8cc_kernel(K7, card):
    """Phase 19: K8 against its plain version (decode_checks.py) at the
    three V tile widths and a ragged single tile; returns the kernels
    line's row, timed at B = 4."""
    from misinfo_tpu_torch.ops import decode_checks as DC
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = None
    for B, ta, T in I8CC_CASES:
        case = DC.cross_i8cc_case(B, ta, T=T)
        if case["tile"] != I8CC_TILES[B]:
            raise AssertionError(f"v_tile({B}, 512, {T}) = {case['tile']}, "
                                 f"want {I8CC_TILES[B]}")
        before = (K7.launches, K7.launches_i8cc)
        res = DC.check_cross_i8cc(case, sms)        # raises if out of band
        torch.cuda.synchronize()
        if (K7.launches, K7.launches_i8cc) != (before[0], before[1] + 1):
            raise AssertionError("the int8-plane call did not count as K8")
        args, H, sc = case["args"], case["n_heads"], case["scales"]
        ms = cuda_ms(lambda: K7.fused_cross_ffn_step(*args, n_heads=H, **sc),
                     50)
        plain_ms = cuda_ms(lambda: K7.cross_ffn_step_i8cc_plain(
            *args, n_heads=H, **sc), 5)
        print(f"cross_ffn_step_i8cc B={B} T={T} t_actual={ta} tile="
              f"{case['tile']}: max_abs_err={res['err']} (band up to "
              f"{res['band']}; {res['equal']:.4f} of the outputs bit for bit; "
              f"{res['edges']} probabilities at a rounding boundary; "
              f"{res['faults']} planted faults, nearest at "
              f"{res['nearest_fault']:.2f} bands) kernel_ms={ms} "
              f"plain_ms={plain_ms} [{card}]", flush=True)
        if B == 4:
            row = {"err": res["err"], "ms": ms, "plain_ms": plain_ms,
                   **decode_bound("cross_ffn_step", case, True,
                                  sc.values())}
    return row


def check_layer_kernel(K6, K7, K9, card):
    """Phase 20: K9 against K6b → K7b (bit for bit) and against its plain
    version (decode_checks.py), one __global__ launch per call; returns
    the kernels line's row, timed at B = 4, pos 447, beside the two-call
    route's time."""
    from misinfo_tpu_torch.ops import decode_checks as DC
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = None
    for B in (1, 4, 32):
        for pos in (0, 447):
            case = DC.layer_case(B, pos)
            before = (K9.launches, K9.kernel_launches())
            res = DC.check_layer(case, sms)         # raises on any difference
            torch.cuda.synchronize()
            calls = K9.launches - before[0]
            per_call = K9.kernel_launches() - before[1]
            if (calls, per_call) != (1, 1):
                raise AssertionError(
                    f"layer_step B={B} pos={pos}: {per_call} __global__ "
                    f"launches in {calls} calls, want 1 in 1")
            x, blk, ck, cv, xk, xv, _, ta = case["args"]
            H = case["n_heads"]
            sa, ca = blk["self_attn"], blk["cross_attn"]

            def two_call():
                x1 = K6.fused_self_attn_step(x, blk["ln1"], sa["qkv"],
                                             sa["o"], ck, cv, pos,
                                             n_heads=H)[0]
                return K7.fused_cross_ffn_step(
                    x1, blk["ln_cross"], ca["q"], ca["o"], blk["ln2"],
                    blk["mlp_in"], blk["mlp_out"], xk, xv, ta, n_heads=H)
            ms = cuda_ms(lambda: K9.fused_layer_step(
                x, blk, ck, cv, xk, xv, pos, ta, n_heads=H), 50)
            two_ms = cuda_ms(two_call, 50)
            plain_ms = cuda_ms(lambda: K9.layer_step_plain(
                x, blk, ck, cv, xk, xv, pos, ta, n_heads=H), 5)
            print(f"layer_step B={B} pos={pos}: output and caches equal to "
                  f"K6b → K7b; {per_call} __global__ launch per call; "
                  f"against the plain version max_abs_err={res['err']} (band "
                  f"up to {res['band']}; {res['faults']} planted faults, "
                  f"nearest at {res['nearest_fault']:.2f} bands) kernel_ms="
                  f"{ms} two_call_ms={two_ms} plain_ms={plain_ms} [{card}]",
                  flush=True)
            if B == 4 and pos == 447:
                m6, o6 = decode_work("self_attn_step", case["self"])
                m7, o7 = decode_work("cross_ffn_step", case["cross"])
                # x1 stays inside the kernel: neither written nor read
                row = {"err": res["err"], "ms": ms, "plain_ms": plain_ms,
                       "two_call_ms": two_ms,
                       **bound(m6 + m7 - 2 * nbytes(x), o6 + o7, "int8")}
    return row


def write_wav(path: str, seconds: float = 20.0, sr: int = 16000) -> None:
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * sr)) / sr
    audio = (0.4 * np.sin(2 * np.pi * 440.0 * t)
             + 0.3 * np.sin(2 * np.pi * 660.0 * t)
             + 0.05 * rng.normal(size=t.shape))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.numpy()


@contextlib.contextmanager
def counting_steps(W):
    """Count decode steps that ran the fused kernels (the decode looks
    ``_cached_decoder_step`` up by name on every step)."""
    real = W._cached_decoder_step
    seen = {"fused": 0}

    def spy(*a, **kw):
        if kw.get("pallas_self_attn") and kw.get("pallas_cross"):
            seen["fused"] += 1
        return real(*a, **kw)
    W._cached_decoder_step = spy
    try:
        yield seen
    finally:
        W._cached_decoder_step = real


def plain_decode_steps(W, K6, K7):
    """The fused decode step with the kernels' plain versions (on the
    card) for the duration of the block; the cross step's for either kind
    of planes."""
    def plain_cross(*a, k_scale=None, v_scale=None, **kw):
        if k_scale is None:
            return K7.cross_ffn_step_plain(*a, **kw)
        return K7.cross_ffn_step_i8cc_plain(*a, k_scale=k_scale,
                                            v_scale=v_scale, **kw)
    return swapped((W, "fused_self_attn_step", K6.self_attn_step_plain),
                   (W, "fused_cross_ffn_step", plain_cross))


def transcribe_counted(tr, wav, W, K6, K7, int8: bool):
    """Phase 6 for one transcriber: counts set to 0 just before, read just
    after; every launch must be of the int8 body (``int8``) or of the bf16
    body. Returns (K6 launches, K7 launches)."""
    layers = tr.cfg.decoder_layers
    what = "quant=kernels" if int8 else "quant=embedding"
    with counting_steps(W) as seen:
        K6.launches = K7.launches = 0       # this path's run starts here
        K6.launches_i8 = K7.launches_i8 = 0
        t0 = time.perf_counter()
        text = tr.transcribe(wav)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = (K6.launches, K6.launches_i8, K7.launches,
                  K7.launches_i8)           # read just after the path
    l6, l6_i8, l7, l7_i8 = counts
    print(f"transcribe ({what}) wall time: {sec} s, {seen['fused']} fused "
          f"decode steps, K6 launches {l6} (int8 {l6_i8}), K7 launches {l7} "
          f"(int8 {l7_i8}) (want {layers * seen['fused']} each); transcript "
          f"{len(text)} chars: {text[:60]!r}", flush=True)
    if text.startswith("[transcript error"):
        raise AssertionError(f"transcribe ({what}) failed: {text}")
    if not (seen["fused"] > 0 and l6 == l7 == layers * seen["fused"]):
        raise AssertionError(f"{what}: K6/K7 launches {l6}/{l7} != "
                             f"{layers} × {seen['fused']} fused steps")
    if (l6_i8, l7_i8) != ((l6, l7) if int8 else (0, 0)):
        raise AssertionError(f"{what}: int8-body launches {l6_i8}/{l7_i8} "
                             f"of {l6}/{l7}")
    return l6, l7


def teacher_forced(tr, wav, W, K6, K7):
    """Phase 7: greedy tokens through the fused step with the kernels and
    with the plain versions; per-step logits within TF_BAND."""
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    mels, _ = prep_mel_windows(wav, 2 * tr.cfg.max_source_positions, 1)
    sp = tr.tokenizer.specials
    with torch.inference_mode():
        enc = tr._encode(mels)
        prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                              device="cuda")
        tokens = tr._decode(enc, prompt)[0]
        n = int((tokens[0] != sp.eot).sum().item()) + 1
        n = min(max(n, 8), tr.cfg.max_target_positions)

        def run():
            cache = W.init_kv_cache(tr.params, enc, n, tr.cfg, tr.policy,
                                    merged_self=True, merged_cross=True)
            out = []
            for i in range(n - 1):
                logits, _ = W._cached_decoder_step(
                    tr.params, tokens[:, i], i, enc, cache, tr.cfg,
                    tr.policy, pallas_self_attn=True, pallas_cross=True)
                out.append(logits.float())
            return torch.cat(out)
        got = run()
        with plain_decode_steps(W, K6, K7):
            want = run()
    diff = (got - want).abs().max().item()
    spread = (want.max() - want.min()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"teacher-forced {n - 1} steps: max |Δlogit| {diff} (band "
          f"{TF_BAND}; logit range {spread}); argmax agreement {agree}",
          flush=True)
    if not (math.isfinite(diff) and diff <= TF_BAND):
        raise AssertionError(f"teacher-forced logits differ by {diff}")
    return diff, agree


def transcript_timings(tr, wav, W, K6, K7, profile):
    """Phase 8 timings (printed): encoder per 30 s window, decode ms per
    step with the kernels and with the plain versions."""
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    mels, _ = prep_mel_windows(wav, 2 * tr.cfg.max_source_positions, 1)
    with torch.inference_mode():
        tr._encode(mels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            enc = tr._encode(mels)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) / 5 * 1e3
        prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                              device="cuda")
        per_step = {}
        for name in ("kernel", "plain", "kernel again"):
            ctx = (plain_decode_steps(W, K6, K7) if name == "plain"
                   else contextlib.nullcontext())
            with ctx, counting_steps(W) as seen:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr._decode(enc, prompt)
                torch.cuda.synchronize()
                per_step[name] = ((time.perf_counter() - t0) * 1e3
                                  / max(seen["fused"], 1))
        if profile:
            append_profile(profile, "one greedy transcript decode (B = 1, "
                           "whisper-base, quant=kernels)",
                           lambda: tr._decode(enc, prompt))
    print(f"encoder one 30 s window: {enc_ms} ms; decode ms/step: "
          + ", ".join(f"{k} {v}" for k, v in per_step.items()), flush=True)


def transcript_phases(engine, image, card, profile):
    """Phases 6-8, 18 and 21-23; returns the decode kernels' launches."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    from misinfo_tpu_torch.serve.transcript import (
        WhisperTranscriber, merge_into_caption)

    sp = ByteWhisperTokenizer().specials
    cfg = W.WhisperConfig(vocab_size=sp.vocab_size, eos_token_id=sp.eot,
                          decoder_start_token_id=sp.sot, **WB)
    weights = to_numpy(W.whisper_init(7, cfg))    # the JAX-layout tree
    wav = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_wav_"), "clip.wav")
    write_wav(wav)
    launches = {}
    trs = {}
    for quant, cut in (("auto", {}),
                       ("embedding", {"fallback_temperatures": (0.0,)})):
        tr = WhisperTranscriber(weights, config=cfg, device="cuda",
                                decode_cfg=dataclasses.replace(
                                    WhisperDecodeConfig(), quant=quant,
                                    **cut))
        want = "kernels" if quant == "auto" else "embedding"
        if not (tr.pallas and getattr(tr, f"quant_{want}")):
            raise AssertionError(f"quant={quant!r} resolved to pallas="
                                 f"{tr.pallas}, kernels={tr.quant_kernels}")
        if not (tr.has_weights and tr.tokenizer_compatible):
            raise AssertionError("transcriber reports no usable weights")
        l6, l7 = transcribe_counted(tr, wav, W, K6, K7, want == "kernels")
        suffix = "_i8" if want == "kernels" else ""
        launches["self_attn_step" + suffix] = l6
        launches["cross_ffn_step" + suffix] = l7
        trs[want] = tr
    tr = trs["kernels"]
    teacher_forced(tr, wav, W, K6, K7)
    merged = merge_into_caption("Caption of the clip.", wav, tr)
    if not merged.startswith("Caption of the clip.\n\n"):
        raise AssertionError(f"merge_into_caption gave {merged[:80]!r}")
    check_reports([engine.analyze(merged, image, verbose=False)],
                  "analyze(merged caption)")
    print(f"merged caption: {len(merged)} chars; analyze report ok",
          flush=True)
    transcript_timings(tr, wav, W, K6, K7, profile)
    launches["fused_ffn_whisper"] = whisper_pallas_ffn(weights, cfg, wav,
                                                       card)
    launches.update(whisper_int8_modes(tr, weights, cfg, wav,   # 21-23
                                       card))
    return launches


# ------------------------------------------------------------------- bounds

# H100 SXM peaks, dense, from NVIDIA's data sheet: HBM3 bytes and
# operations per second by operand type
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(moved: float, ops: float, kind: str):
    """The least time the card could take (ms): the bytes moved over the
    memory rate or the operations over the peak rate of their type,
    whichever is larger."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# -------------------------------------------------------------------- vault

BIG_ROWS = 1 << 20                  # 512 × INT4_TILE_ROWS
RAGGED_ROWS = BIG_ROWS - 1971       # not a multiple of 2048, nor of 128
K10_BATCHES = (1, 8, 32)
SEP = 0.75         # most a request image may resemble another planted one
PLANT_SIGMA = 0.005                 # noise per element of a planted row


def check_int4_kernels(K10, IC, card):
    """Phase 9: K10a/K10b against their plain versions at 1,048,576 rows
    (B = 1, 8, 32) and at a ragged row count (B = 3): K10b bit for bit,
    K10a within its band with the planted faults outside it; CUDA-event
    times and the kernels' share of the HBM bandwidth."""
    packed, scale = IC.vault_case(BIG_ROWS, device="cuda")
    rows = {}
    for b, n in [(b, BIG_ROWS) for b in K10_BATCHES] + [(3, RAGGED_ROWS)]:
        pk, sc = packed[:n], scale[:n]
        q = IC.query_case(b, seed=b, device="cuda")
        ra = IC.check_k10a(q, pk, sc)
        IC.check_k10b(q, pk, sc)
        torch.cuda.synchronize()
        moved = n * (q.shape[1] // 2 + 4) + b * n * 4
        for name, fn, plain in (
                ("int4_sims", K10.int4_sims, K10.int4_sims_plain),
                ("int4_sims_i8", K10.int4_sims_i8, K10.int4_sims_i8_plain)):
            ms = cuda_ms(lambda: fn(q, pk, sc), 20)
            plain_ms = cuda_ms(lambda: plain(q, pk, sc), 3)
            err = ra["err"] if name == "int4_sims" else 0.0
            extra = (f" (band up to {ra['band']}; {ra['faults']} planted "
                     f"faults, nearest at {ra['nearest_fault']:.1f} bands)"
                     if name == "int4_sims" else " (bitwise equal)")
            print(f"{name} B={b} N={n}: max_abs_err={err}{extra} "
                  f"kernel_ms={ms} plain_ms={plain_ms} "
                  f"kernel_GB/s={moved / ms / 1e6:.1f} "
                  f"({moved / ms * 1e3 / PEAK_BYTES_PER_S:.1%} of 3.35 TB/s) "
                  f"[{card}]", flush=True)
            row = rows.setdefault(name, {"errs": []})
            row["errs"].append(err)
            if n == BIG_ROWS and b == 32:
                row.update(ms=ms, plain_ms=plain_ms, **bound(
                    moved, 2 * b * n * q.shape[1],
                    "int8" if name == "int4_sims_i8" else "bf16"))
    del packed, scale
    return {k: {"err": max(v.pop("errs")), **v} for k, v in rows.items()}


def vault_params():
    """Seeded detector weights (host, f32) for the vault phases, with the
    CLIP vision tower's class and position embeddings zeroed: with them a
    random-weight image embedding is dominated by the image-independent
    class token (in DetectorConfig.tiny() two noise images sit at cosine
    0.99), and no request could stay below the 0.85 reuse gate."""
    from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
    params = detector_init(0, DetectorConfig())
    for k in ("class_embedding", "position_embedding"):
        params["clip"]["vision"][k].zero_()
    return params


def vault_engine(params, path, **serving):
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    cfg = ForensicsConfig(verbose=False)
    cfg = cfg.replace(paths=dataclasses.replace(cfg.paths, vault_path=path),
                      serving=dataclasses.replace(cfg.serving, **serving))
    t0 = time.perf_counter()
    eng = MisinfoForensics(cfg, DetectorConfig(), params=params,
                           device="cuda")
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def clip_embeddings(eng, images=(), captions=()):
    """The engine's l2-normalized CLIP embeddings of images (one at a
    time, as the visual branch computes them) or of captions."""
    from misinfo_tpu_torch.models.clip import (
        clip_image_features, clip_text_features)
    from misinfo_tpu_torch.ops.common import l2_normalize
    from misinfo_tpu_torch.ops.image_ops import normalize_images
    out = []
    with torch.inference_mode():
        for im in images:
            x = normalize_images(eng._image_batch([im], 1)["image_clip"],
                                 "clip", eng.policy.compute)
            out.append(l2_normalize(clip_image_features(
                eng.params["clip"], x, eng.det_cfg.clip, eng.policy)))
        for c in captions:
            ids, mask = eng.clip_tokenizer.batch([c], eng._cl_len)
            out.append(l2_normalize(clip_text_features(
                eng.params["clip"], eng._tensor(ids), eng._tensor(mask),
                eng.det_cfg.clip, eng.policy)))
    return torch.cat(out).float().cpu().numpy()


def block_image(seed: int) -> np.ndarray:
    """A 224×224 image of 14×14 random 16-pixel blocks, each channel 0 or
    255: of the generators tried on the card (noise, 7×7 or 2×2 blocks of
    any colour) the one whose random-weight embeddings spread most."""
    cells = np.random.default_rng(seed).integers(0, 2, (14, 14, 3)) * 255
    return np.repeat(np.repeat(cells.astype(np.uint8), 16, axis=0), 16,
                     axis=1)


def pick_images(emb: np.ndarray, n_planted: int, n_other: int = 4):
    """Request images from a pool whose embeddings are all below SEP
    cosine of each other (the gate is 0.85), chosen farthest-first: the
    first ``n_planted`` to plant, the rest to stay unmatched."""
    c = emb @ emb.T
    sel = [int(np.argmin(c.mean(axis=1)))]
    while len(sel) < n_planted + n_other:
        rest = [i for i in range(len(emb)) if i not in sel]
        j = min(rest, key=lambda i: c[i, sel].max())
        if not c[j, sel].max() < SEP:
            break
        sel.append(j)
    off = c[np.triu_indices(len(emb), 1)]
    print(f"request image pool: {len(emb)} images, pairwise cosine "
          f"{off.min():.3f}..{off.max():.3f} (mean {off.mean():.3f}); "
          f"{len(sel)} chosen, each below {SEP} of the others", flush=True)
    if len(sel) < n_planted + n_other:
        raise AssertionError("the request images are too alike to plant "
                             "near-duplicates that others cannot match")
    return sel[:n_planted], sel[n_planted:]


def write_vault(path, rows, titles, n, planted, seed):
    """A vault of n random unit rows (and title rows) with planted rows
    {index: (image embedding, title embedding)}; f32, written once."""
    from misinfo_tpu_torch.vault.store import TruthVault
    d = len(next(iter(planted.values()))[0])
    if rows is None:
        seqs = np.random.SeedSequence(seed).spawn(16)
        rows = np.empty((n, d), np.float32)
        titles = np.empty((n, d), np.float32)
        step = -(-n // 8)

        def fill(i):
            r = np.random.default_rng(seqs[i])
            sl = slice((i % 8) * step, min(n, (i % 8 + 1) * step))
            dst = rows if i < 8 else titles
            dst[sl] = r.standard_normal((sl.stop - sl.start, d),
                                        dtype=np.float32)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(fill, range(16)))
    rng = np.random.default_rng(seed + 1)
    for i, (e, t) in planted.items():
        rows[i] = e + PLANT_SIGMA * rng.standard_normal(d)
        titles[i] = t
    meta = [{"title": f"Guardian archive {i}", "url": f"u{i}",
             "date": "2024-01-01"} for i in range(n)]
    TruthVault(rows, meta, titles).save(path)
    return rows, titles


@contextlib.contextmanager
def counting_programs(F):
    """Count the engine's visual program calls (full, visual_only) for
    the duration of the block."""
    real = F.signals_program
    seen = {"visual": 0}

    def spy(params, batch, *, variant, **kw):
        if variant in ("full", "visual_only"):
            seen["visual"] += 1
        return real(params, batch, variant=variant, **kw)
    F.signals_program = spy
    try:
        yield seen
    finally:
        F.signals_program = real


def top(report):
    m = report["vault_matches"]
    return (m[0]["title"], m[0]["similarity"]) if m else (None, None)


def check_vault_reports(reports, plants, what):
    """Planted requests at top-1 with their title and the gate open;
    every other request with the gate shut."""
    check_reports(reports, what)
    for i, r in enumerate(reports):
        gate = r["scores"]["vault_discrepancy"]
        if i in plants:
            title, _ = top(r)
            want = f"Guardian archive {plants[i]}"
            if title != want or not gate > 0.85:
                raise AssertionError(f"{what}: request {i} matched {title} "
                                     f"(want {want}) at {gate}")
        elif gate != 0.0:
            raise AssertionError(f"{what}: unplanted request {i} has "
                                 f"vault_discrepancy {gate} ({top(r)})")


def search_call(eng, q):
    """One vault_search of the query batch q on the engine's planes."""
    from misinfo_tpu_torch.vault.search import vault_search
    dev = eng._vault_device
    ivf = ({k: v for k, v in dev.items() if k.startswith("ivf_")}
           if "ivf_centroids" in dev else None)
    return lambda: vault_search(q, dev["vault_emb"], dev["vault_valid"],
                                top_k=5, ivf=ivf,
                                vault_scale=dev.get("vault_scale"))


def search_ms(eng, q32):
    """ms of one vault_search at B = 32 on the engine's device planes."""
    return cuda_ms(search_call(eng, q32), 10)


def vault_phases(card, small_vault, profile=None):
    """Phases 10-14: the vault capacity modes at 1,048,576 rows. Returns
    the K10a / K10b launch counts of their main-path runs. With
    ``profile``, appends profiler tables of the int4 engine's batch of 32
    and of one int4 vault_search at B = 32."""
    from misinfo_tpu_torch.engine import forensics as F
    from misinfo_tpu_torch.vault import int4 as K10
    from misinfo_tpu_torch.vault import ivf as IVF
    from misinfo_tpu_torch.vault import prepack
    params = vault_params()
    probe, _ = vault_engine(params, "")
    pool = [block_image(100 + i) for i in range(32)]
    emb = clip_embeddings(probe, images=pool)
    planted, others = pick_images(emb, 7)
    captions = [f"Archived photo number {i} of the flood" for i in range(4)]
    cap_emb = clip_embeddings(probe, captions=captions)
    rng = np.random.default_rng(4)
    del probe
    # requests 0-3 full and 4-5 visual_only planted; 6-31 unplanted;
    # planted[6] is the row the reload appends
    reqs = ([{"text": captions[i], "image": pool[planted[i]]}
             for i in range(4)]
            + [{"image": pool[planted[i]]} for i in (4, 5)]
            + [{"text": words(rng, 20), "image": pool[others[i % len(others)]]}
               for i in range(22)]
            + [{"image": pool[others[i % len(others)]]} for i in range(4)])
    rows_at = {i: 1000 + BIG_ROWS // 6 * i for i in range(6)}
    plant_rows = {rows_at[i]: (emb[planted[i]],
                               cap_emb[i] if i < 4 else emb[planted[i]])
                  for i in range(6)}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vault_")
    path = os.path.join(tmp, "vault.npz")
    t0 = time.perf_counter()
    rows, titles = write_vault(path, None, None, BIG_ROWS, plant_rows, 5)
    print(f"vault: {BIG_ROWS} rows × {emb.shape[1]} (f32 image + title "
          f"planes) made "
          f"and written in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 10: the int4 engine at 1,048,576 rows, two boots
    eng, boot1 = vault_engine(params, path, vault_dtype="int4")
    if not os.path.exists(prepack.sidecar_path(path)):
        raise AssertionError("the first int4 boot wrote no sidecar")
    real_build = prepack.build_prepacked
    builds = []
    prepack.build_prepacked = lambda v: builds.append(1) or real_build(v)
    del eng
    eng, boot2 = vault_engine(params, path, vault_dtype="int4")
    prepack.build_prepacked = real_build
    print(f"int4 engine boot: first {boot1:.1f} s (quantized both planes, "
          f"wrote {os.path.basename(prepack.sidecar_path(path))}), second "
          f"{boot2:.1f} s ({len(builds)} re-quantizations)", flush=True)
    if builds:
        raise AssertionError("the second boot re-quantized the vault")
    d = emb.shape[1]
    if tuple(eng._vault_device["vault_emb"].shape) != (BIG_ROWS, d // 2):
        raise AssertionError("int4 device plane shape")

    with counting_programs(F) as seen:
        K10.launches = K10.launches_i8 = 0      # this path's run starts here
        t0 = time.perf_counter()
        single = eng.analyze(reqs[0]["text"], reqs[0]["image"],
                             verbose=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batch = eng.analyze_batch(reqs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k10 = (K10.launches, K10.launches_i8)   # read just after the path
    plants = {i: rows_at[i] for i in range(6)}
    check_vault_reports([single], {0: rows_at[0]}, "int4 analyze")
    check_vault_reports(batch, plants, "int4 analyze_batch")
    print(f"int4 engine: analyze {1e3 * (t1 - t0):.1f} ms, analyze_batch "
          f"of 32 {1e3 * (t2 - t1):.1f} ms [{card}]; visual programs "
          f"{seen['visual']}, K10b launches {k10[1]}, K10a {k10[0]}",
          flush=True)
    if k10 != (0, seen["visual"]) or seen["visual"] != 3:
        raise AssertionError(f"K10 launches {k10} for {seen['visual']} "
                             "visual programs (want K10b once each)")

    # phase 11: the same vault in the other dtypes (f32 is the reference)
    q32 = torch.nn.functional.normalize(
        torch.randn(32, d, generator=torch.Generator().manual_seed(3)),
        dim=1).to(eng.device)
    if profile:
        append_profile(profile, f"int4 vault ({BIG_ROWS} rows) "
                       "analyze_batch of 32", lambda: eng.analyze_batch(reqs))
        append_profile(profile, "int4 vault_search at B = 32",
                       search_call(eng, q32))
    report = {"int4": (eng.memory_report(), search_ms(eng, q32))}
    f32, boot = vault_engine(params, path)
    ref = f32.analyze_batch(reqs)
    check_vault_reports(ref, plants, "f32 analyze_batch")
    drift = 0.0
    for i in plants:
        a, b = batch[i], ref[i]
        if top(a)[0] != top(b)[0]:
            raise AssertionError(f"request {i}: int4 top-1 {top(a)[0]} vs "
                                 f"f32 {top(b)[0]}")
        sims = [m["similarity"] for m in a["vault_matches"]]
        want = [m["similarity"] for m in b["vault_matches"]]
        drift = max([drift, *(abs(x - y) for x, y in zip(sims, want)),
                     *(abs(a["scores"][k] - b["scores"][k]) for k in
                       ("vault_discrepancy", "text_similarity"))])
    print(f"int4 vs f32 engine, planted requests: same top-1, max sim "
          f"drift {drift} (limit 0.05); f32 boot {boot:.1f} s", flush=True)
    if not drift < 0.05:
        raise AssertionError(f"int4 sims drift {drift} from f32's")
    report["float32"] = (f32.memory_report(), search_ms(f32, q32))
    del f32
    for dt in ("bfloat16", "int8"):
        e, boot = vault_engine(params, path, vault_dtype=dt)
        report[dt] = (e.memory_report(), search_ms(e, q32))
        print(f"{dt} engine boot {boot:.1f} s", flush=True)
        del e
    for dt, (mem, ms) in report.items():
        print(f"vault_dtype={dt}: vault_search B=32 {ms} ms; memory_report "
              f"{json.dumps(mem)} [{card}]", flush=True)

    # phase 12: IVF over the same f32 vault, built on the card
    real_ivf = IVF.build_ivf
    built = {}

    def timed_build(*a, **kw):
        t = time.perf_counter()
        out = real_ivf(*a, **kw)
        torch.cuda.synchronize()
        built.update(seconds=time.perf_counter() - t, clusters=out.n_clusters,
                     spill=int((out.spill >= 0).sum()))
        return out
    IVF.build_ivf = timed_build
    try:
        ivf_eng, boot = vault_engine(params, path, vault_ivf=True)
    finally:
        IVF.build_ivf = real_ivf
    ivf_reqs = reqs[:6] + reqs[6:8] + reqs[28:30]
    got = ivf_eng.analyze_batch(ivf_reqs)
    check_vault_reports(got, plants, "IVF analyze_batch")
    print(f"IVF: built on the card in {built['seconds']:.1f} s "
          f"({built['clusters']} clusters, {built['spill']} spilled rows), "
          f"engine boot {boot:.1f} s; analyze_batch of {len(ivf_reqs)} found "
          f"every planted row; vault_search B=32 {search_ms(ivf_eng, q32)} "
          f"ms [{card}]", flush=True)
    del ivf_eng

    # phase 13: reload_vault(drop_first=True) onto the vault with rows
    # appended, one of them planted
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    extra = 4096
    new_row = BIG_ROWS + 100
    rng = np.random.default_rng(6)
    more = rng.standard_normal((extra, d)).astype(np.float32)
    path2 = os.path.join(tmp, "vault_grown.npz")
    write_vault(path2, np.concatenate([rows, more]),
                np.concatenate([titles, more[::-1]]), BIG_ROWS + extra,
                {new_row: (emb[planted[6]], emb[planted[6]])}, 7)
    del rows, titles
    t0 = time.perf_counter()
    info = eng.reload_vault(path2, drop_first=True)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    grown = eng.analyze_batch([{"image": pool[planted[6]]}, reqs[4],
                               reqs[6]])
    check_vault_reports(grown, {0: new_row, 1: rows_at[4]},
                        "after reload_vault")
    print(f"reload_vault(drop_first=True): {info} in {reload_s:.1f} s; the "
          f"appended row {new_row} is found", flush=True)
    del eng

    # phase 14: an int4 vault below KERNEL_MIN_ROWS runs K10a
    small, _ = vault_engine(params, small_vault, vault_dtype="int4")
    rng = np.random.default_rng(8)
    small_reqs = ([{"image": pool[i]} for i in others[:3]]
                  + [{"text": words(rng, 20), "image": pool[planted[0]]}])
    with counting_programs(F) as seen:
        K10.launches = K10.launches_i8 = 0      # this path's run starts here
        out = small.analyze_batch(small_reqs)
        torch.cuda.synchronize()
        k10a = (K10.launches, K10.launches_i8)  # read just after the path
    check_reports(out, "int4 small-vault analyze_batch")
    print(f"int4 engine, {small.vault.num_articles}-row vault: visual "
          f"programs {seen['visual']}, K10a launches {k10a[0]}, K10b "
          f"{k10a[1]}", flush=True)
    if k10a != (seen["visual"], 0) or not seen["visual"]:
        raise AssertionError(f"K10 launches {k10a} on the small vault")
    shutil.rmtree(tmp)
    return {"int4_sims": k10a[0], "int4_sims_i8": k10[1]}


# ------------------------------------------------------- opt-in kernel modes

OPT_SHAPES = {                      # the main path's shapes at full b32/S512
    "int8_dense": (("roberta", 32 * 512, 768, 768),
                   ("clip_text", 32 * 77, 512, 512),
                   ("clip_vision", 32 * 50, 768, 768)),
    "fused_attention": (("roberta", 32, 512, 12, True, False),
                        ("clip_text", 32, 77, 8, True, True),
                        ("clip_vision", 32, 50, 12, False, False)),
    "fused_ffn": (("roberta", 32 * 512, 768, 3072, "tanh"),
                  ("clip_text", 32 * 77, 512, 2048, "quick"),
                  ("clip_vision", 32 * 50, 768, 3072, "quick"),
                  ("whisper_decode", 32, 512, 2048, "tanh"),
                  ("whisper_tiny_decode", 32, 384, 1536, "tanh"),
                  ("whisper_medium_decode", 32, 1024, 4096, "tanh"),
                  ("whisper_large_decode", 32, 1280, 5120, "tanh")),
}


# phases 16-17: (label, quant, use_pallas, launches of one analyze of a
# 300-word request, launches of the b32/S512 batch). 12 layers per tower;
# K2 takes the 4 projections of a tower whose rows reach 256 (RoBERTa
# 512 / 16,384, CLIP text 77 / 2,464, CLIP vision 50 / 1,600)
OPT_ENGINES = (
    ("I", "int8", True,
     {"int8_dense": 48, "int8_ffn": 36, "fused_attention": 36},
     {"int8_dense": 144, "int8_ffn": 36, "fused_attention": 36}),
    ("II", "none", "ffn", {"fused_ffn": 36}, {"fused_ffn": 36}))


def _report(what, res, card) -> None:
    extra = (f"bitwise equal (a one-ulp scale fault moves "
             f"{res['fault_elements']} outputs)" if "fault_elements" in res
             else f"max_abs_err={res['err']} (band up to {res['band']}; "
                  f"worst {res['worst']:.3f} of the band; {res['faults']} "
                  f"planted faults, nearest at "
                  f"{res['nearest_fault']:.1f} bands)")
    print(f"{what}: {extra} [{card}]", flush=True)


def _timed(name, fn, plain, library, moved, ops, kind, card, reps=20):
    row = {"ms": cuda_ms(fn, reps), "plain_ms": cuda_ms(plain, 3),
           "library_ms": cuda_ms(library, reps) if library else None,
           **bound(moved, ops, kind)}
    print(f"{name} times: kernel_ms={row['ms']} plain_ms={row['plain_ms']} "
          f"library_ms={row['library_ms']} bound_ms={row['bound_ms']} "
          f"({row['bound_by']}) [{card}]", flush=True)
    return row


def check_opt_in_kernels(card):
    """Phase 15: K2-K5 against their plain versions on the card at the
    main path's shapes (ops/kernel_checks.py), bf16 and f32; CUDA-event
    times at the RoBERTa shape (bf16) with the bound and, for K3 and K4,
    the one PyTorch call that computes the same function."""
    import torch.nn.functional as F
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import kernel_checks as KC
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    for name, M, K, N in OPT_SHAPES["int8_dense"]:
        for xd in (bf16, f32):
            _report(f"int8_dense {name} M={M} K={K} N={N} x {xd}",
                    KC.check_int8_dense(KC.int8_dense_case(M, K, N, xd)),
                    card)
    _report("int8_dense no bias M=300 K=N=768", KC.check_int8_dense(
        KC.int8_dense_case(300, 768, 768, bias=False)), card)
    _, M, K, N = OPT_SHAPES["int8_dense"][0]
    c = KC.int8_dense_case(M, K, N)
    a = (c["x"], c["wq"], c["w_scale"], c["bias"])
    rows["int8_dense"] = {"err": 0.0, **_timed(
        "int8_dense roberta", lambda: K2.int8_dense(*a),
        lambda: K2.int8_dense_plain(*a), None, nbytes(*a) + M * N * 2,
        2 * M * K * N, "int8", card)}

    errs = []
    for dt in (bf16, f32):
        for name, B, S, H, m, causal in OPT_SHAPES["fused_attention"]:
            res = KC.check_attention(KC.attention_case(B, S, H, m, causal, dt))
            errs.append(res["err"])
            _report(f"fused_attention {name} B={B} S={S} H={H} {dt}", res,
                    card)
    _, B, S, H, m, causal = OPT_SHAPES["fused_attention"][0]
    c = KC.attention_case(B, S, H, m, causal, bf16)
    q, k, v, mask = c["q"], c["k"], c["v"], c["mask"]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    add = ((1.0 - mask) * -1e9)[:, None, None, :].to(bf16)
    rows["fused_attention"] = {"err": max(errs), **_timed(
        "fused_attention roberta", lambda: K3.fused_attention(q, k, v, mask),
        lambda: K3.fused_attention_plain(q, k, v, mask),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add),
        nbytes(q, k, v, q, mask), 4 * B * H * S * S * q.shape[-1], "bf16",
        card)}

    errs = []
    for dt in (bf16, f32):
        res = KC.check_layer_norm(KC.layer_norm_case(32 * 512, 768, dt))
        errs.append(res["err"])
        _report(f"layer_norm rows={32 * 512} D=768 {dt}", res, card)
    c = KC.layer_norm_case(32 * 512, 768, bf16)
    x, sc, bi = c["x"], c["scale"], c["bias"]
    sc16, bi16 = sc.to(bf16), bi.to(bf16)
    K3.ln_launches = 0      # K4's own drive (no model calls it) starts here
    K3.fused_layer_norm(x, sc, bi)
    torch.cuda.synchronize()
    ln_launches = K3.ln_launches        # read just after it
    rows["layer_norm"] = {"err": max(errs), "launches": ln_launches, **_timed(
        "layer_norm", lambda: K3.fused_layer_norm(x, sc, bi),
        lambda: K3.fused_layer_norm_plain(x, sc, bi),
        lambda: F.layer_norm(x, (768,), sc16, bi16),
        2 * nbytes(x) + nbytes(sc, bi), 8 * x.numel(), "f32", card)}

    errs = []
    for dt in (bf16, f32):
        for name, M, K, N, mode in OPT_SHAPES["fused_ffn"]:
            res = KC.check_ffn(KC.ffn_case(M, K, N, mode, dt))
            errs.append(res["err"])
            _report(f"fused_ffn {name} M={M} K={K} N={N} {mode} {dt}", res,
                    card)
    _, M, K, N, mode = OPT_SHAPES["fused_ffn"][0]
    a = KC.ffn_case(M, K, N, mode, bf16)["args"]
    rows["fused_ffn"] = {"err": max(errs), **_timed(
        "fused_ffn roberta", lambda: K5.fused_ffn(*a, mode=mode),
        lambda: K5.fused_ffn_plain(*a, mode=mode), None,
        nbytes(*a) + M * K * 2, 2 * M * N * 2 * K, "bf16", card, reps=10)}
    return rows


@contextlib.contextmanager
def swapped(*swaps):
    """Replace module attributes, (module, name, stand-in) each, for the
    duration of the block: here the kernels' wrappers by their plain
    versions, which then run on the card."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def opt_in_engines(default, vault_path, b32, image, rng, card,
                   profile=None):
    """Phases 16-17: the engine at full width in its opt-in kernel modes,
    with phase 4's seeded weights, vault and b32/S512 requests. Engine I
    (quant="int8", use_pallas=True): one analyze() of a 300-word request
    (RoBERTa's 512 rows take K2, CLIP's 77 and 50 stay below 256) and the
    b32 batch, whose full program must launch K2 144, K1 36 and K3 36
    times. Engine II (quant="none", use_pallas="ffn"): K5 36 times. Each:
    scores within 0.05 of the same engine with the plain versions,
    verdicts/s beside the default engine's, params bytes. With
    ``profile``, appends a profiler table of each engine's b32 batch.
    Returns the kernels' launch counts of the b32 runs."""
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import int8_ffn as K1
    mods = {"int8_dense": K2, "int8_ffn": K1, "fused_attention": K3,
            "fused_ffn": K5}
    plain = {"int8_dense": (K2, "int8_dense", K2.int8_dense_plain),
             "int8_ffn": (K1, "int8_ffn", K1.int8_ffn_plain),
             "fused_attention": (K3, "fused_attention",
                                 K3.fused_attention_plain),
             "fused_ffn": (K5, "fused_ffn", K5.fused_ffn_plain)}
    launches = {}
    vps = {"default": verdicts_per_s(default, b32)}
    for label, quant, use_pallas, want_single, want_b32 in OPT_ENGINES:
        cfg = ForensicsConfig(verbose=False)
        cfg = cfg.replace(
            paths=dataclasses.replace(cfg.paths, vault_path=vault_path),
            precision=dataclasses.replace(cfg.precision, quant=quant))
        eng = MisinfoForensics(cfg, DetectorConfig(), use_pallas=use_pallas,
                               device="cuda")
        what = f"engine {label} (quant={quant!r}, use_pallas={use_pallas!r})"
        if eng.quant != quant:
            raise AssertionError(f"{what}: quant resolved to {eng.quant}")
        text = words(rng, 300)
        eng.analyze(text, image, verbose=False)          # build, warm up
        torch.cuda.synchronize()
        counts = {}
        for run, fn in (("single", lambda: [eng.analyze(text, image,
                                                        verbose=False)]),
                        ("b32", lambda: eng.analyze_batch(b32))):
            for m in mods.values():
                m.launches = 0          # this path's run starts here
            reports = fn()
            torch.cuda.synchronize()
            counts[run] = {n: m.launches for n, m in mods.items()
                           if m.launches}  # read just after the path
            check_reports(reports, f"{what} {run}")
        print(f"{what}: launches, one analyze {counts['single']} (want "
              f"{want_single}); full b32/S512 {counts['b32']} (want "
              f"{want_b32})", flush=True)
        if counts != {"single": want_single, "b32": want_b32}:
            raise AssertionError(f"{what}: launch counts off")
        launches.update(counts["b32"])
        with_kernels = eng.analyze_batch(b32)
        with swapped(*[plain[n] for n in want_b32]):
            with_plain = eng.analyze_batch(b32)
        drift = max(abs(a["scores"][k] - b["scores"][k])
                    for a, b in zip(with_kernels, with_plain)
                    for k in ("ai_score", "misinfo_score", "deepfake_score",
                              "clip_similarity", "fake_probability"))
        vps[label] = verdicts_per_s(eng, b32)
        print(f"{what}: max score drift against the plain versions {drift} "
              f"(limit 0.05); b32/S512 {vps[label]} verdicts/s; params "
              f"{eng.memory_report()['params_bytes']} bytes (default "
              f"engine, quant={default.quant!r}: "
              f"{default.memory_report()['params_bytes']}) [{card}]",
              flush=True)
        if not drift < 0.05:
            raise AssertionError(f"{what}: scores drift {drift} >= 0.05")
        if profile:
            append_profile(profile, f"{what} full b32/S512 analyze_batch",
                           lambda: eng.analyze_batch(b32), rows=40)
        del eng
    vps["default again"] = verdicts_per_s(default, b32)
    print("b32/S512 verdicts/s in one run: " + ", ".join(
        f"{k} {v}" for k, v in vps.items()) + f" [{card}]", flush=True)
    return launches


def whisper_pallas_ffn(weights, cfg, wav, card):
    """Phase 18: one whisper-base greedy decode_transcript(pallas_ffn=True)
    (bf16 weights, fused steps off): K5 once per decoder layer per step;
    tokens equal to those of the same decode with K5's plain version;
    teacher-forced logits within FFN_TF_BAND. Returns K5's launches."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    tr = WhisperTranscriber(weights, config=cfg, device="cuda",
                            decode_cfg=dataclasses.replace(
                                WhisperDecodeConfig(), quant="none",
                                pallas="off"))
    mels, _ = prep_mel_windows(wav, 2 * cfg.max_source_positions, 1)
    prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                          device=tr.device)
    real_step = W._cached_decoder_step
    steps = []

    def step(*a, **kw):
        steps.append(1)
        return real_step(*a, **kw)

    def decode():
        return W.decode_transcript(tr.params, None, tr.cfg, tr.policy,
                                   enc_out=enc, prompt_tokens=prompt,
                                   pallas_ffn=True)[0]
    with torch.inference_mode():
        enc = tr._encode(mels)
        decode()                                        # warm up
        torch.cuda.synchronize()
        with swapped((W, "_cached_decoder_step", step)):
            K5.launches = 0             # this path's run starts here
            t0 = time.perf_counter()
            tokens = decode()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = K5.launches      # read just after the path
        with swapped((K5, "fused_ffn", K5.fused_ffn_plain)):
            tokens_plain = decode()
        n = tokens.shape[1]

        def forced():
            cache = W.init_kv_cache(tr.params, enc, n, tr.cfg, tr.policy)
            return torch.cat([W._cached_decoder_step(
                tr.params, tokens[:, i], i, enc, cache, tr.cfg, tr.policy,
                pallas_ffn=True)[0].float() for i in range(n - 1)])
        got = forced()
        with swapped((K5, "fused_ffn", K5.fused_ffn_plain)):
            want = forced()
    layers = cfg.decoder_layers
    diff = (got - want).abs().max().item()
    emitted = int((tokens[0] != cfg.eos_token_id).sum().item())
    same = torch.equal(tokens, tokens_plain)
    print(f"whisper pallas_ffn decode: {len(steps)} steps ({emitted} tokens "
          f"before EOS) in {sec} s, K5 launches {launches} (want "
          f"{layers} × {len(steps)}); tokens equal to the plain version's: "
          f"{same}; teacher-forced max |Δlogit| {diff} (band {FFN_TF_BAND}) "
          f"[{card}]", flush=True)
    if launches != layers * len(steps) or not steps:
        raise AssertionError(f"K5 launches {launches} != {layers} × "
                             f"{len(steps)} decode steps")
    if not (same and math.isfinite(diff) and diff <= FFN_TF_BAND):
        raise AssertionError("the pallas_ffn decode disagrees with its plain "
                             "version")
    return launches


def whisper_int8_modes(tr, weights, cfg, wav, card):
    """Phases 21-23 on the quant="kernels" transcriber's weights (int8
    blocks, fused QKV): greedy decode_transcript over bf16 cross planes
    (K6b + K7b), with cross_int8=True (K6b + K8) and with
    pallas_layer=True (K9), each with exact launch counts; K8's decode
    teacher-forced against the plain versions; K9's outputs equal to the
    two-call decode's; then the quant="int8" transcriber (no decode
    kernel). Returns the launches of K8 and K9."""
    from misinfo_tpu_torch.core.config import WhisperDecodeConfig
    from misinfo_tpu_torch.models import whisper as W
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import layer_step as K9
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.preprocess.audio import prep_mel_windows
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    mels, _ = prep_mel_windows(wav, 2 * cfg.max_source_positions, 1)
    sp = tr.tokenizer.specials
    prompt = torch.tensor([tr.tokenizer.sot_sequence(language="en")[1:]],
                          device=tr.device)
    layers = cfg.decoder_layers
    real_step = W._cached_decoder_step
    steps = []

    def step(*a, **kw):
        steps.append(1)
        return real_step(*a, **kw)

    def counts():
        return {"K5": K5.launches, "K6": K6.launches,
                "K6 int8": K6.launches_i8, "K7": K7.launches, "K7 int8": K7.launches_i8,
                "K8": K7.launches_i8cc, "K9": K9.launches}

    def counted(**kw):
        """One warm decode, then one with the counts set to 0 just before
        and read just after: (outputs, steps, counts, ms per step)."""
        def decode():
            return W.decode_transcript(
                tr.params, None, tr.cfg, tr.policy, enc_out=enc,
                prompt_tokens=prompt, nospeech_id=sp.no_speech, **kw)
        decode()
        torch.cuda.synchronize()
        del steps[:]
        with swapped((W, "_cached_decoder_step", step)):
            K5.launches = K6.launches = K6.launches_i8 = 0
            K7.launches = K7.launches_i8 = K7.launches_i8cc = 0
            K9.launches = 0             # this path's run starts here
            globals_before = K9.kernel_launches()
            t0 = time.perf_counter()
            out = decode()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            seen = counts()             # read just after the path
            seen["K9 __global__"] = K9.kernel_launches() - globals_before
        n = len(steps)
        if n == 0:
            raise AssertionError(f"decode_transcript({kw}) took no step")
        return out, n, {k: v for k, v in seen.items() if v}, sec * 1e3 / n

    with torch.inference_mode():
        enc = tr._encode(mels)
        two = dict(pallas_self_attn=True, pallas_cross=True)
        out2, n2, c2, ms2 = counted(**two)
        out8, n8, c8, ms8 = counted(**two, cross_int8=True)
        out9, n9, c9, ms9 = counted(pallas_layer=True)
        two_again = counted(**two)[3]

        # phase 21: exact counts, then kernels against plain versions
        for what, n, got, want in (
                ("bf16 planes", n2, c2, {"K6": layers * n2,
                                         "K6 int8": layers * n2,
                                         "K7": layers * n2,
                                         "K7 int8": layers * n2}),
                ("cross_int8", n8, c8, {"K6": layers * n8,
                                        "K6 int8": layers * n8,
                                        "K8": layers * n8}),
                ("pallas_layer", n9, c9, {"K9": layers * n9,
                                          "K9 __global__": layers * n9})):
            print(f"whisper int8-weight decode, {what}: {n} steps, launches "
                  f"{got} (want {want})", flush=True)
            if got != want:
                raise AssertionError(f"{what}: launch counts off")
        tokens = out8[0]
        n = tokens.shape[1]

        def forced():
            cache = W.init_kv_cache(tr.params, enc, n, tr.cfg, tr.policy,
                                    merged_self=True, merged_cross=True,
                                    cross_int8=True)
            if cache["cross_k"][0].dtype != torch.int8:
                raise AssertionError("cross_int8 cache is not int8")
            return torch.cat([W._cached_decoder_step(
                tr.params, tokens[:, i], i, enc, cache, tr.cfg, tr.policy,
                **two)[0].float() for i in range(n - 1)])
        got = forced()
        with plain_decode_steps(W, K6, K7):
            before = counts()
            want = forced()
            if counts() != before:
                raise AssertionError("the plain decode launched a kernel")
    diff = (got - want).abs().max().item()
    spread = (want.max() - want.min()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    same_tokens = (out8[0] == out2[0]).float().mean().item()
    print(f"cross_int8 decode teacher-forced {n - 1} steps: max |Δlogit| "
          f"{diff} (band {I8CC_TF_BAND}; logit range {spread}); argmax "
          f"agreement {agree}; tokens shared with the bf16-plane decode "
          f"{same_tokens}; decode ms/step: bf16 planes {ms2}, cross_int8 "
          f"{ms8}, bf16 planes again {two_again} [{card}]", flush=True)
    if not (math.isfinite(diff) and diff <= I8CC_TF_BAND):
        raise AssertionError(f"cross_int8 teacher-forced logits differ by "
                             f"{diff}")

    # phase 22: the whole-layer decode is the two-call decode
    equal = [torch.equal(a, b) for a, b in zip(out9, out2)]
    print(f"pallas_layer decode: tokens, avg_logprob, p(no speech) equal to "
          f"the two-call decode's: {equal}; decode ms/step: pallas_layer "
          f"{ms9}, two calls {ms2} and {two_again} [{card}]", flush=True)
    if not (all(equal) and len(equal) == 3):
        raise AssertionError("the pallas_layer decode differs from the "
                             "two-call decode")
    if not all(bool(torch.isfinite(t.float()).all()) for t in out9[1:]):
        raise AssertionError("the pallas_layer decode is not finite")

    # phase 23: the int8 streaming transcriber
    trq = WhisperTranscriber(weights, config=cfg, device="cuda",
                             decode_cfg=dataclasses.replace(
                                 WhisperDecodeConfig(), quant="int8",
                                 fallback_temperatures=(0.0,)))
    emb = trq.params["decoder"].get("token_embedding_q")
    if not (trq.quant and not trq.pallas and not trq.quant_kernels
            and emb is not None and emb.dtype == torch.int8
            and emb.is_cuda):
        raise AssertionError("quant='int8' did not resolve to the int8 "
                             "streaming decode on the card")
    exact = WhisperTranscriber(weights, config=cfg, device="cuda",
                               decode_cfg=dataclasses.replace(
                                   WhisperDecodeConfig(), quant="none",
                                   pallas="off"))
    caches = []

    def stream_step(*a, **kw):
        steps.append(1)
        caches.append(a[4].get("cross_k_scale") is not None
                      and a[4]["cross_k"][0].dtype == torch.int8)
        return real_step(*a, **kw)
    del steps[:]
    before = counts()
    with swapped((W, "_cached_decoder_step", stream_step)):
        t0 = time.perf_counter()
        text = trq.transcribe(wav)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    if counts() != before:
        raise AssertionError(f"the int8 streaming transcriber launched a "
                             f"decode kernel: {before} → {counts()}")
    if text.startswith("[transcript error"):
        raise AssertionError(f"transcribe (quant=int8) failed: {text}")
    # every decode step streams int8 caches; language detection's one SOT
    # step has a cache of its own
    if not (sum(caches) > 0 and sum(caches) >= len(caches) - 1):
        raise AssertionError("a streaming decode step ran without int8 "
                             "cross caches")
    with torch.inference_mode():
        sot = torch.full((1,), sp.sot, dtype=torch.int64, device="cuda")
        lq = real_step(trq.params, sot, 0, enc, W.init_kv_cache(
            trq.params, enc, 1, cfg, trq.policy, quant=True), cfg,
            trq.policy)[0].float()
        lx = real_step(exact.params, sot, 0, enc, W.init_kv_cache(
            exact.params, enc, 1, cfg, exact.policy), cfg,
            exact.policy)[0].float()
    rel = ((lq - lx).abs().max() / lx.abs().max()).item()
    print(f"transcribe (quant=int8, greedy rung only): {sec} s, "
          f"{len(steps)} steps, {sec * 1e3 / len(steps)} ms per step, no "
          f"decode kernel launched; transcript {len(text)} chars; position-0 "
          f"logits within {rel} × max|logit| of the unquantized step (limit "
          f"{STREAM_BAND}) [{card}]", flush=True)
    if not (math.isfinite(rel) and rel <= STREAM_BAND):
        raise AssertionError(f"int8 streaming logits off by {rel} × "
                             f"max|logit|")
    return {"cross_ffn_step_i8cc": c8["K8"], "layer_step": c9["K9"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="write torch.profiler tables of the b32 batch and "
                    "of one greedy transcript decode here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.ops import cross_ffn_step as K7
    from misinfo_tpu_torch.ops import fused_attention as K3
    from misinfo_tpu_torch.ops import fused_ffn as K5
    from misinfo_tpu_torch.ops import int8_dense as K2
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops import layer_step as K9
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.ops.quant import quantize_dense
    from misinfo_tpu_torch.vault import int4 as K10
    from misinfo_tpu_torch.vault import int4_checks as IC

    card = card_line()
    print(card, flush=True)                                   # phase 1
    build_all([(m, "_library", "build_log")                   # phase 2
               for m in (K1, K2, K3, K5, K6, K7, K9, K10)]
              + [(K3, "_ln_library", "ln_build_log"),
                 (K7, "_library_i8cc", "build_log_i8cc")])
    kernel_rows = check_kernel(K1, quantize_dense)            # phase 3
    opt_rows = check_opt_in_kernels(card)                     # phase 15

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
    with swapped((K1, "int8_ffn", K1.int8_ffn_plain)):
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
    with swapped((K1, "int8_ffn", K1.int8_ffn_plain)):
        vps_plain = verdicts_per_s(engine, b32)
    vps_again = verdicts_per_s(engine, b32)
    print(f"single analyze latency: {single_ms} ms; full b32/S512: {vps} "
          f"verdicts/s, plain FFN {vps_plain}, kernel again {vps_again} "
          f"[{card}]", flush=True)
    if args.profile:
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        open(args.profile, "w").close()
    opt_launches = opt_in_engines(engine, vault_path, b32,   # phases 16-17
                                  image, rng, card, args.profile)
    decode_rows = check_decode_kernels(K6, K7)                # phase 5
    decode_rows["cross_ffn_step_i8cc"] = check_i8cc_kernel(K7, card)    # 19
    decode_rows["layer_step"] = check_layer_kernel(K6, K7, K9, card)    # 20
    if args.profile:
        append_profile(args.profile, "full b32/S512 analyze_batch",
                       lambda: engine.analyze_batch(b32), rows=40)

    decode_launches = transcript_phases(engine, image, card,  # phases 6-8,
                                        args.profile)         # 18, 21-23
    del engine
    int4_rows = check_int4_kernels(K10, IC, card)             # phase 9
    int4_launches = vault_phases(card, vault_path,            # phases 10-14
                                 args.profile)

    rob = kernel_rows["roberta"]
    M, K, N = 3 * 512, 768, 3072
    kernels = [{
        "name": "int8_ffn", "route": "cuda",
        "source": "misinfo_tpu_torch/csrc/int8_ffn.cu",
        "replaces": "misinfo_tpu/ops/pallas_int8.py:237",
        "launches": main_launches,
        "max_abs_err": max(r["err"] for r in kernel_rows.values()),
        "ms": rob["ms"], "plain_ms": rob["plain_ms"],
        **bound(M * K * 2 * 2 + 2 * K * N + 4 * (2 * N + 2 * K),
                2 * M * N * 2 * K, "int8"),
        "library_ms": None}]
    replaces = {"self_attn_step": "misinfo_tpu/ops/pallas_decode.py:52",
                "self_attn_step_i8": "misinfo_tpu/ops/pallas_decode.py:148",
                "cross_ffn_step": "misinfo_tpu/ops/pallas_cross_ffn.py:125",
                "cross_ffn_step_i8": "misinfo_tpu/ops/pallas_cross_ffn.py:250",
                "cross_ffn_step_i8cc":
                    "misinfo_tpu/ops/pallas_cross_ffn.py:373",
                "layer_step": "misinfo_tpu/ops/pallas_layer.py:48"}
    for name, where in replaces.items():
        row = decode_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("misinfo_tpu_torch/csrc/"
                       f"{name.removesuffix('_i8')}.cu"),
            "replaces": where, "launches": decode_launches[name],
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    for name, line in (("int4_sims", 123), ("int4_sims_i8", 177)):
        row = int4_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "misinfo_tpu_torch/csrc/int4_sims.cu",
            "replaces": f"misinfo_tpu/vault/int4.py:{line}",
            "launches": int4_launches[name], "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    for name, src, where, launches in (
            ("int8_dense", "int8_dense.cu",
             "misinfo_tpu/ops/pallas_int8.py:123",
             opt_launches["int8_dense"]),
            ("fused_attention", "fused_attention.cu",
             "misinfo_tpu/ops/pallas_attention.py:32",
             opt_launches["fused_attention"]),
            ("layer_norm", "layer_norm.cu",
             "misinfo_tpu/ops/pallas_attention.py:115",
             opt_rows["layer_norm"]["launches"]),
            ("fused_ffn", "fused_ffn.cu", "misinfo_tpu/ops/pallas_ffn.py:59",
             opt_launches["fused_ffn"])):
        row = opt_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"misinfo_tpu_torch/csrc/{src}", "replaces": where,
            "launches": launches, "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
