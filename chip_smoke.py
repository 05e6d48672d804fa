"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the four kernel sources in parallel, one nvcc each
     (misinfo_tpu_torch/csrc/{int8_ffn,self_attn_step,cross_ffn_step,
     int4_sims}.cu);
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
     pallas on and quant="kernels" (K6/K7 int8 bodies), then
     quant="embedding" (the bf16 bodies); each transcribes a 20 s
     two-tone-plus-noise WAV, and K6 and K7 must each launch once per
     decoder layer per fused decode step, every launch with the weight
     type of that transcriber's body;
  7. a teacher-forced comparison: the greedy tokens fed through the step
     with the kernels and with their plain versions, per-step logits
     within TF_BAND (argmax agreement printed: with random weights
     near-ties make free-running token equality a coin toss);
  8. merge_into_caption → engine.analyze(merged caption, image), report
     checked; then the encoder's time for one 30 s window, decode ms per
     step with the kernels and with the plain versions, and one
     transcribe() wall time (printed only);
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
     dispatcher runs K10a): K10a launched once per visual program.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors and times. ``--profile FILE``
also writes torch.profiler tables of the b32 batch and of one greedy
transcript decode to FILE.
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


# ---------------------------------------------------------------- transcript

WB = dict(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8,
          ffn_dim=2048, max_source_positions=1500, max_target_positions=448)
# phase 7: |Δlogit| allowed between the kernels' and the plain versions'
# teacher-forced decode, three times the largest measured on an H100
# (0.045, against a logit range of 3.4)
TF_BAND = 0.135


def build_all(modules) -> None:
    """Phase 2: one nvcc per kernel source, all started together."""
    def one(m):
        t0 = time.perf_counter()
        m._library()
        return time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        secs = list(pool.map(one, modules))
    for m, sec in zip(modules, secs):
        print(f"build {m.__name__}: {sec:.2f} s", flush=True)
        print("\n".join(line for line in m.build_log.splitlines()
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
                                        "plain_ms": plain_ms}
    return rows


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


@contextlib.contextmanager
def plain_decode_steps(W, K6, K7):
    """Run the fused decode step with the kernels' plain versions (on the
    card) for the duration of the block."""
    real = (W.fused_self_attn_step, W.fused_cross_ffn_step)
    W.fused_self_attn_step = K6.self_attn_step_plain
    W.fused_cross_ffn_step = K7.cross_ffn_step_plain
    try:
        yield
    finally:
        W.fused_self_attn_step, W.fused_cross_ffn_step = real


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
    print(f"transcribe ({what}): {sec} s, {seen['fused']} fused decode "
          f"steps, K6 launches {l6} (int8 {l6_i8}), K7 launches {l7} (int8 "
          f"{l7_i8}) (want {layers * seen['fused']} each); transcript "
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
    """Phases 6-8; returns the K6/K7 kernel rows' launches."""
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
    for quant in ("auto", "embedding"):
        tr = WhisperTranscriber(weights, config=cfg, device="cuda",
                                decode_cfg=dataclasses.replace(
                                    WhisperDecodeConfig(), quant=quant))
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
    t0 = time.perf_counter()
    tr.transcribe(wav)
    torch.cuda.synchronize()
    print(f"one transcribe() wall time: {time.perf_counter() - t0} s "
          f"[{card}]", flush=True)
    transcript_timings(tr, wav, W, K6, K7, profile)
    return launches


# -------------------------------------------------------------------- vault

BIG_ROWS = 1 << 20                  # 512 × INT4_TILE_ROWS
RAGGED_ROWS = BIG_ROWS - 1971       # not a multiple of 2048, nor of 128
K10_BATCHES = (1, 8, 32)
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, published
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
                row.update(ms=ms, plain_ms=plain_ms)
    del packed, scale
    return {k: {"err": max(v["errs"]), "ms": v["ms"],
                "plain_ms": v["plain_ms"]} for k, v in rows.items()}


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
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.ops import self_attn_step as K6
    from misinfo_tpu_torch.ops.quant import quantize_dense
    from misinfo_tpu_torch.vault import int4 as K10
    from misinfo_tpu_torch.vault import int4_checks as IC

    card = card_line()
    print(card, flush=True)                                   # phase 1
    build_all((K1, K6, K7, K10))                              # phase 2
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
    decode_rows = check_decode_kernels(K6, K7)                # phase 5
    if args.profile:
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        open(args.profile, "w").close()
        append_profile(args.profile, "full b32/S512 analyze_batch",
                       lambda: engine.analyze_batch(b32), rows=40)

    decode_launches = transcript_phases(engine, image, card,  # phases 6-8
                                        args.profile)
    del engine
    int4_rows = check_int4_kernels(K10, IC, card)             # phase 9
    int4_launches = vault_phases(card, vault_path,            # phases 10-14
                                 args.profile)

    rob = kernel_rows["roberta"]
    kernels = [{
        "name": "int8_ffn", "route": "cuda",
        "source": "misinfo_tpu_torch/csrc/int8_ffn.cu",
        "replaces": "misinfo_tpu/ops/pallas_int8.py:237",
        "launches": main_launches,
        "max_abs_err": max(r["err"] for r in kernel_rows.values()),
        "ms": rob["ms"], "plain_ms": rob["plain_ms"]}]
    replaces = {"self_attn_step": "misinfo_tpu/ops/pallas_decode.py:52",
                "self_attn_step_i8": "misinfo_tpu/ops/pallas_decode.py:148",
                "cross_ffn_step": "misinfo_tpu/ops/pallas_cross_ffn.py:125",
                "cross_ffn_step_i8": "misinfo_tpu/ops/pallas_cross_ffn.py:250"}
    for name, where in replaces.items():
        row = decode_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("misinfo_tpu_torch/csrc/"
                       f"{name.removesuffix('_i8')}.cu"),
            "replaces": where, "launches": decode_launches[name],
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"]})
    for name, line in (("int4_sims", 123), ("int4_sims_i8", 177)):
        row = int4_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "misinfo_tpu_torch/csrc/int4_sims.cu",
            "replaces": f"misinfo_tpu/vault/int4.py:{line}",
            "launches": int4_launches[name], "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
