"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the three kernel sources in parallel, one nvcc each
     (misinfo_tpu_torch/csrc/{int8_ffn,self_attn_step,cross_ffn_step}.cu);
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
     transcribe() wall time (printed only).
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
            from torch.profiler import ProfilerActivity, profile as prof_
            with prof_(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                tr._decode(enc, prompt)
                torch.cuda.synchronize()
            with open(profile, "a") as f:
                f.write("\n\n# one greedy transcript decode (B = 1, "
                        "whisper-base, quant=kernels)\n")
                f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                                  row_limit=30))
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

    card = card_line()
    print(card, flush=True)                                   # phase 1
    build_all((K1, K6, K7))                                   # phase 2
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
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.analyze_batch(b32)
            torch.cuda.synchronize()
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        with open(args.profile, "w") as f:
            f.write("# full b32/S512 analyze_batch\n")
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40))

    decode_launches = transcript_phases(engine, image, card,  # phases 6-8
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
