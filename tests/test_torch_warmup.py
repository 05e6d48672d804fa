"""``warmup()`` of the port's engine and transcriber, held to the JAX
package's, and the blocking host-to-card copies taken out of the programs.

- The signature grid: the port's ``warmup()`` returns the JAX engine's
  list, element for element and in order, for every ``pack_text`` mode
  with and without ``full_grid``, with and without video buckets, under
  ``device_resize`` with two staging buckets, with ``parallel=4`` and for
  a vault without title embeddings. The JAX engine instance's programs
  are replaced by stand-ins (nothing compiles), the port's runners by
  stand-ins (nothing runs): the lists are the engines' own bookkeeping.
- Frozen grid: after a full-grid (or the default) warmup, the request
  mixes of tests/test_warmup_grid.py mint no new runner, and their
  reports equal an unwarmed port engine's exactly and JAX's within the
  f32 bar of tests/test_torch_engine.py (1e-4).
- Two batches in flight (``analyze_stream``, and ``analyze_batch_async``
  finalized after a second dispatch of the same signature) give
  ``analyze_batch``'s reports; ``reload_vault`` keeps the warmed runners
  and answers as a fresh engine on the new vault.
- The replaced expressions (attention's score scale, the normalisation
  constants, ``topk_first``'s masked write) are ``torch.equal`` to the
  old ones, kept here.
- The transcriber: ``warmup(buckets)`` returns JAX's list (``[]`` when
  degraded), and ``transcribe()`` gives the same text after warmup.
On the CPU a runner runs the eager program over its input buffers; the
card's graphs are held to eager in tests/test_torch_cuda.py.
"""

import dataclasses
import itertools
import threading
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.core import config as j_config
from misinfo_tpu.engine.forensics import MisinfoForensics as JEngine
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.serve import transcript as j_tr
from misinfo_tpu.vault.store import TruthVault

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.models import whisper as tw
from misinfo_tpu_torch.models.detector import (
    DetectorConfig as TDetectorConfig, detector_init)
from misinfo_tpu_torch.ops import attention as t_attention
from misinfo_tpu_torch.ops import image_ops
from misinfo_tpu_torch.ops.common import Policy
from misinfo_tpu_torch.preprocess.image import (
    CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD)
from misinfo_tpu_torch.serve import transcript as t_tr
from misinfo_tpu_torch.vault import search as t_search

DET = TDetectorConfig.tiny()
SCORES = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
          "vault_discrepancy", "text_similarity", "fake_probability",
          "real_probability", "confidence")


def _vault(path, rows=6, titles=True, seed=5):
    rng = np.random.default_rng(seed)
    d = DET.clip.projection_dim
    TruthVault(rng.normal(size=(rows, d)).astype(np.float32),
               [{"title": f"article {i}", "url": f"u{i}", "date": "2024"}
                for i in range(rows)],
               rng.normal(size=(rows, d)).astype(np.float32) if titles
               else None).save(str(path))
    return str(path)


def _cfg(mod, vault_path, **serving):
    return mod.ForensicsConfig(
        verbose=False, precision=mod.PrecisionConfig.highest(),
        paths=mod.ModelPaths(vault_path=vault_path),
        seq=mod.SequenceConfig(roberta_max_len=64, image_size=64),
        serving=dataclasses.replace(
            mod.ServingConfig(batch_buckets=(1, 4, 8),
                              video_batch_buckets=(1, 2)), **serving))


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(lambda t: t.numpy(), detector_init(0, DET))


def _port(tree, vault_path, **serving):
    return t_forensics.MisinfoForensics(
        config=_cfg(t_config, vault_path, **serving), det_cfg=DET,
        params=params_from_jax(tree), device="cpu")


class _StubRunner:
    def start(self, inputs):
        return None


@pytest.fixture(scope="module")
def grid_engines(tree, tmp_path_factory):
    """A JAX engine whose programs compile nothing and a port engine whose
    runners run nothing: the warmup bookkeeping alone."""
    vp = _vault(tmp_path_factory.mktemp("grid") / "v.npz")
    j = JEngine(config=_cfg(j_config, vp), det_cfg=JDetectorConfig.tiny(),
                params=tree)
    j.programs.warm = lambda variant, params, batch: jnp.zeros(1)
    j._pack_out = lambda out: out
    j._clip_text_jit = lambda *a: jnp.zeros(1)
    t = _port(tree, vp)
    t._new_runner = lambda sig, inputs, vault=None: _StubRunner()
    return j, t


def _both(engines, kw, serving, titles=True):
    out = []
    for eng, mod in zip(engines, (j_config, t_config)):
        eng.cfg = eng.cfg.replace(serving=dataclasses.replace(
            _cfg(mod, "").serving, **serving))
        vault = eng.vault
        if not titles:   # warmup reads only the titles' presence
            eng.vault = types.SimpleNamespace(text_embeddings=None)
        try:
            out.append(eng.warmup(**kw))
        finally:
            eng.vault = vault
        if hasattr(eng, "_runners"):
            eng._runners.clear()
            eng._warmed.clear()
    return out


@pytest.mark.parametrize("pack_text,full_grid", list(itertools.product(
    ["auto", True, False], [False, True])))
def test_grid_equals_jax(grid_engines, pack_text, full_grid):
    want, got = _both(grid_engines, dict(full_grid=full_grid, videos=()),
                      dict(pack_text=pack_text))
    assert want and got == want


@pytest.mark.parametrize("kw,serving,titles", [
    (dict(videos=(1, 2)), {}, True),
    (dict(full_grid=True), {}, True),
    (dict(videos=(1, 2)), dict(device_resize=True,
                               image_staging_buckets=(96, 160)), True),
    (dict(full_grid=True, videos=(), parallel=4), {}, True),
    (dict(full_grid=True, videos=()), dict(pack_text=False), False),
    (dict(batch_sizes=(3, 4), text_buckets=(64,), packed=True,
          variants=("text_only",), videos=()), {}, True),
], ids=["videos", "full_grid_videos", "device_resize", "parallel",
        "no_titles", "explicit"])
def test_grid_equals_jax_per_option(grid_engines, kw, serving, titles):
    want, got = _both(grid_engines, kw, serving, titles)
    assert got == want
    if not titles:
        assert got[-1] == ("caption_title_sim", 2, 32, 0)
    if "parallel" in kw:
        serial, _ = _both(grid_engines, dict(kw, parallel=0), serving)
        assert got == serial


def test_unknown_variants_raise_jax_error(grid_engines):
    msgs = []
    for eng in grid_engines:
        with pytest.raises(ValueError) as e:
            eng.warmup(variants=("full", "video"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="parallel"):
        grid_engines[1].warmup(parallel=-1)


# ------------------------------------------------------------ real runs

def _img(seed):
    return np.random.default_rng(seed).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)


def _traffic():
    """tests/test_warmup_grid.py's request mixes: counts that round to a
    bucket, ragged lengths, an oversize burst, every variant."""
    short = "a short claim"
    mid = "a medium length claim about some breaking news event today"
    long = "many words " * 25
    return [
        [{"text": short}],
        [{"text": long}, {"text": short}, {"text": mid}],
        [{"text": short} for _ in range(5)],
        [{"text": mid} for _ in range(9)] + [{"text": short}],
        [{"image": _img(1)}, {"image": _img(2)}, {"image": _img(3)}],
        [{"text": short, "image": _img(4)}, {"text": long, "image": _img(5)}],
        [{"text": short}, {"image": _img(6)},
         {"text": mid, "image": _img(7)}, {"text": long},
         {"text": short, "image": _img(8)}],
    ]


def _same(a, b):
    for ra, rb in zip(a, b):
        assert ra["scores"] == rb["scores"]
        assert ra["vault_matches"] == rb["vault_matches"]
        assert ra["verdict"] == rb["verdict"]


def _close(a, b, tol=1e-4):
    for ra, rb in zip(a, b):
        for k in SCORES:
            assert abs(ra["scores"][k] - rb["scores"][k]) <= tol, k
        assert ([m["title"] for m in ra["vault_matches"]]
                == [m["title"] for m in rb["vault_matches"]])


@pytest.fixture(scope="module")
def vault_path(tmp_path_factory):
    return _vault(tmp_path_factory.mktemp("real") / "v.npz")


class _ShapedRunner:
    """A runner that runs nothing: zeros of its program's output shape."""

    def __init__(self, sig, eng):
        n = 2 if sig[0] == "caption_title_sim" else sig[1]
        width = (eng.det_cfg.clip.projection_dim if n == 2 and sig[1] == 2
                 and sig[0] == "caption_title_sim"
                 else 10 + 2 * eng.cfg.seq.vault_top_k)
        self.out = torch.zeros(n, width)

    def start(self, inputs):
        return self.out

    __call__ = start


def _frozen(tree, vault_path, **serving):
    eng = _port(tree, vault_path, **serving)
    eng._new_runner = lambda sig, inputs, vault=None: _ShapedRunner(sig, eng)
    return eng


@pytest.mark.parametrize("pack_text", ["auto", True, False])
def test_full_grid_warmup_freezes_the_runners(tree, vault_path, pack_text):
    """No request mix mints a runner after a full-grid warmup (the
    runners are stand-ins here; the real ones run in the next tests)."""
    eng = _frozen(tree, vault_path, pack_text=pack_text)
    sigs = eng.warmup(full_grid=True, videos=())
    assert list(eng._runners) == sigs and list(eng._warmed) == sigs
    for reqs in _traffic():
        assert len(eng.analyze_batch(reqs)) == len(reqs)
        assert list(eng._runners) == sigs, reqs


def test_default_warmup_covers_endpoint_shapes(tree, vault_path):
    eng = _frozen(tree, vault_path, pack_text=False)
    n0 = len(eng.warmup(videos=()))
    eng.analyze_batch([{"text": "one short request"}])
    eng.analyze_batch([{"text": f"req {i}"} for i in range(8)])
    assert len(eng._runners) == n0


def test_warmed_reports_equal_unwarmed_and_jax(tree, vault_path):
    """After a full-grid warmup, every mix's reports equal an unwarmed
    engine's exactly and JAX's within the f32 bar, with no new runner."""
    eng = _port(tree, vault_path)
    cold = _port(tree, vault_path)
    j = JEngine(config=_cfg(j_config, vault_path),
                det_cfg=JDetectorConfig.tiny(), params=tree)
    sigs = eng.warmup(full_grid=True, videos=())
    for reqs in _traffic():
        out = eng.analyze_batch(reqs)
        assert list(eng._runners) == sigs
        _same(out, cold.analyze_batch(reqs))
        _close(j.analyze_batch(reqs), out)


def test_batches_in_flight_keep_their_outputs(tree, vault_path):
    eng = _port(tree, vault_path)
    eng.warmup(batch_sizes=(4,), videos=())
    texts = [f"claim number {i} about the flood" for i in range(8)]
    reqs = [{"text": t} for t in texts]
    want = eng.analyze_batch(reqs)
    _same(list(eng.analyze_stream(reqs, batch_size=4)), want)
    first = eng.analyze_batch_async(reqs[:4])
    second = eng.analyze_batch_async(reqs[4:])   # same signature
    _same(first() + second(), want)


def test_reload_vault_keeps_the_warmed_runners(tree, vault_path,
                                               tmp_path):
    eng = _port(tree, vault_path)
    sigs = eng.warmup(batch_sizes=(4,), videos=())
    reqs = [{"text": "caption", "image": _img(9)}, {"image": _img(10)},
            {"image": _img(11)}, {"text": "x"}]
    before = eng.analyze_batch(reqs)     # b1 groups: first-use runners
    assert len(eng._runners) > len(sigs)
    new = _vault(tmp_path / "v2.npz", rows=9, seed=8)
    eng.reload_vault(new)
    assert list(eng._runners) == sigs
    _same(eng.analyze_batch(reqs), _port(tree, new).analyze_batch(reqs))
    eng.reload_vault(vault_path, drop_first=True)
    assert list(eng._runners) == sigs
    _same(eng.analyze_batch(reqs), before)


class _NoticedLock:
    """The engine's runner lock, noting when the thread named ``who``
    starts to wait on it."""

    def __init__(self, lock, who):
        self.lock, self.who, self.waiting = lock, who, threading.Event()

    def __enter__(self):
        if threading.current_thread().name == self.who:
            self.waiting.set()
        return self.lock.__enter__()

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)


def test_dispatch_waiting_on_reload_uses_the_new_runners(tree, vault_path,
                                                         tmp_path):
    """A dispatch that waits on the runners' lock while reload_vault
    re-captures runs on the runners that the reload publishes: it
    answers as a fresh engine on the new vault, replays the warmed
    signature's new runner, and puts the runner it mints for a signature
    not warmed where later requests find it."""
    eng = _port(tree, vault_path, pack_text=False)
    sigs = eng.warmup(batch_sizes=(4,), videos=())
    reqs = [{"text": f"claim {i} about the flood", "image": _img(20 + i)}
            for i in range(4)] + [{"image": _img(30)}]
    extra = ("visual_only", 1, 0, 0)
    assert ("full", 4, 64, 0) in sigs and extra not in sigs
    old = eng.analyze_batch(reqs)
    new = _vault(tmp_path / "v2.npz", rows=9, seed=8)
    lock = eng._runner_lock = _NoticedLock(eng._runner_lock, "dispatch")
    recapturing, release = threading.Event(), threading.Event()
    made, real = [], eng._new_runner

    def new_runner(sig, inputs, vault=None):
        made.append(sig)
        if vault is not None and not recapturing.is_set():
            recapturing.set()       # reload holds the lock from here
            assert release.wait(60)
        return real(sig, inputs, vault)
    eng._new_runner = new_runner
    reload = threading.Thread(target=eng.reload_vault, args=(new,))
    reload.start()
    try:
        assert recapturing.wait(60)
        out = {}
        dispatch = threading.Thread(
            target=lambda: out.setdefault("r", eng.analyze_batch(reqs)),
            name="dispatch")
        dispatch.start()
        assert lock.waiting.wait(60)
    finally:
        release.set()
        reload.join()
    dispatch.join()
    assert list(eng._runners) == made == sigs + [extra]
    want = _port(tree, new, pack_text=False).analyze_batch(reqs)
    assert [r["vault_matches"] for r in want] != [r["vault_matches"]
                                                  for r in old]
    _same(out["r"], want)


def test_runners_share_their_input_buffers(tree, vault_path):
    """One buffer per (name, shape, dtype) across the engine's runners."""
    eng = _port(tree, vault_path)
    eng.warmup(batch_sizes=(4,), videos=())
    seen, n = {}, 0
    for runner in eng._runners.values():
        for k, t in runner.static.items():
            assert seen.setdefault((k, tuple(t.shape), t.dtype), t) is t
            n += 1
    assert len(seen) == len(eng._buffers) < n


# ------------------------------------------------------------------- F9

def _mha_old(params, x, num_heads, mask=None, policy=Policy(),
             segment_ids=None):
    """ops/attention.py's einsum path as it was, with its device scalar."""
    B, S, D = x.shape
    hd = D // num_heads
    from misinfo_tpu_torch.ops.common import dense
    q = dense(params["q"], x, policy).reshape(B, S, num_heads, hd)
    k = dense(params["k"], x, policy).reshape(B, S, num_heads, hd)
    v = dense(params["v"], x, policy).reshape(B, S, num_heads, hd)
    sdt = policy.score
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=x.device))
    scores = torch.einsum("bshd,bthd->bhst", q.to(sdt), k.to(sdt))
    scores = scores * scale.to(sdt)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        allowed = same & (segment_ids[:, None, :] > 0)
        scores = scores + t_attention._additive(allowed[:, None].float(), sdt)
    elif mask is not None:
        scores = scores + t_attention._additive(
            mask[:, None, None, :].float(), sdt)
    probs = torch.softmax(scores.float(), dim=-1).to(policy.compute)
    ctx = torch.einsum("bhst,bthd->bshd", probs, v)
    return dense(params["o"], ctx.reshape(B, S, D), policy)


@pytest.mark.parametrize("precision,case,hd", list(itertools.product(
    ["float32", "bfloat16"], ["mask", "packed"], [16, 48, 64, 80])))
def test_attention_scale_is_the_old_expression(precision, case, hd):
    policy = Policy(t_config.PrecisionConfig.highest()
                    if precision == "float32"
                    else t_config.PrecisionConfig())
    H, D = 4, 4 * hd
    gen = torch.Generator().manual_seed(hd)
    params = t_attention.attention_init(gen, D, H)
    x = torch.randn(2, 24, D, generator=gen).to(policy.compute)
    kw = ({"mask": (torch.arange(24)[None, :] < torch.tensor([[20], [24]])
                    ).int()} if case == "mask"
          else {"segment_ids": torch.tensor([[1] * 10 + [2] * 10 + [0] * 4,
                                             [1] * 24])})
    got = t_attention.multi_head_attention(params, x, H, policy=policy, **kw)
    want = _mha_old(params, x, H, policy=policy, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stats,dtype", list(itertools.product(
    ["imagenet", "clip"], [torch.float32, torch.bfloat16])))
def test_normalize_images_is_the_old_expression(stats, dtype):
    mean, std = {"imagenet": (IMAGENET_MEAN, IMAGENET_STD),
                 "clip": (CLIP_MEAN, CLIP_STD)}[stats]
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, 16, 16, 3), dtype=np.uint8))
    m = torch.tensor(mean, dtype=torch.float32) * 255.0
    inv = 1.0 / (torch.tensor(std, dtype=torch.float32) * 255.0)
    want = ((u8.float() - m) * inv).to(dtype)
    assert torch.equal(image_ops.normalize_images(u8, stats, dtype), want)


def _topk_old(sims, k):
    cur = sims.clone()
    rows = torch.arange(sims.shape[0])
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=1)
        vals.append(cur[rows, i])
        idxs.append(i.to(torch.int32))
        cur[rows, i] = float("-inf")
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


@pytest.mark.parametrize("k", [1, 5, 12])
def test_topk_first_is_the_old_expression(k):
    rng = np.random.default_rng(k)
    sims = torch.from_numpy(rng.integers(-3, 4, (6, 40)).astype(np.float32)
                            / 4)                     # many ties
    sims[:, 30:] = -2.0
    got, want = t_search.topk_first(sims, k), _topk_old(sims, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32


def test_detect_language_takes_the_ids_as_a_tensor():
    cfg = tw.WhisperConfig(vocab_size=1864, d_model=64, encoder_layers=1,
                           decoder_layers=1, num_heads=2, ffn_dim=128,
                           max_source_positions=8, max_target_positions=8,
                           eos_token_id=256, decoder_start_token_id=257)
    params = tw.whisper_init(3, cfg)
    enc = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(2))
    ids = [259, 260, 300, 301]
    a = tw.detect_language(params, enc, 257, ids, cfg)
    b = tw.detect_language(params, enc, 257, torch.tensor(ids), cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ----------------------------------------------------------- transcriber

def test_transcriber_warmup_list_equals_jax(monkeypatch):
    monkeypatch.setenv("MISINFO_TPU_TRANSCRIPT_ISOLATION", "0")
    degraded = (j_tr.WhisperTranscriber(None, size="tiny"),
                t_tr.WhisperTranscriber(size="tiny", device="cpu"))
    assert [t.warmup((1, 2)) for t in degraded] == [[], []]
    tj = j_tr.WhisperTranscriber(None, size="tiny")
    tj.has_weights = True
    z = jnp.zeros(1)
    tj._programs = lambda: (lambda p, m: z, lambda p, e, pr: z,
                            lambda p, e, pr, t, r: z, None)
    tt = t_tr.WhisperTranscriber(size="tiny", device="cpu")
    tt.has_weights = True
    calls = []
    tt._encode = lambda mels: calls.append(("encode", mels.shape[0])) or mels
    tt._decode = lambda enc, prompt, t=0.0, seed=None: calls.append(
        ("decode", prompt.shape, t))
    tt._detect_language = lambda mels: calls.append(("detect", mels.shape))
    assert tt.warmup((1, 2)) == tj.warmup((1, 2)) == [1, 2]
    assert [c[0] for c in calls] == ["encode", "decode", "decode"] * 2 + [
        "detect"]
    assert calls[2][2] == 1.0 and calls[-1][1][0] == 1


def test_warmup_transcriber_degrades_without_a_card():
    t_tr.reset_transcriber()
    try:
        assert t_tr.warmup_transcriber() == []
    finally:
        t_tr.reset_transcriber()


def _wav(path, seconds=2.0, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.2 * np.sin(2 * np.pi * 950 * t)).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())
    return str(path)


@pytest.mark.parametrize("pallas,temps,seed", [("off", (0.0,), 1),
                                               ("on", (0.0, 0.5), 5)])
def test_transcribe_after_warmup_gives_the_same_text(tmp_path, pallas,
                                                     temps, seed):
    """A random-weight tiny Whisper (the port's init, as a JAX-layout
    tree) transcribes a WAV, the silence rule off; warmed and unwarmed
    give the same non-empty text, the warmed one through the runners it
    made (no new one)."""
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    sp = ByteWhisperTokenizer().specials
    cfg = tw.WhisperConfig(vocab_size=sp.vocab_size, d_model=64,
                           encoder_layers=1, decoder_layers=2, num_heads=2,
                           ffn_dim=128, max_source_positions=100,
                           max_target_positions=14, eos_token_id=sp.eot,
                           decoder_start_token_id=sp.sot)
    # seeds whose random weights spell some text in each mode
    tree = jax.tree.map(lambda t: t.numpy(), tw.whisper_init(seed, cfg))
    dc = dataclasses.replace(t_config.WhisperDecodeConfig(), pallas=pallas,
                             fallback_temperatures=temps, best_of=2,
                             logprob_threshold=0.0, no_speech_threshold=1.0)
    wav = _wav(tmp_path / "a.wav")
    texts = []
    for warm in (False, True):
        tr = t_tr.WhisperTranscriber(tree, config=cfg, device="cpu",
                                     decode_cfg=dc)
        if warm:
            assert tr.warmup((1,)) == [1]
            n0 = len(tr._runners)
        texts.append(tr.transcribe(wav))
        if warm:
            assert len(tr._runners) == n0
    assert texts[0] == texts[1] and texts[0]
    assert not texts[0].startswith("[transcript")


# ------------------------------------------------------- runner plumbing

class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: records the calls."""
    calls = []

    def register_generator_state(self, gen):
        self.calls.append("generator")

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append(("begin", capture_error_mode))

    def capture_end(self):
        self.calls.append("end")


def test_capture_counts_per_replay_and_restores_counters(monkeypatch):
    """A capture launches nothing: the counters' change during it is
    undone and kept as the graph's per-replay delta; a failure names the
    signature."""
    import gc
    from misinfo_tpu_torch.ops import graphs
    from misinfo_tpu_torch.ops import int8_ffn as K1
    from misinfo_tpu_torch.vault import int4 as K10
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(K1, "launches", 5)
    monkeypatch.setattr(K10, "launches_i8", 1)
    _FakeGraph.calls = []

    def program():
        assert not gc.isenabled()
        K1.launches += 36
        K10.launches_i8 += 3
        return "out"
    g, out, delta = graphs.capture(program, ("full", 32, 512, 0),
                                   generators=[None])
    assert out == "out" and (K1.launches, K10.launches_i8) == (5, 1)
    assert delta == {"int8_ffn.launches": 36, "int4.launches_i8": 3}
    assert _FakeGraph.calls == ["generator", ("begin", "thread_local"),
                                "end"]
    graphs.add_counts(delta)
    assert (K1.launches, K10.launches_i8) == (41, 4)
    assert gc.isenabled()

    def broken():
        K1.launches += 1
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match=r"\('video', 16, 64, 0\).*boom"):
        graphs.capture(broken, ("video", 16, 64, 0))
    assert K1.launches == 41 and gc.isenabled()


def test_per_stream_scratch_refuses_to_grow_under_capture(monkeypatch):
    from misinfo_tpu_torch.ops import cuda_build
    dev = torch.device("cpu")
    monkeypatch.setattr(cuda_build, "_PER_STREAM", {})
    monkeypatch.setattr(cuda_build, "_CAPTURED", set())
    monkeypatch.setattr(cuda_build, "_RETIRED", [])
    capturing = [False]     # the card's capture state, stood in for
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    small = cuda_build.workspace(64, dev, 7)
    capturing[0] = True
    assert cuda_build.workspace(32, dev, 7) is small
    with pytest.raises(RuntimeError, match="capture"):
        cuda_build.workspace(128, dev, 7)
    with pytest.raises(RuntimeError, match="capture"):
        cuda_build.tickets(4, dev, 7)         # never sized on this stream
    capturing[0] = False
    big = cuda_build.workspace(128, dev, 7)
    assert big is not small and cuda_build._RETIRED == [small]
    assert cuda_build.workspace(16, dev, 8) is not big   # another stream


def test_runner_checks_its_inputs_and_copies_them_in():
    from misinfo_tpu_torch.ops.graphs import Runner
    seen = []

    def program(b):
        seen.append(b["x"])
        return b["x"] * 2
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    r = Runner(("sig",), program, {"x": x}, device="cpu")
    assert torch.equal(r.start({"x": x}), x * 2)
    y = x + 10
    assert torch.equal(r({"x": y}), y * 2)
    assert seen[0] is seen[1] is r.static["x"]     # one buffer
    with pytest.raises(ValueError, match="int64"):
        r({"x": y.long()})
    with pytest.raises(ValueError, match="inputs"):
        r({"y": y})


def test_runners_with_shared_buffers_copy_their_own_inputs_in():
    from misinfo_tpu_torch.ops.graphs import Runner
    buffers = {}
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    a = Runner(("a",), lambda b: b["x"] + 1, {"x": x}, device="cpu",
               buffers=buffers)
    b = Runner(("b",), lambda b: b["x"] * 3, {"x": x}, device="cpu",
               buffers=buffers)
    c = Runner(("c",), lambda b: b["x"] - 1, {"x": x.long()}, device="cpu",
               buffers=buffers)
    assert a.static["x"] is b.static["x"] is not c.static["x"]
    assert len(buffers) == 2
    assert torch.equal(a.start({"x": x}), x + 1)
    assert torch.equal(b.start({"x": x + 5}), (x + 5) * 3)
    assert torch.equal(a({"x": x}), x + 1)
