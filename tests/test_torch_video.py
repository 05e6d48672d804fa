"""The port's video path held to the JAX package at DetectorConfig.tiny()
in f32 parity mode on the CPU.

* The frame samplers (preprocess/video.py) give JAX's frames, masks and
  errors on a cv2-written mp4 (skipped without cv2 or an mp4 encoder).
* ``video_program`` against JAX's jitted one on the same batch: V = 3
  videos padded to 4, F = 4 frames, with a full, a ragged, a repeated-frame
  and an all-invalid mask, and the legacy ``[F]`` mask; with and without
  text. Two request frames are planted in the vault, so the max vault
  discrepancy picks a frame other than the first, and tied frames pick
  the first. Scores within 1e-4, verdict and ``vault_top_idx`` exact.
* The engines: a mixed ``analyze_batch`` of ``video``, ``video_text``,
  ``full`` and ``visual_only`` requests on mp4 clips, with host resize and
  with ``device_resize``, and one ``analyze(video_path=...)`` with its
  printed report: within 1e-4 of the JAX engine, verdicts and matches
  equal.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.core import config as j_config
from misinfo_tpu.engine import signals as j_signals
from misinfo_tpu.engine.forensics import MisinfoForensics as JEngine
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.preprocess import image as j_image
from misinfo_tpu.preprocess import video as j_video
from misinfo_tpu.vault.store import TruthVault

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.engine import signals as t_signals
from misinfo_tpu_torch.models.clip import clip_image_features
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy as TPolicy, l2_normalize
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.preprocess import video as t_video
from misinfo_tpu_torch.preprocess.tokenizer import (
    load_clip_tokenizer, load_roberta_tokenizer)

DET = DetectorConfig.tiny()
SIZE = 64
F = 4
SCORES = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
          "vault_discrepancy", "text_similarity", "fake_probability",
          "real_probability", "confidence")
FLOATS = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
          "vault_discrepancy", "text_similarity", "confidence",
          "fake_probability", "real_probability", "vault_top_sims")


def _cfg(mod, vault_path, **serving):
    return mod.ForensicsConfig(
        verbose=False, precision=mod.PrecisionConfig.highest(),
        paths=mod.ModelPaths(vault_path=vault_path),
        seq=mod.SequenceConfig(roberta_max_len=32, image_size=SIZE),
        serving=dataclasses.replace(mod.ServingConfig(), **serving),
        video=mod.VideoConfig(max_frames=F))


@pytest.fixture(scope="module")
def tree():
    """Seeded weights with the vision tower's class and position
    embeddings zeroed, so that random-weight image embeddings differ and
    a planted frame is the only one past the 0.85 gate."""
    t = jax.tree.map(lambda a: a.numpy(), detector_init(0, DET))
    for k in ("class_embedding", "position_embedding"):
        t["clip"]["vision"][k] = np.zeros_like(t["clip"]["vision"][k])
    return t


def _embed(params, clip_u8: np.ndarray) -> np.ndarray:
    """The port's l2-normalized CLIP image embeddings of uint8 frames, as
    the visual branch computes them in f32."""
    policy = TPolicy(t_config.PrecisionConfig.highest())
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(clip_u8), "clip", torch.float32)
        return l2_normalize(clip_image_features(
            params["clip"], x, DET.clip, policy)).numpy()


def _vault(planted, n=12, seed=5):
    """A vault of n random rows with rows {index: embedding} planted."""
    rng = np.random.default_rng(seed)
    d = DET.clip.projection_dim
    emb = rng.normal(size=(n, d)).astype(np.float32)
    for i, e in planted.items():
        emb[i] = e + 1e-3 * rng.normal(size=d)
    return TruthVault(emb, [{"title": f"article {i}", "url": f"u{i}",
                             "date": "2024"} for i in range(n)],
                      rng.normal(size=(n, d)).astype(np.float32))


# ------------------------------------------------------------- the program

@pytest.fixture(scope="module")
def program_inputs(tree):
    """Host-resized frames of V = 3 videos padded to 4 (uint8, both
    flavors), their masks, tokens and a vault with frames 2 and 5
    planted."""
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
              for _ in range(7)]
    eff = {i: j_image.image_to_array(f, "effnet", SIZE)
           for i, f in enumerate(frames)}
    clp = {i: j_image.image_to_array(f, "clip", SIZE)
           for i, f in enumerate(frames)}
    # video 0: all valid, frame 2 twice (a tie: the first wins); video 1:
    # ragged; video 2: frame 5 first and again; video 3: the pad video
    layout = [[0, 1, 2, 2], [3, 4, None, None], [5, 5, 6, None],
              [None] * F]
    zero = np.zeros((SIZE, SIZE, 3), np.uint8)
    image_effnet = np.stack([zero if i is None else eff[i]
                             for v in layout for i in v])
    image_clip = np.stack([zero if i is None else clp[i]
                           for v in layout for i in v])
    valid = np.array([[i is not None for i in v] for v in layout])
    tparams = params_from_jax(tree)
    emb = _embed(tparams, np.stack([clp[2], clp[5]]))
    vault = _vault({3: emb[0], 9: emb[1]})
    texts = ["a caption of the first clip", "second", "a third caption",
             ""]
    rb = load_roberta_tokenizer(None, DET.roberta.vocab_size).batch(texts, 32)
    cl = load_clip_tokenizer(None, DET.clip.vocab_size).batch(
        texts, min(77, DET.clip.max_text_len))
    batch = {"image_effnet": image_effnet, "image_clip": image_clip,
             "frame_valid": valid, "roberta_ids": rb[0],
             "roberta_mask": rb[1], "clip_ids": cl[0], "clip_mask": cl[1],
             "vault_emb": vault.embeddings, "vault_valid": vault.row_valid,
             "vault_text_emb": vault.text_embeddings}
    return tree, tparams, batch


def _programs(tree, tparams, batch, has_text):
    """JAX's jitted video_program and the port's on the same batch →
    (JAX output, port output) as numpy SignalOutputs."""
    jcfg, tcfg = _cfg(j_config, ""), _cfg(t_config, "")
    if not has_text:
        batch = {k: v for k, v in batch.items()
                 if not k.startswith(("roberta", "clip_"))}
    want = jax.jit(functools.partial(
        j_signals.video_program, has_text=has_text,
        det_cfg=JDetectorConfig.tiny(), cfg=jcfg,
        policy=JPolicy(j_config.PrecisionConfig.highest())))(
            tree, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got = t_signals.video_program(
            tparams, {k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items()},
            has_text=has_text, det_cfg=DET, cfg=tcfg,
            policy=TPolicy(t_config.PrecisionConfig.highest()))
    return (want._replace(**{k: np.asarray(v)
                             for k, v in want._asdict().items()}),
            got._replace(**{k: v.numpy() for k, v in got._asdict().items()}))


def _assert_outputs(want, got):
    for k in FLOATS:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got.verdict, want.verdict)
    np.testing.assert_array_equal(got.vault_top_idx, want.vault_top_idx)


@pytest.mark.parametrize("has_text", [False, True])
def test_video_program_matches_jax(program_inputs, has_text):
    tree, tparams, batch = program_inputs
    want, got = _programs(tree, tparams, batch, has_text)
    assert got.verdict.shape == (4,)
    _assert_outputs(want, got)
    # the planted frames win: video 0 at its first frame 2 (row 3), video
    # 2 at frame 5 (row 9); the pad video reports its first frame's
    # matches with the gate shut
    assert got.vault_top_idx[0, 0] == 3 and got.vault_top_idx[2, 0] == 9
    assert got.vault_discrepancy[0] > 0.85 and got.vault_discrepancy[2] > 0.85
    assert got.vault_discrepancy[3] == 0.0 and got.deepfake_score[3] == 0.0
    if not has_text:
        np.testing.assert_array_equal(got.ai_score, 0.0)
        np.testing.assert_allclose(
            got.fake_probability,
            np.clip(np.maximum(got.deepfake_score, got.vault_discrepancy),
                    0, 1), atol=1e-7)


def test_video_program_legacy_frame_mask_matches_jax(program_inputs):
    """One video with an ``[F]`` mask (the legacy shape): frames 3, 4 and
    two invalid ones; text rows and caption embeddings cut to [:1]."""
    tree, tparams, batch = program_inputs
    one = dict(batch)
    one["image_effnet"] = batch["image_effnet"][F:2 * F]
    one["image_clip"] = batch["image_clip"][F:2 * F]
    one["frame_valid"] = batch["frame_valid"][1]
    want, got = _programs(tree, tparams, one, True)
    assert got.verdict.shape == (1,)
    _assert_outputs(want, got)


# -------------------------------------------------------------- the clips

def _write_mp4(path, seed, frames, w=96, h=64, fps=10.0):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        pytest.skip("no mp4 encoder available")
    rng = np.random.default_rng(seed)
    for i in range(frames):
        frame = np.full((h, w, 3), (i * 6) % 255, np.uint8)
        frame[:, : w // 2] = rng.integers(0, 255, (h, w // 2, 3))
        writer.write(frame)
    writer.release()
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clips")
    return (_write_mp4(str(tmp / "a.mp4"), 0, 40),     # 4 s: 4 frames
            _write_mp4(str(tmp / "b.mp4"), 7, 25))     # 2.5 s: 3 frames


def test_frame_samplers_match_jax(clips, tmp_path):
    for path in clips:
        for mf, stride in ((F, 1.0), (12, 0.5), (2, 0.05)):
            (tf, tv), (jf, jv) = (
                m.sample_video_frames(path, mf, stride)
                for m in (t_video, j_video))
            np.testing.assert_array_equal(tv, jv)
            assert len(tf) == len(jf) == int(tv.sum())
            for a, b in zip(tf, jf):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(t_video.equidistant_frames(path, 3),
                        j_video.equidistant_frames(path, 3)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    missing = str(tmp_path / "missing.mp4")
    for m in (t_video, j_video):
        with pytest.raises(RuntimeError, match="Could not open video"):
            m.sample_video_frames(missing)
        assert m.equidistant_frames(missing) is None


@pytest.fixture(scope="module")
def vault_path(tree, clips, tmp_path_factory):
    """A vault with the third frame of clip a planted (the port's
    embedding of its host-resized CLIP flavor)."""
    frames, _ = t_video.sample_video_frames(clips[0], F)
    emb = _embed(params_from_jax(tree),
                 j_image.image_to_array(frames[2], "clip", SIZE)[None])
    path = str(tmp_path_factory.mktemp("vault") / "vault.npz")
    _vault({4: emb[0]}).save(path)
    return path


_ENGINES = {}


def _engines(tree, vault_path, device_resize):
    if device_resize not in _ENGINES:
        _ENGINES[device_resize] = (
            JEngine(config=_cfg(j_config, vault_path,
                                device_resize=device_resize),
                    det_cfg=JDetectorConfig.tiny(), params=tree),
            t_forensics.MisinfoForensics(
                config=_cfg(t_config, vault_path,
                            device_resize=device_resize),
                det_cfg=DET, params=params_from_jax(tree), device="cpu"))
    return _ENGINES[device_resize]


def _assert_reports(a, b):
    for ra, rb in zip(a, b):
        for k in SCORES:
            assert abs(ra["scores"][k] - rb["scores"][k]) <= 1e-4, (
                k, ra["scores"][k], rb["scores"][k])
        assert ra["verdict"] == rb["verdict"]
        assert ([m["title"] for m in ra["vault_matches"]]
                == [m["title"] for m in rb["vault_matches"]])


@pytest.mark.parametrize("device_resize", [False, True])
def test_mixed_batch_with_videos_matches_jax_engine(tree, clips, vault_path,
                                                    device_resize,
                                                    monkeypatch):
    j_eng, t_eng = _engines(tree, vault_path, device_resize)
    a_mp4, b_mp4 = clips
    image = np.random.default_rng(1).integers(0, 256, (80, 120, 3),
                                              dtype=np.uint8)
    reqs = [{"video": a_mp4, "text": "first clip caption"},
            {"video": b_mp4},
            {"text": "w1 w2 w3", "image": image},
            {"image": image},
            {"video": b_mp4, "text": "second clip, other words"},
            {"video": a_mp4}]
    seen = []
    prog = t_signals.video_program

    def spy(params, batch, **kw):
        seen.append((kw["has_text"], tuple(batch["frame_valid"].shape),
                     "image_staged" in batch))
        return prog(params, batch, **kw)
    monkeypatch.setattr(t_signals, "video_program", spy)
    a, b = j_eng.analyze_batch(reqs), t_eng.analyze_batch(reqs)
    assert sorted(seen) == [(False, (2, F), device_resize),
                            (True, (2, F), device_resize)]
    _assert_reports(a, b)
    # clip a's planted frame opens the gate, with and without text
    for i in (0, 5):
        assert b[i]["vault_matches"][0]["title"] == "article 4"
        assert b[i]["scores"]["vault_discrepancy"] > 0.85
    assert b[1]["scores"]["ai_score"] == 0.0


def test_analyze_video_path_matches_jax_engine(tree, clips, vault_path,
                                               capsys):
    j_eng, t_eng = _engines(tree, vault_path, False)
    kw = dict(text="a colorful test pattern", video_path=clips[1])
    a = j_eng.analyze(**kw, verbose=True)
    want = capsys.readouterr().out
    b = t_eng.analyze(**kw, verbose=True)
    got = capsys.readouterr().out
    _assert_reports([a], [b])
    assert a["explanation"] == b["explanation"]
    assert "[Step 2] Video Forensics (Frame Sampling)..." in got
    # the same report but for the banner's engine name
    assert ([ln for ln in got.splitlines() if "ANALYSIS (" not in ln]
            == [ln for ln in want.splitlines() if "ANALYSIS (" not in ln])


def test_video_groups_split_at_the_largest_video_bucket(tree, clips,
                                                        vault_path,
                                                        monkeypatch):
    """Five videos with ``video_batch_buckets=(1, 2)``: three programs of
    2, 2 and 1 (bucket 1) videos, each the reports of one-video calls."""
    eng = t_forensics.MisinfoForensics(
        config=_cfg(t_config, vault_path, video_batch_buckets=(1, 2)),
        det_cfg=DET, params=params_from_jax(tree), device="cpu")
    reqs = [{"video": clips[i % 2]} for i in range(5)]
    seen = []
    prog = t_signals.video_program

    def spy(params, batch, **kw):
        seen.append(tuple(batch["frame_valid"].shape))
        return prog(params, batch, **kw)
    monkeypatch.setattr(t_signals, "video_program", spy)
    batched = eng.analyze_batch(reqs)
    assert seen == [(2, F), (2, F), (1, F)]
    singles = [eng.analyze(video_path=r["video"], verbose=False)
               for r in reqs[:2]]
    for i, r in enumerate(batched):
        s = singles[i % 2]
        assert r["verdict"] == s["verdict"]
        for k in SCORES:
            assert abs(r["scores"][k] - s["scores"][k]) <= 1e-5, k
