"""``MisinfoForensics(mesh=...)`` on grids of CPU entries, held to the
port's single-device engine (f32 scores within 1e-5, verdicts and vault
top-k titles exact) and, once, to JAX's single-device engine (within
1e-3, ROADMAP.md's bar). JAX's own mesh tests' parametrisation: data=2,
data=8 and data=4 × model=2; packed text, video groups, the device
resize, a vault row-sharded over the data axis in f32, int8 and int4
rows, and ``reload_vault`` flipping the shard decision. Then the
transcriber under data=2 against no mesh (tokens and window texts equal,
the sampled rungs included) and the CLI with ``--device cpu --mesh
data=2``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from misinfo_tpu_torch.core import config as C
from misinfo_tpu_torch.core import mesh as t_mesh
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.vault.store import TruthVault

DET = DetectorConfig.tiny()
N_VAULT = 300
SCORES = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
          "vault_discrepancy", "text_similarity", "fake_probability",
          "confidence")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A mesh program runs each position's many small ops in turn; with
    every test worker's intra-op pool spinning on a shared host they
    crawl (36-145 s a test, against under 1 s alone). One thread costs
    nothing at these sizes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    return detector_init(0, DET)


@pytest.fixture(scope="module")
def vault_path(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = DET.clip.projection_dim
    emb = rng.normal(size=(N_VAULT, d)).astype(np.float32)
    vault = TruthVault(emb, [{"title": f"article {i}", "url": f"u{i}",
                              "date": "2024"} for i in range(N_VAULT)],
                       rng.normal(size=(N_VAULT, d)).astype(np.float32))
    p = str(tmp_path_factory.mktemp("mesh_vault") / "vault.npz")
    vault.save(p)
    return p


def _cfg(vault_path, **serving):
    return C.ForensicsConfig(
        verbose=False, precision=C.PrecisionConfig.highest(),
        paths=C.ModelPaths(vault_path=vault_path),
        seq=C.SequenceConfig(roberta_max_len=32, image_size=64),
        serving=C.ServingConfig(**serving))


def _mesh(data, model=1):
    return t_mesh.make_mesh(C.MeshConfig(data=data, model=model),
                            devices=["cpu"] * (data * model))


def _engine(params, vault_path, mesh=None, **serving):
    return t_forensics.MisinfoForensics(
        _cfg(vault_path, **serving), DET, params=params, mesh=mesh,
        device="cpu")


def _img(seed):
    return np.random.default_rng(seed).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)


def _requests():
    rng = np.random.default_rng(11)

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(0, 999, n))
    return ([{"text": words(n), "image": _img(n)} for n in (20, 24, 28)]
            + [{"text": words(n)} for n in (1, 2, 3, 3, 4, 5, 2, 6)]
            + [{"image": _img(1)}, {"image": _img(2)}])


def _match(a, b, atol=1e-5):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for k in SCORES:
            np.testing.assert_allclose(ra["scores"][k], rb["scores"][k],
                                       atol=atol, err_msg=k)
        assert ra["verdict"] == rb["verdict"]
        assert ([m["title"] for m in ra["vault_matches"]]
                == [m["title"] for m in rb["vault_matches"]])


@pytest.fixture(scope="module")
def single(params, vault_path):
    eng = _engine(params, vault_path)
    return eng, eng.analyze_batch(_requests())


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (8, 1), (4, 2)])
def test_mesh_engine_matches_single_device(params, vault_path, single,
                                           data, model):
    """Also which programs ran through per-position runners: with
    model=1 the unpacked programs (every program at data=1), one runner
    per data position; with model=2 none (eager)."""
    eng = _engine(params, vault_path, _mesh(data, model))
    assert eng._vault_sharded is False       # below the row threshold
    assert eng.quant == "none" and not eng.cuda_graphs
    assert eng._req_bucket(1) % data == 0
    _match(single[1], eng.analyze_batch(_requests()))
    rep = eng.memory_report()
    assert rep["devices"] == data * model and not rep["vault_sharded"]
    sigs = {sig for sig, _ in eng._runners}
    assert sorted(eng._runners) == sorted(
        (sig, d) for sig in sigs for d in range(data))
    assert ({sig[0] for sig in sigs} >= {"full", "visual_only"}
            if model == 1 else not sigs)
    assert all(data == 1 or not sig[3] for sig in sigs)   # packed: eager
    for (sig, d), runner in eng._runners.items():
        assert runner.device == eng.mesh.data_devices[d]
        if "image" in runner.static:          # its piece of the batch
            assert runner.static["image"].shape[0] * data == sig[1]


def test_mesh_runners_per_position_survive_reload(params, vault_path,
                                                  tmp_path):
    """warmup() over data=2 makes one runner per position of each warmed
    signature; reload_vault re-makes them against the new vault, whose
    reports then equal the single engine's on it."""
    eng = _engine(params, vault_path, _mesh(2))
    done = eng.warmup(batch_sizes=(2,), text_buckets=(32,),
                      variants=("full",), videos=())
    assert sorted(eng._runners) == [(sig, d) for sig in done
                                    for d in range(2)]
    before = dict(eng._runners)
    rng = np.random.default_rng(4)
    d = DET.clip.projection_dim
    other = str(tmp_path / "other.npz")
    TruthVault(rng.normal(size=(40, d)).astype(np.float32),
               [{"title": f"o{i}", "url": "", "date": ""} for i in range(40)],
               rng.normal(size=(40, d)).astype(np.float32)).save(other)
    eng.reload_vault(other)
    assert sorted(eng._runners) == sorted(before)
    assert all(eng._runners[k] is not before[k] for k in before)
    reqs = _requests()[:3]
    _match(_engine(params, other).analyze_batch(reqs),
           eng.analyze_batch(reqs))


@pytest.mark.parametrize("pack", [True, "auto"])
def test_mesh_engine_packed_text(params, vault_path, pack):
    """Packed rows split over data=4: each request's CLS comes from the
    position holding its row; held to the unpacked single engine."""
    texts = [{"text": " ".join(["w"] * n)} for n in (1, 2, 3, 5, 8, 2, 1,
                                                      4, 6, 3)]
    want = _engine(params, vault_path, pack_text=False).analyze_batch(texts)
    eng = _engine(params, vault_path, _mesh(4, 2 if pack is True else 1),
                  pack_text=pack)
    got = eng.analyze_batch(texts)
    _match(want, got)


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_sharded_vault_matches_replicated(params, vault_path, dtype):
    """vault_shard_min_rows below the vault's rows: the vault is row-
    sharded (padded to a multiple of data with invalid rows) and served by
    vault_search_sharded; the same dtype's single engine is the reference."""
    want = _engine(params, vault_path, vault_dtype=dtype)
    eng = _engine(params, vault_path, _mesh(8), vault_dtype=dtype,
                  vault_shard_min_rows=64)
    assert eng._vault_sharded is True
    reqs = _requests() + [{"text": "caption", "image": _img(9)}]
    _match(want.analyze_batch(reqs), eng.analyze_batch(reqs))
    sv, se = eng.search_vault(_img(5)), want.search_vault(_img(5))
    assert [m["title"] for m in sv["matches"]] == \
        [m["title"] for m in se["matches"]]
    rep = eng.memory_report()
    assert rep["vault_sharded"]
    assert rep["vault_rows_padded"] % 8 == 0
    assert rep["vault_bytes_per_device"] * 8 >= rep["vault_bytes"] - 4096


def test_reload_vault_redecides_sharding(params, vault_path, tmp_path):
    """JAX's test_reload_flips_shard_threshold on the port's mesh engine."""
    eng = _engine(params, vault_path, _mesh(2), vault_shard_min_rows=200)
    assert eng._vault_sharded
    rng = np.random.default_rng(3)
    d = DET.clip.projection_dim
    small = str(tmp_path / "small.npz")
    TruthVault(rng.normal(size=(50, d)).astype(np.float32),
               [{"title": f"s{i}", "url": "", "date": ""} for i in range(50)],
               None).save(small)
    out = eng.reload_vault(small)
    assert out["sharded"] is False and not eng._vault_sharded
    want = _engine(params, small)
    _match(want.analyze_batch(_requests()), eng.analyze_batch(_requests()))
    out = eng.reload_vault(vault_path)
    assert out["sharded"] is True and eng._vault_sharded


def test_mesh_video_and_device_resize(params, vault_path, monkeypatch):
    """Video groups (frames ride the batch axis, split with their videos)
    and the device resize under data=2 × model=2."""
    def frames(path, F, stride, fps):
        seed = int(path.split("_")[-1])
        rng = np.random.default_rng(seed)
        n = 2 + seed % 3
        fs = [rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
              for _ in range(n)]
        valid = np.zeros((F,), np.bool_)
        valid[:n] = True
        return fs, valid
    monkeypatch.setattr(t_forensics, "sample_video_frames", frames)
    reqs = [{"video": f"clip_{i}", **({"text": f"caption {i}"} if i % 2
                                      else {})} for i in range(5)]
    reqs += [{"text": "words here", "image": _img(3)}]
    for kw in ({}, {"device_resize": True}):
        want = _engine(params, vault_path, **kw).analyze_batch(reqs)
        got = _engine(params, vault_path, _mesh(2, 2),
                      **kw).analyze_batch(reqs)
        _match(want, got)


def test_mesh_video_through_per_position_runners(params, vault_path,
                                                 monkeypatch):
    """Video groups under data=2 × model=1: each position's videos (and
    their frames) through its own runner, against the single engine."""
    def frames(path, F, stride, fps):
        rng = np.random.default_rng(int(path.split("_")[-1]))
        valid = np.zeros((F,), np.bool_)
        valid[:3] = True
        return ([rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
                 for _ in range(3)], valid)
    monkeypatch.setattr(t_forensics, "sample_video_frames", frames)
    reqs = [{"video": f"clip_{i}", **({"text": f"caption {i}"} if i % 2
                                      else {})} for i in range(3)]
    eng = _engine(params, vault_path, _mesh(2))
    _match(_engine(params, vault_path).analyze_batch(reqs),
           eng.analyze_batch(reqs))
    videos = {sig[0] for sig, _ in eng._runners}
    assert videos == {"video", "video_text"}
    assert sorted(d for _, d in eng._runners) == [0, 0, 1, 1]


def test_mesh_engine_matches_jax_single_device(params, vault_path):
    """data=4 × model=2 against JAX's single-device engine on the same
    tree, f32 parity mode: within 1e-3 (ROADMAP.md's bar)."""
    import jax
    from misinfo_tpu.core import config as J
    from misinfo_tpu.engine.forensics import MisinfoForensics as JEngine
    from misinfo_tpu.models.detector import DetectorConfig as JDet
    cfg = J.ForensicsConfig(
        verbose=False, precision=J.PrecisionConfig.highest(),
        paths=J.ModelPaths(vault_path=vault_path),
        seq=J.SequenceConfig(roberta_max_len=32, image_size=64))
    jeng = JEngine(config=cfg, det_cfg=JDet.tiny(),
                   params=jax.tree.map(lambda t: t.numpy(), params))
    reqs = _requests()
    _match(jeng.analyze_batch(reqs),
           _engine(params, vault_path, _mesh(4, 2)).analyze_batch(reqs),
           atol=1e-3)


def test_int8_mesh_engine_matches_jax_mesh_engine(params, vault_path):
    """quant="int8" over data=2 × model=2: JAX serves a mesh through its
    plain int8 chain (quant_pallas "off"), GSPMD quantizing a row-split
    product's input over the whole row; the port takes the group's abs-max
    before quantizing. Both get the tree quantized at min_elems=1 (the
    tiny kernels sit below the default gate); scores within 1e-3, the band
    of the single-device int8 engines (test_torch_engine_int8.py)."""
    import jax
    from misinfo_tpu.core import config as J
    from misinfo_tpu.core.mesh import make_mesh as j_make_mesh
    from misinfo_tpu.engine.forensics import MisinfoForensics as JEngine
    from misinfo_tpu.models.detector import DetectorConfig as JDet
    from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
    from misinfo_tpu_torch.ops.quant import quantize_params
    if len(jax.devices()) < 4:
        pytest.skip("needs JAX's virtual CPU devices (tests/conftest.py)")
    tree = jax.tree.map(lambda t: t.numpy(), quantize_params(params, 1))
    prec = dataclasses.replace(J.PrecisionConfig.highest(), quant="int8")
    cfg = J.ForensicsConfig(
        verbose=False, precision=prec,
        paths=J.ModelPaths(vault_path=vault_path),
        seq=J.SequenceConfig(roberta_max_len=32, image_size=64))
    jmesh = j_make_mesh(J.MeshConfig(data=2, model=2), jax.devices()[:4])
    jeng = JEngine(config=cfg, det_cfg=JDet.tiny(), params=tree, mesh=jmesh)
    tcfg = _cfg(vault_path).replace(precision=dataclasses.replace(
        C.PrecisionConfig.highest(), quant="int8"))
    teng = t_forensics.MisinfoForensics(tcfg, DET,
                                        params=params_from_jax(tree),
                                        mesh=_mesh(2, 2), device="cpu")
    lay = teng.params.row(0)["roberta"]["layers"][0]
    assert "kernel_q" in lay["mlp_out"].parts[0]
    reqs = _requests()
    _match(jeng.analyze_batch(reqs), teng.analyze_batch(reqs), atol=1e-3)


# ------------------------------------------------------------ transcriber

@pytest.fixture(scope="module")
def whisper():
    from misinfo_tpu_torch.models import whisper as tw
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        ByteWhisperTokenizer)
    sp = ByteWhisperTokenizer().specials
    cfg = tw.WhisperConfig(vocab_size=sp.vocab_size, num_mel_bins=80,
                           d_model=64, encoder_layers=2, decoder_layers=2,
                           num_heads=4, ffn_dim=128, max_source_positions=64,
                           max_target_positions=24, eos_token_id=sp.eot,
                           decoder_start_token_id=sp.sot)
    tree = {k: v for k, v in tw.whisper_init(3, cfg).items()}
    return cfg, tree


def test_transcriber_under_data2_matches_no_mesh(whisper):
    """Random weights: the greedy rung fails the acceptance checks, so
    every window walks the sampled rungs too; the split decode draws the
    same noise, so tokens and texts equal the decode without the mesh."""
    from misinfo_tpu_torch.serve import transcript as t_tr
    cfg, tree = whisper
    kw = dict(config=cfg, device="cpu", cuda_graphs=False)
    plain = t_tr.WhisperTranscriber(tree, **kw)
    meshed = t_tr.WhisperTranscriber(tree, mesh=_mesh(2), **kw)
    assert meshed.pallas is False and meshed.has_weights
    mels = np.random.default_rng(4).normal(
        size=(4, 2 * cfg.max_source_positions, 80)).astype(np.float32)
    enc = meshed._encode(mels)
    assert isinstance(enc, list) and len(enc) == 2
    prompt = torch.tensor([plain.tokenizer.sot_sequence(language="en")[1:]]
                          * 4)
    with torch.inference_mode():
        for t, seed in ((0.0, None), (1.0, 13)):
            a = plain._decode(plain._encode(mels), prompt, t, seed)
            b = meshed._decode(enc, prompt, t, seed)
            assert torch.equal(a[0], b[0]), t
            np.testing.assert_allclose(a[1].numpy(), b[1].numpy(),
                                       atol=1e-5)
        assert (plain._decode_window_batch(mels, "en")
                == meshed._decode_window_batch(mels, "en"))
        # 3 windows do not split over data=2: replicated, the same again
        assert not isinstance(meshed._encode(mels[:3]), list)


def test_module_transcriber_mesh_is_set_and_reset():
    from misinfo_tpu_torch.serve import transcript as t_tr
    m = _mesh(2)
    t_tr.set_transcriber_mesh(m)
    assert t_tr._default_mesh is m
    t_tr.reset_transcriber()
    assert t_tr._default_mesh is None


def test_cli_serves_a_cpu_mesh(params, vault_path, tmp_path, monkeypatch):
    """``--device cpu --mesh data=2`` provisions two CPU entries, builds
    the mesh, hands it to the engine and to the transcriber."""
    from misinfo_tpu_torch.serve import cli as t_cli
    from misinfo_tpu_torch.serve import transcript as t_tr
    real = t_forensics.MisinfoForensics
    built = []

    def tiny(config=None, device=None, mesh=None, **kw):
        cfg = dataclasses.replace(
            config, precision=C.PrecisionConfig.highest(),
            seq=C.SequenceConfig(roberta_max_len=32, image_size=64))
        built.append(real(cfg, DET, params=params, mesh=mesh, device=device))
        return built[-1]
    monkeypatch.setattr(t_forensics, "MisinfoForensics", tiny)
    monkeypatch.setattr(t_mesh, "_platform", "auto")
    monkeypatch.setattr(t_mesh, "_num_cpu_devices", 1)
    out = tmp_path / "report.json"
    try:
        assert t_cli.main(["--text", "some claim", "--quiet", "--device",
                           "cpu", "--mesh", "data=2", "--vault", vault_path,
                           "--output", str(out)]) == 0
        assert t_tr._default_mesh is built[0].mesh
    finally:
        t_tr.reset_transcriber()
    eng = built[0]
    assert eng.mesh.shape == {"data": 2, "model": 1}
    assert {d.type for d in eng.mesh.devices.flat} == {"cpu"}
    report = json.loads(out.read_text())
    want = real(_cfg(vault_path), DET, params=params,
                device="cpu").analyze("some claim", verbose=False)
    assert report["verdict"] == want["verdict"]
    np.testing.assert_allclose(report["scores"]["misinfo_score"],
                               want["scores"]["misinfo_score"], atol=1e-5)
