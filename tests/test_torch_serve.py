"""The port's serving surfaces held to the JAX package's, on the
reference's own checkpoint files.

A tiny detector tree (DetectorConfig.tiny(), the port's seeded init) is
written in the reference's ``.pth`` layout, monolithic and per-branch.
The JAX engine and the port's engine (f32 parity mode, CPU) each boot
from the same directory, starting from one seeded init (the port's, handed
to the JAX engine's ``detector_init`` so that the leaves a per-branch
directory leaves out agree too). They must report the same
``load_report`` and scores within 1e-3, verdicts equal, and so must their
entry points: the CLIs on one JSONL file, the REST APIs on ephemeral
ports (``/analyze``, ``/analyze_batch``, ``/predict``). The cases of
tests/test_api.py, tests/test_cli.py and tests/test_webui.py are mirrored
on the port's surfaces, with the port's refusals (``--device cuda``
without a card, with or without ``--mesh``; a bad mesh spec), the
micro-batcher, the similarity engine, the dashboard's host functions and
the asset verifier.
"""

import base64
import dataclasses
import io
import json
import os
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.core import config as j_config
from misinfo_tpu.engine import forensics as j_forensics
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.serve import api as j_api
from misinfo_tpu.serve import cli as j_cli
from misinfo_tpu.serve import dashboard as j_dash
from misinfo_tpu.serve import download as j_download
from misinfo_tpu.serve import similarity as j_sim

from misinfo_tpu_torch.checkpoints.torch_convert import (
    export_reference_state_dicts)
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.engine.batching import BatchingEngine
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.serve import api as t_api
from misinfo_tpu_torch.serve import cli as t_cli
from misinfo_tpu_torch.serve import dashboard as t_dash
from misinfo_tpu_torch.serve import download as t_download
from misinfo_tpu_torch.serve import similarity as t_sim
from misinfo_tpu_torch.serve import transcript as t_tr
from misinfo_tpu_torch.serve import webui as t_webui

DET = DetectorConfig.tiny()
SEED = 5
SCORES = ("ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
          "vault_discrepancy", "text_similarity", "fake_probability",
          "real_probability", "confidence")
PAYLOAD_KEYS = {"badge_html", "verdict_text", "labels", "gallery",
                "report_md", "vault_md", "transcript"}
WEIGHTS = ("fusion_weights", "ai_head_weights", "misinfo_head_weights",
           "efficientnet_weights", "clip_weights")


def _image(seed, size=64):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                                dtype=np.uint8)


def _png_b64(seed=0):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(_image(seed)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _config(mod, root, layout):
    """``mod``'s ForensicsConfig (f32 parity, tiny sequence shapes) with
    ModelPaths' reference files in ``root``/``layout``."""
    paths = mod.ModelPaths(vault_path=os.path.join(root, "vault.npz"))
    paths = dataclasses.replace(paths, **{
        f: os.path.join(root, layout, getattr(paths, f)) for f in WEIGHTS})
    return mod.ForensicsConfig(
        verbose=False, precision=mod.PrecisionConfig.highest(), paths=paths,
        seq=mod.SequenceConfig(roberta_max_len=32, image_size=64))


def _port_init(key, cfg=None):
    """The port's seeded init as the JAX engine's starting tree (for the
    JAX engine's ``PRNGKey(seed)``: [0, seed])."""
    seed = int(np.asarray(key)[-1])
    return jax.tree.map(lambda t: t.numpy(), detector_init(seed, DET))


def _boot(root, layout):
    """(JAX engine, port engine), each booted from ``root``/``layout``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_forensics, "detector_init", _port_init)
        j = j_forensics.MisinfoForensics(
            config=_config(j_config, root, layout),
            det_cfg=JDetectorConfig.tiny())
    t = t_forensics.MisinfoForensics(config=_config(t_config, root, layout),
                                     det_cfg=DET, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The reference files of a seeded tiny tree, both layouts, and a
    vault."""
    from misinfo_tpu_torch.vault.store import TruthVault
    root = tmp_path_factory.mktemp("torch_serve")
    full, clip_sd = export_reference_state_dicts(detector_init(SEED + 1,
                                                               DET))

    def tensors(sd, prefix=""):
        return {k: torch.from_numpy(v) for k, v in sd.items()
                if k.startswith(prefix)}
    mono, indiv = root / "monolithic", root / "individual"
    mono.mkdir()
    indiv.mkdir()
    torch.save({"full_model_state_dict": tensors(full), "epoch": 8,
                "accuracy": 0.9538}, mono / "forensics_master_final.pth")
    torch.save({"model_state_dict": tensors(clip_sd)},
               mono / "clip_detective_best.pth")
    torch.save({"model_state_dict": tensors(full, "ai_head.")},
               indiv / "ai_head_best.pth")
    torch.save({"model_state_dict": tensors(full, "misinfo_head.")},
               indiv / "roberta_detective_best.pth")
    torch.save(tensors(full, "efficientnet."),
               indiv / "efficientnet_cifake_best.pth")
    rng = np.random.default_rng(3)
    d = DET.clip.projection_dim
    TruthVault(rng.normal(size=(6, d)).astype(np.float32),
               [{"title": f"article {i}", "url": f"u{i}", "date": "2024"}
                for i in range(6)],
               rng.normal(size=(6, d)).astype(np.float32)).save(
        str(root / "vault.npz"))
    return str(root)


@pytest.fixture(scope="module")
def engines(root):
    return _boot(root, "monolithic")


@pytest.fixture(scope="module")
def servers(engines):
    """(JAX API URL, port API URL, port ForensicsAPI)."""
    apis = [j_api.ForensicsAPI(engine=engines[0]),
            t_api.ForensicsAPI(engine=engines[1])]
    httpds = [j_api.serve(apis[0], port=0), t_api.serve(apis[1], port=0)]
    yield tuple(f"http://127.0.0.1:{h.server_address[1]}"
                for h in httpds) + (apis[1],)
    for h, a in zip(httpds, apis):
        h.shutdown()
        a.close()


def _requests():
    return [{"text": "a claim about some news", "image": _image(1)},
            {"text": "short text"}, {"text": "another much longer claim "
                                     "about events that never happened"},
            {"image": _image(2)}]


def _assert_reports_close(a, b, tol=1e-3):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for k in SCORES:
            assert abs(ra["scores"][k] - rb["scores"][k]) <= tol, (
                k, ra["scores"][k], rb["scores"][k])
        assert ra["verdict"] == rb["verdict"]
        assert ra["verdict_text"] == rb["verdict_text"]
        assert ([m["title"] for m in ra["vault_matches"]]
                == [m["title"] for m in rb["vault_matches"]])


def _load_report(engine):
    return {k: engine.load_report.get(k) for k in
            ("mode", "applied", "skipped", "epoch", "accuracy")}


# ------------------------------------------------------- the whole slice

@pytest.mark.parametrize("layout", ["monolithic", "individual"])
def test_port_engine_boots_from_reference_pth_as_jax(root, engines, layout):
    j, t = engines if layout == "monolithic" else _boot(root, layout)
    assert _load_report(t) == _load_report(j)
    assert t.load_report["mode"] == layout and t.load_report["applied"] > 0
    assert t.load_report["skipped"] == []
    _assert_reports_close(j.analyze_batch(_requests()),
                          t.analyze_batch(_requests()))
    assert set(t.host_prep_report()) == set(j.host_prep_report()) - {"link"}


def test_port_engine_soft_fails_an_unreadable_pth_as_jax(tmp_path,
                                                         monkeypatch):
    """No reference file: JAX's report (the per-branch mode, nothing
    applied). A corrupt monolithic file: the cascade stops, the engine
    serves its init, and ``load_report`` carries the error, as in JAX."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(j_forensics, "detector_init", _port_init)

    def both():
        return (t_forensics.MisinfoForensics(
                    config=t_config.ForensicsConfig(verbose=False),
                    det_cfg=DET, device="cpu"),
                j_forensics.MisinfoForensics(
                    config=j_config.ForensicsConfig(verbose=False),
                    det_cfg=JDetectorConfig.tiny()))
    t, j = both()
    assert _load_report(t) == _load_report(j)
    assert (t.load_report["mode"], t.load_report["applied"]) == (
        "individual", 0)
    (tmp_path / "forensics_master_final.pth").write_bytes(b"not a pickle")
    t, j = both()
    assert t.load_report["mode"] == j.load_report["mode"] == "init"
    assert t.load_report["error"] and j.load_report["error"]


# ------------------------------------------------------------------- CLI

class _StubEngine:
    """Captures construction + calls without an engine (as
    tests/test_cli.py's)."""

    instances = []

    def __init__(self, config=None, device=None, **kw):
        self.config, self.device = config, device
        _StubEngine.instances.append(self)
        self.calls = []

    def _report(self):
        return {"verdict": 0, "verdict_text": "REAL", "confidence": 0.6,
                "scores": {"misinfo_score": 0.4}, "vault_matches": [],
                "explanation": "stub"}

    def analyze(self, **kw):
        self.calls.append(("analyze", kw))
        return self._report()

    def analyze_stream(self, reqs, explanations=False):
        reqs = list(reqs)
        self.calls.append(("analyze_stream", reqs))
        return iter([self._report() for _ in reqs])


@pytest.fixture
def stub_engine(monkeypatch):
    _StubEngine.instances = []
    monkeypatch.setattr(t_forensics, "MisinfoForensics", _StubEngine)
    yield


def test_port_cli_text_to_json(stub_engine, tmp_path):
    out = tmp_path / "report.json"
    assert t_cli.main(["--text", "some claim", "--quiet", "--device", "cpu",
                       "--output", str(out)]) == 0
    assert json.loads(out.read_text())["verdict_text"] == "REAL"
    eng = _StubEngine.instances[-1]
    assert eng.device == torch.device("cpu")
    assert eng.calls[0][1]["text"] == "some claim"


def test_port_cli_requires_modality(stub_engine):
    with pytest.raises(SystemExit):
        t_cli.main(["--quiet", "--device", "cpu"])


def test_port_cli_batch_file_and_vault_override(stub_engine, tmp_path):
    bf = tmp_path / "reqs.jsonl"
    bf.write_text('{"text": "a"}\n{"text": "b"}\n')
    out = tmp_path / "out.json"
    assert t_cli.main(["--batch-file", str(bf), "--quiet", "--device", "cpu",
                       "--vault", "/v.pkl", "--output", str(out)]) == 0
    assert len(json.loads(out.read_text())) == 2
    eng = _StubEngine.instances[-1]
    kind, reqs = eng.calls[0]
    assert kind == "analyze_stream" and len(reqs) == 2
    assert eng.config.paths.vault_path == "/v.pkl"


@pytest.mark.parametrize("argv,err,item", [
    (["--mesh", "data=4,model=2"], RuntimeError, "no CUDA device"),
    (["--device", "cpu", "--checkpoint", "/ck", "--mesh", "data=0"],
     ValueError, "bad mesh spec"),
    (["--device", "cuda"], RuntimeError, "no CUDA device"),
    (["--device", "auto"], RuntimeError, "no CUDA device")])
def test_port_cli_and_api_refuse_by_name(stub_engine, argv, err, item):
    """What the port's CLI and API refuse: the card where there is none (no
    fall back to the CPU, with or without a mesh: a mesh of CPU entries
    needs ``--device cpu``), and a bad mesh spec with JAX's error, before
    any engine is built. (A mesh is served: tests/test_torch_mesh.py.)"""
    if err is RuntimeError and torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda/auto select it")
    with pytest.raises(err, match=item):
        t_cli.main(["--text", "claim", "--quiet"] + argv)
    with pytest.raises(err, match=item):
        t_api.main(["--port", "0"] + argv)
    assert not _StubEngine.instances


def test_port_device_choice_reaches_the_transcriber():
    from misinfo_tpu_torch.serve.device import select_device
    try:
        assert select_device("cpu") == torch.device("cpu")
        assert t_tr._default_device == "cpu"
    finally:
        t_tr.reset_transcriber()
    assert t_tr._default_device == "cuda"


def test_port_transcribe_flag_merges_transcript(stub_engine, monkeypatch,
                                                tmp_path):
    """--transcribe applies the dashboard's caption-merge rule (as
    tests/test_cli.py checks JAX's)."""
    monkeypatch.setattr(t_tr, "extract_transcript",
                        lambda p, tr=None: "spoken words" if p else "")
    assert t_cli.main(["--text", "caption", "--video", "/tmp/v.mp4",
                       "--transcribe", "--quiet", "--device", "cpu"]) == 0
    kind, kw = _StubEngine.instances[-1].calls[-1]
    assert kind == "analyze" and kw["text"] == "caption\n\nspoken words"
    t_cli.main(["--text", "caption", "--video", "/tmp/v.mp4", "--quiet",
                "--device", "cpu"])
    assert _StubEngine.instances[-1].calls[-1][1]["text"] == "caption"
    monkeypatch.setattr(t_tr, "extract_transcript",
                        lambda p, tr=None: "[transcript error: boom]")
    t_cli.main(["--text", "caption", "--video", "/tmp/v.mp4",
                "--transcribe", "--quiet", "--device", "cpu"])
    assert _StubEngine.instances[-1].calls[-1][1]["text"] == "caption"
    monkeypatch.setattr(t_tr, "extract_transcript",
                        lambda p, tr=None: "heard" if p else "")
    bf = tmp_path / "reqs.jsonl"
    bf.write_text(json.dumps({"text": "a", "video": "/tmp/v.mp4"}) + "\n"
                  + json.dumps({"text": "b"}) + "\n")
    t_cli.main(["--batch-file", str(bf), "--transcribe", "--quiet",
                "--device", "cpu"])
    _, reqs = _StubEngine.instances[-1].calls[-1]
    assert [r["text"] for r in reqs] == ["a\n\nheard", "b"]


def test_port_cli_matches_jax_cli_on_one_jsonl(root, engines, tmp_path,
                                               monkeypatch):
    """Both CLIs beside the monolithic files, one JSONL file: the port's
    builds its engine from its own config (the .pth cascade from the
    working directory), JAX's is handed the engine booted from the same
    files."""
    from PIL import Image
    img = str(tmp_path / "img.png")
    Image.fromarray(_image(1)).save(img)
    reqs = [{"text": "a claim about some news", "image": img},
            {"text": "short text"}, {"image": img}]
    bf = tmp_path / "reqs.jsonl"
    bf.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    Real = t_forensics.MisinfoForensics
    made = []

    def tiny(config=None, device="cuda", **kw):
        config = config.replace(
            precision=t_config.PrecisionConfig.highest(),
            seq=t_config.SequenceConfig(roberta_max_len=32, image_size=64))
        made.append(Real(config, DET, device=device, **kw))
        return made[-1]
    monkeypatch.setattr(t_forensics, "MisinfoForensics", tiny)
    monkeypatch.setattr(j_forensics, "MisinfoForensics",
                        lambda config=None, mesh=None, **kw: engines[0])
    monkeypatch.chdir(os.path.join(root, "monolithic"))
    outs = [tmp_path / "jax.json", tmp_path / "port.json"]
    vault = os.path.join(root, "vault.npz")
    assert j_cli.main(["--batch-file", str(bf), "--quiet", "--vault", vault,
                       "--output", str(outs[0])]) == 0
    assert t_cli.main(["--batch-file", str(bf), "--quiet", "--vault", vault,
                       "--device", "cpu", "--output", str(outs[1])]) == 0
    assert made[0].load_report["mode"] == "monolithic"
    assert made[0].device == torch.device("cpu")
    _assert_reports_close(*[json.loads(o.read_text()) for o in outs])


# ------------------------------------------------------------------- API

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_port_api_healthz(servers):
    j_url, t_url, _ = servers
    health = [json.loads(_get(u + "/healthz")[2]) for u in (j_url, t_url)]
    assert set(health[1]) == set(health[0])
    assert health[1]["status"] == "ok" and health[1]["device"] == "cpu"
    assert (health[1]["checkpoint_mode"] == health[0]["checkpoint_mode"]
            == "monolithic")
    assert health[1]["tokenizer_parity"] is False
    assert set(health[1]["tokenizer_grades"]) == {"roberta", "clip"}


def test_port_api_metrics(servers):
    _, t_url, _ = servers
    assert _post(t_url + "/analyze", {"text": "metrics probe"})[0] == 200
    body = json.loads(_get(t_url + "/metrics")[2])
    assert body["verdicts_per_sec"] > 0
    assert body.get("analyze_count", 0) >= 1
    assert body.get("analyze_seconds", 0) > 0
    assert body.get("analyze_p50_ms", 0) > 0
    assert body.get("analyze_p99_ms", 0) >= body["analyze_p50_ms"]
    mem = body["memory"]
    assert mem["params_bytes"] > 0
    assert mem["vault_bytes"] == sum(mem["vault_bytes_by_key"].values())
    assert mem["vault_dtype"] == "float32" and mem["devices"] >= 1
    assert {"host_bound_at_probe_res", "fast_decode_recommended", "probe",
            "summary", "active"} == set(body["host_prep"])


def test_port_api_answers_as_jax(servers):
    """/analyze (text; text + base64 image), /analyze_batch and /predict:
    the port's responses within 1e-3 of JAX's, verdicts equal."""
    j_url, t_url, _ = servers
    b64 = _png_b64(4)
    for route, payload in (
            ("/analyze", {"text": "api test claim"}),
            ("/analyze", {"text": "caption", "image_b64": b64}),
            ("/analyze_batch", [{"text": "a"}, {"text": "b"}])):
        (jc, jb), (tc, tb) = (_post(u + route, payload)
                              for u in (j_url, t_url))
        assert jc == tc == 200, (jb, tb)
        _assert_reports_close(jb if isinstance(jb, list) else [jb],
                              tb if isinstance(tb, list) else [tb])
    (jc, jb), (tc, tb) = (_post(u + "/predict",
                                {"text": "caption", "image_b64": b64})
                          for u in (j_url, t_url))
    assert jc == tc == 200 and set(tb) == set(jb) == PAYLOAD_KEYS
    assert tb["verdict_text"] == jb["verdict_text"]
    assert tb["transcript"] == jb["transcript"] == ""
    for key, labels in tb["labels"].items():
        assert list(labels) == list(jb["labels"][key])
        for name, v in labels.items():
            assert abs(v - jb["labels"][key][name]) <= 1e-3, (key, name)


def test_port_api_concurrent_clients_consistent(servers):
    _, t_url, _ = servers
    payload = {"text": "the same claim from every client"}
    with ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(lambda _: _post(t_url + "/analyze", payload),
                              range(16)))
    assert all(code == 200 for code, _ in results)
    assert len({json.dumps(b["scores"], sort_keys=True)
                for _, b in results}) == 1


def test_port_api_errors_as_jax(servers):
    j_url, t_url, _ = servers
    for route, payload in (("/analyze", {}), ("/nope", {"x": 1}),
                           ("/reload_vault", {})):
        (jc, jb), (tc, tb) = (_post(u + route, payload)
                              for u in (j_url, t_url))
        assert jc == tc and "error" in tb and "error" in jb, route
    assert tc == 403
    assert _get(t_url + "/nope")[0] == _get(j_url + "/nope")[0] == 404


def test_port_api_reload_vault_when_allowed(engines, root):
    api = t_api.ForensicsAPI(engine=engines[1], allow_reload=True)
    httpd = t_api.serve(api, port=0)
    try:
        code, body = _post(f"http://127.0.0.1:{httpd.server_address[1]}"
                           "/reload_vault",
                           {"path": os.path.join(root, "vault.npz")})
    finally:
        httpd.shutdown()
        api.close()
    assert code == 200 and body["articles"] == 6


def test_port_decode_request_transcribe(monkeypatch):
    monkeypatch.setattr(t_tr, "extract_transcript",
                        lambda p, tr=None: "spoken")
    out = t_api._decode_request_image({"text": "cap", "video_path": "/v.mp4",
                                       "transcribe": True})
    assert out == {"text": "cap\n\nspoken", "video": "/v.mp4"}
    monkeypatch.setattr(t_tr, "extract_transcript",
                        lambda p, tr=None: "[transcript error: x]")
    assert t_api._decode_request_image(
        {"text": "cap", "video_path": "/v.mp4", "transcribe": True}
    )["text"] == "cap"
    b64 = _png_b64(2)
    got = t_api._decode_request_image({"text": "t", "image_b64": b64})
    want = j_api._decode_request_image({"text": "t", "image_b64": b64})
    np.testing.assert_array_equal(got.pop("image"), want.pop("image"))
    assert got == want


def test_port_metrics_surface_gemini_error_classes(servers):
    from misinfo_tpu_torch.engine.explain import Explainer
    from misinfo_tpu_torch.utils.tracing import GLOBAL_TRACER

    class _Boom:
        def __init__(self, msg):
            self.msg = msg

        def generate_content(self, prompt):
            raise RuntimeError(self.msg)
    ex = Explainer(api_key=None, tracer=GLOBAL_TRACER)
    ex.available = True
    for msg in ("Invalid API key", "quota exceeded today"):
        ex._model = _Boom(msg)
        ex.explain({"verdict": 1, "confidence": 0.5}, [])
    body = json.loads(_get(servers[1] + "/metrics")[2])
    assert body.get("gemini_error_auth_count", 0) >= 1
    assert body.get("gemini_error_quota_count", 0) >= 1


def test_port_serve_while_warming_background(root):
    import time
    cfg = _config(t_config, root, "monolithic")
    cfg = cfg.replace(serving=dataclasses.replace(
        cfg.serving, batch_buckets=(1, 4), pack_text=False))
    engine = t_forensics.MisinfoForensics(config=cfg, det_cfg=DET,
                                          device="cpu")
    api = t_api.ForensicsAPI(engine=engine)
    httpd = t_api.serve(api, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        api.start_background_warmup()
        code, out = _post(f"{base}/analyze", {"text": "warming claim"})
        assert code == 200 and out["verdict_text"] in ("REAL", "FAKE")
        assert "warming" in json.loads(_get(f"{base}/healthz")[2])
        deadline = time.time() + 120
        while time.time() < deadline:
            h = json.loads(_get(f"{base}/healthz")[2])
            if not h["warming"]["active"]:
                break
            time.sleep(0.2)
        assert not h["warming"]["active"] and "error" not in h["warming"], h
        assert h["warming"]["done"] == h["warming"]["signatures"] > 0
    finally:
        httpd.shutdown()
        api.close()


def test_port_batching_engine_drains_on_close(engines):
    eng = engines[1]
    batcher = BatchingEngine(eng, max_wait_ms=2.0)
    futures = [batcher.submit(r) for r in _requests()]
    batcher.close()
    assert all(f.done() for f in futures)
    _assert_reports_close([f.result() for f in futures],
                          eng.analyze_batch(_requests()), tol=0.0)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit({"text": "late"})


# ---------------------------------------------------------------- web UI

def test_port_index_page_served(servers):
    code, ctype, body = _get(servers[1] + "/")
    assert code == 200 and ctype.startswith("text/html")
    page = body.decode()
    for marker in ('id="caption"', 'id="image"', 'id="video"',
                   'id="meters"', 'id="gallery"', 'id="transcript"',
                   "/predict", "/healthz"):
        assert marker in page, marker


def test_port_predict_text_only_and_empty(servers):
    j_url, t_url, _ = servers
    code, body = _post(t_url + "/predict", {"text": "a plain claim"})
    assert code == 200 and set(body) == PAYLOAD_KEYS
    assert body["verdict_text"] in body["badge_html"]
    assert set(body["labels"]["ai"]) == {"AI-generated", "Human-written"}
    assert list(body["labels"]["deepfake"]) == ["N/A (modality not provided)"]
    assert "Forensic report" in body["report_md"]
    assert _post(j_url + "/predict", {"text": "a plain claim"})[1][
        "verdict_text"] == body["verdict_text"]
    code, body = _post(t_url + "/predict", {"text": ""})
    assert code == 200 and body["verdict_text"] == "N/A"
    assert "Provide a caption" in body["badge_html"] and body["gallery"] == []


def test_port_gallery_inlining(tmp_path):
    from PIL import Image
    p = tmp_path / "match.jpg"
    Image.fromarray(np.zeros((8, 8, 3), dtype=np.uint8)).save(p)
    out = t_webui._inline_gallery([(str(p), "93.0% Match"),
                                   ("/nonexistent/x.png", "nope")])
    assert len(out) == 1 and out[0]["caption"] == "93.0% Match"
    assert out[0]["mime"] == "image/jpeg"
    assert base64.b64decode(out[0]["image_b64"])[:2] == b"\xff\xd8"


def test_port_predict_payload_spools_and_cleans(monkeypatch):
    seen = {}

    def fake_predict(image_path, text, video_path, engine=None):
        seen["path"], seen["existed"] = image_path, os.path.exists(image_path)
        empty = {"N/A (modality not provided)": 1.0}
        return ("<div>ok</div>", "REAL", empty, empty, empty, empty, empty,
                [], "", "", "")
    monkeypatch.setattr(t_webui._dash, "predict", fake_predict)
    body = t_webui.predict_payload({"text": "t", "image_b64": _png_b64()})
    assert seen["existed"] and not os.path.exists(seen["path"])
    assert body["verdict_text"] == "REAL"


# ----------------------------------------- dashboard, similarity, assets

def test_port_dashboard_host_functions_equal_jax(tmp_path):
    for score in (None, -0.5, 0.0, 0.37, 1.0, 1.7):
        assert (t_dash.probs_label(score, "A", "B")
                == j_dash.probs_label(score, "A", "B"))
    for text, conf in (("FAKE", 0.91), ("REAL", 0.5)):
        assert (t_dash.verdict_badge_html(text, conf)
                == j_dash.verdict_badge_html(text, conf))
    assert t_dash.normalize_clip_similarity(-0.2) == \
        j_dash.normalize_clip_similarity(-0.2)
    img = tmp_path / "a.png"
    img.write_bytes(b"x")
    scores = {"text_similarity": 0.4}
    for matches, visual in (([], False), ([], True), ([
            {"title": "t", "similarity": 0.9, "date": "d",
             "image_path": str(img)}], True), ([
            {"title": "u", "similarity": 0.2, "url": "/none"}], True)):
        assert (t_dash.vault_gallery_and_metadata(matches, scores, visual)
                == j_dash.vault_gallery_and_metadata(matches, scores,
                                                     visual))


def test_port_dashboard_gradio_gate_and_warmup(monkeypatch, capsys):
    assert t_dash.GRADIO_AVAILABLE == j_dash.GRADIO_AVAILABLE
    if not t_dash.GRADIO_AVAILABLE:
        with pytest.raises(RuntimeError, match="gradio is not installed"):
            t_dash.build_app()
        assert t_dash.main() == 1
        assert "gradio is not installed" in capsys.readouterr().out
    warmed = []

    class Eng:
        def warmup(self, full_grid=False):
            warmed.append(full_grid)

    class Demo:
        def launch(self, server_port):
            warmed.append(("launch", server_port))
    monkeypatch.setattr(t_dash, "GRADIO_AVAILABLE", True)
    monkeypatch.setattr(t_dash, "get_engine", Eng)
    monkeypatch.setattr(t_dash, "build_app", Demo)
    monkeypatch.setenv("MISINFO_TPU_WARMUP", "full")
    monkeypatch.delenv("WHISPER_CHECKPOINT", raising=False)
    assert t_dash.main() == 0
    assert warmed == [True, ("launch", 7860)]


def test_port_similarity_engine_matches_jax():
    sims = np.linspace(-0.2, 0.5, 15)
    assert ([t_sim.tiered_explanation(s) for s in sims]
            == [j_sim.tiered_explanation(s) for s in sims])
    params = detector_init(9, DET)
    jparams = jax.tree.map(lambda t: t.numpy(), params)
    t = t_sim.ClipSimilarityEngine(det_cfg=DET, params=params, device="cpu")
    j = j_sim.ClipSimilarityEngine(det_cfg=JDetectorConfig.tiny(),
                                   params=jparams)
    texts = ["a dog on a beach", "stock market news", "x"]
    images = [_image(s) for s in (1, 2, 3)]
    got, want = t.analyze_pairs(texts, images), j.analyze_pairs(texts, images)
    for a, b in zip(got, want):
        assert abs(a["similarity"] - b["similarity"]) <= 1e-3
        assert (a["label"], a["explanation"]) == (b["label"],
                                                  b["explanation"])
    # a checkpoint path that holds nothing leaves the seeded init, as JAX's
    t = t_sim.ClipSimilarityEngine(det_cfg=DET, checkpoint="/ck",
                                   device="cpu")
    assert torch.equal(t.params["logit_scale"],
                       detector_init(0, DET)["clip"]["logit_scale"])


def test_port_asset_verifier_equals_jax(tmp_path):
    good = tmp_path / "good"
    good.mkdir()
    (good / "vocab.json").write_text(json.dumps(
        {f"t{i}": i for i in range(200)}))
    (good / "merges.txt").write_text("#version: 0.2\n" + "\n".join(
        f"a{i} b{i}" for i in range(150)))
    bad = tmp_path / "whisper-base"
    bad.mkdir()
    (bad / "vocab.json").write_text(json.dumps({"<|endoftext|>": 0, "a": 1}))
    (bad / "merges.txt").write_text("a b\n")
    for d, name in ((good, None), (bad, None), (tmp_path / "none", None),
                    (good, "roberta-base")):
        assert (t_download.verify_assets(str(d), name, log=lambda m: None)
                == j_download.verify_assets(str(d), name,
                                            log=lambda m: None))
    logs = ([], [])
    assert (t_download.verify_all(str(tmp_path), log=logs[0].append)
            == j_download.verify_all(str(tmp_path), log=logs[1].append))
    assert logs[0] == logs[1]
