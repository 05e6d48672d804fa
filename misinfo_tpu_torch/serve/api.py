"""Minimal production REST API (stdlib-only, no gradio dependency), over
the port's engine: counterpart of ``misinfo_tpu/serve/api.py``, with its
routes, payloads, status codes and refusals.

The reference's only network surface is the Gradio dashboard
(forensics_dashboard.py) with one global, strictly serial engine
(:91-94). This server exposes the same analysis over plain HTTP and rides
the pipelined micro-batching engine (engine/batching.py), so N concurrent
clients cost ~one program per batching window; with ``--warmup`` each
warmed signature is a CUDA graph, replayed per batch.

    python -m misinfo_tpu_torch.serve.api --port 8080
    curl -X POST localhost:8080/analyze -d '{"text": "some claim"}'

``--device`` is ``auto`` or ``cuda`` (the card; they raise without one) or
``cpu``. ``--mesh data=N[,model=M]`` serves over a device mesh of the
visible cards (or, with ``--device cpu``, of that many CPU entries).
``--checkpoint`` names a native checkpoint directory (checkpoints/io.py),
which comes before the reference ``.pth`` files in ``ModelPaths`` (the
working directory), as in JAX.

Endpoints:
  GET  /               → browser dashboard (no-gradio UI, serve/webui.py)
  GET  /healthz        → {status, device (the card's name), vault,
                         checkpoint mode}
  GET  /metrics        → serving counters
  POST /analyze        → report dict for one {text?, image_path?|image_b64?,
                         video_path?, transcribe?} request
  POST /analyze_batch  → list of report dicts for a JSON list of requests
  POST /reload_vault   → hot vault refresh {path?} → {articles, rows,
                         sharded}; stages fully while traffic serves the
                         old vault (403 unless --allow-reload)
  POST /predict        → dashboard 11-output contract as JSON (webui)

Images arrive as server-local paths or base64 bytes (``image_b64``).
``transcribe: true`` merges the video's Whisper transcript into the text
before analysis (dashboard caption-merge rule; needs WHISPER_CHECKPOINT).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import torch

from misinfo_tpu_torch.serve.device import DEVICE_CHOICES, select


def _decode_request_image(req: Dict):
    """Return a request dict with image_b64 materialized to a numpy image."""
    out = {k: v for k, v in req.items() if v}
    b64 = out.pop("image_b64", None)
    if b64:
        import numpy as np
        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        out["image"] = np.asarray(img.convert("RGB"), dtype=np.uint8)
    elif "image_path" in out:
        out["image"] = out.pop("image_path")
    if "video_path" in out:
        out["video"] = out.pop("video_path")
    if out.pop("transcribe", False) and out.get("video"):
        # opt-in per-request Whisper transcript merge (CLI --transcribe /
        # dashboard caption-merge rule); needs WHISPER_CHECKPOINT
        from misinfo_tpu_torch.serve.transcript import merge_into_caption

        merged = merge_into_caption(out.get("text"), out["video"])
        if merged:
            out["text"] = merged
    return out


class ForensicsAPI:
    """Holds the engine + batching server; handler delegates here."""

    def __init__(self, engine=None, config=None, mesh=None,
                 allow_reload: bool = False, device="cuda"):
        from misinfo_tpu_torch.engine.batching import BatchingEngine
        from misinfo_tpu_torch.engine.forensics import MisinfoForensics

        self.engine = engine or MisinfoForensics(config=config, mesh=mesh,
                                                 device=device)
        self.batcher = BatchingEngine(self.engine)
        self.warming = None  # serve-while-warming state (start_background_warmup)
        # /reload_vault is a MUTATION endpoint that reads operator-named
        # files (incl. reference pickles) — it stays 403 unless the
        # operator opts in (--allow-reload); never expose it on an
        # untrusted network
        self.allow_reload = allow_reload

    def health(self) -> Dict:
        dev = self.engine.device
        out = {
            "status": "ok",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
            "vault_loaded": self.engine.vault_loaded,
            "checkpoint_mode": self.engine.load_report.get("mode"),
            # hash-fallback tokenizers serve fine but are NOT score-
            # comparable to the reference — monitors should alert on this
            "tokenizer_parity": getattr(self.engine, "tokenizer_parity",
                                        False),
            "tokenizer_grades": getattr(self.engine, "tokenizer_grades", {}),
        }
        if self.warming is not None:
            out["warming"] = dict(self.warming)
        return out

    def start_background_warmup(self, transcriber: bool = False,
                                parallel: Optional[int] = None) -> None:
        """Serve-while-warming (VERDICT r4 #3): the caller has already
        warmed the default endpoint shapes synchronously; this fills the
        REST of the full signature grid from a background thread while
        the API serves traffic. A request that hits a not-yet-warmed
        signature makes its runner inline (an eager pass, then the CUDA
        graph's capture) — exactly the cost it would have paid with no
        warmup. /healthz reports {active, done, signatures, seconds}."""
        import time as _time

        state = {"active": True, "done": 0,
                 "started": round(_time.time(), 1)}
        self.warming = state

        def run():
            t0 = _time.monotonic()
            try:
                sigs = self.engine.warmup(
                    full_grid=True, parallel=parallel,
                    progress=lambda sig: state.__setitem__(
                        "done", state["done"] + 1))
                if transcriber and os.getenv("WHISPER_CHECKPOINT"):
                    from misinfo_tpu_torch.serve.transcript import \
                        warmup_transcriber
                    warmup_transcriber()
                state["signatures"] = len(sigs)
            except Exception as e:
                state["error"] = str(e)
            state["seconds"] = round(_time.monotonic() - t0, 1)
            state["active"] = False

        threading.Thread(target=run, daemon=True,
                         name="misinfo-bg-warmup").start()

    def metrics(self) -> Dict:
        """Serving counters from the structured tracer (SURVEY §5 metrics
        subsystem): cumulative per-stage seconds/counts, rolling-window
        p50/p95/p99 stage latencies, and the aggregate verdicts/sec since
        process start."""
        from misinfo_tpu_torch.utils.tracing import GLOBAL_TRACER

        summary = GLOBAL_TRACER.summary()
        out = {"verdicts_per_sec": round(summary.get("verdicts_per_sec",
                                                     0.0), 3)}
        for k, v in sorted(summary.items()):
            if k.endswith("_seconds") or k.endswith("_count") \
                    or k.endswith("_n_requests") or k.endswith("_ms"):
                out[k] = round(float(v), 6)
        try:
            out["memory"] = self.engine.memory_report()
        except Exception:
            pass
        try:
            # measured host image-prep ceiling + knob recommendation
            # (cached one-time probe)
            out["host_prep"] = self.engine.host_prep_report()
        except Exception:
            pass
        return out

    def analyze(self, req: Dict) -> Dict:
        return self.batcher.submit(_decode_request_image(req)).result()

    def analyze_batch(self, reqs) -> list:
        futures = [self.batcher.submit(_decode_request_image(r))
                   for r in reqs]
        return [f.result() for f in futures]

    def predict(self, req: Dict) -> Dict:
        """Dashboard contract (11 outputs) for the browser UI; rides the
        micro-batcher so UI clicks batch with concurrent REST traffic."""
        from misinfo_tpu_torch.serve.webui import predict_payload

        return predict_payload(req, engine=self.batcher)

    def reload_vault(self, req: Dict) -> Dict:
        """Hot vault refresh: `{"path"?, "drop_first"?}` (path defaults to
        re-reading the configured vault file; drop_first frees the old
        planes before staging — see engine.reload_vault). Disabled unless
        the server was started with --allow-reload."""
        if not self.allow_reload:
            raise PermissionError(
                "vault reload is disabled; start the API with "
                "--allow-reload to enable this mutation endpoint")
        return self.engine.reload_vault(
            path=req.get("path"),
            drop_first=bool(req.get("drop_first", False)))

    def close(self) -> None:
        self.batcher.close()


def _make_handler(api: ForensicsAPI):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload) -> None:
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send(200, api.health())
            elif self.path == "/metrics":
                self._send(200, api.metrics())
            elif self.path in ("/", "/index.html"):
                from misinfo_tpu_torch.serve.webui import INDEX_HTML

                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/analyze":
                    self._send(200, api.analyze(payload))
                elif self.path == "/analyze_batch":
                    self._send(200, api.analyze_batch(payload))
                elif self.path == "/predict":
                    self._send(200, api.predict(payload))
                elif self.path == "/reload_vault":
                    self._send(200, api.reload_vault(payload))
                else:
                    self._send(404, {"error": "unknown endpoint"})
            except ValueError as e:          # bad request (e.g. no modality)
                self._send(400, {"error": str(e)})
            except PermissionError as e:     # gated endpoint not enabled
                self._send(403, {"error": str(e)})
            except Exception as e:           # noqa: BLE001
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *args):   # quiet by default
            pass

    return Handler


def serve(api: ForensicsAPI, port: int = 8080,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the HTTP server on a background thread; returns the server
    (call .shutdown() to stop). Port 0 picks an ephemeral port."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(api))
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="misinfo-api")
    t.start()
    return httpd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Misinformation Forensics REST API")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--vault", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", choices=list(DEVICE_CHOICES), default="auto",
                   help="auto and cuda: the card (an error without one); "
                        "cpu: the CPU")
    p.add_argument("--mesh", default=None,
                   help="Serve over a device mesh: 'data=N[,model=M]' "
                        "(with --device cpu: that many CPU entries)")
    p.add_argument("--warmup", nargs="?", const="default",
                   choices=["default", "full", "background"], default=None,
                   help="Capture serving signatures as CUDA graphs before "
                        "accepting traffic (engine.warmup()); '--warmup "
                        "full' warms EVERY emittable signature so no "
                        "request shape is captured mid-flight; '--warmup "
                        "background' warms "
                        "the default endpoint shapes synchronously, opens "
                        "the API, and fills the rest of the full grid from "
                        "a background thread (serve-while-warming — "
                        "/healthz reports progress)")
    p.add_argument("--allow-reload", action="store_true",
                   help="Enable POST /reload_vault (a mutation endpoint "
                        "that reads operator-named files — only behind a "
                        "trusted network)")
    args = p.parse_args(argv)
    device, mesh = select(args.device, args.mesh)

    from misinfo_tpu_torch.core.config import ForensicsConfig

    cfg = ForensicsConfig.from_env(verbose=False)
    updates = {}
    if args.vault:
        updates["vault_path"] = args.vault
    if args.checkpoint:
        updates["orbax_dir"] = args.checkpoint
    if updates:
        import dataclasses
        cfg = cfg.replace(paths=dataclasses.replace(cfg.paths, **updates))
    api = ForensicsAPI(config=cfg, mesh=mesh,
                       allow_reload=args.allow_reload, device=device)
    if args.warmup:
        # all modes warm the default endpoint shapes before the socket
        # opens; "full" finishes the whole grid first, "background" fills
        # the remainder while serving (VERDICT r4 #3 serve-while-warming)
        api.engine.warmup(full_grid=args.warmup == "full")
        if args.warmup != "background" and os.getenv("WHISPER_CHECKPOINT"):
            from misinfo_tpu_torch.serve.transcript import warmup_transcriber
            warmup_transcriber()
        if args.warmup == "background":
            api.start_background_warmup(transcriber=True)
    httpd = serve(api, args.port, args.host)
    print(f"misinfo_tpu_torch API listening on "
          f"{args.host}:{httpd.server_address[1]}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        api.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
