"""Gradio-free browser dashboard for the misinfo forensics engine (C12),
over the port's engine: a copy of ``misinfo_tpu/serve/webui.py``.

The reference UI is a Gradio Blocks app (reference
forensics_dashboard.py:330-578) whose 11-output ``predict`` contract we
already mirror in serve/dashboard.py. gradio is not installable in every
deployment, so this module serves the same
dashboard as ONE static HTML page + a JSON ``POST /predict`` endpoint on
the stdlib REST API (serve/api.py) — zero extra dependencies, and every
browser click rides the micro-batching engine alongside REST traffic.

Surface contract (same field order as the gradio outputs, reference
forensics_dashboard.py:290-302):

    badge_html, verdict_text, labels.{ai,misinfo,deepfake,clip,vault},
    gallery[{image_b64, caption}], report_md, vault_md, transcript

Uploads arrive as base64 (``image_b64``/``video_b64``) and are spooled to
temp files so the identical dashboard ``predict()`` path — transcript
merge rule included (reference :160-162) — handles them.
"""

from __future__ import annotations

import base64
import os
import tempfile
from typing import Dict, Optional

from misinfo_tpu_torch.serve import dashboard as _dash

#: gr.Label-dict slots in predict()'s 11-tuple, keyed for JSON clients.
_LABEL_KEYS = ("ai", "misinfo", "deepfake", "clip", "vault")


def _spool(b64: str, suffix: str) -> str:
    """Write a base64 upload to a temp file; returns its path."""
    fd, path = tempfile.mkstemp(suffix=suffix, prefix="misinfo_ui_")
    with os.fdopen(fd, "wb") as f:
        f.write(base64.b64decode(b64))
    return path


def _inline_gallery(gallery) -> list:
    """(path, caption) gallery tuples → JSON-safe base64 image entries.

    The vault stores archive images as local paths (vault builder
    metadata); the browser can't fetch server paths, so the top-match
    image travels inline exactly once per predict call.
    """
    out = []
    for path, caption in (gallery or []):
        try:
            with open(path, "rb") as f:
                data = base64.b64encode(f.read()).decode()
        except OSError:
            continue
        ext = os.path.splitext(str(path))[1].lstrip(".").lower() or "jpeg"
        if ext == "jpg":
            ext = "jpeg"
        out.append({"image_b64": data, "mime": f"image/{ext}",
                    "caption": caption})
    return out


def predict_payload(req: Dict, engine=None) -> Dict:
    """Run the dashboard predict() contract for a JSON request.

    req keys: ``text`` (str), ``image_b64``/``image_path``,
    ``video_b64``/``video_path`` (+ optional ``video_name`` to pick the
    temp-file suffix). Returns the 11 outputs as a JSON-ready dict.
    """
    tmp_paths = []
    image_path: Optional[str] = req.get("image_path")
    video_path: Optional[str] = req.get("video_path")
    try:
        if req.get("image_b64"):
            image_path = _spool(req["image_b64"], ".png")
            tmp_paths.append(image_path)
        if req.get("video_b64"):
            suffix = os.path.splitext(req.get("video_name", ""))[1] or ".mp4"
            video_path = _spool(req["video_b64"], suffix)
            tmp_paths.append(video_path)

        (badge_html, verdict_text, ai_lbl, mis_lbl, deep_lbl, clip_lbl,
         vault_lbl, gallery, report_md, vault_md, transcript) = \
            _dash.predict(image_path, req.get("text") or "", video_path,
                          engine=engine)
    finally:
        for p in tmp_paths:
            try:
                os.unlink(p)
            except OSError:
                pass

    labels = dict(zip(_LABEL_KEYS,
                      (ai_lbl, mis_lbl, deep_lbl, clip_lbl, vault_lbl)))
    return {
        "badge_html": badge_html,
        "verdict_text": verdict_text,
        "labels": labels,
        "gallery": _inline_gallery(gallery),
        "report_md": report_md,
        "vault_md": vault_md,
        "transcript": transcript,
    }


# --------------------------------------------------------------------- UI
# Single-hue meters for the five magnitude signals (text labels carry the
# identity; color never does). Status red/green appears ONLY on the
# verdict badge, where the reference fixes the exact colors
# (forensics_dashboard.py via dashboard.verdict_badge_html).

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Misinformation Forensics — GPU engine</title>
<style>
  :root {
    --ink: #1a1c20; --ink-2: #5f6672; --ink-3: #8a919e;
    --surface: #f6f7f9; --card: #ffffff; --line: #e3e6ea;
    --meter: #5874a6; --meter-track: #e9ecf1;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      --ink: #e8eaed; --ink-2: #aab1bc; --ink-3: #7d8490;
      --surface: #17191d; --card: #1f2228; --line: #32363e;
      --meter: #7b97c9; --meter-track: #2a2e36;
    }
  }
  * { box-sizing: border-box; }
  body { margin: 0; background: var(--surface); color: var(--ink);
         font: 15px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif; }
  header { padding: 18px 24px 10px; }
  header h1 { margin: 0; font-size: 1.25em; font-weight: 700; }
  #health { color: var(--ink-3); font-size: 0.85em; margin-top: 4px; }
  main { display: grid; grid-template-columns: minmax(280px, 420px) 1fr;
         gap: 16px; padding: 8px 24px 32px; align-items: start; }
  @media (max-width: 860px) { main { grid-template-columns: 1fr; } }
  .card { background: var(--card); border: 1px solid var(--line);
          border-radius: 10px; padding: 16px; }
  label { display: block; font-weight: 600; font-size: 0.9em;
          margin: 12px 0 4px; color: var(--ink-2); }
  textarea, input[type=file] { width: 100%; font: inherit; color: var(--ink); }
  textarea { background: var(--card); border: 1px solid var(--line);
             border-radius: 6px; padding: 8px; resize: vertical; }
  #preview { max-width: 100%; max-height: 180px; border-radius: 6px;
             margin-top: 6px; display: none; }
  button { margin-top: 16px; width: 100%; padding: 10px; font: inherit;
           font-weight: 700; color: #fff; background: var(--meter);
           border: 0; border-radius: 8px; cursor: pointer; }
  button:disabled { opacity: 0.55; cursor: wait; }
  #results > .card { margin-bottom: 16px; }
  .meter-row { display: grid; grid-template-columns: 200px 1fr 56px;
               gap: 10px; align-items: center; margin: 8px 0; }
  .meter-name { font-size: 0.9em; color: var(--ink-2); }
  .meter-name .muted { display: block; font-size: 0.82em; }
  .meter-track { height: 10px; border-radius: 5px;
                 background: var(--meter-track); overflow: hidden; }
  .meter-fill { height: 100%; border-radius: 5px; background: var(--meter);
                transition: width 0.25s; }
  .meter-val { font-variant-numeric: tabular-nums; text-align: right;
               font-size: 0.9em; color: var(--ink); }
  .meter-na { color: var(--ink-3); font-size: 0.85em; grid-column: 2 / 4; }
  .gallery { display: flex; gap: 12px; flex-wrap: wrap; }
  .gallery figure { margin: 0; }
  .gallery img { max-height: 160px; border-radius: 6px;
                 border: 1px solid var(--line); }
  .gallery figcaption { font-size: 0.85em; color: var(--ink-2);
                        margin-top: 4px; }
  .md h2, .md h3 { margin: 0.4em 0; }
  .md table { border-collapse: collapse; margin: 8px 0; }
  .md td, .md th { border: 1px solid var(--line); padding: 4px 10px;
                   font-size: 0.9em; }
  .md th { color: var(--ink-2); text-align: left; }
  pre#transcript { white-space: pre-wrap; background: var(--surface);
                   border-radius: 6px; padding: 10px; min-height: 1.4em;
                   color: var(--ink-2); }
  #error { color: #d93025; font-weight: 600; margin-top: 10px; }
  .muted { color: var(--ink-3); }
</style>
</head>
<body>
<header>
  <h1>Misinformation Forensics — GPU engine</h1>
  <div id="health" class="muted">connecting…</div>
</header>
<main>
  <section class="card">
    <label for="caption">Caption / headline</label>
    <textarea id="caption" rows="4"
      placeholder="Breaking: shocking footage shows event that never happened"></textarea>
    <label for="image">Image</label>
    <input type="file" id="image" accept="image/*">
    <img id="preview" alt="">
    <label for="video">Video (optional)</label>
    <input type="file" id="video" accept="video/*">
    <button id="analyze">Analyze</button>
    <div id="error"></div>
  </section>
  <section id="results">
    <div class="card" id="badge-card">
      <div id="badge" class="muted">Provide a caption, image, or video,
        then press Analyze.</div>
    </div>
    <div class="card">
      <h3 style="margin-top:0">Signals</h3>
      <div id="meters"></div>
    </div>
    <div class="card"><h3 style="margin-top:0">Vault matches</h3>
      <div class="gallery" id="gallery"><span class="muted">—</span></div>
      <div class="md" id="vault-md"></div>
    </div>
    <div class="card"><div class="md" id="report-md"><span class="muted">
      Forensic report appears here.</span></div></div>
    <div class="card"><h3 style="margin-top:0">Video transcript</h3>
      <pre id="transcript"></pre></div>
  </section>
</main>
<script>
"use strict";
const $ = id => document.getElementById(id);

fetch("/healthz").then(r => r.json()).then(h => {
  $("health").textContent =
    `device ${h.device} · checkpoint ${h.checkpoint_mode}` +
    ` · tokenizer parity ${h.tokenizer_parity ? "full" : "degraded"}` +
    ` · vault ${h.vault_loaded ? "loaded" : "absent"}`;
}).catch(() => { $("health").textContent = "health check failed"; });

$("image").addEventListener("change", () => {
  const f = $("image").files[0];
  const img = $("preview");
  if (!f) { img.style.display = "none"; return; }
  img.src = URL.createObjectURL(f);
  img.style.display = "block";
});

function fileB64(input) {
  const f = input.files[0];
  if (!f) return Promise.resolve(null);
  return new Promise((res, rej) => {
    const r = new FileReader();
    r.onload = () => res({name: f.name,
                          b64: r.result.split(",", 2)[1]});
    r.onerror = rej;
    r.readAsDataURL(f);
  });
}

// Minimal markdown (headers, bold, tables, list items, line breaks) for
// the report/vault blocks — enough for the engine's templated output.
function esc(s) {
  return s.replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;");
}
function mdToHtml(md) {
  const lines = esc(md || "").split("\\n");
  const out = [];
  let table = null;
  const flush = () => {
    if (table) { out.push("<table>" + table.join("") + "</table>"); table = null; }
  };
  for (const raw of lines) {
    const line = raw.trimEnd();
    if (/^\\|.*\\|$/.test(line.trim())) {
      const cells = line.trim().slice(1, -1).split("|").map(c => c.trim());
      if (cells.every(c => /^:?-{2,}:?$/.test(c))) continue;  // separator row
      const tag = table ? "td" : "th";
      table = table || [];
      table.push("<tr>" + cells.map(c => `<${tag}>${inline(c)}</${tag}>`).join("") + "</tr>");
      continue;
    }
    flush();
    if (!line) continue;
    const h = line.match(/^(#{1,4})\\s+(.*)$/);
    if (h) { out.push(`<h${h[1].length + 1}>${inline(h[2])}</h${h[1].length + 1}>`); continue; }
    if (/^[-*]\\s+/.test(line)) { out.push(`<div>• ${inline(line.replace(/^[-*]\\s+/, ""))}</div>`); continue; }
    out.push(`<p>${inline(line)}</p>`);
  }
  flush();
  return out.join("");
}
function inline(s) {
  return s.replace(/\\*\\*([^*]+)\\*\\*/g, "<b>$1</b>");
}

const METERS = [
  ["ai", "AI-text"], ["misinfo", "Misinformation"], ["deepfake", "Deepfake"],
  ["clip", "Image-text consistency"], ["vault", "Vault discrepancy"],
];

function renderMeters(labels) {
  const rows = [];
  for (const [key, title] of METERS) {
    const lbl = labels[key] || {};
    const names = Object.keys(lbl);
    const na = names.length === 1 && names[0].startsWith("N/A");
    // positive class first (dashboard probs_label contract)
    const sub = na ? "" :
      `<span class="muted">${esc(names[0])} vs ${esc(names[1] || "")}</span>`;
    rows.push(`<div class="meter-row">` +
              `<span class="meter-name">${title}${sub}</span>`);
    if (na) {
      rows.push(`<span class="meter-na">N/A (modality not provided)</span>`);
    } else {
      const v = lbl[names[0]];
      rows.push(`<div class="meter-track"><div class="meter-fill" ` +
                `style="width:${(100 * v).toFixed(1)}%"></div></div>` +
                `<span class="meter-val">${(100 * v).toFixed(1)}%</span>`);
    }
    rows.push("</div>");
  }
  $("meters").innerHTML = rows.join("");
}

function renderGallery(items) {
  if (!items.length) {
    $("gallery").innerHTML = '<span class="muted">—</span>';
    return;
  }
  $("gallery").innerHTML = items.map(g =>
    `<figure><img src="data:${g.mime};base64,${g.image_b64}" alt="">` +
    `<figcaption>${esc(g.caption)}</figcaption></figure>`).join("");
}

$("analyze").addEventListener("click", async () => {
  const btn = $("analyze");
  btn.disabled = true;
  $("error").textContent = "";
  try {
    const [img, vid] = await Promise.all([fileB64($("image")), fileB64($("video"))]);
    const req = {text: $("caption").value};
    if (img) req.image_b64 = img.b64;
    if (vid) { req.video_b64 = vid.b64; req.video_name = vid.name; }
    const resp = await fetch("/predict", {
      method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify(req),
    });
    const body = await resp.json();
    if (!resp.ok) throw new Error(body.error || resp.statusText);
    $("badge").innerHTML = body.badge_html;
    renderMeters(body.labels);
    renderGallery(body.gallery);
    $("vault-md").innerHTML = mdToHtml(body.vault_md);
    $("report-md").innerHTML = mdToHtml(body.report_md);
    $("transcript").textContent = body.transcript || "";
  } catch (e) {
    $("error").textContent = String(e.message || e);
  } finally {
    btn.disabled = false;
  }
});
</script>
</body>
</html>
"""
