"""Gradio forensics dashboard (C12/C14, reference forensics_dashboard.py),
over the port's engine.

Counterpart of ``misinfo_tpu/serve/dashboard.py``; the UI contract is the
same: image/caption/video inputs → verdict badge (HTML) + REAL/FAKE label,
five per-signal `gr.Label` scoreboards with N/A gating for missing
modalities, vault match gallery + metadata markdown, forensic report
markdown, transcript box, one example case, custom CSS, and the
port-conflict → ephemeral-port fallback (reference :557-578).

Score normalization matches C14: CLIP similarity maps [-1,1] → [0,1] via
(s+1)/2 (reference :222-223); the Whisper transcript is merged into the
caption as `caption + "\\n\\n" + transcript` when it isn't an error string
(reference :160-162).

The engine behind the UI is the port's batched engine on the card; the
host functions (``probs_label``, ``verdict_badge_html``,
``normalize_clip_similarity``, ``predict``, ``vault_gallery_and_metadata``)
also serve the gradio-free web UI (serve/webui.py).

gradio is an optional dependency; `main()` degrades with a clear message
when it is absent.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

try:
    import gradio as gr
    GRADIO_AVAILABLE = True
except ImportError:
    gr = None
    GRADIO_AVAILABLE = False

_engine = None


def get_engine():
    """Lazy module-global engine (reference :90-94), on the card — but
    requests batch."""
    global _engine
    if _engine is None:
        from misinfo_tpu_torch.engine.forensics import MisinfoForensics
        _engine = MisinfoForensics()
    return _engine


def probs_label(score: Optional[float], positive: str, negative: str) -> Dict:
    """Score → gr.Label dict; None → N/A gating (reference _probs :98-114)."""
    if score is None:
        return {"N/A (modality not provided)": 1.0}
    score = max(0.0, min(1.0, float(score)))
    return {positive: score, negative: 1.0 - score}


def verdict_badge_html(verdict_text: str, confidence: float) -> str:
    """Color-coded verdict badge (reference _verdict_badge_html :117-124)."""
    color = "#d93025" if verdict_text == "FAKE" else "#188038"
    return (f'<div class="verdict-badge" style="background:{color};color:#fff;'
            f'padding:14px 18px;border-radius:10px;font-size:1.4em;'
            f'font-weight:700;text-align:center">'
            f'{verdict_text} — {confidence:.1%} confidence</div>')


def normalize_clip_similarity(sim: float) -> float:
    """[-1,1] → [0,1] for the scoreboard (reference :222-223)."""
    return (float(sim) + 1.0) / 2.0


def predict(image_path, user_caption: str, video_path, engine=None):
    """Gradio callback → 11 UI outputs (reference predict :143-320).

    `engine` defaults to the module-global lazy engine (gradio wiring);
    the no-gradio web dashboard (serve/webui.py) injects the API server's
    BatchingEngine here so browser requests micro-batch with REST traffic.
    """
    from misinfo_tpu_torch.serve.transcript import extract_transcript

    user_caption = (user_caption or "").strip()
    transcript = extract_transcript(video_path) if video_path else ""
    combined = user_caption
    if transcript and not transcript.startswith("[transcript error"):
        combined = (combined + "\n\n" + transcript).strip()

    has_text = bool(combined)
    has_visual = bool(image_path) or bool(video_path)
    if not has_text and not has_visual:
        empty = probs_label(None, "", "")
        return ("<div>Provide a caption, image, or video.</div>", "N/A",
                empty, empty, empty, empty, empty, [], "", "", transcript)

    engine = engine if engine is not None else get_engine()
    report = engine.analyze(text=combined or None,
                            image_path=image_path,
                            video_path=video_path,
                            verbose=False)
    s = report["scores"]

    ai_lbl = probs_label(s["ai_score"] if has_text else None,
                         "AI-generated", "Human-written")
    mis_lbl = probs_label(s["misinfo_score"] if has_text else None,
                          "Misinformation", "Legitimate")
    deep_lbl = probs_label(s["deepfake_score"] if has_visual else None,
                           "Deepfake", "Authentic")
    clip_lbl = probs_label(
        normalize_clip_similarity(s["clip_similarity"])
        if (has_text and has_visual) else None,
        "Consistent", "Mismatched")
    vault_lbl = probs_label(s["vault_discrepancy"] if has_visual else None,
                            "Archive reuse", "Not in archive")

    gallery, vault_md = vault_gallery_and_metadata(
        report["vault_matches"], s, has_visual)

    report_md = (f"## Forensic report\n\n{report['explanation']}\n\n"
                 f"| signal | value |\n|---|---|\n"
                 f"| AI-generated | {s['ai_score']:.2%} |\n"
                 f"| Misinformation | {s['misinfo_score']:.2%} |\n"
                 f"| Deepfake | {s['deepfake_score']:.2%} |\n"
                 f"| CLIP consistency | {s['clip_similarity']:.4f} |\n"
                 f"| Vault discrepancy | {s['vault_discrepancy']:.2%} |")

    # output order mirrors the reference predict() return (reference
    # forensics_dashboard.py:290-302): gallery, forensic summary, vault
    # metadata, transcript
    return (verdict_badge_html(report["verdict_text"], report["confidence"]),
            report["verdict_text"], ai_lbl, mis_lbl, deep_lbl, clip_lbl,
            vault_lbl, gallery or None, report_md, vault_md, transcript)


def vault_gallery_and_metadata(vault_matches: List[Dict], scores: Dict,
                               has_visual: bool) -> Tuple[List, str]:
    """Gallery images + vault-metadata markdown, matching the reference's
    contract (forensics_dashboard.py:228-265): the top match's archive
    image (its `url` metadata is a local path when built by the vault
    builder) captioned with the similarity, plus the top-match detail
    block with the >0.85 recontextualization warning."""
    if not has_visual:
        return [], ("### Truth Vault Cross-Check\n\n**Skipped**\n\n"
                    "Upload an image or a video to enable archive matching.")
    if not vault_matches:
        return [], ("### Truth Vault Cross-Check\n\n"
                    "**No Archive Matches Found**\n\n"
                    "No image/video match found in the archive database.")
    top = vault_matches[0]
    gallery: List = []
    img_path = top.get("image_path") or top.get("url")
    if img_path and os.path.exists(str(img_path)):
        gallery = [(str(img_path), f"{top['similarity']:.1%} Match")]
    tsim = float(scores.get("text_similarity", 0.0))
    warning = ("⚠️ **Warning:** This image was previously used in a "
               "different context!" if top["similarity"] > 0.85
               else "✓ No significant archive matches found.")
    vault_md = (
        "### Truth Vault Cross-Check\n\n"
        "**Top Match Found:**\n"
        f"- **Original Headline:** \"{top['title']}\"\n"
        f"- **Image Similarity:** {top['similarity']:.1%}\n"
        f"- **Text Similarity:** {tsim:.1%}\n"
        f"- **Published:** {top.get('date', 'N/A')}\n"
        f"- **Semantic Mismatch:** {abs(tsim - top['similarity']):.1%}\n\n"
        f"{warning}")
    return gallery, vault_md


CSS = """
.verdict-badge { letter-spacing: 0.5px; }
.signal-box .label-name { font-weight: 600; }
footer { display: none !important; }
"""


def build_app():
    if not GRADIO_AVAILABLE:
        raise RuntimeError(
            "gradio is not installed; install it to serve the dashboard "
            "(the engine itself has no gradio dependency)")
    with gr.Blocks(css=CSS, title="Misinformation Forensics (GPU)") as demo:
        gr.Markdown("# Misinformation Forensics — GPU engine")
        with gr.Row():
            with gr.Column():
                image_in = gr.Image(type="filepath", label="Image")
                video_in = gr.Video(label="Video (optional)")
                caption_in = gr.Textbox(label="Caption / headline", lines=3)
                btn = gr.Button("Analyze", variant="primary")
            with gr.Column():
                badge = gr.HTML(label="Verdict")
                verdict_lbl = gr.Textbox(label="Verdict", interactive=False)
                ai_lbl = gr.Label(label="AI-text", elem_classes="signal-box")
                mis_lbl = gr.Label(label="Misinformation", elem_classes="signal-box")
                deep_lbl = gr.Label(label="Deepfake", elem_classes="signal-box")
                clip_lbl = gr.Label(label="Image-text consistency",
                                    elem_classes="signal-box")
                vault_lbl = gr.Label(label="Vault discrepancy",
                                     elem_classes="signal-box")
        gallery = gr.Gallery(label="Vault matches")
        report_md = gr.Markdown()
        vault_md = gr.Markdown()
        transcript_box = gr.Textbox(label="Video transcript", interactive=False)

        # ordering mirrors the reference's 11-output contract
        # (forensics_dashboard.py:290-302 / :510-526)
        outputs = [badge, verdict_lbl, ai_lbl, mis_lbl, deep_lbl, clip_lbl,
                   vault_lbl, gallery, report_md, vault_md, transcript_box]
        btn.click(predict, [image_in, caption_in, video_in], outputs)
        gr.Examples(
            examples=[[None, "Breaking: shocking footage shows event that "
                             "never happened", None]],
            inputs=[image_in, caption_in, video_in])
    return demo


def main():
    if not GRADIO_AVAILABLE:
        print("gradio is not installed — dashboard unavailable. "
              "The CLI (`python -m misinfo_tpu_torch.serve.cli`) and the web UI "
              "of the API (`python -m misinfo_tpu_torch.serve.api`) serve "
              "the same engine.")
        return 1
    wu = os.getenv("MISINFO_TPU_WARMUP", "0")
    if wu not in ("0", ""):
        # capture the serving grid as CUDA graphs (and the whisper
        # programs when a checkpoint is configured) before the first
        # request arrives — the dashboard keeps the reference's zero-flag
        # launch, so this rides an env var rather than argparse. "full" =
        # every signature (same as the CLI/API `--warmup full`)
        get_engine().warmup(full_grid=wu == "full")
        if os.getenv("WHISPER_CHECKPOINT"):
            from misinfo_tpu_torch.serve.transcript import warmup_transcriber
            warmup_transcriber()
    demo = build_app()
    port = int(os.getenv("GRADIO_SERVER_PORT", "7860"))
    try:
        demo.launch(server_port=port)
    except OSError:
        # port conflict → ephemeral rebind (reference :566-578)
        demo.launch(server_port=0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
