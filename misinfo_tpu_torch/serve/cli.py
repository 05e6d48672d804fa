"""CLI entry over the port's engine — flag-compatible with the reference's
`main` (C11, reference misinfo_forensics.py:930-966): --text/--image/
--video/--gemini-key/--output, requiring at least one modality, with an
optional JSON dump of the report. Adds --batch-file for the batched path.

Counterpart of ``misinfo_tpu/serve/cli.py``. ``--device`` is ``auto`` or
``cuda`` (the card; they raise without one) or ``cpu``, for the engine and
the transcriber alike. ``--mesh data=N[,model=M]`` serves over a device
mesh of the visible cards (or, with ``--device cpu``, of that many CPU
entries) and shards the transcriber alongside. ``--checkpoint`` names a native checkpoint directory
(checkpoints/io.py: the trainers' output, or the JAX package's saved
without orbax), which comes before the reference ``.pth`` files in
``ModelPaths`` (the working directory), as in JAX.

    python -m misinfo_tpu_torch.serve.cli --text "some claim" --image a.jpg
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from misinfo_tpu_torch.serve.device import DEVICE_CHOICES, select


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Misinformation Forensics Analysis (GPU)")
    p.add_argument("--text", type=str, help="News headline or article text")
    p.add_argument("--image", type=str, help="Path to image file")
    p.add_argument("--video", type=str, help="Path to video file")
    p.add_argument("--gemini-key", type=str,
                   help="Google Gemini API key (optional, reads from env)")
    p.add_argument("--output", type=str, help="Save results to JSON file")
    p.add_argument("--batch-file", type=str,
                   help="JSONL of {text?, image?, video?} requests (batched path)")
    p.add_argument("--vault", type=str, default=None, help="Vault path override")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Native checkpoint dir (as saved by the trainers; "
                        "takes precedence over the torch .pth cascade)")
    p.add_argument("--device", choices=list(DEVICE_CHOICES), default="auto",
                   help="auto and cuda: the card (an error without one); "
                        "cpu: the CPU")
    p.add_argument("--mesh", type=str, default=None,
                   help="Serve over a device mesh: 'data=N[,model=M]' "
                        "(with --device cpu: that many CPU entries)")
    p.add_argument("--warmup", nargs="?", const="default",
                   choices=["default", "full"], default=None,
                   help="Capture serving signatures as CUDA graphs before "
                        "handling requests (engine.warmup()). Bare --warmup "
                        "warms the endpoint shapes; '--warmup full' warms "
                        "EVERY signature the engine can emit (batch × text "
                        "× packed-row grid)")
    p.add_argument("--transcribe", action="store_true",
                   help="Extract the video's audio transcript (Whisper, "
                        "WHISPER_CHECKPOINT env) and merge it into the text "
                        "before analysis — the dashboard's caption-merge "
                        "rule (reference forensics_dashboard.py:160-162); "
                        "the reference CLI itself never transcribes, so "
                        "this is opt-in")
    p.add_argument("--quiet", action="store_true")
    return p


def merge_transcript(text, video_path):
    """Dashboard merge rule — shared helper in serve/transcript.py."""
    from misinfo_tpu_torch.serve.transcript import merge_into_caption

    return merge_into_caption(text, video_path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.text or args.image or args.video or args.batch_file):
        build_parser().error("Provide at least one of --text, --image, --video, or --batch-file")
    device, mesh = select(args.device, args.mesh)

    from misinfo_tpu_torch.core.config import ForensicsConfig
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics

    cfg = ForensicsConfig.from_env(verbose=not args.quiet)
    if args.gemini_key:
        cfg = cfg.replace(gemini_api_key=args.gemini_key)
    if args.vault:
        cfg = cfg.replace(paths=cfg.paths.__class__(
            **{**cfg.paths.__dict__, "vault_path": args.vault}))
    if args.checkpoint:
        cfg = cfg.replace(paths=cfg.paths.__class__(
            **{**cfg.paths.__dict__, "orbax_dir": args.checkpoint}))

    engine = MisinfoForensics(config=cfg, device=device, mesh=mesh)
    if args.warmup:
        engine.warmup(full_grid=args.warmup == "full")
        if os.getenv("WHISPER_CHECKPOINT"):
            from misinfo_tpu_torch.serve.transcript import warmup_transcriber
            warmup_transcriber()

    if args.batch_file:
        with open(args.batch_file, encoding="utf-8") as f:
            requests = [json.loads(line) for line in f if line.strip()]
        if args.transcribe:
            for r in requests:
                r["text"] = merge_transcript(r.get("text"), r.get("video"))
        # pipelined: batch N+1's host prep overlaps batch N's device run
        results = list(engine.analyze_stream(requests, explanations=True))
    else:
        text = (merge_transcript(args.text, args.video)
                if args.transcribe else args.text)
        results = engine.analyze(text=text, image_path=args.image,
                                 video_path=args.video,
                                 verbose=not args.quiet)

    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2, ensure_ascii=False)
        if not args.quiet:
            print(f"Results saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
