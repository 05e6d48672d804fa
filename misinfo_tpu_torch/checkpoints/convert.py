"""One-time checkpoint converter: reference ``.pth`` assets → a native
checkpoint directory (checkpoints/io.py's layout, which both packages
read).

Counterpart of ``misinfo_tpu/checkpoints/convert.py``. The engine reads
the reference's ``.pth`` files itself through the loading cascade
(torch_convert.load_detector_from_reference_ckpts); this CLI runs that
cascade once and saves the result, so that serving pays the torch parse
once:

    python -m misinfo_tpu_torch.checkpoints.convert --assets . --out ckpt/
    python -m misinfo_tpu_torch.serve.cli --checkpoint ckpt/ --text "..."

    python -m misinfo_tpu_torch.checkpoints.convert --whisper base.pt \\
        --out wck/
    WHISPER_CHECKPOINT=wck/ python -m misinfo_tpu_torch.serve.dashboard

Whisper inputs may be HF torch files or openai-whisper's format; the
architecture is read from the checkpoint's own tensor shapes and written
into metadata.json (``whisper_config``), so the directory loads without
any ambient config. Conversion is host work: it runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
from typing import Optional


def convert_detector(assets_dir: str, out_dir: str, det_cfg=None) -> dict:
    """Run the reference loading cascade over the .pth files in
    ``assets_dir`` and save the detector tree natively. ``det_cfg``
    defaults to the full-size DetectorConfig."""
    from misinfo_tpu_torch.checkpoints.io import save_checkpoint
    from misinfo_tpu_torch.checkpoints.torch_convert import (
        load_detector_from_reference_ckpts)
    from misinfo_tpu_torch.core.config import ModelPaths
    from misinfo_tpu_torch.models.detector import (
        DetectorConfig, detector_init)

    paths = ModelPaths()
    overrides = {
        f.name: os.path.join(assets_dir,
                             os.path.basename(getattr(paths, f.name)))
        for f in dataclasses.fields(paths)
        if f.name.endswith("_weights")
    }
    paths = dataclasses.replace(paths, **overrides)
    params = detector_init(0, det_cfg if det_cfg is not None
                           else DetectorConfig())
    report = load_detector_from_reference_ckpts(params, paths)
    if not report.get("applied"):
        # a converter that persists pure random init as a "converted"
        # production artifact is worse than failing
        raise SystemExit(
            f"no reference .pth weights found/applied under {assets_dir} "
            f"(mode={report.get('mode')}); refusing to save a random-init "
            f"checkpoint")
    save_checkpoint(out_dir, params, metadata={
        "source": "reference-pth-cascade",
        "assets_dir": os.path.abspath(assets_dir),
        "load_mode": report.get("mode"),
        "applied": report.get("applied"),
        "skipped": len(report.get("skipped", [])),
    })
    return report


def convert_whisper_file(pth: str, out_dir: str,
                         tokenizer_dir: Optional[str] = None) -> dict:
    """HF / openai-whisper torch file → native dir with a self-describing
    ``whisper_config`` in metadata.json (the layout the transcriber
    loads)."""
    from misinfo_tpu_torch.checkpoints.io import save_checkpoint
    from misinfo_tpu_torch.checkpoints.torch_convert import (
        apply_updates, convert_whisper, whisper_config_from_torch,
        whisper_state_dict)
    from misinfo_tpu_torch.models.whisper import WhisperConfig, whisper_init
    from misinfo_tpu_torch.preprocess.whisper_tokenizer import (
        specials_for_vocab)

    sd = whisper_state_dict(pth)
    kw = whisper_config_from_torch(sd)
    if not kw:
        raise SystemExit(f"{pth}: no whisper decoder found in state dict")
    sp = specials_for_vocab(kw["vocab_size"])
    kw.setdefault("eos_token_id", sp.eot)
    kw.setdefault("decoder_start_token_id", sp.sot)
    cfg = WhisperConfig(**kw)
    params = whisper_init(0, cfg)
    applied, skipped = apply_updates(params, convert_whisper(sd))
    meta = {"source": os.path.abspath(pth),
            "whisper_config": dataclasses.asdict(cfg),
            "applied": applied, "skipped": len(skipped)}
    save_checkpoint(out_dir, params, metadata=meta)
    if tokenizer_dir:
        # bundle the vocab so the dir is self-contained (the transcriber
        # looks for <ckpt>/tokenizer first). A partial bundle is worse than
        # none: <ckpt>/tokenizer shadows WHISPER_TOKENIZER at load time
        srcs = {name: os.path.join(tokenizer_dir, name)
                for name in ("vocab.json", "merges.txt")}
        missing = [n for n, s in srcs.items() if not os.path.isfile(s)]
        if missing:
            raise SystemExit(
                f"--tokenizer {tokenizer_dir}: missing {', '.join(missing)} "
                f"(both vocab.json and merges.txt are required); not "
                f"bundling a partial tokenizer")
        dst = os.path.join(out_dir, "tokenizer")
        os.makedirs(dst, exist_ok=True)
        for name, src in srcs.items():
            shutil.copy(src, os.path.join(dst, name))
    return meta


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert reference .pth checkpoints to a native dir")
    p.add_argument("--out", required=True, help="Output checkpoint dir")
    p.add_argument("--assets", default=".",
                   help="Dir holding the reference .pth files "
                        "(forensics_master_final.pth / per-branch files)")
    p.add_argument("--whisper", default=None,
                   help="Convert a whisper torch file (HF or openai-whisper "
                        "format) instead of the detector cascade")
    p.add_argument("--tokenizer", default=None,
                   help="Vocab dir to bundle into <out>/tokenizer "
                        "(whisper mode)")
    p.add_argument("--device", choices=["cpu", "auto"], default="cpu",
                   help="accepted as the JAX CLI's flag; conversion is "
                        "host work and runs on the CPU either way")
    args = p.parse_args(argv)

    if args.whisper:
        meta = convert_whisper_file(args.whisper, args.out, args.tokenizer)
        print(json.dumps({"out": args.out, **{k: meta[k] for k in
                                              ("applied", "skipped")}}))
    else:
        report = convert_detector(args.assets, args.out)
        print(json.dumps({"out": args.out, "mode": report.get("mode"),
                          "applied": report.get("applied"),
                          "skipped": len(report.get("skipped", []))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
