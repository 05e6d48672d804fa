"""Model asset downloader + verifier (C27, reference model_download.py):
a copy of ``misinfo_tpu/serve/download.py`` (it imports no JAX).

The reference's 8-line script downloads `meta-llama/Llama-3.1-8B` and is
used nowhere else (SURVEY.md §2.4 'vestigial'). This module bootstraps the
assets the engine actually consumes — tokenizer vocab files for RoBERTa,
CLIP and Whisper — and VERIFIES them structurally (vocab size, special
tokens, merge count), so that a truncated or wrong-model file is caught at
bootstrap instead of silently degrading scores. ``download_assets`` needs
``huggingface_hub`` and the network; without them it prints what it would
fetch, and the engine serves with the hash-fallback tokenizer and says so
in its banner, `load_report`, and `/healthz` (`tokenizer_parity: false`)
— functional, but NOT score-comparable to the reference.

    python -m misinfo_tpu_torch.serve.download --verify-only --out models
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

ASSETS = {
    "roberta-base": ["vocab.json", "merges.txt"],
    "openai/clip-vit-base-patch32": ["vocab.json", "merges.txt"],
    "openai/whisper-base": ["vocab.json", "merges.txt"],
}

# structural expectations per asset dir (local name → checks): exact vocab
# entry count of the published tokenizers, required special tokens, and a
# minimum merge-rule count. Content hashes are intentionally NOT pinned —
# the published files have several byte-equivalent re-serializations; the
# structural contract is what the BPE encoders actually depend on.
# Whisper accepts BOTH published layouts: the multilingual vocab.json
# (50258 entries, <|endoftext|> at 50257) and the English-only GPT-2 vocab
# (50257 entries, <|endoftext|> at 50256); either way the eot token must
# be present and LAST — that is the anchor whisper_tokenizer.py derives
# the whole special block from.
EXPECTED = {
    "roberta-base": dict(vocab_size=(50265,), merges_min=49000,
                         specials=("<s>", "<pad>", "</s>", "<unk>")),
    "clip-vit-base-patch32": dict(vocab_size=(49408,), merges_min=48000,
                                  specials=("<|startoftext|>",
                                            "<|endoftext|>")),
    "whisper-base": dict(vocab_size=(50257, 50258), merges_min=49000,
                         specials=("<|endoftext|>",), eot_last=True),
}


def verify_assets(asset_dir: str, name: Optional[str] = None,
                  log=print) -> Tuple[bool, List[str]]:
    """Structural verification of a tokenizer asset directory.

    ``name`` selects the EXPECTED entry (defaults to the directory's
    basename). Returns (ok, problems)."""
    name = name or os.path.basename(os.path.normpath(asset_dir))
    exp = EXPECTED.get(name)
    problems: List[str] = []
    vocab_path = os.path.join(asset_dir, "vocab.json")
    merges_path = os.path.join(asset_dir, "merges.txt")
    if not os.path.exists(vocab_path):
        return False, [f"missing {vocab_path}"]
    if not os.path.exists(merges_path):
        return False, [f"missing {merges_path}"]
    try:
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
    except Exception as e:
        return False, [f"unreadable vocab.json: {e}"]
    with open(merges_path, encoding="utf-8") as f:
        merges = [ln for ln in f.read().split("\n")
                  if ln.strip() and not ln.startswith("#version")]
    if exp:
        sizes = exp["vocab_size"]
        if len(vocab) not in sizes:
            problems.append(f"vocab has {len(vocab)} entries, expected "
                            + " or ".join(str(s) for s in sizes))
        if len(merges) < exp["merges_min"]:
            problems.append(f"only {len(merges)} merge rules, expected ≥ "
                            f"{exp['merges_min']}")
        for s in exp["specials"]:
            if s not in vocab:
                problems.append(f"special token {s!r} missing from vocab")
        if exp.get("eot_last") and vocab.get("<|endoftext|>") not in (
                None, len(vocab) - 1):
            # (None already reported above as a missing special)
            problems.append(
                f"<|endoftext|> at id {vocab['<|endoftext|>']}, expected "
                f"{len(vocab) - 1} (must be the LAST vocab entry — the "
                "special-block anchor)")
    else:
        if len(vocab) < 100 or len(merges) < 100:
            problems.append("vocab/merges implausibly small")
    ok = not problems
    if not ok:
        for p in problems:
            log(f"  {name}: {p}")
    return ok, problems


def verify_all(out_root: str = "models", log=print) -> Dict[str, bool]:
    """Verify every known asset directory under ``out_root``."""
    results: Dict[str, bool] = {}
    for repo in ASSETS:
        local = repo.split("/")[-1]
        d = os.path.join(out_root, local)
        if os.path.isdir(d):
            ok, _ = verify_assets(d, local, log=log)
            results[local] = ok
            log(f"{d}: {'OK' if ok else 'FAILED verification'}")
        else:
            results[local] = False
            log(f"{d}: absent (engine will use the hash-fallback tokenizer "
                "— functional, NOT score-comparable)")
    return results


def download_assets(out_root: str = "models", repo: Optional[str] = None,
                    log=print, verify: bool = True) -> bool:
    """Fetch tokenizer assets via huggingface_hub when network access
    exists, then verify them; returns False (with instructions) otherwise."""
    targets = {repo: ASSETS.get(repo, ["vocab.json", "merges.txt"])} \
        if repo else ASSETS
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        log("huggingface_hub not installed; place these files manually:")
        for r, files in targets.items():
            log(f"  {out_root}/{r.split('/')[-1]}/: {', '.join(files)}")
        return False
    ok = True
    for r, files in targets.items():
        dest = os.path.join(out_root, r.split("/")[-1])
        os.makedirs(dest, exist_ok=True)
        for fn in files:
            try:
                p = hf_hub_download(r, fn)
                import shutil
                shutil.copy(p, os.path.join(dest, fn))
                log(f"fetched {r}/{fn}")
            except Exception as e:
                log(f"could not fetch {r}/{fn}: {e}")
                ok = False
        if verify and ok:
            vok, _ = verify_assets(dest, log=log)
            ok = ok and vok
    return ok


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(
        description="Download + verify tokenizer assets")
    p.add_argument("--out", default="models")
    p.add_argument("--repo", default=None)
    p.add_argument("--verify-only", action="store_true",
                   help="verify existing assets without fetching")
    args = p.parse_args()
    if args.verify_only:
        res = verify_all(args.out)
        raise SystemExit(0 if all(res.values()) else 1)
    download_assets(args.out, args.repo)
