"""Dataset preparation pipelines (C22/C24/C25, SURVEY.md §2.4).

Host copy of ``misinfo_tpu/train/data_prep.py`` (numpy, pandas and the
standard library; held to the original by tests/test_torch_data_prep.py).
Its outputs feed the port's trainers:

* `harmonize_datasets` — C22 (reference data_manager.py): merges CIFAKE
  (placeholder text "Unlabeled image") + Fakeddit (TSV `2-class` column,
  image-existence check) into {text, image_path, label} dicts with a 50/50
  balanced sample; emits harmonized_train_data.pkl +
  newscippings_genuine_seed.json.
* `prepare_fusion_dataset` — C24 (reference prepare_fusion_dataset.py):
  mixes misinformation types into Final_Fusion_Train.csv (read by
  train/fusion_judge.py) — out-of-context pairs (clip_train mismatches)
  + real matched pairs, HC3 AI/human text × random guardian images,
  WELFake fake/real × random guardian images; 2:1 fake:real sampling per
  source, seed 42.
* `quick_fusion_prep` — C25 (reference quick_fusion_prep.py): first N rows
  of clip_train.csv → Final_Fusion_Train.csv.

    python -m misinfo_tpu_torch.train.data_prep fusion \\
        --clip-train clip_train.csv --hc3 hc3.csv --welfake welfake.csv
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np


def balanced_sample(items: List[Dict], n_per_label: int,
                    seed: int = 42) -> List[Dict]:
    """50/50 label balance (reference data_manager.py:23-34)."""
    rng = np.random.default_rng(seed)
    by_label: Dict[int, List[Dict]] = {}
    for it in items:
        by_label.setdefault(int(it["label"]), []).append(it)
    out: List[Dict] = []
    for label, group in sorted(by_label.items()):
        idx = rng.permutation(len(group))[:n_per_label]
        out.extend(group[i] for i in idx)
    rng.shuffle(out)
    return out


def load_cifake_items(cifake_root: str,
                      limit: Optional[int] = None) -> List[Dict]:
    """CIFAKE → items with placeholder text (reference data_manager.py:54-58)."""
    import glob

    items = []
    for sub, label in (("REAL", 0), ("FAKE", 1)):
        for split in ("train", "test"):
            for p in sorted(glob.glob(os.path.join(cifake_root, split, sub,
                                                   "*"))):
                items.append({"text": "Unlabeled image", "image_path": p,
                              "label": label})
                if limit and len(items) >= limit:
                    return items
    return items


def load_fakeddit_items(tsv_path: str, image_dir: str,
                        limit: Optional[int] = None) -> List[Dict]:
    """Fakeddit TSV with `2_way_label`/`2-class` column and image-existence
    check (reference data_manager.py:63-105)."""
    import pandas as pd

    df = pd.read_csv(tsv_path, sep="\t")
    label_col = next((c for c in ("2_way_label", "2-class", "label")
                      if c in df.columns), None)
    if label_col is None:
        raise ValueError(f"no 2-class label column in {tsv_path}")
    items = []
    for _, r in df.iterrows():
        img = os.path.join(image_dir, f"{r.get('id', '')}.jpg")
        if not os.path.exists(img):
            continue
        items.append({"text": str(r.get("clean_title", r.get("title", ""))),
                      "image_path": img, "label": int(r[label_col])})
        if limit and len(items) >= limit:
            break
    return items


def harmonize_datasets(cifake_root: Optional[str] = None,
                       fakeddit_tsv: Optional[str] = None,
                       fakeddit_images: Optional[str] = None,
                       n_per_label: int = 5000,
                       out_pkl: str = "harmonized_train_data.pkl",
                       out_seed_json: str = "newscippings_genuine_seed.json",
                       log=print) -> List[Dict]:
    items: List[Dict] = []
    if cifake_root and os.path.isdir(cifake_root):
        items += load_cifake_items(cifake_root)
    if fakeddit_tsv and os.path.exists(fakeddit_tsv):
        items += load_fakeddit_items(fakeddit_tsv, fakeddit_images or ".")
    sampled = balanced_sample(items, n_per_label) if items else []
    with open(out_pkl, "wb") as f:
        pickle.dump(sampled, f)
    genuine = [it for it in sampled if it["label"] == 0][:1000]
    with open(out_seed_json, "w", encoding="utf-8") as f:
        json.dump(genuine, f, indent=2)
    log(f"harmonized {len(sampled)} samples → {out_pkl}")
    return sampled


def prepare_fusion_dataset(clip_train_csv: str = "clip_train.csv",
                           hc3_csv: Optional[str] = None,
                           welfake_csv: Optional[str] = None,
                           out_csv: str = "Final_Fusion_Train.csv",
                           per_source_fake: int = 800, seed: int = 42,
                           log=print):
    """2:1 fake:real mix per source (reference prepare_fusion_dataset.py)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    rows = []

    clip_df = pd.read_csv(clip_train_csv)
    guardian_images = clip_df["image_path"].dropna().unique().tolist()

    def rand_image():
        return guardian_images[int(rng.integers(len(guardian_images)))] \
            if guardian_images else ""

    # out-of-context: mismatched pairs → FAKE; matched → REAL
    mism = clip_df[clip_df["label"] == 1]
    match = clip_df[clip_df["label"] == 0]
    for _, r in mism.head(per_source_fake).iterrows():
        rows.append({"text": r["text"], "image_path": r["image_path"],
                     "label": 1})
    for _, r in match.head(per_source_fake // 2).iterrows():
        rows.append({"text": r["text"], "image_path": r["image_path"],
                     "label": 0})

    # HC3: AI answers (fake) / human answers (real) × random guardian images
    if hc3_csv and os.path.exists(hc3_csv):
        hc3 = pd.read_csv(hc3_csv)
        ai_rows = hc3[hc3["label"] == 1].head(per_source_fake)
        hu_rows = hc3[hc3["label"] == 0].head(per_source_fake // 2)
        for _, r in ai_rows.iterrows():
            rows.append({"text": r["text"], "image_path": rand_image(),
                         "label": 1})
        for _, r in hu_rows.iterrows():
            rows.append({"text": r["text"], "image_path": rand_image(),
                         "label": 0})

    # WELFake: fake/real news × random guardian images
    if welfake_csv and os.path.exists(welfake_csv):
        wf = pd.read_csv(welfake_csv)
        fk = wf[wf["label"] == 1].head(per_source_fake)
        rl = wf[wf["label"] == 0].head(per_source_fake // 2)
        for _, r in fk.iterrows():
            rows.append({"text": r["text"], "image_path": rand_image(),
                         "label": 1})
        for _, r in rl.iterrows():
            rows.append({"text": r["text"], "image_path": rand_image(),
                         "label": 0})

    out = pd.DataFrame(rows).sample(frac=1.0, random_state=seed)
    out.to_csv(out_csv, index=False)
    log(f"fusion dataset: {len(out)} rows "
        f"({int((out['label'] == 1).sum())} fake) → {out_csv}")
    return out


def quick_fusion_prep(clip_train_csv: str = "clip_train.csv",
                      out_csv: str = "Final_Fusion_Train.csv",
                      n_rows: int = 800, log=print):
    """Shortcut prep (reference quick_fusion_prep.py:1-12)."""
    import pandas as pd

    df = pd.read_csv(clip_train_csv).head(n_rows)
    df.to_csv(out_csv, index=False)
    log(f"quick fusion prep: {len(df)} rows → {out_csv}")
    return df


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Dataset prep pipelines (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("harmonize")
    h.add_argument("--cifake-root")
    h.add_argument("--fakeddit-tsv")
    h.add_argument("--fakeddit-images")
    h.add_argument("--n-per-label", type=int, default=5000)
    f = sub.add_parser("fusion")
    f.add_argument("--clip-train", default="clip_train.csv")
    f.add_argument("--hc3")
    f.add_argument("--welfake")
    f.add_argument("--out", default="Final_Fusion_Train.csv")
    q = sub.add_parser("quick-fusion")
    q.add_argument("--clip-train", default="clip_train.csv")
    q.add_argument("--out", default="Final_Fusion_Train.csv")
    q.add_argument("--rows", type=int, default=800)
    args = p.parse_args(argv)
    if args.cmd == "harmonize":
        harmonize_datasets(args.cifake_root, args.fakeddit_tsv,
                           args.fakeddit_images, args.n_per_label)
    elif args.cmd == "fusion":
        prepare_fusion_dataset(args.clip_train, args.hc3, args.welfake,
                               args.out)
    elif args.cmd == "quick-fusion":
        quick_fusion_prep(args.clip_train, args.out, args.rows)


if __name__ == "__main__":
    main()
