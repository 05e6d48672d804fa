"""Guardian archive preprocessing pipeline (C23, reference
fast_prep_guardian.py).

Host copy of ``misinfo_tpu/train/guardian_prep.py`` (numpy, pandas, PIL
and the standard library; held to the original by
tests/test_torch_data_prep.py). Pipeline preserved: scrape a local
Guardian HTML archive — title via og:title with h1 fallback, image via a
5-strategy cascade (og:image → twitter:image → link rel=image_src →
largest article <img> → first <img>, reference :84-140) — download
images concurrently (ThreadPoolExecutor, reference :213), resize to 224
LANCZOS + JPEG q95 (reference :142-180), emit leak-free 80/20
`clip_train.csv`/`clip_val.csv` with one matched + one mismatched pair per
image (reference :236-325; read by train/clip_detective.py) and
`vector_db_seed.json` (reference :327-342; read by
``clip_detective.build_vault``).

requests/beautifulsoup4 are optional (imported at use): without bs4 the
title and og:image come from a regex fallback, and local-file archives
need no network.

    python -m misinfo_tpu_torch.train.guardian_prep --archive-dir archive/
"""

from __future__ import annotations

import json
import os
import random
import re
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional, Tuple


def extract_article(html: str) -> Tuple[Optional[str], Optional[str]]:
    """→ (title, image_url) with the reference's fallback cascade."""
    try:
        from bs4 import BeautifulSoup
    except ImportError:
        return _extract_article_regex(html)

    soup = BeautifulSoup(html, "html.parser")
    title = None
    og_title = soup.find("meta", property="og:title")
    if og_title and og_title.get("content"):
        title = og_title["content"].strip()
    if not title:
        h1 = soup.find("h1")
        if h1:
            title = h1.text.strip()

    image_url = None
    og_image = soup.find("meta", property="og:image")
    if og_image and og_image.get("content"):
        image_url = og_image["content"]
    if not image_url:
        tw = soup.find("meta", attrs={"name": "twitter:image"})
        if tw and tw.get("content"):
            image_url = tw["content"]
    if not image_url:
        link = soup.find("link", rel="image_src")
        if link and link.get("href"):
            image_url = link["href"]
    if not image_url:
        best = None
        for img in soup.find_all("img"):
            src = img.get("src")
            if not src:
                continue
            try:
                w = int(img.get("width", 0))
            except (TypeError, ValueError):
                w = 0
            if w >= 300:
                image_url = src
                break
            if best is None:
                best = src
        if not image_url:
            image_url = best
    return title, image_url


def _extract_article_regex(html: str):
    """bs4-free fallback using regex (good enough for og:* meta tags)."""

    def meta(prop):
        m = re.search(
            rf'<meta[^>]+(?:property|name)=["\']{prop}["\'][^>]+content=["\']([^"\']+)',
            html)
        if not m:
            m = re.search(
                rf'<meta[^>]+content=["\']([^"\']+)["\'][^>]+(?:property|name)=["\']{prop}["\']',
                html)
        return m.group(1).strip() if m else None

    title = meta("og:title")
    if not title:
        m = re.search(r"<h1[^>]*>([^<]+)</h1>", html)
        title = m.group(1).strip() if m else None
    return title, meta("og:image")


def fetch_and_save_image(image_url: str, out_path: str, size: int = 224,
                         retries: int = 2) -> bool:
    """Download (or copy local file) + resize LANCZOS + JPEG q95
    (reference :142-180)."""
    from PIL import Image

    data = None
    if os.path.exists(image_url):
        with open(image_url, "rb") as f:
            data = f.read()
    else:
        try:
            import requests
        except ImportError:
            return False
        for _ in range(retries + 1):
            try:
                r = requests.get(image_url, timeout=10)
                if r.ok:
                    data = r.content
                    break
            except Exception:
                continue
    if not data:
        return False
    try:
        import io

        img = Image.open(io.BytesIO(data)).convert("RGB")
        img = img.resize((size, size), Image.LANCZOS)
        img.save(out_path, "JPEG", quality=95)
        return True
    except Exception:
        return False


def process_archive(archive_dir: str, out_dir: str = "guardian_images",
                    target_articles: int = 3000, workers: int = 15,
                    log=print) -> List[Dict]:
    """Scrape every .html file in the archive; returns article dicts
    {article_id, text_content, image_local_path, url} in the order their
    images were saved (``as_completed``)."""
    import glob

    os.makedirs(out_dir, exist_ok=True)
    html_files = sorted(glob.glob(os.path.join(archive_dir, "**", "*.html"),
                                  recursive=True))[: target_articles * 2]
    candidates = []
    for i, hf in enumerate(html_files):
        try:
            with open(hf, encoding="utf-8", errors="ignore") as f:
                title, image_url = extract_article(f.read())
        except OSError:
            continue
        if title and image_url:
            candidates.append((i, hf, title, image_url))
        if len(candidates) >= target_articles:
            break

    articles: List[Dict] = []

    def work(item):
        i, hf, title, image_url = item
        local = os.path.join(out_dir, f"guardian_{i:05d}.jpg")
        if fetch_and_save_image(image_url, local):
            return {"article_id": f"guardian_{i:05d}", "text_content": title,
                    "image_local_path": local, "url": hf}
        return None

    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures = [ex.submit(work, c) for c in candidates]
        for fut in as_completed(futures):
            r = fut.result()
            if r:
                articles.append(r)
    log(f"processed {len(articles)} articles with images")
    return articles


def emit_clip_csvs(articles: List[Dict], train_csv: str = "clip_train.csv",
                   val_csv: str = "clip_val.csv", val_fraction: float = 0.2,
                   seed: int = 42, log=print) -> None:
    """1 matched + 1 mismatched pair per image; split is leak-free at the
    ARTICLE level before pairing (reference :236-325)."""
    import pandas as pd

    rng = random.Random(seed)
    arts = list(articles)
    rng.shuffle(arts)
    n_val = int(len(arts) * val_fraction)
    splits = {val_csv: arts[:n_val], train_csv: arts[n_val:]}
    for path, group in splits.items():
        rows = []
        titles = [a["text_content"] for a in group]
        for i, a in enumerate(group):
            rows.append({"image_path": a["image_local_path"],
                         "text": a["text_content"], "label": 0})
            if len(group) > 1:
                j = rng.randrange(len(group) - 1)
                j = j if j < i else j + 1  # any other article's title
                rows.append({"image_path": a["image_local_path"],
                             "text": titles[j], "label": 1})
        pd.DataFrame(rows).to_csv(path, index=False)
        log(f"{path}: {len(rows)} pairs from {len(group)} articles")


def emit_vault_seed(articles: List[Dict],
                    out_json: str = "vector_db_seed.json", log=print) -> None:
    with open(out_json, "w", encoding="utf-8") as f:
        json.dump(articles, f, indent=2, ensure_ascii=False)
    log(f"{out_json}: {len(articles)} articles")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Guardian archive prep (PyTorch port)")
    p.add_argument("--archive-dir", required=True)
    p.add_argument("--out-dir", default="guardian_images")
    p.add_argument("--target", type=int, default=3000)
    p.add_argument("--workers", type=int, default=15)
    args = p.parse_args(argv)
    articles = process_archive(args.archive_dir, args.out_dir, args.target,
                               args.workers)
    emit_clip_csvs(articles)
    emit_vault_seed(articles)


if __name__ == "__main__":
    main()
