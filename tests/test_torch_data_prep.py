"""The dataset preparation scripts (train/data_prep.py,
train/guardian_prep.py) held to the JAX package's on generated inputs.

Every function runs on both sides over the same files and must give the
same result: equal lists and dicts, byte-equal CSV, JSON and pickle
files, byte-equal JPEGs. ``extract_article`` is held in both branches,
BeautifulSoup's and the regex fallback (bs4 hidden). ``process_archive``
fills its list in ``as_completed`` order, which differs from run to run,
so its articles are compared sorted by ``article_id``, and the scripts'
``main`` outputs built from that order are compared as sets and by their
split invariants. No test reaches the network: image URLs are local
paths, and ``requests`` is hidden where a path does not exist.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from misinfo_tpu.train import data_prep as j_dp
from misinfo_tpu.train import guardian_prep as j_gp

from misinfo_tpu_torch.train import data_prep as t_dp
from misinfo_tpu_torch.train import guardian_prep as t_gp

QUIET = dict(log=lambda *_: None)


def _png(path, seed, size=40):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                    ).save(path)
    return str(path)


def _same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ---------------------------------------------------------------- data_prep

def test_balanced_sample_matches_jax():
    rng = np.random.default_rng(0)
    items = [{"text": f"t{i}", "image_path": f"p{i}",
              "label": int(rng.integers(0, 2))} for i in range(57)]
    for n in (3, 10, 40):
        assert t_dp.balanced_sample(items, n) == j_dp.balanced_sample(items, n)
    assert t_dp.balanced_sample(items, 5, seed=7) == j_dp.balanced_sample(
        items, 5, seed=7)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A CIFAKE tree, a Fakeddit TSV (some images missing), and the HC3,
    WELFake and clip_train CSVs of prepare_fusion_dataset."""
    root = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        for sub in ("REAL", "FAKE"):
            d = root / "cifake" / split / sub
            d.mkdir(parents=True)
            for i in range(int(rng.integers(3, 7))):
                (d / f"{sub.lower()}_{i}.jpg").write_bytes(b"x")
    imgs = root / "fakeddit"
    imgs.mkdir()
    rows = []
    for i in range(30):
        if i % 4:
            (imgs / f"fd{i}.jpg").write_bytes(b"x")
        rows.append({"id": f"fd{i}", "clean_title": f"post {i} title",
                     "2_way_label": int(rng.integers(0, 2))})
    pd.DataFrame(rows).to_csv(root / "fakeddit.tsv", sep="\t", index=False)
    words = lambda n: " ".join(f"w{int(k)}" for k in rng.integers(0, 99, n))  # noqa: E731
    pd.DataFrame([{"image_path": f"g/{i // 2}.jpg", "text": words(6),
                   "label": i % 2} for i in range(40)]).to_csv(
        root / "clip_train.csv", index=False)
    for name in ("hc3", "welfake"):
        pd.DataFrame([{"text": words(9), "label": int(rng.integers(0, 2))}
                      for _ in range(50)]).to_csv(root / f"{name}.csv",
                                                  index=False)
    return root


def test_dataset_loaders_match_jax(sources):
    cifake = str(sources / "cifake")
    for limit in (None, 5):
        assert (t_dp.load_cifake_items(cifake, limit)
                == j_dp.load_cifake_items(cifake, limit))
    tsv, imgs = str(sources / "fakeddit.tsv"), str(sources / "fakeddit")
    for limit in (None, 4):
        got = t_dp.load_fakeddit_items(tsv, imgs, limit)
        assert got == j_dp.load_fakeddit_items(tsv, imgs, limit)
        assert got and all(os.path.exists(it["image_path"]) for it in got)
    bad = str(sources / "nolabel.tsv")
    pd.DataFrame([{"id": "a", "title": "t"}]).to_csv(bad, sep="\t",
                                                     index=False)
    for dp in (t_dp, j_dp):
        with pytest.raises(ValueError, match="no 2-class label column"):
            dp.load_fakeddit_items(bad, imgs)


def test_harmonize_and_fusion_outputs_match_jax(sources, tmp_path):
    out = {}
    for name, dp in (("jax", j_dp), ("torch", t_dp)):
        d = tmp_path / name
        d.mkdir()
        got = dp.harmonize_datasets(
            str(sources / "cifake"), str(sources / "fakeddit.tsv"),
            str(sources / "fakeddit"), n_per_label=8,
            out_pkl=str(d / "h.pkl"), out_seed_json=str(d / "seed.json"),
            **QUIET)
        fusion = dp.prepare_fusion_dataset(
            str(sources / "clip_train.csv"), str(sources / "hc3.csv"),
            str(sources / "welfake.csv"), out_csv=str(d / "fusion.csv"),
            per_source_fake=12, **QUIET)
        quick = dp.quick_fusion_prep(str(sources / "clip_train.csv"),
                                     str(d / "quick.csv"), n_rows=7, **QUIET)
        out[name] = (d, got, fusion, quick)
    (dj, hj, fj, qj), (dt, ht, ft, qt) = out["jax"], out["torch"]
    assert ht == hj and len(ht) == 16
    assert sorted(it["label"] for it in ht) == [0] * 8 + [1] * 8
    pd.testing.assert_frame_equal(ft, fj)
    pd.testing.assert_frame_equal(qt, qj)
    assert len(ft) == 3 * (12 + 6) and int(ft["label"].sum()) == 3 * 12
    for f in ("h.pkl", "seed.json", "fusion.csv", "quick.csv"):
        assert _same_files(dt / f, dj / f), f
    with open(dt / "h.pkl", "rb") as fh:
        assert pickle.load(fh) == ht


@pytest.mark.parametrize("argv", [
    ["harmonize", "--cifake-root", "{src}/cifake", "--fakeddit-tsv",
     "{src}/fakeddit.tsv", "--fakeddit-images", "{src}/fakeddit",
     "--n-per-label", "4"],
    ["fusion", "--clip-train", "{src}/clip_train.csv", "--hc3",
     "{src}/hc3.csv", "--welfake", "{src}/welfake.csv"],
    ["quick-fusion", "--clip-train", "{src}/clip_train.csv", "--rows", "5"]])
def test_data_prep_main_matches_jax(sources, tmp_path, monkeypatch, argv):
    argv = [a.format(src=sources) for a in argv]
    for name, dp in (("jax", j_dp), ("torch", t_dp)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        dp.main(argv)
    files = sorted(os.listdir(tmp_path / "torch"))
    assert files and files == sorted(os.listdir(tmp_path / "jax"))
    for f in files:
        assert _same_files(tmp_path / "torch" / f, tmp_path / "jax" / f), f


# ------------------------------------------------------------ guardian_prep

PAGES = {
    "og": '<html><head><meta property="og:title" content=" Title A ">'
          '<meta property="og:image" content="{img}"></head></html>',
    "og_reversed": '<meta content="Title B" property="og:title">'
                   '<meta content="{img}" name="og:image">',
    "twitter": '<meta property="og:title" content="Title C">'
               '<meta name="twitter:image" content="{img}">',
    "link": '<h1 class="x">Headline D</h1><link rel="image_src" '
            'href="{img}">',
    "wide_img": '<h1>Headline E</h1><img src="small.jpg" width="100">'
                '<img src="{img}" width="640"><img src="later.jpg" '
                'width="900">',
    "first_img": '<h1> Headline F </h1><img alt="none"><img src="{img}" '
                 'width="abc"><img src="b.jpg" width="20">',
    "no_title": '<meta property="og:image" content="{img}"><p>text</p>',
    "no_image": '<meta property="og:title" content="Title H">',
    "empty": "",
}


@pytest.mark.parametrize("branch", ["bs4", "regex"])
def test_extract_article_matches_jax(monkeypatch, branch):
    if branch == "regex":
        monkeypatch.setitem(sys.modules, "bs4", None)   # ImportError
    else:
        pytest.importorskip("bs4")
    for name, html in PAGES.items():
        html = html.format(img="/imgs/a.png")
        got = t_gp.extract_article(html)
        assert got == j_gp.extract_article(html), (branch, name)
    assert t_gp.extract_article(PAGES["og"].format(img="/i.png")) == (
        "Title A", "/i.png")


def test_fetch_and_save_image_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "requests", None)   # never the network
    src = _png(tmp_path / "src.png", 2, size=300)
    broken = tmp_path / "broken.png"
    broken.write_bytes(b"\x89PNG not an image")
    for name, gp in (("jax", j_gp), ("torch", t_gp)):
        assert gp.fetch_and_save_image(src, str(tmp_path / f"{name}.jpg"))
        assert gp.fetch_and_save_image(src, str(tmp_path / f"{name}64.jpg"),
                                       size=64)
        assert not gp.fetch_and_save_image(str(broken),
                                           str(tmp_path / "x.jpg"))
        assert not gp.fetch_and_save_image(str(tmp_path / "missing.png"),
                                           str(tmp_path / "y.jpg"))
    for f in ("{}.jpg", "{}64.jpg"):
        assert _same_files(tmp_path / f.format("torch"),
                           tmp_path / f.format("jax"))
    assert Image.open(tmp_path / "torch64.jpg").size == (64, 64)
    assert not (tmp_path / "x.jpg").exists()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """40 pages in nested folders: og tags to a local PNG (h1 and <img>
    on every fifth page), broken image files on pages 3, 13, 23, 33, no
    title on pages 7, 20, 33."""
    root = tmp_path_factory.mktemp("archive")
    imgs = root / "imgs"
    imgs.mkdir()
    for i in range(40):
        d = root / "site" / f"sec{i % 3}"
        d.mkdir(parents=True, exist_ok=True)
        img = str(imgs / f"{i}.png")
        if i % 10 == 3:
            with open(img, "wb") as f:
                f.write(b"not a png")
        else:
            _png(img, 100 + i)
        page = (f'<meta property="og:title" content="Story {i}">'
                f'<meta property="og:image" content="{img}">'
                if i % 5 else f'<h1>Story {i}</h1><img src="{img}">')
        if i % 13 == 7:
            page = f'<meta property="og:image" content="{img}">'
        (d / f"page{i:03d}.html").write_text(page)
    (root / "site" / "notes.txt").write_text("not html")
    return root


def _by_id(articles):
    return sorted(articles, key=lambda a: a["article_id"])


@pytest.mark.parametrize("branch", ["bs4", "regex"])
def test_process_archive_and_emitters_match_jax(archive, tmp_path,
                                                monkeypatch, branch):
    """Sorted by article_id (``as_completed`` order differs per run)."""
    if branch == "regex":
        monkeypatch.setitem(sys.modules, "bs4", None)
    got = {}
    for name, gp in (("jax", j_gp), ("torch", t_gp)):
        out = tmp_path / name
        arts = gp.process_archive(str(archive), str(out / "imgs"),
                                  target_articles=40, workers=4, **QUIET)
        for a in arts:
            a["image_local_path"] = os.path.relpath(a["image_local_path"],
                                                    out)
        got[name] = _by_id(arts)
        gp.emit_clip_csvs(got[name], str(out / "train.csv"),
                          str(out / "val.csv"), **QUIET)
        gp.emit_vault_seed(got[name], str(out / "seed.json"), **QUIET)
    assert got["torch"] == got["jax"]
    # every page with a title and a readable image; the regex branch finds
    # no image on the pages with only <h1> and <img>
    kept = {f"Story {i}" for i in range(40) if i % 13 != 7 and i % 10 != 3
            and (i % 5 or branch == "bs4")}
    assert {a["text_content"] for a in got["torch"]} == kept
    assert len(got["torch"]) == len(kept) == (34 if branch == "bs4" else 27)
    for a in got["torch"]:
        assert _same_files(tmp_path / "torch" / a["image_local_path"],
                           tmp_path / "jax" / a["image_local_path"])
    for f in ("train.csv", "val.csv", "seed.json"):
        assert _same_files(tmp_path / "torch" / f, tmp_path / "jax" / f), f


def test_guardian_main_matches_jax(archive, tmp_path, monkeypatch):
    """The script end to end: the same articles (as a set), and the same
    split invariants: 80/20 at the article level, one matched and one
    mismatched pair per article."""
    outs = {}
    for name, gp in (("jax", j_gp), ("torch", t_gp)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        gp.main(["--archive-dir", str(archive), "--target", "25",
                 "--workers", "3"])
        with open("vector_db_seed.json", encoding="utf-8") as f:
            seed = json.load(f)
        outs[name] = (seed, pd.read_csv("clip_train.csv"),
                      pd.read_csv("clip_val.csv"))
    key = lambda a: a["article_id"]                      # noqa: E731
    assert sorted(outs["torch"][0], key=key) == sorted(outs["jax"][0],
                                                       key=key)
    seed, train, val = outs["torch"]
    n = len(seed)
    assert len(val) == 2 * int(n * 0.2) and len(train) == 2 * (n - int(n * 0.2))
    assert not set(train["image_path"]) & set(val["image_path"])
    titles = {a["image_local_path"]: a["text_content"] for a in seed}
    for df in (train, val):
        assert (df["label"] == 0).sum() == (df["label"] == 1).sum()
        for _, r in df.iterrows():
            assert (r["text"] == titles[r["image_path"]]) == (r["label"] == 0)


def test_prep_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, misinfo_tpu_torch.train.data_prep, "
            "misinfo_tpu_torch.train.guardian_prep; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'misinfo_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "[]"
