"""The port's trainers (misinfo_tpu_torch/train/) held to the JAX
package's on generated rows, tiny configs, f32.

- ``roberta_detective.train`` (hidden dropout 0), ``fusion_judge.
  train_on_scores`` (``FUSION_DROPOUT`` patched to 0 in both packages) and
  ``clip_detective.train`` for 2 epochs: each epoch's train and val
  metrics within 1e-4 of JAX's, and the same best epoch;
- ``run_training`` on scripted metrics: JAX's best epoch, early stop,
  prune and checkpoint calls;
- the CIFAKE trainer's run (its step draws stochastic depth, so no
  parity here: tests/test_torch_train_steps.py holds the step), the AI-head
  recipe, the native median-pruner search, the vault builder and search
  (equal to JAX's), the feature-fusion forward (equal to JAX's) and demo;
- a ``--mesh`` the CLI cannot build refused, ``--device cuda`` refused
  without a card (training over a mesh: tests/test_torch_trainers_mesh.py).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from misinfo_tpu.models import fusion as j_fusion
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.train import clip_detective as j_clip
from misinfo_tpu.train import feature_fusion as j_ff
from misinfo_tpu.train import fusion_judge as j_fj
from misinfo_tpu.train import harness as j_harness
from misinfo_tpu.train import roberta_detective as j_rd

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.checkpoints.io import load_checkpoint, load_metadata
from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.models import fusion as t_fusion
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy
from misinfo_tpu_torch.train import ai_head as t_ai
from misinfo_tpu_torch.train import cifake_efficientnet as t_cifake
from misinfo_tpu_torch.train import clip_detective as t_clip
from misinfo_tpu_torch.train import feature_fusion as t_ff
from misinfo_tpu_torch.train import fusion_judge as t_fj
from misinfo_tpu_torch.train import harness as t_harness
from misinfo_tpu_torch.train import roberta_detective as t_rd
from misinfo_tpu_torch.train.steps import batch_to
from misinfo_tpu_torch.utils.tree import leaves_with_paths, tree_map

from tests.test_torch_train_steps import JDET, TDET

WORDS = ("moon landing fake experts say breaking news vaccine election "
         "claim photo shows city flood storm report official denies "
         "viral video minister market crash").split()


def _np_tree(seed=4):
    return tree_map(lambda t: t.numpy(), detector_init(seed, TDET))


def _jax(np_tree):
    return jax.tree.map(lambda a: jnp.array(a), np_tree)


def _text_csv(path, n=40, seed=0):
    rng = np.random.default_rng(seed)
    rows = [{"text": " ".join(rng.choice(WORDS, int(rng.integers(3, 20)))),
             "label": int(rng.integers(0, 2))} for _ in range(n)]
    pd.DataFrame(rows).to_csv(path, index=False)
    return str(path)


def _pngs(tmp_path, n, size=64, seed=1):
    from PIL import Image
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     dtype=np.uint8)).save(p)
        out.append(p)
    return out


def _assert_histories_close(a, b, keys, tol=1e-4):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        for k in keys:
            assert abs(ea[k] - eb[k]) <= tol, (k, ea[k], eb[k])


def test_roberta_detective_matches_jax(tmp_path):
    csv = _text_csv(tmp_path / "welfake.csv")
    tree = _np_tree()
    kw = dict(epochs=2, batch_size=8, max_len=32, precision="float32",
              log=lambda *_: None)
    want = j_rd.train(csv, str(tmp_path / "jax"), det_cfg=JDET,
                      params=_jax(tree), **kw)
    start = params_from_jax(tree)
    got = t_rd.train(csv, str(tmp_path / "port"), det_cfg=TDET,
                     params=start, device="cpu", **kw)
    _assert_histories_close(want.history, got.history,
                            ("train_loss", "train_accuracy", "val_loss",
                             "val_accuracy"))
    assert got.best_epoch == want.best_epoch
    # the caller's tree is the trainer's to copy, never to update
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(start), leaves_with_paths(params_from_jax(tree))))
    out = str(tmp_path / "port")
    saved = load_checkpoint(out, detector_init(0, TDET))
    for (p, a), (_, b) in zip(leaves_with_paths(saved),
                              leaves_with_paths(got.params)):
        assert torch.equal(a, b), p
    meta = load_metadata(out)
    assert meta["trainer"] == "roberta_detective"
    assert meta["epoch"] == got.best_epoch


def test_fusion_train_on_scores_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(j_fusion, "FUSION_DROPOUT", 0.0)
    monkeypatch.setattr(t_fusion, "FUSION_DROPOUT", 0.0)
    rng = np.random.default_rng(2)
    vecs = rng.uniform(size=(70, 5)).astype(np.float32)
    labels = (vecs[:, 1] + 0.3 * rng.normal(size=70) > 0.5).astype(np.int32)
    tree = _np_tree(5)
    kw = dict(epochs=3, batch_size=16, log=lambda *_: None)
    want = j_fj.train_on_scores(vecs, labels, _jax(tree),
                                str(tmp_path / "jax"), **kw)
    got = t_fj.train_on_scores(vecs, labels, params_from_jax(tree),
                               str(tmp_path / "port"), device="cpu", **kw)
    _assert_histories_close(want.history, got.history,
                            ("train_loss", "train_accuracy", "val_loss",
                             "val_accuracy"))
    assert got.best_epoch == want.best_epoch
    moved = {p[0] for (p, a), (_, b) in zip(
        leaves_with_paths(got.params), leaves_with_paths(
            params_from_jax(tree))) if not torch.equal(a, b)}
    assert moved == {"fusion"}


def _pairs_csv(tmp_path, paths, n=24, seed=3):
    rng = np.random.default_rng(seed)
    rows = [{"image_path": paths[i % len(paths)],
             "text": " ".join(rng.choice(WORDS, 6)),
             "label": int(i % 3 == 0)} for i in range(n)]
    p = str(tmp_path / "pairs.csv")
    pd.DataFrame(rows).to_csv(p, index=False)
    return p


def test_clip_detective_matches_jax(tmp_path):
    csv = _pairs_csv(tmp_path, _pngs(tmp_path, 6))
    tree = _np_tree(6)
    kw = dict(epochs=2, batch_size=4, precision="float32",
              log=lambda *_: None)
    want = j_clip.train(csv, out_dir=str(tmp_path / "jax"), det_cfg=JDET,
                        params=_jax(tree), **kw)
    got = t_clip.train(csv, out_dir=str(tmp_path / "port"), det_cfg=TDET,
                       params=params_from_jax(tree), device="cpu", **kw)
    _assert_histories_close(want.history, got.history,
                            ("train_loss", "train_mean_matched_sim",
                             "val_median_accuracy", "val_fixed_accuracy"))
    assert got.best_epoch == want.best_epoch
    start = params_from_jax(tree)
    for (p, a), (_, b) in zip(leaves_with_paths(start),
                              leaves_with_paths(got.params)):
        trains = p[:2] in (("clip", "text_projection"),
                           ("clip", "visual_projection"),
                           ("clip", "logit_scale"))
        assert torch.equal(a, b) != trains, p


def test_run_training_policy_matches_jax():
    """A scripted metric sequence through both harnesses: the same best
    epoch and metric, early stop, prune and checkpoint epochs."""
    scripts = [
        ("min", [0.9, 0.7, 0.8, 0.75, 0.72, 0.6], 3, None),
        ("max", [0.5, 0.6, 0.55, 0.65, 0.64, 0.63], 2, None),
        ("max", [0.5, 0.6, 0.55, 0.65], None, 2),
    ]
    for mode, vals, patience, prune_at in scripts:
        results = []
        for m in (j_harness, t_harness):
            seen, saved = iter(vals), []

            def step(p, o, b, k):
                return p, o, {"loss": torch.tensor(float(b))}

            def cb(epoch, metrics):
                return epoch != prune_at
            res = m.run_training(
                {"w": torch.zeros(2)}, None, step, lambda: iter([1.0, 2.0]),
                lambda p: {"metric": next(seen)}, epochs=len(vals),
                select_metric="metric", select_mode=mode,
                early_stop_patience=patience,
                checkpoint_fn=lambda p, o, e, mm: saved.append(e),
                epoch_callback=cb, log=lambda *_: None)
            hist = [{k: v for k, v in h.items() if k != "seconds"}
                    for h in res.history]
            results.append((res.best_epoch, res.best_metric, res.pruned,
                            saved, hist))
        assert results[0] == results[1], (mode, vals)


def test_cifake_trainer_runs_and_trains_only_efficientnet(tmp_path):
    items = [(p, i % 2) for i, p in enumerate(_pngs(tmp_path, 10, 48))]
    start = detector_init(7, TDET)
    res = t_cifake.train("", str(tmp_path / "eff"), epochs=1, batch_size=4,
                         image_size=48, det_cfg=TDET, params=start,
                         precision="float32", items=items, device="cpu",
                         log=lambda *_: None)
    h = res.history[0]
    assert np.isfinite(h["train_loss"]) and "val_accuracy" in h
    moved = {p[0] for (p, a), (_, b) in zip(
        leaves_with_paths(start), leaves_with_paths(res.params))
        if not torch.equal(a, b)}
    assert moved == {"efficientnet"}
    assert load_metadata(str(tmp_path / "eff"))["trainer"] == (
        "cifake_efficientnet")


def test_cifake_paths_equal_jax(tmp_path):
    from misinfo_tpu.train import cifake_efficientnet as j_cifake
    for sub in ("test/REAL", "train/FAKE", "test/FAKE"):
        d = tmp_path / sub
        d.mkdir(parents=True)
        for i in range(5):
            (d / f"{i}.png").write_bytes(b"x")
    assert (t_cifake.load_cifake_paths(str(tmp_path), 4)
            == j_cifake.load_cifake_paths(str(tmp_path), 4))


def test_ai_head_recipe(tmp_path, monkeypatch):
    """The AI-head trainer lays a base checkpoint over the seeded init and
    trains ai_head alone through the text trainer."""
    from misinfo_tpu_torch.checkpoints.io import save_checkpoint
    base = detector_init(8, TDET)
    save_checkpoint(str(tmp_path / "base"), base)
    calls = []
    monkeypatch.setattr(t_ai, "_train_text",
                        lambda *a, **kw: calls.append((a, kw)))
    t_ai.train("hc3.csv", str(tmp_path / "ai"), str(tmp_path / "base"),
               det_cfg=TDET, device="cpu", log=lambda *_: None)
    (args, kw), = calls
    assert args[:5] == ("hc3.csv", str(tmp_path / "ai"), 3, 16, 1e-3)
    assert (kw["head"], kw["freeze_backbone"], kw["max_len"],
            kw["device"]) == ("ai_head", True, 256, "cpu")
    for (p, a), (_, b) in zip(leaves_with_paths(kw["params"]),
                              leaves_with_paths(base)):
        assert torch.equal(a, b), p


def test_hpo_search_native_pruner_without_optuna(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "optuna", None)
    csv = _pairs_csv(tmp_path, _pngs(tmp_path, 4), n=12)
    best = t_clip.hpo_search(csv, n_trials=3, epochs=2, n_startup_trials=1,
                             device="cpu", det_cfg=TDET,
                             params=detector_init(9, TDET),
                             precision="float32", log=lambda *_: None)
    assert best["backend"] == "native-median-pruner"
    assert 0 <= best["n_pruned"] <= 2 and np.isfinite(best["metric"])


def test_build_vault_and_search_equal_jax(tmp_path):
    paths = _pngs(tmp_path, 5)
    arts = [{"article_id": i, "text_content": f"{WORDS[i]} {WORDS[i + 5]}",
             "image_local_path": p, "date": "2024"}
            for i, p in enumerate(paths)]
    arts.append({"article_id": 9, "text_content": "gone",
                 "image_local_path": str(tmp_path / "missing.png")})
    js = tmp_path / "seed.json"
    js.write_text(json.dumps(arts))
    tree = _np_tree(10)
    outs = [str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")]
    jv = j_clip.build_vault(str(js), outs[0], det_cfg=JDET,
                            params=_jax(tree), batch_size=4,
                            log=lambda *_: None)
    tv = t_clip.build_vault(str(js), outs[1], det_cfg=TDET,
                            params=params_from_jax(tree), batch_size=4,
                            log=lambda *_: None, device="cpu")
    assert tv.metadata == jv.metadata and tv.num_articles == 5
    np.testing.assert_allclose(tv.embeddings, jv.embeddings, atol=1e-5)
    np.testing.assert_allclose(tv.text_embeddings, jv.text_embeddings,
                               atol=1e-5)
    for q in (dict(query_text="moon landing photo"),
              dict(query_image_path=paths[2])):
        a = j_clip.search_similar_articles(outs[0], top_k=3, det_cfg=JDET,
                                           params=_jax(tree), **q)
        b = t_clip.search_similar_articles(outs[1], top_k=3, det_cfg=TDET,
                                           params=params_from_jax(tree),
                                           device="cpu", **q)
        assert [m["title"] for m in a] == [m["title"] for m in b]
        np.testing.assert_allclose([m["similarity"] for m in a],
                                   [m["similarity"] for m in b], atol=1e-5)


def test_feature_fusion_forward_equals_jax():
    tree = _np_tree(11)
    head = tree_map(lambda t: t.numpy(), t_ff.feature_fusion_head_init(
        torch.Generator().manual_seed(1), TDET))
    tree = {**tree, "feature_fusion": head}
    rng = np.random.default_rng(0)
    s = TDET.clip.image_size
    batch = {"input_ids": rng.integers(3, 1000, (2, 12)).astype(np.int32),
             "attention_mask": np.ones((2, 12), np.int32),
             "clip_ids": rng.integers(1, 500, (2, 16)).astype(np.int32),
             "clip_mask": np.ones((2, 16), np.int32),
             "images_u8": rng.integers(0, 255, (2, s, s, 3)).astype(np.uint8)}
    from misinfo_tpu.core.config import PrecisionConfig as JPrecision
    from misinfo_tpu.ops.common import Policy as JPolicy
    pol = JPolicy(JPrecision.highest())
    want = jax.jit(lambda p, b: j_ff.feature_fusion_forward(p, b, JDET, pol))(
        _jax(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    got = t_ff.feature_fusion_forward(params_from_jax(tree),
                                      batch_to(batch, "cpu"), TDET,
                                      Policy(PrecisionConfig.highest()))
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)
    mask = t_ff.freeze_backbones_mask(params_from_jax(tree))
    assert {p[0] for p, v in leaves_with_paths(mask) if v} == {
        "efficientnet", "feature_fusion"}
    losses = []
    t_ff.training_loop_example(2, det_cfg=TDET, device="cpu",
                               log=losses.append)
    assert len(losses) == 2 and "nan" not in " ".join(losses)


@pytest.mark.parametrize("main,argv", [
    (t_rd.main, ["--csv", "x.csv"]),
    (t_ai.main, ["--csv", "x.csv"]),
    (t_cifake.main, ["--cifake-root", "x"]),
    (t_clip.main, ["--train-csv", "x.csv"]),
    (t_fj.main, ["--csv", "x.csv"])])
def test_trainer_cli_refuses_mesh_and_missing_card(main, argv, monkeypatch):
    """A mesh the CLI cannot build is refused before any training: a bad
    spec by name, and without a card a mesh of cards; ``--device
    cuda|auto`` raise without a card. (Training over a mesh runs:
    tests/test_torch_trainers_mesh.py.)"""
    from misinfo_tpu_torch.core import mesh as t_mesh
    monkeypatch.setattr(t_mesh, "_platform", t_mesh._platform)
    monkeypatch.setattr(t_mesh, "_num_cpu_devices", t_mesh._num_cpu_devices)
    with pytest.raises(ValueError, match="bad mesh spec"):
        main(argv + ["--device", "cpu", "--mesh", "pipeline=2"])
    if not torch.cuda.is_available():
        for dev in ("cuda", "auto"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv + ["--device", dev])
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv + ["--device", dev, "--mesh", "data=2"])
