"""CLIP detective trainer, Truth-Vault builder and kNN search
(reference train_clip_detective.py).

Counterpart of ``misinfo_tpu/train/clip_detective.py``:

* CLIPDetective's semantics: frozen CLIP encoders, trainable
  ``visual_projection`` / ``text_projection`` / ``logit_scale``
  (``clip_trainable_mask``);
* symmetric InfoNCE on matched pairs only (label 0 rows), in-batch
  negatives; validation on all pairs with the per-batch median-threshold
  accuracy and the fixed-threshold companion;
* AdamW 1e-4, cosine anneal, clip 1.0, batch 16, 10 epochs;
* ``hpo_search``: optuna's MedianPruner study when optuna is importable,
  else random search with the native median-stopping rule;
* ``build_vault`` (articles → normalized image + text embeddings →
  TruthVault) and ``search_similar_articles`` (text/image query kNN).

    python -m misinfo_tpu_torch.train.clip_detective --train-csv pairs.csv \\
        --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.models.clip import (
    clip_image_features, clip_text_features)
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy, l2_normalize, set_exact_f32
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.preprocess.image import image_to_array
from misinfo_tpu_torch.preprocess.tokenizer import load_clip_tokenizer
from misinfo_tpu_torch.train.harness import (
    eval_batches, multihost, own_params, placer, run_training, select_device,
    train_mesh)
from misinfo_tpu_torch.train.losses import (
    fixed_threshold_accuracy, median_threshold_accuracy)
from misinfo_tpu_torch.train.optim import OptimConfig, make_optimizer
from misinfo_tpu_torch.train.steps import batch_to, make_clip_step
from misinfo_tpu_torch.utils.tree import tree_map
from misinfo_tpu_torch.vault.store import TruthVault


def load_pairs_csv(csv_path: str, matched_only: bool = False):
    """(image_path, text, label) rows; label 0 = matched, 1 = mismatched."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    if matched_only:
        df = df[df["label"] == 0].reset_index(drop=True)
    return list(zip(df["image_path"].astype(str), df["text"].astype(str),
                    df["label"].astype(int)))


class _PairBatcher:
    def __init__(self, rows, tokenizer, image_size: int, clip_len: int,
                 seed: int = 0, shuffle: bool = True):
        self.rows = rows
        self.tok = tokenizer
        self.image_size = image_size
        self.clip_len = clip_len
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle

    def batches(self, batch_size: int):
        idx = np.arange(len(self.rows))
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(0, len(idx), batch_size):
            chunk = idx[s:s + batch_size]
            if len(chunk) < batch_size:
                break
            imgs, texts, labels = [], [], []
            for i in chunk:
                path, text, label = self.rows[i]
                try:
                    imgs.append(image_to_array(path, "clip", self.image_size))
                except Exception:  # black-image fallback (reference :45-48)
                    imgs.append(np.zeros((self.image_size, self.image_size,
                                          3), np.uint8))
                texts.append(text)
                labels.append(label)
            ids, mask = self.tok.batch(texts, self.clip_len)
            yield {"input_ids": ids, "attention_mask": mask,
                   "images_u8": np.stack(imgs),
                   "labels": np.asarray(labels, np.int32)}


def clip_trainable_mask(params: Dict) -> Dict:
    """Freeze the CLIP encoders; train the projections and logit_scale."""
    mask = tree_map(lambda _: False, params)
    clip = mask["clip"]
    for k in ("text_projection", "visual_projection"):
        clip[k] = tree_map(lambda _: True, params["clip"][k])
    clip["logit_scale"] = True
    return mask


def train(train_csv: str, val_csv: Optional[str] = None,
          out_dir: str = "clip_detective_best",
          epochs: int = 10, batch_size: int = 16, lr: float = 1e-4,
          det_cfg: Optional[DetectorConfig] = None,
          params: Optional[Dict] = None, precision: str = "bfloat16",
          mesh_spec: Optional[str] = None, epoch_callback=None, log=print,
          device="cuda"):
    det_cfg = det_cfg or DetectorConfig()
    policy = Policy(PrecisionConfig(compute_dtype=precision))
    set_exact_f32(parity=policy.compute == torch.float32)
    device = torch.device(device)
    params = own_params(params, det_cfg, device)
    tok = load_clip_tokenizer(None, det_cfg.clip.vocab_size)
    clip_len = det_cfg.clip.max_text_len
    img_size = det_cfg.clip.image_size

    train_rows = load_pairs_csv(train_csv, matched_only=True)
    val_rows = load_pairs_csv(val_csv or train_csv, matched_only=False)
    train_b = _PairBatcher(train_rows, tok, img_size, clip_len, 0)
    val_b = _PairBatcher(val_rows, tok, img_size, clip_len, 1, shuffle=False)

    steps = max(1, len(train_rows) // batch_size) * epochs
    tx = make_optimizer(OptimConfig(lr=lr, weight_decay=0.01,
                                    warmup_fraction=0.0, total_steps=steps,
                                    clip_norm=1.0),
                        trainable_mask=clip_trainable_mask(params))
    # '--mesh data=N': InfoNCE's negatives span the global batch
    mesh, params, device = train_mesh(mesh_spec, params, batch_size, device)
    place = placer(mesh, device)
    opt_state = tx.init(params)
    step = make_clip_step(tx, det_cfg, policy)

    @torch.no_grad()
    def sims_fn(params, batch):
        te = l2_normalize(clip_text_features(
            params["clip"], batch["input_ids"], batch["attention_mask"],
            det_cfg.clip, policy))
        ie = l2_normalize(clip_image_features(
            params["clip"],
            normalize_images(batch["images_u8"], "clip", policy.compute),
            det_cfg.clip, policy))
        return torch.sum(te * ie, dim=-1)

    def eval_fn(params):
        med_accs, fix_accs = [], []
        for b in eval_batches(val_b.batches, len(val_b.rows), batch_size):
            tb = batch_to(b, device)
            sims = sims_fn(params, tb)
            # label 0 = matched: match prediction = sim >= threshold
            matched = 1 - tb["labels"]
            med_accs.append(float(median_threshold_accuracy(sims, matched)))
            fix_accs.append(float(fixed_threshold_accuracy(sims, matched)))
        return {"median_accuracy": (float(np.mean(med_accs))
                                    if med_accs else 0.0),
                "fixed_accuracy": (float(np.mean(fix_accs))
                                   if fix_accs else 0.0)}

    def train_batches():
        from misinfo_tpu_torch.train.datasets import prefetch
        for b in prefetch(train_b.batches(batch_size)):
            yield place(b)

    def ckpt(params, opt_state, epoch, metrics):
        from misinfo_tpu_torch.checkpoints.io import save_checkpoint
        save_checkpoint(out_dir, params, opt_state,
                        {"epoch": epoch, **metrics,
                         "trainer": "clip_detective"})

    return run_training(params, opt_state, step, train_batches, eval_fn,
                        epochs=epochs, select_metric="median_accuracy",
                        select_mode="max", checkpoint_fn=ckpt,
                        epoch_callback=epoch_callback, log=log)


def hpo_search(train_csv: str, val_csv: Optional[str] = None,
               n_trials: int = 8, epochs: int = 2,
               n_startup_trials: int = 2, log=print, device="cuda",
               **train_kw) -> Dict:
    """Hyperparameter search over lr/batch (the reference's optuna study
    with a MedianPruner). Without optuna the search uses the native
    median-stopping rule (train/harness.MedianPruner) through per-epoch
    callbacks; ``n_startup_trials`` defaults to 2 (optuna's is 5) because
    the study runs few trials. ``train_kw`` reaches ``train`` (a config or
    tree of another size)."""
    space_lr = [3e-5, 1e-4, 3e-4, 1e-3]
    space_bs = [8, 16, 32]
    ckpt_dir = os.path.join(tempfile.gettempdir(), "clip_hpo_ckpt")

    def objective(lr, bs, epoch_callback=None):
        return train(train_csv, val_csv, out_dir=ckpt_dir, epochs=epochs,
                     batch_size=bs, lr=lr, epoch_callback=epoch_callback,
                     log=lambda *_: None, device=device, **train_kw)

    try:
        import optuna

        def opt_obj(trial):
            lr = trial.suggest_float("lr", 1e-5, 1e-3, log=True)
            bs = trial.suggest_categorical("batch_size", space_bs)

            def cb(epoch, metrics):
                trial.report(metrics.get("val_median_accuracy", 0.0), epoch)
                return not trial.should_prune()
            res = objective(lr, bs, cb)
            if res.pruned:
                raise optuna.TrialPruned()
            return -res.best_metric

        study = optuna.create_study(pruner=optuna.pruners.MedianPruner(
            n_startup_trials=n_startup_trials))
        study.optimize(opt_obj, n_trials=n_trials)
        best = dict(study.best_params)
        best["metric"] = -study.best_value
        best["backend"] = "optuna"
    except ImportError:
        from misinfo_tpu_torch.train.harness import MedianPruner
        rng = np.random.default_rng(0)
        pruner = MedianPruner(mode="max", n_startup_trials=n_startup_trials)
        best = {"metric": -np.inf}
        n_pruned = 0
        for t in range(n_trials):
            lr = float(rng.choice(space_lr))
            bs = int(rng.choice(space_bs))
            pruner.start_trial()

            def cb(epoch, metrics):
                return not pruner.report(
                    epoch, metrics.get("val_median_accuracy", 0.0))
            res = objective(lr, bs, cb)
            pruner.complete_trial(pruned=res.pruned)
            n_pruned += int(res.pruned)
            status = "PRUNED" if res.pruned else f"{res.best_metric:.4f}"
            log(f"trial {t}: lr={lr} bs={bs} → {status}")
            if not res.pruned and res.best_metric > best["metric"]:
                best = {"lr": lr, "batch_size": bs,
                        "metric": res.best_metric}
        best["backend"] = "native-median-pruner"
        best["n_pruned"] = n_pruned
    log(f"best hyperparameters: {best}")
    return best


def _clip_params(params, checkpoint, det_cfg, device):
    if params is None:
        params = detector_init(0, det_cfg)
    if checkpoint:
        from misinfo_tpu_torch.checkpoints.io import load_checkpoint
        restored = load_checkpoint(checkpoint, params)
        if restored is not None:
            params = restored
    return tree_map(lambda t: t.to(device), params["clip"])


def build_vault(json_file: str = "vector_db_seed.json",
                output_file: str = "guardian_embeddings.npz",
                det_cfg: Optional[DetectorConfig] = None,
                params: Optional[Dict] = None,
                checkpoint: Optional[str] = None,
                batch_size: int = 32, precision: str = "float32",
                log=print, device="cuda") -> Optional[TruthVault]:
    """Articles (``article_id``, ``text_content``, ``image_local_path``) →
    normalized image + text embeddings → TruthVault, one dual-tower
    forward per ``batch_size`` articles; unreadable images are skipped."""
    det_cfg = det_cfg or DetectorConfig()
    policy = Policy(PrecisionConfig(compute_dtype=precision))
    set_exact_f32(parity=policy.compute == torch.float32)
    clip = _clip_params(params, checkpoint, det_cfg, device)

    with open(json_file, encoding="utf-8") as f:
        articles = json.load(f)
    log(f"encoding {len(articles)} articles")

    tok = load_clip_tokenizer(None, det_cfg.clip.vocab_size)
    clip_len = det_cfg.clip.max_text_len
    img_size = det_cfg.clip.image_size

    @torch.no_grad()
    def encode(ids, mask, imgs_u8):
        te = l2_normalize(clip_text_features(clip, ids, mask, det_cfg.clip,
                                             policy))
        ie = l2_normalize(clip_image_features(
            clip, normalize_images(imgs_u8, "clip", policy.compute),
            det_cfg.clip, policy))
        return ie, te

    img_embs, txt_embs, metadata = [], [], []
    for s in range(0, len(articles), batch_size):
        chunk = articles[s:s + batch_size]
        imgs, texts, metas = [], [], []
        for a in chunk:
            try:
                imgs.append(image_to_array(a["image_local_path"], "clip",
                                           img_size))
            except Exception:
                continue  # skip unreadable (reference per-article try/except)
            texts.append(a.get("text_content", ""))
            metas.append({"title": a.get("text_content", "Unknown"),
                          "url": a.get("url", a.get("image_local_path",
                                                    "N/A")),
                          "date": a.get("date", "N/A"),
                          "article_id": a.get("article_id")})
        if not imgs:
            continue
        pad = batch_size - len(imgs)
        ids, mask = tok.batch(texts + [""] * pad, clip_len)
        imgs_arr = np.zeros((batch_size, img_size, img_size, 3), np.uint8)
        imgs_arr[: len(imgs)] = np.stack(imgs)
        t = batch_to({"ids": ids, "mask": mask, "imgs": imgs_arr}, device)
        ie, te = encode(t["ids"], t["mask"], t["imgs"])
        img_embs.append(ie.cpu().numpy()[: len(imgs)])
        txt_embs.append(te.cpu().numpy()[: len(imgs)])
        metadata.extend(metas)

    if not metadata:
        log("no articles encoded")
        return None
    vault = TruthVault(np.concatenate(img_embs), metadata,
                       np.concatenate(txt_embs))
    vault.save(output_file)
    summary = {"total_articles": vault.num_articles,
               "embedding_dim": vault.dim, "output": output_file}
    with open(os.path.splitext(output_file)[0] + "_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    log(f"vault built: {summary}")
    return vault


def search_similar_articles(vault_path: str, query_text: Optional[str] = None,
                            query_image_path: Optional[str] = None,
                            top_k: int = 5,
                            det_cfg: Optional[DetectorConfig] = None,
                            params: Optional[Dict] = None,
                            device="cuda") -> List[Dict]:
    """kNN query: encode the query with its tower (f32), rank the vault's
    rows by cosine similarity on the host."""
    det_cfg = det_cfg or DetectorConfig()
    policy = Policy(PrecisionConfig.highest())
    set_exact_f32(parity=True)
    clip = _clip_params(params, None, det_cfg, device)
    vault = TruthVault.load(vault_path)
    if vault is None:
        raise FileNotFoundError(vault_path)

    with torch.no_grad():
        if query_text is not None:
            tok = load_clip_tokenizer(None, det_cfg.clip.vocab_size)
            ids, mask = tok.batch([query_text], det_cfg.clip.max_text_len)
            t = batch_to({"ids": ids, "mask": mask}, device)
            q = l2_normalize(clip_text_features(
                clip, t["ids"], t["mask"], det_cfg.clip,
                policy)).cpu().numpy()[0]
            base = (vault.text_embeddings if vault.text_embeddings is not None
                    else vault.embeddings)
        elif query_image_path is not None:
            img = image_to_array(query_image_path, "clip",
                                 det_cfg.clip.image_size)
            imgs = torch.from_numpy(img[None]).to(device)
            q = l2_normalize(clip_image_features(
                clip, normalize_images(imgs, "clip", policy.compute),
                det_cfg.clip, policy)).cpu().numpy()[0]
            base = vault.embeddings
        else:
            raise ValueError("provide query_text or query_image_path")

    sims = base[: vault.num_articles] @ q
    order = np.argsort(sims)[::-1][:top_k]
    return vault.matches_from_indices(order, sims[order])


def main(argv=None):
    p = argparse.ArgumentParser(description="CLIP detective trainer / vault "
                                "tools (CUDA)")
    p.add_argument("--train-csv", default=None)
    p.add_argument("--val-csv", default=None)
    p.add_argument("--out", default="clip_detective_best")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--hpo", action="store_true",
                   help="run hyperparameter search")
    p.add_argument("--generate-db", action="store_true")
    p.add_argument("--json-file", default="vector_db_seed.json")
    p.add_argument("--db-out", default="guardian_embeddings.npz")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--search-text", default=None)
    p.add_argument("--search-image", default=None)
    p.add_argument("--vault", default="guardian_embeddings.npz")
    p.add_argument("--mesh", default=None,
                   help="device mesh for training, e.g. 'data=8' or "
                        "'data=4,model=2' (across processes: init_multihost's "
                        "env vars)")
    p.add_argument("--device", choices=["auto", "cpu", "cuda"],
                   default="auto")
    args = p.parse_args(argv)
    device = select_device(args.device, args.mesh)
    with multihost():
        return _run(p, args, device)


def _run(p, args, device):

    if args.generate_db:
        build_vault(args.json_file, args.db_out, checkpoint=args.checkpoint,
                    device=device)
    elif args.search_text or args.search_image:
        for m in search_similar_articles(args.vault, args.search_text,
                                         args.search_image, device=device):
            print(f"{m['similarity']:.4f}  {m['title'][:80]}")
    elif args.hpo and args.train_csv:
        hpo_search(args.train_csv, args.val_csv, device=device)
    elif args.train_csv:
        return train(args.train_csv, args.val_csv, args.out, args.epochs,
                     args.batch_size, args.lr, mesh_spec=args.mesh,
                     device=device)
    else:
        p.error("nothing to do: pass --train-csv, --generate-db, or "
                "--search-*")


if __name__ == "__main__":
    main()
