"""Fusion-judge trainer (reference train_fusion_judge.py).

Counterpart of ``misinfo_tpu/train/fusion_judge.py``: rows (text,
image_path, label) → 5-score vectors → fusion MLP; AdamW 1e-3 wd 0.01,
cosine anneal, no clip, CE loss, batch 16, 10 epochs, best-accuracy
checkpoint of the full detector tree (fusion trained, the other branches
as served). The score matrix is computed once by a batched engine sweep
(``precompute_scores``: on the card the engine's default serving path,
every tower FFN through the int8 FFN kernel K1), then the 2.6k-parameter
MLP trains on it. A row whose image is missing or whose batch fails gets
a zero vector.

    python -m misinfo_tpu_torch.train.fusion_judge --csv rows.csv \\
        --device cuda
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.models.fusion import fusion_apply
from misinfo_tpu_torch.train.harness import (
    multihost, placer, run_training, select_device, train_mesh)
from misinfo_tpu_torch.train.losses import binary_accuracy, cross_entropy
from misinfo_tpu_torch.train.optim import (
    OptimConfig, branch_mask, make_optimizer)
from misinfo_tpu_torch.train.steps import batch_to, make_fusion_step
from misinfo_tpu_torch.utils.tree import clone_tree


def load_fusion_csv(csv_path: str, max_samples: Optional[int] = None):
    import pandas as pd

    df = pd.read_csv(csv_path)
    if max_samples:
        df = df.head(max_samples)
    rows = []
    for _, r in df.iterrows():
        rows.append({"text": str(r.get("text", "")),
                     "image": str(r.get("image_path", "")) or None,
                     "label": int(r.get("label", 0))})
    return rows


def precompute_scores(engine, rows: List[Dict], batch_size: int = 32,
                      log=print) -> Tuple[np.ndarray, np.ndarray]:
    """One batched engine sweep → [N,5] score matrix + [N] labels."""
    vectors = np.zeros((len(rows), 5), np.float32)
    labels = np.asarray([r["label"] for r in rows], np.int32)
    requests, req_idx = [], []
    for i, r in enumerate(rows):
        img = r.get("image")
        if img and os.path.exists(img):
            requests.append({"text": r["text"], "image": img})
            req_idx.append(i)
    log(f"precomputing scores for {len(requests)}/{len(rows)} analyzable rows")
    for s in range(0, len(requests), batch_size):
        chunk = requests[s:s + batch_size]
        try:
            outs = engine.analyze_batch(chunk)
        except Exception as e:
            log(f"batch {s // batch_size} failed ({e}); zero vectors")
            continue
        for j, out in enumerate(outs):
            sc = out["scores"]
            vectors[req_idx[s + j]] = [sc["ai_score"], sc["misinfo_score"],
                                       sc["deepfake_score"],
                                       sc["clip_similarity"],
                                       sc["vault_discrepancy"]]
    return vectors, labels


def train_on_scores(score_vectors: np.ndarray, labels: np.ndarray,
                    params: Dict, out_dir: str = "forensics_master_final",
                    epochs: int = 10, batch_size: int = 16, lr: float = 1e-3,
                    mesh_spec: Optional[str] = None, log=print,
                    device="cuda"):
    device = torch.device(device)
    # own the params: the steps update in place, and the caller's tree is
    # often a live engine's
    params = clone_tree(params, device)
    n = len(labels)
    n_val = max(1, int(0.2 * n))
    rng = np.random.default_rng(42)
    order = rng.permutation(n)
    val_idx, train_idx = order[:n_val], order[n_val:]

    steps = max(1, len(train_idx) // batch_size) * epochs
    tx = make_optimizer(OptimConfig(lr=lr, weight_decay=0.01,
                                    warmup_fraction=0.0, total_steps=steps,
                                    clip_norm=None),
                        trainable_mask=branch_mask(params, ["fusion"]))
    # '--mesh data=N': plain data parallelism over the score matrix
    mesh, params, device = train_mesh(mesh_spec, params, batch_size, device)
    place = placer(mesh, device)
    opt_state = tx.init(params)
    step = make_fusion_step(tx)

    def train_batches():
        idx = rng.permutation(train_idx)
        for s in range(0, len(idx) - batch_size + 1, batch_size):
            chunk = idx[s:s + batch_size]
            yield place({"score_vectors": score_vectors[chunk],
                         "labels": labels[chunk]})

    val = batch_to({"vecs": score_vectors[val_idx],
                    "labels": labels[val_idx]}, device)

    @torch.no_grad()
    def eval_fn(params):
        logits = fusion_apply(params["fusion"], val["vecs"])
        return {"loss": float(cross_entropy(logits, val["labels"])),
                "accuracy": float(binary_accuracy(logits, val["labels"]))}

    def ckpt(params, opt_state, epoch, metrics):
        from misinfo_tpu_torch.checkpoints.io import save_checkpoint
        from misinfo_tpu_torch.ops.serving import deoptimize_params
        # the full detector tree (fusion + the frozen branches), put back
        # from the engine's serving layout (bf16 / int8) into the canonical
        # one, so that any engine reloads the dir via ModelPaths.orbax_dir
        save_checkpoint(out_dir, deoptimize_params(params), opt_state,
                        {"epoch": epoch, **metrics,
                         "trainer": "fusion_judge"})

    return run_training(params, opt_state, step, train_batches, eval_fn,
                        epochs=epochs, select_metric="accuracy",
                        select_mode="max", checkpoint_fn=ckpt, log=log)


def train(csv_path: str, out_dir: str = "forensics_master_final",
          engine=None, epochs: int = 10, batch_size: int = 16,
          lr: float = 1e-3, max_samples: Optional[int] = None,
          mesh_spec: Optional[str] = None, log=print, device="cuda"):
    if engine is None:
        from misinfo_tpu_torch.engine.forensics import MisinfoForensics
        engine = MisinfoForensics(device=device)
    rows = load_fusion_csv(csv_path, max_samples)
    vectors, labels = precompute_scores(engine, rows, log=log)
    return train_on_scores(vectors, labels, engine.params, out_dir,
                           epochs, batch_size, lr, mesh_spec=mesh_spec,
                           log=log, device=engine.device)


def test_fusion_model(engine=None,
                      image_glob: str = "guardian_images/*.jpg",
                      text: str = "Breaking news from the archive",
                      device="cuda") -> Dict:
    """Post-training smoke test (reference test_fusion_model)."""
    import glob

    if engine is None:
        from misinfo_tpu_torch.engine.forensics import MisinfoForensics
        engine = MisinfoForensics(device=device)
    images = glob.glob(image_glob)
    return engine.analyze(text=text,
                          image_path=images[0] if images else None,
                          verbose=True)


def main(argv=None):
    p = argparse.ArgumentParser(description="Fusion judge trainer (CUDA)")
    p.add_argument("--csv", default="Final_Fusion_Train.csv")
    p.add_argument("--out", default="forensics_master_final")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--test", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="device mesh for training, e.g. 'data=8' or "
                        "'data=4,model=2' (across processes: init_multihost's "
                        "env vars)")
    p.add_argument("--device", choices=["auto", "cpu", "cuda"],
                   default="auto")
    args = p.parse_args(argv)
    device = select_device(args.device, args.mesh)
    if args.test:
        return test_fusion_model(device=device)
    with multihost():
        return train(args.csv, args.out, epochs=args.epochs,
                     batch_size=args.batch_size, lr=args.lr,
                     max_samples=args.max_samples, mesh_spec=args.mesh,
                     device=device)


if __name__ == "__main__":
    main()
