"""CIFAKE EfficientNet trainer (reference train_cifake_forensics.py).

Counterpart of ``misinfo_tpu/train/cifake_efficientnet.py``: REAL from
``test/REAL``, FAKE from ``train/FAKE`` + ``test/FAKE``, balanced
2,500/label seed 42, 80/20 split; train augmentations flip + color
jitter; CLIP-stat normalization; Adam 1e-4 (constant, no clip), batch 16,
10 epochs; best-accuracy checkpoint. BatchNorm trains on batch
statistics and folds its running statistics back after each update.

    python -m misinfo_tpu_torch.train.cifake_efficientnet \\
        --cifake-root CIFAKE --device cuda
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.models.detector import DetectorConfig
from misinfo_tpu_torch.models.efficientnet import effnet_apply
from misinfo_tpu_torch.ops.common import Policy, set_exact_f32
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.preprocess.image import image_to_array
from misinfo_tpu_torch.train.datasets import train_augment
from misinfo_tpu_torch.train.harness import (
    eval_batches, multihost, own_params, placer, run_training, select_device,
    split_train_val, train_mesh)
from misinfo_tpu_torch.train.losses import binary_accuracy, cross_entropy
from misinfo_tpu_torch.train.optim import (
    OptimConfig, branch_mask, make_optimizer)
from misinfo_tpu_torch.train.steps import batch_to, make_effnet_step


def load_cifake_paths(root: str, per_label: int = 2500,
                      seed: int = 42) -> List[Tuple[str, int]]:
    """Balanced path list: REAL ← test/REAL; FAKE ← train/FAKE +
    test/FAKE; ``per_label`` each."""
    rng = np.random.default_rng(seed)
    real = sorted(glob.glob(os.path.join(root, "test", "REAL", "*")))
    fake = (sorted(glob.glob(os.path.join(root, "train", "FAKE", "*")))
            + sorted(glob.glob(os.path.join(root, "test", "FAKE", "*"))))
    rng.shuffle(real)
    rng.shuffle(fake)
    items = ([(p, 0) for p in real[:per_label]]
             + [(p, 1) for p in fake[:per_label]])
    rng.shuffle(items)
    return items


class _ImageBatcher:
    def __init__(self, items, image_size: int, train: bool, seed: int):
        self.items = items
        self.image_size = image_size
        self.train = train
        self.rng = np.random.default_rng(seed)

    def batches(self, batch_size: int, drop_remainder: bool = True):
        idx = np.arange(len(self.items))
        if self.train:
            self.rng.shuffle(idx)
        for s in range(0, len(idx), batch_size):
            chunk = idx[s:s + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                break
            imgs, labels = [], []
            for i in chunk:
                path, lab = self.items[i]
                try:
                    arr = image_to_array(path, "effnet", self.image_size)
                except Exception:  # unreadable → zeros (reference :63-66)
                    arr = np.zeros((self.image_size, self.image_size, 3),
                                   np.uint8)
                if self.train:
                    arr = train_augment(arr, self.rng, jpeg=False)
                imgs.append(arr)
                labels.append(lab)
            yield {"images_u8": np.stack(imgs),
                   "labels": np.asarray(labels, np.int32)}


def train(cifake_root: str, out_dir: str = "efficientnet_cifake_best",
          epochs: int = 10, batch_size: int = 16, lr: float = 1e-4,
          per_label: int = 2500, image_size: int = 224,
          det_cfg: Optional[DetectorConfig] = None,
          params: Optional[Dict] = None, precision: str = "bfloat16",
          items: Optional[List[Tuple[str, int]]] = None,
          mesh_spec: Optional[str] = None, log=print, device="cuda"):
    det_cfg = det_cfg or DetectorConfig()
    policy = Policy(PrecisionConfig(compute_dtype=precision))
    set_exact_f32(parity=policy.compute == torch.float32)
    device = torch.device(device)
    params = own_params(params, det_cfg, device)
    if items is None:
        items = load_cifake_paths(cifake_root, per_label)
    train_items, val_items = split_train_val(items, 0.2, seed=42)
    train_b = _ImageBatcher(train_items, image_size, True, 0)
    val_b = _ImageBatcher(val_items, image_size, False, 1)

    steps = max(1, len(train_items) // batch_size) * epochs
    tx = make_optimizer(
        OptimConfig(lr=lr, weight_decay=0.0, warmup_fraction=0.0,
                    total_steps=steps, clip_norm=None, schedule="constant"),
        trainable_mask=branch_mask(params, ["efficientnet"]))
    # '--mesh data=N': BatchNorm's statistics over the global batch
    mesh, params, device = train_mesh(mesh_spec, params, batch_size, device)
    place = placer(mesh, device)
    opt_state = tx.init(params)
    # CLIP-stat normalization quirk preserved (train_cifake_forensics.py:44,50)
    step = make_effnet_step(tx, policy, stats="clip")

    @torch.no_grad()
    def eval_step(params, batch):
        imgs = normalize_images(batch["images_u8"], "clip", policy.compute)
        logits, _ = effnet_apply(params["efficientnet"], imgs, policy=policy)
        return (cross_entropy(logits, batch["labels"]),
                binary_accuracy(logits, batch["labels"]))

    def eval_fn(params):
        ls, accs = [], []
        for b in eval_batches(val_b.batches, len(val_b.items), batch_size):
            l, a = eval_step(params, batch_to(b, device))
            ls.append(float(l))
            accs.append(float(a))
        return {"loss": float(np.mean(ls)) if ls else 0.0,
                "accuracy": float(np.mean(accs)) if accs else 0.0}

    def train_batches():
        from misinfo_tpu_torch.train.datasets import prefetch
        for b in prefetch(train_b.batches(batch_size)):
            yield place(b)

    def ckpt(params, opt_state, epoch, metrics):
        from misinfo_tpu_torch.checkpoints.io import save_checkpoint
        save_checkpoint(out_dir, params, opt_state,
                        {"epoch": epoch, **metrics,
                         "trainer": "cifake_efficientnet"})

    return run_training(params, opt_state, step, train_batches, eval_fn,
                        epochs=epochs, select_metric="accuracy",
                        select_mode="max", checkpoint_fn=ckpt, log=log)


def main(argv=None):
    p = argparse.ArgumentParser(description="CIFAKE EfficientNet trainer "
                                "(CUDA)")
    p.add_argument("--cifake-root", required=True)
    p.add_argument("--out", default="efficientnet_cifake_best")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--per-label", type=int, default=2500)
    p.add_argument("--mesh", default=None,
                   help="device mesh for training, e.g. 'data=8' or "
                        "'data=4,model=2' (across processes: init_multihost's "
                        "env vars)")
    p.add_argument("--device", choices=["auto", "cpu", "cuda"],
                   default="auto")
    args = p.parse_args(argv)
    device = select_device(args.device, args.mesh)
    with multihost():
        return train(args.cifake_root, args.out, args.epochs,
                     args.batch_size, args.lr, args.per_label,
                     mesh_spec=args.mesh, device=device)


if __name__ == "__main__":
    main()
