"""RoBERTa misinfo-head trainer (reference train_roberta_detective.py).

Counterpart of ``misinfo_tpu/train/roberta_detective.py``. Recipe
preserved: WELFake-style CSV (text,label), max_len 256, batch 16, AdamW
2e-5 / wd 0.01, cosine schedule with 10% warmup, grad-clip 1.0, 80/20
split seed 42, early stop patience 3, best-val-loss checkpoint with the
optimizer state. The inference detector's tree (backbone + heads) trains
directly, so the checkpoint is what the engine serves. Master weights
stay f32; ``precision="bfloat16"`` runs the products in bf16 (each dense
casts its kernel per call), with HF-exact erf GELU.

    python -m misinfo_tpu_torch.train.roberta_detective --csv data.csv \\
        --device cuda
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.models.detector import DetectorConfig
from misinfo_tpu_torch.models.roberta import dual_head_logits
from misinfo_tpu_torch.ops.common import Policy, set_exact_f32
from misinfo_tpu_torch.preprocess.tokenizer import (
    load_clip_tokenizer, load_roberta_tokenizer)
from misinfo_tpu_torch.train.datasets import MisinfoDataset, Sample
from misinfo_tpu_torch.train.harness import (
    multihost, own_params, placer, run_training, select_device,
    split_train_val, train_mesh)
from misinfo_tpu_torch.train.losses import binary_accuracy, cross_entropy
from misinfo_tpu_torch.train.optim import (
    OptimConfig, branch_mask, make_optimizer)
from misinfo_tpu_torch.train.steps import batch_to, make_text_head_step

TEXT_KEYS = ("input_ids", "attention_mask", "labels")


def load_csv_samples(csv_path: str, text_col: str = "text",
                     label_col: str = "label",
                     max_samples: Optional[int] = None) -> List[Sample]:
    import pandas as pd

    df = pd.read_csv(csv_path)
    if max_samples:
        df = df.head(max_samples)
    return [Sample(text=str(r[text_col]), label=int(r[label_col]))
            for _, r in df.iterrows()]


def make_eval_fn(det_cfg, policy, batches_fn, head: str, device):
    @torch.no_grad()
    def eval_step(params, batch):
        ai, mis = dual_head_logits(
            params["roberta"], params["ai_head"], params["misinfo_head"],
            batch["input_ids"], batch["attention_mask"],
            det_cfg.roberta, policy)
        logits = ai if head == "ai_head" else mis
        return (cross_entropy(logits, batch["labels"]),
                binary_accuracy(logits, batch["labels"]))

    def eval_fn(params):
        losses, accs = [], []
        for batch in batches_fn():
            l, a = eval_step(params, batch_to(
                {k: v for k, v in batch.items() if k in TEXT_KEYS}, device))
            losses.append(float(l))
            accs.append(float(a))
        return {"loss": float(np.mean(losses)) if losses else 0.0,
                "accuracy": float(np.mean(accs)) if accs else 0.0}

    return eval_fn


def train(csv_path: str, out_dir: str = "roberta_detective_best",
          epochs: int = 5, batch_size: int = 16, lr: float = 2e-5,
          max_len: int = 256, det_cfg: Optional[DetectorConfig] = None,
          params: Optional[Dict] = None, max_samples: Optional[int] = None,
          head: str = "misinfo_head", freeze_backbone: bool = False,
          precision: str = "bfloat16", pack: bool = False,
          mesh_spec: Optional[str] = None, log=print, device="cuda"):
    det_cfg = det_cfg or DetectorConfig()
    # training keeps HF-exact erf GELU even in bf16
    policy = Policy(PrecisionConfig(compute_dtype=precision, gelu_mode="erf"))
    set_exact_f32(parity=policy.compute == torch.float32)
    device = torch.device(device)
    params = own_params(params, det_cfg, device)

    samples = load_csv_samples(csv_path, max_samples=max_samples)
    train_s, val_s = split_train_val(samples, 0.2, seed=42)
    rt = load_roberta_tokenizer(None, det_cfg.roberta.vocab_size)
    ct = load_clip_tokenizer(None, det_cfg.clip.vocab_size)

    def mk(ds_samples, train_mode, seed):
        return MisinfoDataset(ds_samples, rt, ct, train=train_mode,
                              roberta_len=max_len,
                              clip_len=det_cfg.clip.max_text_len,
                              image_size=det_cfg.clip.image_size, seed=seed)

    train_ds, val_ds = mk(train_s, True, 0), mk(val_s, False, 1)
    steps_per_epoch = max(1, len(train_ds) // batch_size)

    trainable = ["roberta", "ai_head", "misinfo_head"]
    if freeze_backbone:
        trainable = [head]
    tx = make_optimizer(
        OptimConfig(lr=lr, weight_decay=0.01, warmup_fraction=0.1,
                    total_steps=steps_per_epoch * epochs, clip_norm=1.0),
        trainable_mask=branch_mask(params, trainable))
    # '--mesh data=N[,model=M]': a replica a data position, the batch's
    # rows split over them, gradients summed over data (core/mesh.py)
    mesh, params, device = train_mesh(mesh_spec, params, batch_size, device)
    place = placer(mesh, device)
    opt_state = tx.init(params)
    if pack:
        # perf mode: ragged sequences packed into batch_size rows of
        # max_len under segment attention (the cosine schedule's length
        # stays the unpacked upper bound)
        from misinfo_tpu_torch.train.steps import make_packed_text_head_step
        step = make_packed_text_head_step(tx, det_cfg, policy, head=head)
    else:
        step = make_text_head_step(tx, det_cfg, policy, head=head)

    def train_batches():
        from misinfo_tpu_torch.train.datasets import prefetch
        if pack:
            gen = train_ds.packed_batches(n_rows=batch_size,
                                          n_slots=batch_size * 4)
        else:
            gen = ({k: v for k, v in b.items() if k in TEXT_KEYS}
                   for b in train_ds.batches(batch_size,
                                             drop_remainder=True))
        for b in prefetch(gen):
            yield place(b)

    def val_batches():
        from misinfo_tpu_torch.train.harness import eval_batches
        yield from eval_batches(
            lambda bs: val_ds.batches(bs, shuffle=False, drop_remainder=True),
            len(val_ds), batch_size)

    def ckpt(params, opt_state, epoch, metrics):
        from misinfo_tpu_torch.checkpoints.io import save_checkpoint
        save_checkpoint(out_dir, params, opt_state,
                        {"epoch": epoch, **metrics,
                         "trainer": "roberta_detective"})

    return run_training(
        params, opt_state, step, train_batches,
        make_eval_fn(det_cfg, policy, val_batches, head, device),
        epochs=epochs, select_metric="loss", select_mode="min",
        early_stop_patience=3, checkpoint_fn=ckpt, log=log)


def main(argv=None):
    p = argparse.ArgumentParser(description="RoBERTa misinfo detective "
                                "trainer (CUDA)")
    p.add_argument("--csv", required=True, help="CSV with text,label columns")
    p.add_argument("--out", default="roberta_detective_best")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--pack", action="store_true",
                   help="sequence-packed batches (perf mode)")
    p.add_argument("--mesh", default=None,
                   help="device mesh for training, e.g. 'data=8' or "
                        "'data=4,model=2' (across processes: init_multihost's "
                        "env vars)")
    p.add_argument("--device", choices=["auto", "cpu", "cuda"],
                   default="auto")
    args = p.parse_args(argv)
    device = select_device(args.device, args.mesh)
    with multihost():
        return train(args.csv, args.out, args.epochs, args.batch_size,
                     args.lr, args.max_len, max_samples=args.max_samples,
                     pack=args.pack, mesh_spec=args.mesh, device=device)


if __name__ == "__main__":
    main()
