"""AI-head trainer on HC3-style data (reference train_ai_head.py).

Counterpart of ``misinfo_tpu/train/ai_head.py``: loads a previously
trained detector checkpoint over the seeded init, freezes everything but
``ai_head``, LR 1e-3, 3 epochs, loss on ai_logits only, best checkpoint
by validation loss (the text trainer's policy).

    python -m misinfo_tpu_torch.train.ai_head --csv hc3.csv \\
        --base-checkpoint roberta_detective_best --device cuda
"""

from __future__ import annotations

import argparse
from typing import Optional

from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.train.harness import multihost, select_device
from misinfo_tpu_torch.train.roberta_detective import train as _train_text


def train(csv_path: str, out_dir: str = "ai_head_best",
          welfake_checkpoint: Optional[str] = None,
          epochs: int = 3, batch_size: int = 16, lr: float = 1e-3,
          det_cfg: Optional[DetectorConfig] = None,
          max_samples: Optional[int] = None,
          mesh_spec: Optional[str] = None, log=print, device="cuda"):
    det_cfg = det_cfg or DetectorConfig()
    params = detector_init(0, det_cfg)
    if welfake_checkpoint:
        from misinfo_tpu_torch.checkpoints.io import load_checkpoint
        restored = load_checkpoint(welfake_checkpoint, params)
        if restored is not None:
            params = restored
            log(f"loaded base checkpoint from {welfake_checkpoint}")
    # freeze_backbone=True + head='ai_head' → only ai_head gets updates
    return _train_text(csv_path, out_dir, epochs, batch_size, lr,
                       max_len=256, det_cfg=det_cfg, params=params,
                       max_samples=max_samples, head="ai_head",
                       freeze_backbone=True, mesh_spec=mesh_spec, log=log,
                       device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="AI-text head trainer (HC3, "
                                "CUDA)")
    p.add_argument("--csv", required=True,
                   help="CSV with text,label columns (label 1 = AI-generated)")
    p.add_argument("--out", default="ai_head_best")
    p.add_argument("--base-checkpoint", default=None,
                   help="native checkpoint dir of a trained detector")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--mesh", default=None,
                   help="device mesh for training, e.g. 'data=8' or "
                        "'data=4,model=2' (across processes: init_multihost's "
                        "env vars)")
    p.add_argument("--device", choices=["auto", "cpu", "cuda"],
                   default="auto")
    args = p.parse_args(argv)
    device = select_device(args.device, args.mesh)
    with multihost():
        return train(args.csv, args.out, args.base_checkpoint, args.epochs,
                     args.batch_size, args.lr, max_samples=args.max_samples,
                     mesh_spec=args.mesh, device=device)


if __name__ == "__main__":
    main()
