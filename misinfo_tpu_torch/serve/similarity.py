"""Standalone CLIP similarity engine (C26, reference
clip_similarity_engine.py), in PyTorch.

Counterpart of ``misinfo_tpu/serve/similarity.py``: Match/Mismatch at the
0.25 cosine threshold (reference :18) with the tiered explanations
(strong/moderate/weak match, strong mismatch < 0.1, reference :164-174).
``analyze_pairs`` scores many (text, image) pairs in one forward of both
towers (models/clip.py::clip_similarity) on one device, the card by
default. Its ``checkpoint`` is a native checkpoint directory
(checkpoints/io.py) laid over the seeded init, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from misinfo_tpu_torch.checkpoints.from_jax import to_device
from misinfo_tpu_torch.checkpoints.io import load_checkpoint
from misinfo_tpu_torch.core.config import PrecisionConfig
from misinfo_tpu_torch.models.clip import clip_similarity
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy, set_exact_f32
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.preprocess.image import batch_images, image_to_array
from misinfo_tpu_torch.preprocess.tokenizer import load_clip_tokenizer

MATCH_THRESHOLD = 0.25  # reference clip_similarity_engine.py:18


def tiered_explanation(sim: float, threshold: float = MATCH_THRESHOLD) -> str:
    """Tiered wording (reference :164-174)."""
    if sim >= threshold:
        if sim >= 0.35:
            return ("Strong match: the image content closely corresponds "
                    "to the text description.")
        if sim >= 0.30:
            return ("Moderate match: the image is consistent with the text, "
                    "with good semantic overlap.")
        return ("Weak match: the image plausibly relates to the text, but "
                "the connection is loose.")
    if sim < 0.10:
        return ("Strong mismatch: the image and text appear unrelated — "
                "possible out-of-context use.")
    return ("Mismatch: the image does not clearly support the text "
            "description.")


class ClipSimilarityEngine:
    """Self-contained dual-tower similarity scorer. ``params`` is the
    detector tree (or its ``clip`` branch) as torch tensors; without it the
    engine serves the port's seeded init (seed 0), with ``checkpoint``'s
    tree over it when given."""

    def __init__(self, det_cfg: Optional[DetectorConfig] = None,
                 params: Optional[Dict] = None,
                 checkpoint: Optional[str] = None,
                 threshold: float = MATCH_THRESHOLD,
                 precision: str = "float32", device="cuda"):
        self.det_cfg = det_cfg or DetectorConfig()
        self.policy = Policy(PrecisionConfig(compute_dtype=precision))
        set_exact_f32(parity=self.policy.compute == torch.float32)
        self.threshold = threshold
        self.device = torch.device(device)
        if params is None:
            params = detector_init(0, self.det_cfg)
            if checkpoint:
                restored = load_checkpoint(checkpoint, params)
                if restored is not None:
                    params = restored
        params = params["clip"] if "clip" in params else params
        self.params = to_device(params, self.device)
        self.tokenizer = load_clip_tokenizer(None, self.det_cfg.clip.vocab_size)

    def analyze_pairs(self, texts: Sequence[str], images: Sequence
                      ) -> List[Dict]:
        size = self.det_cfg.clip.image_size
        ids, mask = self.tokenizer.batch(list(texts),
                                         self.det_cfg.clip.max_text_len)
        arrs = [image_to_array(im, "clip", size) for im in images]
        dev = self.device
        with torch.inference_mode():
            imgs = normalize_images(
                torch.from_numpy(batch_images(arrs, size)).to(dev), "clip",
                self.policy.compute)
            sims = clip_similarity(
                self.params, torch.from_numpy(np.asarray(ids)).to(dev),
                torch.from_numpy(np.asarray(mask)).to(dev), imgs,
                self.det_cfg.clip, self.policy)[0].cpu().numpy()
        out = []
        for t, s in zip(texts, sims):
            s = float(s)
            out.append({
                "text": t,
                "similarity": s,
                "label": "Match" if s >= self.threshold else "Mismatch",
                "explanation": tiered_explanation(s, self.threshold),
            })
        return out

    def analyze(self, text: str, image) -> Dict:
        return self.analyze_pairs([text], [image])[0]


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Standalone CLIP similarity engine")
    p.add_argument("--text", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", choices=["auto", "cuda", "cpu"],
                   default="auto")
    args = p.parse_args(argv)
    from misinfo_tpu_torch.serve.device import select_device
    result = ClipSimilarityEngine(
        checkpoint=args.checkpoint,
        device=select_device(args.device)).analyze(args.text, args.image)
    print(f"{result['label']}  sim={result['similarity']:.4f}")
    print(result["explanation"])


if __name__ == "__main__":
    main()
