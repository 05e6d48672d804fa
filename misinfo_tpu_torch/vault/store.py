"""Truth Vault embedding store.

Host copy of ``misinfo_tpu/vault/store.py``, importable without JAX;
held to the original by tests/test_torch_host.py.

Host-side container for the Guardian-article CLIP embedding database
(C5/L7 in SURVEY.md). Loads the reference's pickle formats with the same
dual-schema handling (reference misinfo_forensics.py:216-246):

  * ``{'embeddings': ..., 'metadata': [...]}``
  * ``{'image_embeddings': ..., 'text_contents': [...], 'image_paths': [...]}``

plus a TPU-native ``.npz`` format that additionally carries the titles'
CLIP *text* embeddings, enabling the caption-vs-headline similarity check
(reference :468-484) to run inside the fused XLA program with a gather
instead of an extra CLIP forward per query.

TPU-first differences from the reference:
  * embeddings are L2-normalized ONCE at load (the reference re-normalizes
    the entire vault on every query, misinfo_forensics.py:443-445)
  * rows are zero-padded to a multiple of 128 (lane-aligned matmul tiles);
    a validity mask excludes pad rows from top-k
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

_ROW_ALIGN = 128


def _l2norm_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


class TruthVault:
    """Normalized, padded, device-ready vault."""

    def __init__(self,
                 image_embeddings: np.ndarray,          # [N, D]
                 metadata: List[Dict],
                 text_embeddings: Optional[np.ndarray] = None):
        assert len(metadata) == image_embeddings.shape[0]
        self.num_articles = image_embeddings.shape[0]
        self.dim = image_embeddings.shape[1]
        self.metadata = metadata

        n_pad = ((self.num_articles + _ROW_ALIGN - 1) // _ROW_ALIGN) * _ROW_ALIGN
        emb = np.zeros((n_pad, self.dim), np.float32)
        emb[: self.num_articles] = _l2norm_rows(
            np.asarray(image_embeddings, np.float32))
        self.embeddings = emb
        self.row_valid = np.zeros((n_pad,), np.bool_)
        self.row_valid[: self.num_articles] = True

        if text_embeddings is not None:
            te = np.zeros((n_pad, text_embeddings.shape[1]), np.float32)
            te[: self.num_articles] = _l2norm_rows(
                np.asarray(text_embeddings, np.float32))
            self.text_embeddings: Optional[np.ndarray] = te
        else:
            self.text_embeddings = None

    # ------------------------------------------------------------- I/O

    @classmethod
    def load(cls, path: str) -> Optional["TruthVault"]:
        """Load .npz (native) or .pkl (reference-compatible). Returns None
        when the file is missing or unreadable — soft-degradation contract
        (reference misinfo_forensics.py:243-246)."""
        if not os.path.exists(path):
            return None
        try:
            if path.endswith(".npz"):
                data = np.load(path, allow_pickle=True)
                meta = list(data["metadata"])
                te = data["text_embeddings"] if "text_embeddings" in data else None
                return cls(data["image_embeddings"], meta, te)
            with open(path, "rb") as f:
                raw = pickle.load(f)
        except Exception:
            return None
        return cls.from_reference_dict(raw)

    @classmethod
    def from_reference_dict(cls, raw: Dict) -> Optional["TruthVault"]:
        """Dual-schema handling, matching reference misinfo_forensics.py:222-238."""
        if "embeddings" in raw:
            emb = np.asarray(raw["embeddings"])
            meta = list(raw["metadata"])
            te = raw.get("text_embeddings")
            te = np.asarray(te) if te is not None else None
            return cls(emb, meta, te)
        if "image_embeddings" in raw:
            emb = np.asarray(raw["image_embeddings"])
            texts = raw.get("text_contents", [])
            paths = raw.get("image_paths", [])
            meta = []
            for i in range(len(texts)):
                meta.append({
                    "title": texts[i] if i < len(texts) else "Unknown",
                    "url": paths[i] if i < len(paths) else "N/A",
                    "date": "N/A",
                })
            emb = emb[: len(meta)]
            te = raw.get("text_embeddings")
            te = np.asarray(te)[: len(meta)] if te is not None else None
            return cls(emb, meta, te)
        return None  # unknown format (reference :236)

    def save(self, path: str) -> None:
        if path.endswith(".npz"):
            arrays = {
                "image_embeddings": self.embeddings[: self.num_articles],
                "metadata": np.asarray(self.metadata, dtype=object),
            }
            if self.text_embeddings is not None:
                arrays["text_embeddings"] = self.text_embeddings[: self.num_articles]
            np.savez(path, **arrays)
        else:
            payload = {
                "embeddings": self.embeddings[: self.num_articles],
                "metadata": self.metadata,
            }
            if self.text_embeddings is not None:
                payload["text_embeddings"] = self.text_embeddings[: self.num_articles]
            with open(path, "wb") as f:
                pickle.dump(payload, f)

    # -------------------------------------------------------- metadata

    def matches_from_indices(self, indices, similarities) -> List[Dict]:
        """Format top-k rows as the reference's match dicts
        (misinfo_forensics.py:452-460)."""
        out = []
        for idx, sim in zip(indices, similarities):
            idx = int(idx)
            # negative = empty-slot sentinel (IVF path); >= num_articles =
            # pad row (exact path) — both are non-matches
            if idx < 0 or idx >= self.num_articles:
                continue
            m = self.metadata[idx]
            match = {
                "similarity": float(sim),
                "title": m.get("title", "Unknown"),
                "url": m.get("url", "N/A"),
                "date": m.get("date", "N/A"),
            }
            # dashboards surface the matched archive image when its local
            # path is known (reference forensics_dashboard.py:243-245 uses
            # `url` for this; native vaults may carry an explicit path)
            if m.get("image_path"):
                match["image_path"] = m["image_path"]
            out.append(match)
        return out

    @staticmethod
    def empty_result() -> Dict:
        """Vault-unavailable result (reference misinfo_forensics.py:422-428)."""
        return {"vault_discrepancy": 0.0, "matches": [],
                "vault_available": False, "text_similarity": 0.0}
