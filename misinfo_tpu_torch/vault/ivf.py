"""IVF (inverted-file) index for archive-scale Truth Vaults.

Counterpart of ``misinfo_tpu/vault/ivf.py``: spherical k-means over the
normalized vault rows (bf16 rows on the device, f32 sums), a dense
``[C, L]`` list table plus a spill list so that every valid row sits in
exactly one probe-able slot, and a probed search that ranks the query's
``nprobe`` nearest centroids, gathers their rows and rescores them exactly
in f32. With ``nprobe == n_clusters`` the search equals brute force.

The index and its sidecar (``<vault>.ivf.npz``: the same keys, the same
``vault_digest``) are shared with the JAX package. ``build_ivf`` adds the
per-cluster sums with ``index_add_``, which on CUDA adds in no fixed
order, so centroids may differ from JAX's (and from run to run) in their
last bits; the tests hold the build to its properties and the search to
JAX's on the same index arrays.
"""

from __future__ import annotations

import zipfile
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.ops.common import matmul_f32
from misinfo_tpu_torch.vault.search import exact_matmul, topk_first

_LANE = 128
_SUB = 8
# what reading a missing, foreign or damaged sidecar raises
SIDECAR_ERRORS = (OSError, ValueError, KeyError, EOFError,
                  zipfile.BadZipFile)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class IVFIndex(NamedTuple):
    """Host-side index arrays (the engine moves them to its device)."""

    centroids: np.ndarray   # [C, D] f32, L2-normalized
    lists: np.ndarray       # [C, L] int32 vault row ids, -1 = empty slot
    spill: np.ndarray       # [S] int32 rows past their cluster's cap (always probed)
    nprobe: int             # default probe count chosen at build time
    n_rows: int             # padded vault row count the index was built for
    digest: str             # sha1 of the valid embedding rows (staleness check)

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    def device_arrays(self, device="cuda") -> Dict[str, torch.Tensor]:
        """Keys the engine merges into program batches (prefix `ivf_`), on
        the card unless the caller asks for another device."""
        return {
            "ivf_centroids": torch.as_tensor(self.centroids, device=device),
            "ivf_lists": torch.as_tensor(self.lists, device=device),
            "ivf_spill": torch.as_tensor(self.spill, device=device),
        }

    # ------------------------------------------------------------- I/O

    def save(self, path: str) -> None:
        np.savez(path, centroids=self.centroids, lists=self.lists,
                 spill=self.spill, nprobe=np.int32(self.nprobe),
                 n_rows=np.int32(self.n_rows), digest=self.digest)

    @classmethod
    def load(cls, path: str) -> Optional["IVFIndex"]:
        """The index in ``path``, or None when it is missing or unreadable
        (the engine then rebuilds it)."""
        try:
            with np.load(path) as data:
                return cls(data["centroids"], data["lists"], data["spill"],
                           int(data["nprobe"]), int(data["n_rows"]),
                           str(data["digest"]))
        except SIDECAR_ERRORS:
            return None


def vault_digest(embeddings: np.ndarray, row_valid: np.ndarray) -> str:
    """Content digest of the valid rows: detects vault edits that keep the
    same padded shape (appends within a 128-row pad bucket, in-place row
    changes). The same hex string as the JAX package's for the same
    vault."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.asarray(embeddings, np.float32)[np.asarray(row_valid)].tobytes())
    return h.hexdigest()


def _bf16_sims(rows: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """bf16 rows · bf16 centroids with f32 sums (the JAX build's dot)."""
    return matmul_f32(rows, centroids.to(torch.bfloat16).T)


def _kmeans_stats(v3: torch.Tensor, valid3: torch.Tensor,
                  centroids: torch.Tensor, n_clusters: int):
    """One Lloyd pass on the device over row chunks: per-cluster f32 sums
    and counts (pad rows go to a dropped segment)."""
    D = v3.shape[-1]
    sums = torch.zeros(n_clusters + 1, D, device=v3.device)
    counts = torch.zeros(n_clusters + 1, device=v3.device)
    for rows, ok in zip(v3, valid3):
        a = torch.argmax(_bf16_sims(rows, centroids), dim=1)
        a = torch.where(ok, a, torch.full_like(a, n_clusters))
        sums.index_add_(0, a, rows.float())
        counts.index_add_(0, a, ok.float())
    return sums[:-1], counts[:-1]


def _kmeans_assign(v3: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Final assignment against the FINAL centroids (the lists must agree
    with the centroids the query-time probe ranks)."""
    return torch.cat([torch.argmax(_bf16_sims(rows, centroids), dim=1)
                      for rows in v3]).to(torch.int32)


def build_ivf(
    embeddings: np.ndarray,      # [N, D] L2-normalized (pad rows are zero)
    row_valid: np.ndarray,       # [N] bool
    *,
    n_clusters: Optional[int] = None,
    iters: int = 8,
    cap_factor: float = 2.0,
    nprobe: Optional[int] = None,
    seed: int = 0,
    chunk_rows: int = 16384,
    device="cuda",
) -> IVFIndex:
    """Spherical k-means + dense list table; the assignment products run
    on ``device`` (the card unless the caller asks for the CPU, as JAX's
    default device), the centroid updates and the table on the host, as
    in the JAX package."""
    emb = np.asarray(embeddings, np.float32)
    valid_idx = np.flatnonzero(np.asarray(row_valid))
    n_valid = len(valid_idx)
    if n_valid == 0:
        raise ValueError("cannot build an IVF index over an empty vault "
                         "(no valid rows); callers should fall back to "
                         "exact search")
    if n_clusters is None:
        # ≈4·√N keeps lists ~√N/4 long; lane-aligned like the JAX build
        n_clusters = max(_LANE, _round_up(int(4 * np.sqrt(max(n_valid, 1))),
                                          _LANE))
    n_clusters = min(n_clusters, max(_SUB, _round_up(n_valid, _SUB)))
    rng = np.random.default_rng(seed)
    init = valid_idx[rng.choice(n_valid, size=min(n_clusters, n_valid),
                                replace=False)]
    centroids = emb[init]
    if len(init) < n_clusters:  # tiny vaults: duplicate-pad the centroid set
        reps = rng.choice(len(init), size=n_clusters - len(init))
        centroids = np.concatenate([centroids, centroids[reps]], axis=0)

    # the valid rows go to the device ONCE as bf16 [T, chunk, D]; every
    # Lloyd pass returns only the [C, D] stats to the host
    chunk = min(chunk_rows, _round_up(n_valid, _SUB))
    n_pad = _round_up(n_valid, chunk)
    v3 = torch.zeros(n_pad, emb.shape[1], dtype=torch.bfloat16, device=device)
    v3[:n_valid] = torch.from_numpy(emb[valid_idx]).to(device)
    v3 = v3.reshape(-1, chunk, emb.shape[1])
    valid3 = (torch.arange(n_pad, device=device) < n_valid).reshape(-1, chunk)
    for _ in range(max(iters, 1)):
        sums, counts = _kmeans_stats(
            v3, valid3, torch.as_tensor(centroids, device=device), n_clusters)
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        new = sums / np.maximum(counts[:, None], 1.0)
        norms = np.linalg.norm(new, axis=1, keepdims=True)
        # empty clusters keep their previous centroid (spherical k-means)
        centroids = np.where(norms > 1e-6, new / np.maximum(norms, 1e-12),
                             centroids)
    assign = _kmeans_assign(
        v3, torch.as_tensor(centroids, device=device)).cpu().numpy()[:n_valid]
    del v3

    # dense [C, L] list table + spill
    mean = max(1.0, n_valid / n_clusters)
    cap = _round_up(int(np.ceil(cap_factor * mean)), _SUB)
    lists = np.full((n_clusters, cap), -1, np.int32)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_clusters))
    pos = np.arange(n_valid) - starts[sorted_assign]   # rank within cluster
    rows = valid_idx[order].astype(np.int32)
    in_cap = pos < cap
    lists[sorted_assign[in_cap], pos[in_cap]] = rows[in_cap]
    spill_arr = rows[~in_cap]
    if spill_arr.size % _SUB:
        spill_arr = np.concatenate(
            [spill_arr, np.full((_SUB - spill_arr.size % _SUB,), -1, np.int32)])
    if nprobe is None:
        nprobe = max(1, min(n_clusters, 8))
    return IVFIndex(centroids.astype(np.float32), lists, spill_arr, nprobe,
                    emb.shape[0], vault_digest(emb, row_valid))


def _rescore(query: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[B, D] · gathered candidates [B, M, D] → [B, M] in full f32."""
    return exact_matmul(query[:, None, :], rows.transpose(1, 2))[:, 0]


def ivf_topk(
    query: torch.Tensor,        # [B, D] L2-normalized f32
    vault_emb: torch.Tensor,    # [N, D]
    row_valid: torch.Tensor,    # [N] bool
    centroids: torch.Tensor,    # [C, D]
    lists: torch.Tensor,        # [C, L] int32
    spill: torch.Tensor,        # [S] int32
    *,
    top_k: int,
    nprobe: int,
    emb16: Optional[torch.Tensor] = None,   # [N, D] bf16 copy (gather path)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probed-cluster exact-rescore top-k, all on the device.

    With ``emb16`` the candidate gather reads the bf16 copy at half the
    bytes; its bf16-ranked top-(k+8) shortlist is then rescored exactly
    from the vault rows, so the final similarities (and the 0.85 gate)
    stay f32-exact. Ties go to the lowest candidate position
    (``topk_first``), as ``lax.top_k`` resolves them."""
    B = query.shape[0]
    C = centroids.shape[0]
    nprobe = min(nprobe, C)
    csims = exact_matmul(query, centroids.T)
    _, probe = topk_first(csims, nprobe)                      # [B, P]
    cand = lists[probe.long()].reshape(B, -1)                 # [B, P·L]
    if spill.shape[0]:
        cand = torch.cat([cand, spill[None, :].expand(B, -1)], dim=1)
    safe = cand.clamp_min(0).long()
    ok = (cand >= 0) & row_valid[safe]
    neg = query.new_full((), -2.0)
    if emb16 is not None:
        # bf16 operands, f32 sums: every product is exact in f32
        s16 = _rescore(query.to(torch.bfloat16), emb16[safe])
        s16 = torch.where(ok, s16, neg)
        short = min(top_k + 8, s16.shape[1])
        _, pos16 = topk_first(s16, short)
        cand = torch.gather(cand, 1, pos16.long())            # [B, short]
        safe = cand.clamp_min(0).long()
        ok = (cand >= 0) & row_valid[safe]
    rows = vault_emb[safe]                                    # [B, M, D]
    if rows.dtype == torch.int8:   # capacity mode (ServingConfig.vault_dtype)
        rows = rows.float() * (1.0 / 127.0)
    sims = torch.where(ok, _rescore(query, rows), neg)
    k = min(top_k, sims.shape[1])
    top_s, pos = topk_first(sims, k)
    top_i = torch.gather(cand, 1, pos.long())
    if k < top_k:  # degenerate tiny index: pad to the requested k
        pad = top_k - k
        top_s = torch.cat([top_s, top_s.new_full((B, pad), -2.0)], dim=1)
        top_i = torch.cat([top_i, top_i.new_full((B, pad), -1)], dim=1)
    return top_s, top_i.to(torch.int32)
