"""On-device vault kNN: one similarity product + top-k per batch.

Counterpart of ``misinfo_tpu/vault/search.py``. ``vault_sims`` takes
every row type of ``ServingConfig.vault_dtype``:

* f32 rows (the default): exact f32, no TF32 (the 0.85 reuse gate
  depends on it);
* bf16 rows: bf16 operands with f32 sums;
* int8 rows: the query rounded to int8 too, int8 · int8 sums (exact),
  times 1/127²;
* packed int4 rows with per-row scales (``row_scale``): the int4
  kernels of ``vault/int4.py``.

Invalid rows are filled with −2.0, then top-k. ``topk_first`` is exact
with ties going to the lowest index, as ``lax.top_k`` resolves them, so
it stands for every mode of the JAX package's ``_topk`` (iterative,
chunked, approx at recall 1.0, mono: those differ in speed on a TPU, not
in results). Then the reuse gate and the caption-vs-headline similarity
gather, with int8 or int4 title rows dequantized after the gather.
``vault_search(ivf=...)`` scores only the probed clusters' rows
(``vault/ivf.py``); IVF and int4 rows are mutually exclusive.
``vault_search_sharded`` serves a vault row-sharded over a mesh's data
axis: a local top-k per shard, then one merge.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from misinfo_tpu_torch.ops.common import matmul_f32

_INT8_SCALE = 127.0  # rows are L2-normalized → every element is in [-1, 1]
# int8 rows are widened to bf16 this many at a time (a copy of the whole
# plane would cost twice the int8 vault's memory)
_INT8_CHUNK_ROWS = 1 << 16


class VaultResult(NamedTuple):
    top_sims: torch.Tensor          # [B, K] f32
    top_idx: torch.Tensor           # [B, K] int32
    vault_discrepancy: torch.Tensor  # [B] f32
    text_similarity: torch.Tensor   # [B] f32


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched too) with both operands widened to f32 and full
    f32 sums: on the card only with TF32 off (``ops.common.
    set_exact_f32``), which the f32 vault's 0.85 gate, the IVF rescoring
    and the exact integer sums of the int4 plain versions depend on."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact f32 products need TF32 matmuls off "
                           "(ops.common.set_exact_f32)")
    return a.float() @ b.float()


def quantize_rows_int8(rows):
    """Symmetric per-tensor int8 quantization of L2-normalized embedding
    rows (|element| ≤ 1 → scale 127), numpy on the host. 4× the articles
    per card against f32; cosine error ~0.5% RMS."""
    return np.clip(np.round(np.asarray(rows, np.float32) * _INT8_SCALE),
                   -127, 127).astype(np.int8)


def _dequant(rows: torch.Tensor) -> torch.Tensor:
    if rows.dtype == torch.int8:
        return rows.float() * (1.0 / _INT8_SCALE)
    return rows.float()


def vault_sims(query: torch.Tensor, vault_emb: torch.Tensor,
               row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B,D]×[N,D]ᵀ cosine sims over any vault row type (module
    docstring); ``row_scale`` marks ``vault_emb`` as packed int4 rows."""
    if row_scale is not None:
        from misinfo_tpu_torch.vault.int4 import int4_vault_sims
        return int4_vault_sims(query, vault_emb, row_scale)
    if vault_emb.dtype == torch.int8:
        q = torch.clamp(torch.round(query.float() * _INT8_SCALE), -127, 127)
        # int8 values are exact in bf16 and every partial sum is an
        # integer below 512·127² < 2^24: the f32 sums are exact
        q = q.to(torch.bfloat16)
        acc = torch.cat([
            matmul_f32(q, vault_emb[i:i + _INT8_CHUNK_ROWS].to(
                torch.bfloat16).T)
            for i in range(0, vault_emb.shape[0], _INT8_CHUNK_ROWS)], dim=1)
        return acc * (1.0 / (_INT8_SCALE * _INT8_SCALE))
    if vault_emb.dtype == torch.bfloat16:
        return matmul_f32(query.to(torch.bfloat16), vault_emb.T)
    return exact_matmul(query, vault_emb.T)


def topk_first(sims: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Exact top-k as k passes of (argmax → record → mask): argmax returns
    the first maximum, so ties resolve to the lowest index (padded rows all
    sit at −2.0), which ``torch.topk`` does not promise. The mask is a
    scatter of the scalar, which copies nothing to the device."""
    cur = sims.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=1)[:, None]
        vals.append(cur.gather(1, i))
        idxs.append(i.to(torch.int32))
        cur.scatter_(1, i, float("-inf"))
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def vault_search(
    query_image_emb: torch.Tensor,   # [B, D] L2-normalized f32
    vault_emb: torch.Tensor,         # [N, D] normalized rows, or int4 [N, D/2]
    row_valid: torch.Tensor,         # [N] bool
    *,
    top_k: int = 5,
    reuse_threshold: float = 0.85,
    caption_text_emb: Optional[torch.Tensor] = None,  # [B, D] normalized
    vault_text_emb: Optional[torch.Tensor] = None,    # [N, D] normalized
    has_caption: Optional[torch.Tensor] = None,       # [B] bool
    ivf: Optional[Dict[str, torch.Tensor]] = None,    # ivf.py device arrays
    nprobe: int = 8,
    vault_scale: Optional[torch.Tensor] = None,       # [N] f32 → int4 rows
    vault_text_scale: Optional[torch.Tensor] = None,  # [N] f32 → int4 titles
) -> VaultResult:
    """Batched vault search on the device. With ``ivf`` only the probed
    clusters' rows are scored; ``vault_scale`` marks ``vault_emb`` as
    packed int4 rows and ``vault_text_scale`` likewise the titles."""
    if ivf is not None and vault_scale is not None:
        raise ValueError("int4 vault storage and IVF are mutually "
                         "exclusive (engine enforces this at vault prep)")
    if ivf is not None:
        from misinfo_tpu_torch.vault.ivf import ivf_topk
        top_sims, top_idx = ivf_topk(
            query_image_emb, vault_emb, row_valid,
            ivf["ivf_centroids"], ivf["ivf_lists"], ivf["ivf_spill"],
            top_k=top_k, nprobe=nprobe, emb16=ivf.get("ivf_emb16"))
    else:
        sims = vault_sims(query_image_emb, vault_emb, row_scale=vault_scale)
        sims = torch.where(row_valid[None, :], sims, sims.new_full((), -2.0))
        top_sims, top_idx = topk_first(sims, top_k)
    return _gate_and_text(top_sims, top_idx, reuse_threshold,
                          caption_text_emb, vault_text_emb, has_caption,
                          vault_text_scale=vault_text_scale)


def _matched_rows(emb, i: torch.Tensor) -> torch.Tensor:
    """Rows ``i`` of ``emb``: a tensor, or a list of equal row shards (a
    row-sharded plane), gathered onto ``i``'s device. Each shard gives
    its candidate for every row and the owner's is kept, so that nothing
    waits on the indices' values."""
    if not isinstance(emb, (list, tuple)):
        return emb[i]
    n = emb[0].shape[0]
    out = None
    for d, shard in enumerate(emb):
        local = (i - d * n).clamp(0, n - 1).to(shard.device)
        rows = shard[local].to(i.device)
        own = (i // n) == d
        if out is None:
            out = rows
        else:
            out = torch.where(own[:, None] if rows.dim() > 1 else own,
                              rows, out)
    return out


def _gate_and_text(top_sims, top_idx, reuse_threshold,
                   caption_text_emb=None, vault_text_emb=None,
                   has_caption=None, vault_text_scale=None) -> VaultResult:
    """The exact 0.85 reuse gate + the conditional caption-vs-headline
    text similarity (only the B matched title rows are dequantized; the
    title plane may be row-sharded, a list of shards)."""
    max_sim = top_sims[:, 0]
    gate = max_sim > reuse_threshold
    zero = max_sim.new_zeros(())
    vault_discrepancy = torch.where(gate, max_sim, zero)
    if caption_text_emb is not None and vault_text_emb is not None:
        i = top_idx[:, 0].long()
        if vault_text_scale is not None:
            from misinfo_tpu_torch.vault.int4 import unpack_int4
            matched = (unpack_int4(_matched_rows(vault_text_emb, i)).float()
                       * _matched_rows(vault_text_scale, i)[:, None])
        else:
            matched = _dequant(_matched_rows(vault_text_emb, i))
        tsim = (caption_text_emb * matched).sum(dim=-1)
        if has_caption is not None:
            gate = gate & has_caption
        text_similarity = torch.where(gate, tsim, zero)
    else:
        text_similarity = torch.zeros_like(max_sim)
    return VaultResult(top_sims, top_idx.to(torch.int32), vault_discrepancy,
                       text_similarity)


def _gathered(x, dev: torch.device) -> Optional[torch.Tensor]:
    """A batch-sharded operand (a list of per-position pieces) or a whole
    one, as one tensor on ``dev``."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return torch.cat([c.to(dev) for c in x], dim=0)
    return x.to(dev)


def sharded_vault_sims(query, vault_shard, shard_offset, row_valid_shard,
                       top_k: int, axis_name: str = "data", row_scale=None):
    """Local product + local top-k per row shard, then the K·shards
    candidates merged by one more top-k: O(K·shards) moved instead of N.
    ``vault_shard``, ``shard_offset`` (each shard's first global row),
    ``row_valid_shard`` and ``row_scale`` (int4 rows) hold one entry per
    data position, each on its device; ``query`` is the whole batch (or
    its per-position pieces), scored against every shard. Returns
    (top_sims, top_idx) [B, K] on the first shard's device. Candidates
    are merged in shard order, so that equal sims keep the lowest global
    index, as one top-k over all rows does (``topk_first``)."""
    del axis_name     # the shards' order is the data axis
    dev0 = vault_shard[0].device
    q_all = _gathered(query, dev0)
    cand_s, cand_i = [], []
    for d, shard in enumerate(vault_shard):
        dev = shard.device
        sims = vault_sims(q_all.to(dev), shard,
                          row_scale=None if row_scale is None
                          else row_scale[d])
        sims = torch.where(row_valid_shard[d][None, :], sims,
                           sims.new_full((), -2.0))
        loc_s, loc_i = topk_first(sims, min(top_k, shard.shape[0]))
        cand_s.append(loc_s.to(dev0))
        cand_i.append((loc_i + int(shard_offset[d])).to(dev0))
    all_s = torch.cat(cand_s, dim=1)
    all_i = torch.cat(cand_i, dim=1)
    top_s, pos = topk_first(all_s, top_k)
    return top_s, all_i.gather(1, pos.long())


def vault_search_sharded(
    query_image_emb,              # [B, D], or its per-position pieces
    vault_emb,                    # [N, D] row shards, one per position
    row_valid,                    # [N] row shards
    *,
    mesh,
    top_k: int = 5,
    reuse_threshold: float = 0.85,
    caption_text_emb=None,        # [B, D] or its pieces
    vault_text_emb=None,          # row shards like vault_emb
    has_caption=None,             # [B] or its pieces
    axis_name: str = "data",
    vault_scale=None,             # [N] shards → int4-packed rows
    vault_text_scale=None,        # [N] shards → int4 titles
) -> VaultResult:
    """The engine's row-sharded vault: the vault lives split across the
    mesh's data axis (a list of equal row shards, shard d on data position
    d's device), each position scores the full query batch against its
    shard with ``vault_sims`` (K10a/K10b for int4 rows on the card, the
    exact f32 product for f32 rows) and contributes only K candidates,
    and the final top-k merges O(K·positions) values on the first
    position's device (``sharded_vault_sims``). The result, for all B rows
    on that device, equals the exact replicated search bit for bit, ties
    included (``topk_first``'s lowest-index rule holds across shards).
    The gate and text-similarity tail is ``vault_search``'s; the matched
    titles are gathered from their shards."""
    n_pos = mesh.shape[axis_name]
    if len(vault_emb) != n_pos or len(row_valid) != n_pos:
        raise ValueError(f"vault_search_sharded: expected {n_pos} row "
                         f"shards on the {axis_name!r} axis, got "
                         f"{len(vault_emb)}")
    rows = vault_emb[0].shape[0]
    top_sims, top_idx = sharded_vault_sims(
        query_image_emb, vault_emb, [d * rows for d in range(n_pos)],
        row_valid, top_k, axis_name, row_scale=vault_scale)
    dev0 = top_sims.device
    return _gate_and_text(top_sims, top_idx, reuse_threshold,
                          _gathered(caption_text_emb, dev0), vault_text_emb,
                          _gathered(has_caption, dev0),
                          vault_text_scale=vault_text_scale)
