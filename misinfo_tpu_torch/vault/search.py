"""On-device vault kNN: one exact f32 matmul + top-k.

Counterpart of the exact path of ``misinfo_tpu/vault/search.py``
(``vault_dtype="float32"``, the default): cosine sims in full f32 (no
TF32; the 0.85 reuse gate depends on it), invalid rows filled with −2.0,
top-k with ties going to the lowest index as ``lax.top_k`` does, then the
reuse gate and the caption-vs-headline similarity gather.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class VaultResult(NamedTuple):
    top_sims: torch.Tensor          # [B, K] f32
    top_idx: torch.Tensor           # [B, K] int32
    vault_discrepancy: torch.Tensor  # [B] f32
    text_similarity: torch.Tensor   # [B] f32


def vault_sims(query: torch.Tensor, vault_emb: torch.Tensor) -> torch.Tensor:
    """[B,D]×[N,D]ᵀ cosine sims in full f32."""
    if vault_emb.dtype != torch.float32:
        raise NotImplementedError(
            "only f32 vault rows are ported; the bf16/int8/int4 capacity "
            "modes are ROADMAP.md M14")
    if query.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("vault sims need exact f32: TF32 matmuls are on "
                           "(ops.common.set_exact_f32)")
    return query.float() @ vault_emb.T


def topk_first(sims: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Exact top-k as k passes of (argmax → record → mask): argmax returns
    the first maximum, so ties resolve to the lowest index (padded rows all
    sit at −2.0), which ``torch.topk`` does not promise."""
    cur = sims.clone()
    rows = torch.arange(sims.shape[0], device=sims.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=1)
        vals.append(cur[rows, i])
        idxs.append(i.to(torch.int32))
        cur[rows, i] = float("-inf")
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def vault_search(
    query_image_emb: torch.Tensor,   # [B, D] L2-normalized f32
    vault_emb: torch.Tensor,         # [N, D] L2-normalized, zero rows padded
    row_valid: torch.Tensor,         # [N] bool
    *,
    top_k: int = 5,
    reuse_threshold: float = 0.85,
    caption_text_emb: Optional[torch.Tensor] = None,  # [B, D] normalized
    vault_text_emb: Optional[torch.Tensor] = None,    # [N, D] normalized
    has_caption: Optional[torch.Tensor] = None,       # [B] bool
) -> VaultResult:
    sims = vault_sims(query_image_emb, vault_emb)
    sims = torch.where(row_valid[None, :], sims, sims.new_full((), -2.0))
    top_sims, top_idx = topk_first(sims, top_k)
    return _gate_and_text(top_sims, top_idx, reuse_threshold,
                          caption_text_emb, vault_text_emb, has_caption)


def _gate_and_text(top_sims, top_idx, reuse_threshold,
                   caption_text_emb=None, vault_text_emb=None,
                   has_caption=None) -> VaultResult:
    """The exact 0.85 reuse gate + the conditional caption-vs-headline
    text similarity."""
    max_sim = top_sims[:, 0]
    gate = max_sim > reuse_threshold
    zero = max_sim.new_zeros(())
    vault_discrepancy = torch.where(gate, max_sim, zero)
    if caption_text_emb is not None and vault_text_emb is not None:
        matched = vault_text_emb[top_idx[:, 0].long()].float()
        tsim = (caption_text_emb * matched).sum(dim=-1)
        if has_caption is not None:
            gate = gate & has_caption
        text_similarity = torch.where(gate, tsim, zero)
    else:
        text_similarity = torch.zeros_like(max_sim)
    return VaultResult(top_sims, top_idx.to(torch.int32), vault_discrepancy,
                       text_similarity)
