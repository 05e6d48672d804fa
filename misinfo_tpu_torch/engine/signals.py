"""The fused 5-signal programs — the serving hot path.

Counterpart of ``misinfo_tpu/engine/signals.py``. One call per modality
combination maps (RoBERTa tokens, CLIP tokens, images, vault) to the five
scores, the verdict, the probabilities and the vault top-k, with the
reference's gating arithmetic:

  * ``full``        — text AND visual → fusion MLP verdict
  * ``text_only``   — fake_prob = misinfo_score
  * ``visual_only`` — fake_prob = max(deepfake, vault_discrepancy)
  * ``text_packed`` — ``text_only`` over packed rows (block-diagonal
    attention, CLS scores gathered per request; ``packed_text_program``)

plus ``video_program`` (``video`` / ``video_text``), which treats sampled
frames as a batch axis and applies the reference's mean/mean/max
aggregation (reference :563-573) before the verdict. An image batch may
carry staged frames and resize parameters instead of the two 224px
flavors (``ServingConfig.device_resize``); the program then derives both
flavors on the device (ops/resize.py).

PyTorch runs eagerly, so a program is a plain function; the engine calls
it under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from misinfo_tpu_torch.core.config import ForensicsConfig
from misinfo_tpu_torch.models.clip import clip_image_features, clip_text_features
from misinfo_tpu_torch.models.detector import DetectorConfig
from misinfo_tpu_torch.models.efficientnet import effnet_apply
from misinfo_tpu_torch.models.fusion import fusion_apply
from misinfo_tpu_torch.models.roberta import (
    dual_head_logits, head_apply, roberta_encode)
from misinfo_tpu_torch.ops.common import Policy, l2_normalize, softmax_f32
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.ops.resize import device_resize_pair
from misinfo_tpu_torch.vault.search import vault_search


class SignalOutput(NamedTuple):
    """Score vector + verdict per request (reference report keys)."""

    ai_score: torch.Tensor            # [B]
    misinfo_score: torch.Tensor       # [B]
    deepfake_score: torch.Tensor      # [B]
    clip_similarity: torch.Tensor     # [B]
    vault_discrepancy: torch.Tensor   # [B]
    text_similarity: torch.Tensor     # [B]
    verdict: torch.Tensor             # [B] int32 (1=FAKE)
    confidence: torch.Tensor          # [B]
    fake_probability: torch.Tensor    # [B]
    real_probability: torch.Tensor    # [B]
    vault_top_sims: torch.Tensor      # [B, K]
    vault_top_idx: torch.Tensor       # [B, K]


# the ten per-request vectors of SignalOutput, ahead of K sims and K indices
_N_VEC_FIELDS = 10


def pack_signal_output(out: SignalOutput) -> torch.Tensor:
    """Coalesce a SignalOutput into ONE f32 tensor ``[B, 10 + 2K]`` for a
    single device→host copy. ``vault_top_idx`` is int32 bit-viewed as f32,
    exact for every index value."""
    vecs = torch.stack([
        out.ai_score, out.misinfo_score, out.deepfake_score,
        out.clip_similarity, out.vault_discrepancy, out.text_similarity,
        out.verdict.float(), out.confidence, out.fake_probability,
        out.real_probability,
    ], dim=1).float()
    idx_f = out.vault_top_idx.to(torch.int32).contiguous().view(torch.float32)
    return torch.cat([vecs, out.vault_top_sims.float(), idx_f], dim=1)


def unpack_signal_output(arr) -> SignalOutput:
    """Host-side inverse of ``pack_signal_output`` (numpy in, numpy out)."""
    arr = np.asarray(arr, np.float32)
    K = (arr.shape[1] - _N_VEC_FIELDS) // 2
    v = arr[:, :_N_VEC_FIELDS]
    sims = arr[:, _N_VEC_FIELDS:_N_VEC_FIELDS + K]
    idx = np.ascontiguousarray(arr[:, _N_VEC_FIELDS + K:]).view(np.int32)
    return SignalOutput(
        ai_score=v[:, 0], misinfo_score=v[:, 1], deepfake_score=v[:, 2],
        clip_similarity=v[:, 3], vault_discrepancy=v[:, 4],
        text_similarity=v[:, 5], verdict=v[:, 6].astype(np.int32),
        confidence=v[:, 7], fake_probability=v[:, 8],
        real_probability=v[:, 9], vault_top_sims=sims, vault_top_idx=idx)


def _text_branch(params, batch, det_cfg, policy, use_pallas):
    if "roberta_seg" in batch:
        # packed rows: block-diagonal attention, per-segment positions,
        # CLS scores gathered per request
        hidden = roberta_encode(
            params["roberta"], batch["roberta_ids"], batch["roberta_mask"],
            det_cfg.roberta, policy, use_pallas=use_pallas,
            position_ids=batch["roberta_pos"],
            segment_ids=batch["roberta_seg"])
        pooled = hidden[batch["cls_rows"].long(), batch["cls_cols"].long()]
        ai_logits = head_apply(params["ai_head"], pooled, policy)
        mis_logits = head_apply(params["misinfo_head"], pooled, policy)
    else:
        ai_logits, mis_logits = dual_head_logits(
            params["roberta"], params["ai_head"], params["misinfo_head"],
            batch["roberta_ids"], batch["roberta_mask"], det_cfg.roberta,
            policy, use_pallas)
    return softmax_f32(ai_logits)[:, 1], softmax_f32(mis_logits)[:, 1]


def _visual_branch(params, batch, det_cfg, cfg, policy, use_pallas,
                   caption_text_emb=None, has_caption=None):
    if "image_staged" in batch:
        # on-device resize: the host shipped one padded frame per image;
        # both 224px flavors are derived here (ServingConfig.device_resize)
        eff_u8, clip_u8 = device_resize_pair(
            batch["image_staged"], batch["resize_params"],
            out_size=cfg.seq.image_size)
    else:
        eff_u8, clip_u8 = batch["image_effnet"], batch["image_clip"]
    img_eff = normalize_images(eff_u8, "imagenet", policy.compute)
    img_clip = normalize_images(clip_u8, "clip", policy.compute)
    deepfake_score = softmax_f32(
        effnet_apply(params["efficientnet"], img_eff, policy))[:, 1]
    image_emb = l2_normalize(clip_image_features(
        params["clip"], img_clip, det_cfg.clip, policy, use_pallas))
    ivf = ({k: batch[k]
            for k in ("ivf_centroids", "ivf_lists", "ivf_spill", "ivf_emb16")
            if k in batch}
           if "ivf_centroids" in batch else None)
    vr = vault_search(
        image_emb, batch["vault_emb"], batch["vault_valid"],
        top_k=cfg.seq.vault_top_k,
        reuse_threshold=cfg.thresholds.vault_reuse,
        caption_text_emb=caption_text_emb,
        vault_text_emb=batch.get("vault_text_emb"),
        has_caption=has_caption,
        ivf=ivf, nprobe=cfg.serving.ivf_nprobe,
        vault_scale=batch.get("vault_scale"),
        vault_text_scale=batch.get("vault_text_scale"))
    return deepfake_score, image_emb, vr


def _verdict_from_fusion(params, scores_vec):
    probs = softmax_f32(fusion_apply(params["fusion"], scores_vec))
    real_p, fake_p = probs[:, 0], probs[:, 1]
    verdict = (fake_p > 0.5).to(torch.int32)
    return verdict, torch.where(verdict == 1, fake_p, real_p), fake_p, real_p


def _verdict_from_prob(fake_p):
    """Fallback verdict arithmetic (reference misinfo_forensics.py:890-899)."""
    fake_p = fake_p.clamp(0.0, 1.0)
    real_p = 1.0 - fake_p
    verdict = (fake_p > 0.5).to(torch.int32)
    return verdict, torch.where(verdict == 1, fake_p, real_p), fake_p, real_p


def signals_program(params: Dict, batch: Dict[str, torch.Tensor], *,
                    variant: str, det_cfg: DetectorConfig,
                    cfg: ForensicsConfig, policy: Policy,
                    use_pallas=False) -> SignalOutput:
    """One program (``full``, ``text_only``, ``visual_only`` or
    ``text_packed``) over a device batch → SignalOutput. ``use_pallas``
    (False, True or "ffn") selects the towers' opt-in kernels."""
    if variant == "text_packed":
        variant = "text_only"   # the packed keys route _text_branch
    B = (batch["cls_rows"].shape[0] if "cls_rows" in batch
         else batch["roberta_ids"].shape[0] if "roberta_ids" in batch
         else batch["image_staged"].shape[0] if "image_staged" in batch
         else batch["image_clip"].shape[0])
    dev = next(iter(batch.values())).device
    zeros = torch.zeros(B, device=dev)
    K = cfg.seq.vault_top_k

    if variant == "text_only":
        ai, mis = _text_branch(params, batch, det_cfg, policy, use_pallas)
        verdict, conf, fake_p, real_p = _verdict_from_prob(mis)
        return SignalOutput(
            ai, mis, zeros, zeros, zeros, zeros, verdict, conf, fake_p,
            real_p, torch.zeros(B, K, device=dev),
            torch.full((B, K), -1, dtype=torch.int32, device=dev))

    if variant == "visual_only":
        deep, _, vr = _visual_branch(params, batch, det_cfg, cfg, policy,
                                     use_pallas)
        verdict, conf, fake_p, real_p = _verdict_from_prob(
            torch.maximum(deep, vr.vault_discrepancy))
        return SignalOutput(zeros, zeros, deep, zeros, vr.vault_discrepancy,
                            vr.text_similarity, verdict, conf, fake_p, real_p,
                            vr.top_sims, vr.top_idx)

    if variant == "full":
        ai, mis = _text_branch(params, batch, det_cfg, policy, use_pallas)
        cap_emb = l2_normalize(clip_text_features(
            params["clip"], batch["clip_ids"], batch["clip_mask"],
            det_cfg.clip, policy, use_pallas))
        deep, img_emb, vr = _visual_branch(
            params, batch, det_cfg, cfg, policy, use_pallas,
            caption_text_emb=cap_emb,
            has_caption=torch.ones(B, dtype=torch.bool, device=dev))
        clip_sim = (cap_emb * img_emb).sum(dim=-1)
        scores_vec = torch.stack([ai, mis, deep, clip_sim,
                                  vr.vault_discrepancy], dim=1)
        verdict, conf, fake_p, real_p = _verdict_from_fusion(params,
                                                             scores_vec)
        return SignalOutput(ai, mis, deep, clip_sim, vr.vault_discrepancy,
                            vr.text_similarity, verdict, conf, fake_p, real_p,
                            vr.top_sims, vr.top_idx)

    raise ValueError(f"unknown variant {variant!r}")


def packed_text_program(params: Dict, batch: Dict[str, torch.Tensor], *,
                        det_cfg: DetectorConfig, cfg: ForensicsConfig,
                        policy: Policy, use_pallas=False) -> SignalOutput:
    """``text_only`` over a PACKED token matrix (preprocess/packing.py):
    several ragged requests per row, block-diagonal attention, per-segment
    positions, CLS scores gathered at (cls_rows, cls_cols). Verdict
    semantics identical to ``text_only`` (reference misinfo_forensics.py:
    883-889: fake_prob = misinfo_score); the packed keys in ``batch``
    route ``_text_branch`` onto the packed path."""
    return signals_program(params, batch, variant="text_only",
                           det_cfg=det_cfg, cfg=cfg, policy=policy,
                           use_pallas=use_pallas)


def video_program(params: Dict, batch: Dict[str, torch.Tensor], *,
                  has_text: bool, det_cfg: DetectorConfig,
                  cfg: ForensicsConfig, policy: Policy,
                  use_pallas=False) -> SignalOutput:
    """Video forensics over V videos in one call: ``frame_valid`` is [F]
    (one video, the legacy shape) or [V, F]; images are [V·F, ...] (frames
    ride the batch axis) and text tensors [V, S]. Per-video aggregation
    matches reference analyze_video (misinfo_forensics.py:563-573): mean
    deepfake, mean CLIP similarity over the valid frames, MAX vault
    discrepancy (invalid frames at -1; the first frame of the largest
    wins, and its text similarity and matches are reported); then the
    standard verdict gating. Outputs are [V]."""
    fv_in = batch["frame_valid"]
    fv = (fv_in[None, :] if fv_in.dim() == 1 else fv_in).float()
    V, F = fv.shape
    dev = fv.device
    n = fv.sum(dim=1).clamp_min(1.0)                        # [V]

    if has_text:
        ai, mis = _text_branch(params, batch, det_cfg, policy, use_pallas)
        ai, mis = ai[:V], mis[:V]
        cap_emb = l2_normalize(clip_text_features(
            params["clip"], batch["clip_ids"], batch["clip_mask"],
            det_cfg.clip, policy, use_pallas))[:V]          # [V, D]
        cap_per_frame = cap_emb.repeat_interleave(F, dim=0)  # [V·F, D]
    else:
        ai = mis = torch.zeros(V, device=dev)
        cap_emb = cap_per_frame = None

    deep, img_emb, vr = _visual_branch(
        params, batch, det_cfg, cfg, policy, use_pallas,
        caption_text_emb=cap_per_frame,
        has_caption=(torch.ones(V * F, dtype=torch.bool, device=dev)
                     if has_text else None))

    deep_mean = (deep.reshape(V, F) * fv).sum(dim=1) / n
    if cap_emb is not None:
        sims = (img_emb * cap_per_frame).sum(dim=-1).reshape(V, F)
        clip_mean = (sims * fv).sum(dim=1) / n
    else:
        clip_mean = torch.zeros(V, device=dev)

    vd = torch.where(fv > 0, vr.vault_discrepancy.reshape(V, F),
                     torch.full_like(fv, -1.0))
    best_f = torch.argmax(vd, dim=1)                        # [V]
    rows = torch.arange(V, device=dev)
    vault_disc = vd[rows, best_f].clamp_min(0.0)
    text_sim = vr.text_similarity.reshape(V, F)[rows, best_f]
    K = vr.top_sims.shape[-1]
    top_sims = vr.top_sims.reshape(V, F, K)[rows, best_f]
    top_idx = vr.top_idx.reshape(V, F, K)[rows, best_f]

    if has_text:
        scores_vec = torch.stack([ai, mis, deep_mean, clip_mean, vault_disc],
                                 dim=1)
        verdict, conf, fake_p, real_p = _verdict_from_fusion(params,
                                                             scores_vec)
    else:
        verdict, conf, fake_p, real_p = _verdict_from_prob(
            torch.maximum(deep_mean, vault_disc))
    return SignalOutput(ai, mis, deep_mean, clip_mean, vault_disc, text_sim,
                        verdict, conf, fake_p, real_p, top_sims, top_idx)
