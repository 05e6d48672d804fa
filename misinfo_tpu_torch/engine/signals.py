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
it under ``torch.inference_mode`` through ``SignalPrograms``. Over a mesh
(``mesh_program``) each data position runs the program on its piece of
the batch, the vault search joins them where the rows are sharded, and
packed text rows hand each request's CLS token to its position.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.core.config import ForensicsConfig
from misinfo_tpu_torch.core.mesh import split_rows
from misinfo_tpu_torch.models.clip import clip_image_features, clip_text_features
from misinfo_tpu_torch.models.detector import DetectorConfig
from misinfo_tpu_torch.models.efficientnet import effnet_apply
from misinfo_tpu_torch.models.fusion import fusion_apply
from misinfo_tpu_torch.models.roberta import (
    dual_head_logits, head_apply, roberta_encode)
from misinfo_tpu_torch.ops.common import Policy, l2_normalize, softmax_f32
from misinfo_tpu_torch.ops.image_ops import normalize_images
from misinfo_tpu_torch.ops.resize import device_resize_pair
from misinfo_tpu_torch.vault.search import (
    VaultResult, vault_search, vault_search_sharded)


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
        hidden = _packed_hidden(params, batch, det_cfg, policy, use_pallas)
        pooled = hidden[batch["cls_rows"].long(), batch["cls_cols"].long()]
        return _head_scores(params, pooled, policy)
    ai_logits, mis_logits = dual_head_logits(
        params["roberta"], params["ai_head"], params["misinfo_head"],
        batch["roberta_ids"], batch["roberta_mask"], det_cfg.roberta,
        policy, use_pallas)
    return softmax_f32(ai_logits)[:, 1], softmax_f32(mis_logits)[:, 1]


def _packed_hidden(params, batch, det_cfg, policy, use_pallas):
    return roberta_encode(
        params["roberta"], batch["roberta_ids"], batch["roberta_mask"],
        det_cfg.roberta, policy, use_pallas=use_pallas,
        position_ids=batch["roberta_pos"], segment_ids=batch["roberta_seg"])


def _head_scores(params, pooled, policy):
    ai_logits = head_apply(params["ai_head"], pooled, policy)
    mis_logits = head_apply(params["misinfo_head"], pooled, policy)
    return softmax_f32(ai_logits)[:, 1], softmax_f32(mis_logits)[:, 1]


def _visual_front(params, batch, det_cfg, cfg, policy, use_pallas):
    """(deepfake score, L2-normalized CLIP image embedding) per image."""
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
    logits, _ = effnet_apply(params["efficientnet"], img_eff, policy=policy)
    deepfake_score = softmax_f32(logits)[:, 1]
    image_emb = l2_normalize(clip_image_features(
        params["clip"], img_clip, det_cfg.clip, policy, use_pallas))
    return deepfake_score, image_emb


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


class _Front(NamedTuple):
    """A program's work before the vault search: the text scores, the
    caption embeddings, and per image row the deepfake score, the image
    embedding and the caption (and its flag) the search gates on."""
    n: int                    # requests (videos for a video program)
    ai: Optional[torch.Tensor]
    mis: Optional[torch.Tensor]
    cap_emb: Optional[torch.Tensor]
    deep: Optional[torch.Tensor]
    img_emb: Optional[torch.Tensor]
    caption: Optional[torch.Tensor]
    has_caption: Optional[torch.Tensor]


def _front(params, batch, kind, det_cfg, cfg, policy, use_pallas,
           text=None) -> _Front:
    """``kind`` (full, text_only, visual_only, video, video_text) up to the
    vault search. ``text`` hands in the (ai, mis) scores a mesh program
    computed over packed rows split across positions."""
    dev = next(iter(batch.values())).device
    video = kind.startswith("video")
    if video:
        fv = batch["frame_valid"]
        n, F = (1, fv.shape[0]) if fv.dim() == 1 else tuple(fv.shape)
    else:
        F = 1
        n = (batch["cls_rows"].shape[0] if "cls_rows" in batch
             else batch["roberta_ids"].shape[0] if "roberta_ids" in batch
             else batch["image_staged"].shape[0] if "image_staged" in batch
             else batch["image_clip"].shape[0])
    ai = mis = cap_emb = caption = has_caption = None
    if kind in ("full", "text_only", "video_text"):
        ai, mis = (text if text is not None else
                   _text_branch(params, batch, det_cfg, policy, use_pallas))
    if kind in ("full", "video_text"):
        cap_emb = l2_normalize(clip_text_features(
            params["clip"], batch["clip_ids"], batch["clip_mask"],
            det_cfg.clip, policy, use_pallas))
        if video:
            ai, mis, cap_emb = ai[:n], mis[:n], cap_emb[:n]
            caption = cap_emb.repeat_interleave(F, dim=0)   # [V·F, D]
        else:
            caption = cap_emb
        has_caption = torch.ones(n * F, dtype=torch.bool, device=dev)
    deep = img_emb = None
    if kind != "text_only":
        deep, img_emb = _visual_front(params, batch, det_cfg, cfg, policy,
                                      use_pallas)
    return _Front(n, ai, mis, cap_emb, deep, img_emb, caption, has_caption)


def _search(batch, f: _Front, cfg, vault_mesh=None):
    """The vault search of the front's image embeddings over the batch's
    vault arrays; with ``vault_mesh`` those are row shards over its data
    axis (``vault_search_sharded``; the front's fields may then be lists
    of per-position pieces)."""
    kw = dict(top_k=cfg.seq.vault_top_k,
              reuse_threshold=cfg.thresholds.vault_reuse,
              caption_text_emb=f.caption,
              vault_text_emb=batch.get("vault_text_emb"),
              has_caption=f.has_caption, vault_scale=batch.get("vault_scale"),
              vault_text_scale=batch.get("vault_text_scale"))
    if vault_mesh is not None:
        return vault_search_sharded(f.img_emb, batch["vault_emb"],
                                    batch["vault_valid"], mesh=vault_mesh,
                                    **kw)
    ivf = ({k: batch[k]
            for k in ("ivf_centroids", "ivf_lists", "ivf_spill", "ivf_emb16")
            if k in batch}
           if "ivf_centroids" in batch else None)
    return vault_search(f.img_emb, batch["vault_emb"], batch["vault_valid"],
                        ivf=ivf, nprobe=cfg.serving.ivf_nprobe, **kw)


def _back(params, kind, f: _Front, vr, batch, cfg) -> SignalOutput:
    """The verdict arithmetic of ``kind`` after the vault search."""
    B = f.n
    dev = next(iter(batch.values())).device
    zeros = torch.zeros(B, device=dev)
    if kind == "text_only":
        K = cfg.seq.vault_top_k
        verdict, conf, fake_p, real_p = _verdict_from_prob(f.mis)
        return SignalOutput(
            f.ai, f.mis, zeros, zeros, zeros, zeros, verdict, conf, fake_p,
            real_p, torch.zeros(B, K, device=dev),
            torch.full((B, K), -1, dtype=torch.int32, device=dev))
    if kind == "visual_only":
        verdict, conf, fake_p, real_p = _verdict_from_prob(
            torch.maximum(f.deep, vr.vault_discrepancy))
        return SignalOutput(zeros, zeros, f.deep, zeros, vr.vault_discrepancy,
                            vr.text_similarity, verdict, conf, fake_p, real_p,
                            vr.top_sims, vr.top_idx)
    if kind == "full":
        clip_sim = (f.cap_emb * f.img_emb).sum(dim=-1)
        scores_vec = torch.stack([f.ai, f.mis, f.deep, clip_sim,
                                  vr.vault_discrepancy], dim=1)
        verdict, conf, fake_p, real_p = _verdict_from_fusion(params,
                                                             scores_vec)
        return SignalOutput(f.ai, f.mis, f.deep, clip_sim,
                            vr.vault_discrepancy, vr.text_similarity,
                            verdict, conf, fake_p, real_p, vr.top_sims,
                            vr.top_idx)
    # video / video_text: per-video aggregation over the valid frames
    fv_in = batch["frame_valid"]
    fv = (fv_in[None, :] if fv_in.dim() == 1 else fv_in).float()
    V, F = fv.shape
    n = fv.sum(dim=1).clamp_min(1.0)                        # [V]
    has_text = kind == "video_text"
    ai = f.ai if has_text else torch.zeros(V, device=dev)
    mis = f.mis if has_text else torch.zeros(V, device=dev)
    deep_mean = (f.deep.reshape(V, F) * fv).sum(dim=1) / n
    if has_text:
        sims = (f.img_emb * f.caption).sum(dim=-1).reshape(V, F)
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


def _run_program(params, batch, kind, det_cfg, cfg, policy, use_pallas,
                 vault_mesh=None):
    f = _front(params, batch, kind, det_cfg, cfg, policy, use_pallas)
    vr = (None if kind == "text_only"
          else _search(batch, f, cfg, vault_mesh))
    return _back(params, kind, f, vr, batch, cfg)


def signals_program(params: Dict, batch: Dict[str, torch.Tensor], *,
                    variant: str, det_cfg: DetectorConfig,
                    cfg: ForensicsConfig, policy: Policy,
                    use_pallas=False, vault_mesh=None,
                    mesh_gather: bool = False) -> SignalOutput:
    """One program (``full``, ``text_only``, ``visual_only`` or
    ``text_packed``) over a device batch → SignalOutput. ``use_pallas``
    (False, True or "ffn") selects the towers' opt-in kernels. With
    ``vault_mesh`` the batch's vault arrays are row shards over its data
    axis (lists, ``vault_search_sharded``). ``mesh_gather`` is JAX's
    switch to a one-hot CLS gather for data-sharded packed rows; here a
    batch on one device gathers directly, and ``mesh_program`` gathers
    per position, so it changes nothing."""
    del mesh_gather
    if variant == "text_packed":
        variant = "text_only"   # the packed keys route _text_branch
    if variant not in ("full", "text_only", "visual_only"):
        raise ValueError(f"unknown variant {variant!r}")
    return _run_program(params, batch, variant, det_cfg, cfg, policy,
                        use_pallas, vault_mesh)


def packed_text_program(params: Dict, batch: Dict[str, torch.Tensor], *,
                        det_cfg: DetectorConfig, cfg: ForensicsConfig,
                        policy: Policy, use_pallas=False,
                        mesh_gather: bool = False) -> SignalOutput:
    """``text_only`` over a PACKED token matrix (preprocess/packing.py):
    several ragged requests per row, block-diagonal attention, per-segment
    positions, CLS scores gathered at (cls_rows, cls_cols). Verdict
    semantics identical to ``text_only`` (reference misinfo_forensics.py:
    883-889: fake_prob = misinfo_score); the packed keys in ``batch``
    route ``_text_branch`` onto the packed path."""
    return signals_program(params, batch, variant="text_only",
                           det_cfg=det_cfg, cfg=cfg, policy=policy,
                           use_pallas=use_pallas, mesh_gather=mesh_gather)


def video_program(params: Dict, batch: Dict[str, torch.Tensor], *,
                  has_text: bool, det_cfg: DetectorConfig,
                  cfg: ForensicsConfig, policy: Policy,
                  use_pallas=False, vault_mesh=None,
                  mesh_gather: bool = False) -> SignalOutput:
    """Video forensics over V videos in one call: ``frame_valid`` is [F]
    (one video, the legacy shape) or [V, F]; images are [V·F, ...] (frames
    ride the batch axis) and text tensors [V, S]. Per-video aggregation
    matches reference analyze_video (misinfo_forensics.py:563-573): mean
    deepfake, mean CLIP similarity over the valid frames, MAX vault
    discrepancy (invalid frames at -1; the first frame of the largest
    wins, and its text similarity and matches are reported); then the
    standard verdict gating. Outputs are [V]. ``vault_mesh`` and
    ``mesh_gather`` as in ``signals_program``."""
    del mesh_gather
    return _run_program(params, batch,
                        "video_text" if has_text else "video", det_cfg, cfg,
                        policy, use_pallas, vault_mesh)


# ------------------------------------------------------------ mesh serving

def _is_vault_key(k: str) -> bool:
    return k.startswith("vault") or k.startswith("ivf")


def _packed_text_mesh(params, batches, mesh, det_cfg, policy, use_pallas):
    """Packed rows split over the data positions: each position encodes
    its rows; every request's CLS token is taken from the position that
    holds its row (each position picks from its own rows, the owner's
    pick is kept), then each position scores its own requests. Returns
    (ai, mis) per position."""
    devs = mesh.data_devices
    hidden = [_packed_hidden(params.row(d), b, det_cfg, policy, use_pallas)
              for d, b in enumerate(batches)]
    R = hidden[0].shape[0]
    rows = torch.cat([b["cls_rows"].long().to(devs[0]) for b in batches])
    cols = torch.cat([b["cls_cols"].long().to(devs[0]) for b in batches])
    pooled = None
    for d, h in enumerate(hidden):
        local = (rows - d * R).clamp(0, R - 1)
        pick = h[local.to(h.device), cols.to(h.device)].to(devs[0])
        own = ((rows // R) == d)[:, None]
        pooled = pick if pooled is None else torch.where(own, pick, pooled)
    n = batches[0]["cls_rows"].shape[0]
    return [_head_scores(params.row(d), pooled[d * n:(d + 1) * n].to(dev),
                         policy)
            for d, dev in enumerate(devs)]


def _split_result(vr: VaultResult, sizes, devs) -> list:
    out, lo = [], 0
    for n, dev in zip(sizes, devs):
        out.append(VaultResult(*(t[lo:lo + n].to(dev) for t in vr)))
        lo += n
    return out


def mesh_program(params, batch: Dict, *, kind: str, mesh, det_cfg, cfg,
                 policy, use_pallas=False, vault_sharded: bool = False
                 ) -> SignalOutput:
    """One program of ``kind`` over a mesh, driven from this process: the
    request tensors split their leading axis over the data positions
    (lists of pieces are taken as they are), each position runs the
    program on its device with its tree (``params.row(d)``, a
    ``ShardedParams``; split pieces run over the model group), and the
    outputs are gathered, in position order, on the first position's
    device. Vault arrays are lists, one entry per data position: replicas,
    or row shards with ``vault_sharded`` (then every position's queries
    meet every shard in ``vault_search_sharded``)."""
    devs = mesh.data_devices
    n_pos = len(devs)
    pieces = {k: (v if isinstance(v, (list, tuple)) else split_rows(v, mesh))
              for k, v in batch.items() if not _is_vault_key(k)}
    batches = [{k: v[d] for k, v in pieces.items()} for d in range(n_pos)]
    vaults = [{k: v[d] for k, v in batch.items() if _is_vault_key(k)}
              for d in range(n_pos)]
    texts = [None] * n_pos
    if kind in ("full", "text_only") and "roberta_seg" in batches[0]:
        texts = _packed_text_mesh(params, batches, mesh, det_cfg, policy,
                                  use_pallas)
    fronts = [_front(params.row(d), b, kind, det_cfg, cfg, policy,
                     use_pallas, text=texts[d])
              for d, b in enumerate(batches)]
    if kind == "text_only":
        vrs = [None] * n_pos
    elif vault_sharded:
        def pieces_of(field):
            first = getattr(fronts[0], field)
            return None if first is None else [getattr(f, field)
                                               for f in fronts]
        joined = fronts[0]._replace(img_emb=pieces_of("img_emb"),
                                    caption=pieces_of("caption"),
                                    has_caption=pieces_of("has_caption"))
        vr = _search(batch, joined, cfg, vault_mesh=mesh)
        vrs = _split_result(vr, [f.img_emb.shape[0] for f in fronts], devs)
    else:
        vrs = [_search({**b, **v}, f, cfg)
               for b, v, f in zip(batches, vaults, fronts)]
    outs = [_back(params.row(d), kind, fronts[d], vrs[d], batches[d], cfg)
            for d in range(n_pos)]
    return SignalOutput(*(torch.cat([o[i].to(devs[0]) for o in outs])
                          for i in range(len(SignalOutput._fields))))


_KINDS = {"full": "full", "text_only": "text_only",
          "visual_only": "visual_only", "text_packed": "text_only",
          "video": "video", "video_text": "video_text"}


class SignalPrograms:
    """The program set, one per variant (full, text_only, visual_only,
    text_packed, video, video_text): ``get(variant)`` is a callable
    ``(params, batch) → SignalOutput``; ``call`` and ``warm`` run it.
    With ``data_mesh`` the programs run over that mesh (``mesh_program``:
    ``params`` a ``ShardedParams``, vault arrays one entry per data
    position) and ``vault_mesh`` set means the vault rows are sharded over
    it. PyTorch runs eagerly: a program is made once per variant, and a
    shape needs no compile (the engine's CUDA graphs are its warmed
    signatures, engine/forensics.py). ``aot`` (JAX's executable cache) is
    not carried (ROADMAP.md M15). Every program is this module's function
    by its name at each call (``signals_program``, ``video_program``,
    ``mesh_program``), so that a caller can wrap it here."""

    def __init__(self, det_cfg: DetectorConfig, cfg: ForensicsConfig,
                 policy: Policy, use_pallas=False, vault_mesh=None,
                 data_mesh=None, aot=None):
        if aot is not None:
            not_ported("SignalPrograms(aot=...) (JAX's AOT executable "
                       "cache; CUDA graphs play its role)", "M15")
        self.det_cfg = det_cfg
        self.cfg = cfg
        self.policy = policy
        self.use_pallas = use_pallas
        self.vault_mesh = vault_mesh
        self.data_mesh = data_mesh
        self.aot = aot
        self._programs: Dict[str, Callable] = {}

    def get(self, variant: str) -> Callable:
        if variant not in self._programs:
            if variant not in _KINDS:
                raise ValueError(f"unknown variant {variant!r}")
            kw = dict(det_cfg=self.det_cfg, cfg=self.cfg, policy=self.policy,
                      use_pallas=self.use_pallas)
            kind = _KINDS[variant]
            if self.data_mesh is not None:
                def fn(params, batch, kind=kind):
                    return mesh_program(
                        params, batch, kind=kind, mesh=self.data_mesh,
                        vault_sharded=self.vault_mesh is not None, **kw)
            elif kind.startswith("video"):
                def fn(params, batch, has_text=kind == "video_text"):
                    return video_program(
                        params, batch, has_text=has_text, **kw)
            else:
                def fn(params, batch, variant=variant):
                    return signals_program(
                        params, batch, variant=variant, **kw)
            self._programs[variant] = fn
        return self._programs[variant]

    def call(self, variant: str, params, batch) -> SignalOutput:
        return self.get(variant)(params, batch)

    def warm(self, variant: str, params, batch) -> SignalOutput:
        """Run one signature once (JAX's load-or-compile step; here there
        is nothing to compile, and the engine's ``warmup()`` captures its
        graphs)."""
        return self.get(variant)(params, batch)
