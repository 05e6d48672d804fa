"""MisinfoForensics — the serving facade.

Counterpart of ``misinfo_tpu/engine/forensics.py`` for the slice the port
carries: ``analyze(text, image_path)`` and ``analyze_batch(requests)``
return the reference's report dicts ``{verdict, verdict_text, confidence,
scores, vault_matches, explanation}``. Requests are grouped per variant
(full / text_only / visual_only), padded to batch buckets, text to length
buckets 64/128/256/512 or packed into shared rows (``pack_text="auto"``),
and each group runs as one signal program on the device.

The Truth Vault takes every ``ServingConfig.vault_dtype`` (float32,
bfloat16, int8, int4 with its ``<vault>.int4.npz`` sidecar) and
``vault_ivf`` (with its ``<vault>.ivf.npz`` sidecar), hot-swaps with
``reload_vault`` and reports its footprint in ``memory_report``.

The opt-in kernel modes are carried: ``PrecisionConfig.quant="int8"``
(every large dense in int8: the int8 dense kernel K2 from 256 rows, the
fused int8 FFN K1), ``use_pallas=True`` (the fused attention kernel K3
on unpacked rows) and ``use_pallas="ffn"`` (the fused FFN kernel K5).

Not carried yet, and refused with NotImplementedError: video, meshes,
warmup and the AOT cache, on-device resize and ``use_pallas="flash"``
(JAX's library TPU kernel).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.checkpoints.from_jax import to_device
from misinfo_tpu_torch.core.config import ForensicsConfig
from misinfo_tpu_torch.engine.explain import Explainer
from misinfo_tpu_torch.engine.signals import (
    SignalOutput, pack_signal_output, signals_program, unpack_signal_output)
from misinfo_tpu_torch.models.clip import clip_text_features
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops.common import Policy, l2_normalize, set_exact_f32
from misinfo_tpu_torch.ops.serving import (
    optimize_for_serving, quant_mode, resolve_quant)
from misinfo_tpu_torch.preprocess.image import (
    batch_images, decode_rgb, image_to_array)
from misinfo_tpu_torch.preprocess.packing import (
    dense_rows_from_seqs, pack_token_rows, pad_packed_rows, trim_padded)
from misinfo_tpu_torch.preprocess.tokenizer import (
    load_clip_tokenizer, load_roberta_tokenizer)
from misinfo_tpu_torch.vault.int4 import Int4Vault, pad_int4_vault
from misinfo_tpu_torch.vault import ivf as vault_ivf
from misinfo_tpu_torch.vault.prepack import get_or_build
from misinfo_tpu_torch.vault.search import quantize_rows_int8
from misinfo_tpu_torch.vault.store import TruthVault

_UNSET = object()  # distinguishes "default to self.vault" from vault=None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return _nbytes(tree) if isinstance(tree, torch.Tensor) else 0


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class MisinfoForensics:
    """Batched forensics engine on one device: the CUDA card by default,
    the CPU when the caller asks for it (``device="cpu"``)."""

    _TEXT_BUCKETS = (64, 128, 256, 512)

    def __init__(self, config: Optional[ForensicsConfig] = None,
                 det_cfg: Optional[DetectorConfig] = None,
                 params: Optional[Dict] = None, mesh=None,
                 use_pallas=False, device="cuda"):
        self.cfg = config or ForensicsConfig.from_env()
        self.det_cfg = det_cfg or DetectorConfig()
        self.device = torch.device(device)
        self.policy = Policy(self.cfg.precision)
        sv = self.cfg.serving
        if mesh is not None:
            not_ported("a device mesh (multi-GPU serving)", "M17")
        if use_pallas == "flash":
            not_ported("use_pallas='flash' (JAX's library TPU flash-attention "
                       "kernel, not this repository's code)", "queue 2, K3")
        if use_pallas not in (False, True, "ffn"):
            raise ValueError(f"use_pallas={use_pallas!r}: expected False, "
                             "True or 'ffn'")
        self.use_pallas = use_pallas
        if sv.device_resize:
            not_ported("serving.device_resize", "M14")
        if sv.aot_cache:
            not_ported("serving.aot_cache", "M15")
        if self.cfg.paths.orbax_dir:
            not_ported("native checkpoint loading", "M16")
        set_exact_f32(parity=self.policy.compute == torch.float32)
        t0 = time.perf_counter()

        self.roberta_tokenizer = load_roberta_tokenizer(
            self.cfg.paths.roberta_tokenizer_dir,
            vocab_size=self.det_cfg.roberta.vocab_size)
        self.clip_tokenizer = load_clip_tokenizer(
            self.cfg.paths.clip_tokenizer_dir,
            vocab_size=self.det_cfg.clip.vocab_size)
        self.tokenizer_parity = all(
            bool(getattr(t, "parity_grade", False))
            for t in (self.roberta_tokenizer, self.clip_tokenizer))

        if params is None:
            # no reference .pth loading yet: seeded random init, as the
            # JAX engine serves when no checkpoint files are present
            params = detector_init(self.cfg.seed, self.det_cfg)
            self.load_report = {"mode": "init"}
        else:
            self.load_report = {"mode": "provided"}
        self.load_report["tokenizer_parity"] = self.tokenizer_parity
        self.quant = resolve_quant(self.cfg.precision.quant, self.policy,
                                   self.device)
        if self.quant != "none":
            quant_mode(self.policy, self.device)    # raises on a bad mode
        params = to_device(params, self.device)
        self.params = optimize_for_serving(params, self.policy, self.quant)

        self.vault = TruthVault.load(self.cfg.paths.vault_path)
        self.vault_loaded = self.vault is not None
        self._vault_device = self._prepare_vault()
        self._warn_vault_capacity(self._vault_device)
        self._reload_lock = threading.Lock()  # serializes reload_vault
        self.explainer = Explainer(self.cfg.gemini_api_key,
                                   self.cfg.gemini_model,
                                   self.cfg.thresholds)
        self.init_seconds = time.perf_counter() - t0
        if self.cfg.verbose:
            print(f"MisinfoForensics ready in {self.init_seconds:.1f}s "
                  f"(device={self.device}, quant={self.quant}, "
                  f"use_pallas={self.use_pallas}, "
                  f"vault={'loaded' if self.vault_loaded else 'absent'}, "
                  f"vault_dtype={sv.vault_dtype}, "
                  f"ckpt={self.load_report['mode']})")

    # ----------------------------------------------------------- helpers

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _prepare_vault(self, vault=_UNSET,
                       vault_path=_UNSET) -> Dict[str, torch.Tensor]:
        """The device arrays of ``vault`` (default ``self.vault``; None
        gives the empty dummy). ``vault_path`` locates the IVF and int4
        sidecars. Pure staging: engine state is untouched, so
        ``reload_vault`` can quantize for minutes while the old vault
        serves."""
        vault = self.vault if vault is _UNSET else vault
        vault_path = (self.cfg.paths.vault_path
                      if vault_path is _UNSET else vault_path)
        dev = self.device
        if vault is None:
            # 128-row dummy so program shapes stay static; no valid rows
            d = self.det_cfg.clip.projection_dim
            return {"vault_emb": torch.zeros(128, d, device=dev),
                    "vault_valid": torch.zeros(128, dtype=torch.bool,
                                               device=dev),
                    "vault_text_emb": torch.zeros(128, d, device=dev)}
        sv = self.cfg.serving
        # IVF index first: its k-means needs a transient bf16 row copy on
        # the device before the vault planes occupy it; the index is
        # cached beside the vault file and invalidated by a content digest
        index = None
        ivf_engages = sv.vault_ivf and vault.num_articles > 0
        if ivf_engages and sv.vault_dtype == "int4":
            raise ValueError(
                "vault_dtype='int4' and vault_ivf are mutually exclusive "
                "— the IVF gather needs addressable rows; pick one")
        if ivf_engages:
            sidecar = (vault_path + ".ivf.npz") if vault_path else None
            index = vault_ivf.IVFIndex.load(sidecar) if sidecar else None
            if (index is None
                    or index.n_rows != vault.embeddings.shape[0]
                    or index.digest != vault_ivf.vault_digest(
                        vault.embeddings, vault.row_valid)):
                index = vault_ivf.build_ivf(vault.embeddings,
                                            vault.row_valid, device=dev)
                if sidecar:
                    try:
                        index.save(sidecar)
                    except OSError:
                        pass  # read-only vault dir: rebuild next start

        if sv.vault_dtype == "int4":
            # packed nibbles, 8× f32's articles per card on both planes:
            # image rows feed the int4 kernels, title rows are a [B]-row
            # gather. Rows pad to the kernel tile, row_valid alongside.
            pre = get_or_build(vault_path, vault)
            q4 = pad_int4_vault(pre.image)
            n_pad = q4.packed.shape[0]
            valid = np.zeros((n_pad,), bool)
            valid[: vault.row_valid.shape[0]] = vault.row_valid
            if pre.text is not None:
                t4 = pad_int4_vault(pre.text)
            else:
                # no titles: the packed-zero plane directly, not an
                # [N, D] f32 zeros array through the quantizer
                t4 = Int4Vault(packed=np.zeros_like(q4.packed),
                               scale=np.zeros((n_pad,), np.float32))
            return {"vault_emb": self._tensor(q4.packed),
                    "vault_scale": self._tensor(q4.scale),
                    "vault_valid": self._tensor(valid),
                    "vault_text_emb": self._tensor(t4.packed),
                    "vault_text_scale": self._tensor(t4.scale)}
        if sv.vault_dtype == "int8":
            def cast(a):
                return self._tensor(quantize_rows_int8(a))
        elif sv.vault_dtype == "bfloat16":
            def cast(a):
                return torch.from_numpy(a).to(torch.bfloat16).to(dev)
        else:
            cast = self._tensor
        out = {"vault_emb": cast(vault.embeddings),
               "vault_valid": self._tensor(vault.row_valid)}
        out["vault_text_emb"] = (
            cast(vault.text_embeddings)
            if vault.text_embeddings is not None
            else torch.zeros_like(out["vault_emb"]))
        if index is not None:
            out.update(index.device_arrays(dev))
            if sv.ivf_bf16_gather:
                out["ivf_emb16"] = torch.from_numpy(vault.embeddings).to(
                    torch.bfloat16).to(dev)
        return out

    # warn when the vault's device residency crosses this fraction of the
    # card's memory: past it, the 2× headroom a staged reload_vault needs
    # is gone and batch activations start fighting the allocator
    _VAULT_HBM_WARN_FRACTION = 0.7

    def _device_memory(self) -> Optional[Tuple[int, int]]:
        """(bytes allocated by PyTorch, the card's total bytes), or None
        on the CPU, which reports nothing."""
        if self.device.type != "cuda":
            return None
        _, total = torch.cuda.mem_get_info(self.device)
        return torch.cuda.memory_allocated(self.device), total

    def _warn_vault_capacity(self, dev: Dict[str, torch.Tensor]) -> None:
        """Operator guardrail: log when the vault's footprint approaches
        the card's memory, naming the cheaper capacity mode. Diagnostics
        only; the allocator is the hard limit."""
        mem = self._device_memory()
        if mem is None:
            return
        limit = mem[1]
        used = sum(_nbytes(t) for t in dev.values())
        if used <= self._VAULT_HBM_WARN_FRACTION * limit:
            return
        vdt = self.cfg.serving.vault_dtype
        nxt = {"int4": "row-sharding across cards (ROADMAP.md M17)",
               "int8": 'vault_dtype="int4" (2× more capacity)'}.get(
            vdt, 'vault_dtype="int8" (4× capacity) or "int4" (8×)')
        logging.getLogger("misinfo_tpu_torch.engine").warning(
            "vault occupies %.0f%% of device HBM (%.2f GB of %.2f GB, "
            "dtype=%s); hot reload_vault needs ~2× headroom (or "
            "drop_first=True) — consider %s",
            100.0 * used / limit, used / 2**30, limit / 2**30, vdt, nxt)

    def _publish_vault(self, vault, dev: Dict[str, torch.Tensor]) -> None:
        """Swap the serving vault in a few reference assignments (atomic
        under the GIL)."""
        self.vault_loaded = vault is not None
        self.vault = vault
        self._vault_device = dev

    def reload_vault(self, path: Optional[str] = None,
                     drop_first: bool = False) -> Dict:
        """Hot-swap the Truth Vault without restarting the engine.

        The replacement is staged first (host load, normalization,
        quantization or IVF and their sidecars, device copies) while
        requests keep serving the old vault; a few assignments then
        publish it and, for an explicit ``path``, the engine config. A
        failed staging leaves both untouched. A missing file soft-fails
        to the vault-less dummy, as a missing vault does at start.
        Concurrent reloads serialize on a lock.

        Device memory: the staged swap holds both vaults' arrays briefly,
        2× the footprint ``memory_report()`` shows. ``drop_first=True``
        publishes the dummy before staging, so requests during the swap
        are served without a vault instead of running out of memory.

        A batch in flight during the swap may map its scores onto the new
        metadata; append-only growth keeps indices stable. Returns
        ``{articles, rows, sharded}``."""
        with self._reload_lock:
            new_path = path if path is not None else self.cfg.paths.vault_path
            new_vault = TruthVault.load(new_path)
            if drop_first:
                self._publish_vault(None, self._prepare_vault(None, None))
            dev = self._prepare_vault(new_vault, vault_path=new_path)
            self._warn_vault_capacity(dev)
            if path is not None:  # publish config only after staging worked
                self.cfg = self.cfg.replace(
                    paths=dataclasses.replace(self.cfg.paths,
                                              vault_path=path))
            self._publish_vault(new_vault, dev)
            return {"articles": (0 if new_vault is None
                                 else new_vault.num_articles),
                    "rows": int(dev["vault_emb"].shape[0]),
                    "sharded": False}

    def memory_report(self) -> Dict:
        """Device-memory accounting for capacity planning: detector
        params, vault planes by key and, on a card, PyTorch's allocated
        bytes against the card's total (the JAX engine's keys)."""
        vault_by_key = {k: _nbytes(v) for k, v in self._vault_device.items()}
        out = {
            "params_bytes": _tree_bytes(self.params),
            "vault_bytes": sum(vault_by_key.values()),
            "vault_bytes_per_device": sum(vault_by_key.values()),
            "vault_bytes_by_key": vault_by_key,
            "vault_dtype": self.cfg.serving.vault_dtype,
            "vault_articles": (self.vault.num_articles
                               if self.vault is not None else 0),
            "vault_rows_padded": int(
                self._vault_device["vault_emb"].shape[0]),
            "vault_sharded": False,
            "devices": 1,
        }
        mem = self._device_memory()
        if mem is not None:
            out["hbm_in_use_bytes"], out["hbm_limit_bytes"] = mem
            out["hbm_headroom_bytes"] = mem[1] - mem[0]
        return out

    def warmup(self, *args, **kwargs):
        not_ported("warmup (CUDA-graph capture per signature)", "M9")

    @property
    def _rb_max(self) -> int:
        """Effective RoBERTa row length (position table minus the offset)."""
        return min(self.cfg.seq.roberta_max_len,
                   self.det_cfg.roberta.max_position_embeddings - 2)

    @property
    def _cl_len(self) -> int:
        return min(self.cfg.seq.clip_max_len, self.det_cfg.clip.max_text_len)

    def _req_bucket(self, n: int) -> int:
        return _bucket(n, self.cfg.serving.batch_buckets)

    def _tokenize_batch(self, texts: List[str], bucket: int):
        """Dense RoBERTa rows for `bucket` requests, cut to the smallest
        length bucket that covers the longest row."""
        rb_max = self._rb_max
        padded = texts + [""] * (bucket - len(texts))
        rb_ids, rb_mask = self.roberta_tokenizer.batch(padded, rb_max)
        longest = int(rb_mask.sum(axis=1).max()) if len(padded) else rb_max
        rb_len = next((b for b in self._TEXT_BUCKETS
                       if b >= longest and b <= rb_max), rb_max)
        return rb_ids[:, :rb_len], rb_mask[:, :rb_len]

    def _text_pack_plan(self, texts: List[str]):
        """Tokenize once and pick the packed row length."""
        rb_max = self._rb_max
        ids, mask = self.roberta_tokenizer.batch(texts, rb_max)
        seqs = trim_padded(ids, mask)
        longest = max((len(s) for s in seqs), default=1)
        row_len = next((b for b in self._TEXT_BUCKETS
                        if longest <= b <= rb_max), rb_max)
        return seqs, row_len

    def _pack_text_batch(self, plan) -> Dict:
        _, _, packed, rows = plan
        packed = pad_packed_rows(packed, rows,
                                 self.det_cfg.roberta.pad_token_id)
        return {"roberta_ids": self._tensor(packed.ids),
                "roberta_mask": self._tensor(packed.mask),
                "roberta_pos": self._tensor(packed.position_ids),
                "roberta_seg": self._tensor(packed.segment_ids),
                "cls_rows": self._tensor(packed.cls_rows),
                "cls_cols": self._tensor(packed.cls_cols)}

    def _image_batch(self, images: List, bucket: int) -> Dict:
        """Host decode once, resize to both 224px flavors, zero-fill pads."""
        size = self.cfg.seq.image_size
        fast = self.cfg.serving.fast_decode

        def prep(im):
            arr = decode_rgb(im, fast=fast)
            return (image_to_array(arr, "effnet", size),
                    image_to_array(arr, "clip", size))

        pairs = [prep(im) for im in images]
        pad = [None] * (bucket - len(images))
        return {"image_effnet": self._tensor(
                    batch_images([p[0] for p in pairs] + pad, size)),
                "image_clip": self._tensor(
                    batch_images([p[1] for p in pairs] + pad, size))}

    # --------------------------------------------------------- analyze()

    def analyze(self, text: Optional[str] = None,
                image_path=None, video_path=None,
                verbose: bool = True) -> Dict:
        """Complete forensic pipeline for one request; the reference's
        report dict."""
        if not text and image_path is None and not video_path:
            raise ValueError(
                "Provide at least one of: text, image_path, or video_path")
        req: Dict = {}
        if text:
            req["text"] = text
        if image_path is not None:
            req["image"] = image_path
        if video_path is not None:
            req["video"] = video_path
        report = self.analyze_batch([req], explanations=True)[0]
        if verbose:
            self._print_report(req, report)
        return report

    def analyze_batch(self, requests: List[Dict],
                      explanations: bool = False) -> List[Dict]:
        """Batched analyze over {text?, image?} dicts: one program call per
        variant group of at most the largest batch bucket."""
        groups: Dict[str, List[int]] = {}
        for i, r in enumerate(requests):
            if "video" in r:
                not_ported("video analysis", "M12")
            if r.get("text") and "image" in r:
                v = "full"
            elif r.get("text"):
                v = "text_only"
            elif "image" in r:
                v = "visual_only"
            else:
                raise ValueError(f"request {i} has no modality")
            groups.setdefault(v, []).append(i)
        maxb = self.cfg.serving.batch_buckets[-1]
        dispatches = [self._dispatch_group(requests, variant, idxs[lo:lo + maxb])
                      for variant, idxs in groups.items()
                      for lo in range(0, len(idxs), maxb)]
        return self._finalize_batch(dispatches, requests, explanations)

    def _dispatch_group(self, requests: List[Dict], variant: str,
                        idxs: List[int]):
        """Prep + run one ≤max-bucket group of same-variant requests."""
        reqs = [requests[i] for i in idxs]
        bucket = self._req_bucket(len(reqs))
        texts = [r.get("text", "") for r in reqs]
        pack_mode = self.cfg.serving.pack_text
        plan = None
        if pack_mode and variant in ("full", "text_only"):
            seqs, row_len = self._text_pack_plan(texts)
            packed = pack_token_rows(seqs, row_len,
                                     self.det_cfg.roberta.pad_token_id,
                                     n_slots=bucket)
            plan = (seqs, row_len, packed,
                    self._req_bucket(packed.ids.shape[0]))
        # "auto" packs only when the bucketed packed row count beats the
        # dense layout by the 25% margin; True always packs
        pack = plan is not None and (pack_mode is True
                                     or plan[3] * 4 <= bucket * 3)
        batch: Dict = {}
        if variant in ("full", "text_only"):
            cl_ids, cl_mask = self.clip_tokenizer.batch(
                texts + [""] * (bucket - len(texts)), self._cl_len)
            if pack:
                batch.update(self._pack_text_batch(plan))
            else:
                if plan is not None:   # auto decided dense: reuse tokens
                    rb_ids, rb_mask = dense_rows_from_seqs(
                        plan[0], bucket, plan[1],
                        self.det_cfg.roberta.pad_token_id)
                else:
                    rb_ids, rb_mask = self._tokenize_batch(texts, bucket)
                batch.update(roberta_ids=self._tensor(rb_ids),
                             roberta_mask=self._tensor(rb_mask))
            if variant == "full":
                batch.update(clip_ids=self._tensor(cl_ids),
                             clip_mask=self._tensor(cl_mask))
        if variant in ("full", "visual_only"):
            batch.update(self._image_batch([r["image"] for r in reqs],
                                           bucket))
        batch.update(self._vault_device)
        program = "text_packed" if pack and variant == "text_only" else variant
        with torch.inference_mode():
            out = pack_signal_output(signals_program(
                self.params, batch, variant=program, det_cfg=self.det_cfg,
                cfg=self.cfg, policy=self.policy,
                use_pallas=self.use_pallas))
        return variant, out, idxs

    def _finalize_batch(self, dispatches, requests: List[Dict],
                        explanations: bool = False) -> List[Dict]:
        results: List[Optional[Dict]] = [None] * len(requests)
        for _, out, idxs in dispatches:
            out = unpack_signal_output(out.cpu().numpy())    # one transfer
            for row, i in enumerate(idxs):
                results[i] = self._format_report(out, row, requests[i])
        for r in results:
            r["explanation"] = (self.explainer.explain(r["scores"],
                                                       r["vault_matches"])
                                if explanations else "")
        return results

    # ------------------------------------------------------- formatting

    def _format_report(self, out: SignalOutput, row: int, req: Dict) -> Dict:
        scores = {
            "ai_score": float(out.ai_score[row]),
            "misinfo_score": float(out.misinfo_score[row]),
            "deepfake_score": float(out.deepfake_score[row]),
            "clip_similarity": float(out.clip_similarity[row]),
            "vault_discrepancy": float(out.vault_discrepancy[row]),
            "text_similarity": float(out.text_similarity[row]),
        }
        matches: List[Dict] = []
        vault = self.vault
        if vault is not None and "image" in req:
            idxs = out.vault_top_idx[row]
            if idxs[0] >= 0:
                matches = vault.matches_from_indices(
                    idxs, out.vault_top_sims[row])
        # on-demand caption-vs-headline similarity when the vault lacks
        # precomputed title text embeddings (reference :468-484)
        if (matches and req.get("text")
                and scores["vault_discrepancy"]
                > self.cfg.thresholds.vault_reuse
                and vault.text_embeddings is None):
            scores["text_similarity"] = self._caption_title_similarity(
                req["text"], matches[0]["title"])
        verdict = int(out.verdict[row])
        scores.update({
            "verdict": verdict,
            "confidence": float(out.confidence[row]),
            "fake_probability": float(out.fake_probability[row]),
            "real_probability": float(out.real_probability[row]),
        })
        return {"verdict": verdict,
                "verdict_text": "FAKE" if verdict == 1 else "REAL",
                "confidence": float(out.confidence[row]),
                "scores": scores,
                "vault_matches": matches}

    def _caption_title_similarity(self, caption: str, title: str) -> float:
        ids, mask = self.clip_tokenizer.batch([caption, title], self._cl_len)
        with torch.inference_mode():
            emb = l2_normalize(clip_text_features(
                self.params["clip"], self._tensor(ids), self._tensor(mask),
                self.det_cfg.clip, self.policy)).cpu().numpy()
        return float(np.dot(emb[0], emb[1]))

    def _print_report(self, req: Dict, report: Dict) -> None:
        """Step-by-step forensic report (reference's verbose analyze())."""
        s = report["scores"]
        has_text = bool(req.get("text"))
        has_visual = req.get("image") is not None
        print("\n" + "=" * 70)
        print(f"MISINFORMATION FORENSICS ANALYSIS ({self.device.type} engine)")
        print("=" * 70)
        print("\n[Step 1] Text Analysis (RoBERTa Dual Heads)...")
        if has_text:
            print(f"  - AI-Generated Score: {s['ai_score']:.2%}")
            print(f"  - Misinfo/Propaganda Score: {s['misinfo_score']:.2%}")
        else:
            print("  - Skipped (no text provided)")
        print("\n[Step 2] Visual Forensics (EfficientNet)...")
        if has_visual:
            print(f"  - Deepfake Probability: {s['deepfake_score']:.2%}")
        else:
            print("  - Skipped (no image/video provided)")
        print("\n[Step 3] Image-Text Consistency (CLIP)...")
        if has_text and has_visual:
            print(f"  - CLIP Similarity: {s['clip_similarity']:.4f}")
        else:
            print("  - Skipped (missing modality)")
        print("\n[Step 4] Truth Vault Search...")
        if has_visual and self.vault_loaded:
            print(f"  - Historical Discrepancy: {s['vault_discrepancy']:.2%}")
            if report["vault_matches"]:
                m = report["vault_matches"][0]
                print(f"  - Top Match: \"{m['title']}\"")
                print(f"    Image Similarity: {m['similarity']:.1%}")
                if s.get("text_similarity", 0.0) > 0:
                    print(f"    Text Similarity: {s['text_similarity']:.2%}")
        elif has_visual:
            print("  - Vault not available")
        else:
            print("  - Skipped (no image/video provided)")
        print("\n[Step 5] Verdict...")
        print(f"  Final Verdict: {report['verdict_text']}")
        print(f"  - Confidence: {report['confidence']:.1%}")
        if report.get("explanation"):
            print("\n[Step 6] Forensic Summary...")
            print("=" * 70)
            print(report["explanation"])
        print("=" * 70)
