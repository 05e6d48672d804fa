"""MisinfoForensics — the serving facade.

Counterpart of ``misinfo_tpu/engine/forensics.py`` for the slice the port
carries: ``analyze(text, image_path, video_path)`` and
``analyze_batch(requests)`` return the reference's report dicts
``{verdict, verdict_text, confidence, scores, vault_matches,
explanation}``. Requests are grouped per variant (full / text_only /
visual_only / video / video_text), padded to batch buckets, text to
length buckets 64/128/256/512 or packed into shared rows
(``pack_text="auto"``), and each group runs as one signal program on the
device. Videos go in groups of up to ``video_batch_buckets[-1]``: their
frames are sampled on the host (preprocess/video.py, on the image-prep
pool) and ride the batch axis of one ``video_program`` per group. Images
and frames are resized on the host, or with ``serving.device_resize``
staged as one padded frame each and resized on the device
(ops/resize.py).
``analyze_batch_async`` enqueues a batch and returns its ``finalize()``
(the device programs run asynchronously on the card; the one host sync is
the result's copy back), ``analyze_stream`` keeps one batch in flight, and
``analyze_text`` / ``analyze_image`` / ``analyze_consistency`` /
``search_vault`` / ``fusion_verdict`` are the reference's per-signal
conveniences over one batched call. Image host prep runs on a thread pool
for more than one image.

The Truth Vault takes every ``ServingConfig.vault_dtype`` (float32,
bfloat16, int8, int4 with its ``<vault>.int4.npz`` sidecar) and
``vault_ivf`` (with its ``<vault>.ivf.npz`` sidecar), hot-swaps with
``reload_vault`` and reports its footprint in ``memory_report``.

The opt-in kernel modes are carried: ``PrecisionConfig.quant="int8"``
(every large dense in int8: the int8 dense kernel K2 from 256 rows, the
fused int8 FFN K1), ``use_pallas=True`` (the fused attention kernel K3
on unpacked rows), ``use_pallas="flash"`` (the flash attention kernel K11
on RoBERTa's rows of 128 tokens and more, packed or padded; K3 on CLIP's)
and ``use_pallas="ffn"`` (the fused FFN kernel K5).

Each group runs through a runner of its signature (ops/graphs.py), the
counterpart of the JAX engine's jit caches: (variant, batch bucket, text
bucket, packed rows[, staging size]) as ``warmup()`` lists them. On the
card a runner is a CUDA graph, captured on the engine's stream after one
eager pass and replayed for every later request of its signature
(``cuda_graphs=False`` runs every program eagerly instead); on the CPU it
runs the eager program over the same input buffers. ``warmup()`` makes
the runners of the serving grid before traffic arrives; a signature not
warmed gets its runner at first use, whose eager pass answers that
request. ``reload_vault`` re-captures the warmed signatures against the
new vault before it publishes it. Over a mesh, a program that stays
within each data position (``model=1``, the vault replicated, rows not
packed; or a ``data=1`` mesh) runs through one runner per position, each
on its position's device and, on the card, its own CUDA graph; one that
exchanges between positions (a model group's partial sums, a row-sharded
vault, packed rows) runs eagerly (``_positions``).

Without ``params`` the engine starts from its seeded init and loads a
native checkpoint directory (``paths.orbax_dir``, checkpoints/io.py: the
trainers' output, or the JAX package's saved without orbax), else
overlays the reference's ``.pth`` files where ``ModelPaths`` finds them
(checkpoints/torch_convert.py: the monolithic file first, then the
per-branch ones); ``load_report`` says which mode loaded.
``host_prep_report`` measures this host's image prep once.

``MisinfoForensics(mesh=...)`` serves over a device mesh (core/mesh.py),
in the JAX constructor's order: quant resolves under the mesh ("auto" →
"none"), the serving transforms run, then ``shard_params`` places the
tree (parallel/sharding.py); the vault is row-sharded over the data axis
when ``data > 1`` and its rows reach ``serving.vault_shard_min_rows``
(padded with invalid rows to a multiple of ``data``), else replicated on
each data position; request buckets round up to a multiple of ``data``,
and each batch splits over the data positions, each running its program
on its own device (engine/signals.py::mesh_program). Programs over a mesh
run eagerly: no CUDA graphs (the numbers are the same).

Not carried, and refused with NotImplementedError: the AOT cache (the
runners play its role).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.checkpoints.from_jax import to_device
from misinfo_tpu_torch.checkpoints.io import load_checkpoint, load_metadata
from misinfo_tpu_torch.checkpoints.torch_convert import (
    load_detector_from_reference_ckpts)
from misinfo_tpu_torch.core.config import ForensicsConfig
from misinfo_tpu_torch.core.mesh import Mesh, pad_to_multiple
from misinfo_tpu_torch.engine.explain import Explainer
from misinfo_tpu_torch.engine.signals import (
    SignalOutput, SignalPrograms, pack_signal_output, unpack_signal_output)
from misinfo_tpu_torch.models.clip import clip_text_features
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.models.fusion import fusion_apply
from misinfo_tpu_torch.ops.common import (
    Policy, check_accum, l2_normalize, set_exact_f32)
from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.graphs import Runner
from misinfo_tpu_torch.ops.serving import (
    optimize_for_serving, quant_mode, resolve_quant)
from misinfo_tpu_torch.parallel.sharding import shard_params
from misinfo_tpu_torch.preprocess import hostprobe
from misinfo_tpu_torch.preprocess.image import (
    batch_images, choose_staging_bucket, decode_rgb, image_to_array,
    resize_param_row, stage_image_batch)
from misinfo_tpu_torch.preprocess.packing import (
    dense_rows_from_seqs, pack_token_rows, pad_packed_rows, trim_padded)
from misinfo_tpu_torch.preprocess.tokenizer import (
    load_clip_tokenizer, load_roberta_tokenizer)
from misinfo_tpu_torch.preprocess.video import sample_video_frames
from misinfo_tpu_torch.vault.int4 import (
    INT4_TILE_ROWS, Int4Vault, pad_int4_vault)
from misinfo_tpu_torch.vault import ivf as vault_ivf
from misinfo_tpu_torch.vault.prepack import get_or_build
from misinfo_tpu_torch.vault.search import quantize_rows_int8
from misinfo_tpu_torch.utils.tracing import GLOBAL_TRACER, stage_timer
from misinfo_tpu_torch.vault.store import TruthVault

_UNSET = object()  # distinguishes "default to self.vault" from vault=None
# the vault arrays that a row-sharded vault splits over the data axis
_ROW_KEYS = ("vault_emb", "vault_valid", "vault_text_emb", "vault_scale",
             "vault_text_scale")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _per_device(v) -> torch.Tensor:
    """A vault entry as one device holds it: a tensor, or under a mesh the
    first data position's replica or row shard."""
    return v[0] if isinstance(v, (list, tuple)) else v


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
    the CPU when the caller asks for it (``device="cpu"``), or over a
    ``mesh`` of devices (``device`` is then its first). On the card each
    signature's program (over a mesh, each data position's, where it stays
    within the position) is a captured CUDA graph unless
    ``cuda_graphs=False``."""

    _TEXT_BUCKETS = (64, 128, 256, 512)

    def __init__(self, config: Optional[ForensicsConfig] = None,
                 det_cfg: Optional[DetectorConfig] = None,
                 params: Optional[Dict] = None, mesh=None,
                 use_pallas=False, device="cuda", cuda_graphs: bool = True):
        self.cfg = config or ForensicsConfig.from_env()
        self.det_cfg = det_cfg or DetectorConfig()
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("MisinfoForensics(mesh=...): expected a "
                            "misinfo_tpu_torch.core.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh is not None:
            mesh.require_local("MisinfoForensics(mesh=...)")
        self.mesh = mesh
        self.device = (mesh.data_devices[0] if mesh is not None
                       else torch.device(device))
        self.policy = Policy(self.cfg.precision)
        sv = self.cfg.serving
        if use_pallas not in (False, True, "ffn", "flash"):
            raise ValueError(f"use_pallas={use_pallas!r}: expected False, "
                             "True, 'ffn' or 'flash'")
        self.use_pallas = use_pallas
        if sv.aot_cache:
            not_ported("serving.aot_cache", "M15")
        set_exact_f32(parity=self.policy.compute == torch.float32)
        t0 = time.perf_counter()

        self.roberta_tokenizer = load_roberta_tokenizer(
            self.cfg.paths.roberta_tokenizer_dir,
            vocab_size=self.det_cfg.roberta.vocab_size)
        self.clip_tokenizer = load_clip_tokenizer(
            self.cfg.paths.clip_tokenizer_dir,
            vocab_size=self.det_cfg.clip.vocab_size)
        # hash-fallback serving works, but its scores are not comparable
        # to the reference's: surfaced in load_report and the banner
        self.tokenizer_grades = {
            "roberta": bool(getattr(self.roberta_tokenizer, "parity_grade",
                                    False)),
            "clip": bool(getattr(self.clip_tokenizer, "parity_grade", False)),
        }
        self.tokenizer_parity = all(self.tokenizer_grades.values())

        if params is None:
            # seeded init, then the cascade: a native checkpoint directory
            # (checkpoints/io.py, the trainers' output), else the reference
            # .pth files (C10), where an unreadable file stops the cascade,
            # as in JAX, and the error is reported
            params = detector_init(self.cfg.seed, self.det_cfg)
            orbax_dir = self.cfg.paths.orbax_dir
            native = (load_checkpoint(orbax_dir, params) if orbax_dir
                      else None)
            if native is not None:
                params = native
                self.load_report = {"mode": "native", "path": orbax_dir,
                                    **load_metadata(orbax_dir)}
            else:
                try:
                    self.load_report = load_detector_from_reference_ckpts(
                        params, self.cfg.paths)
                except Exception as e:
                    self.load_report = {"mode": "init", "error": str(e)}
        else:
            self.load_report = {"mode": "provided"}
        self.load_report["tokenizer_parity"] = self.tokenizer_parity
        self.load_report["tokenizer_grades"] = dict(self.tokenizer_grades)
        self.quant = resolve_quant(self.cfg.precision.quant, self.policy,
                                   mesh, self.device)
        if self.quant != "none" or self.use_pallas:
            # the card's int8 and opt-in kernels sum in f32 only
            check_accum(self.policy, f"quant={self.quant!r} / use_pallas="
                        f"{self.use_pallas!r}")
        if self.quant != "none":
            for dev in ([self.device] if mesh is None
                        else set(mesh.devices.flat)):
                quant_mode(self.policy, dev)     # raises on a bad mode
        params = to_device(params, self.device)
        params = optimize_for_serving(params, self.policy, self.quant)
        self._params_bytes = _tree_bytes(params)
        # under a mesh: the serving transforms first, then the placement
        # (cast and quantize are per-leaf rewrites, which commute with it)
        self.params = (params if mesh is None
                       else shard_params(mesh, params))

        self.vault = TruthVault.load(self.cfg.paths.vault_path)
        self.vault_loaded = self.vault is not None
        self._vault_sharded = self._shards_vault(self.vault)
        self._vault_device = self._prepare_vault()
        self._warn_vault_capacity(self._vault_device)
        self._reload_lock = threading.Lock()  # serializes reload_vault
        # signature (over a mesh, (signature, data position)) → Runner;
        # the lock covers a runner's copy-in, run and copy-out, so that no
        # two threads replay one graph at once, and the runners of one
        # device share their input buffers (graphs.Runner)
        self._runners: Dict[tuple, Runner] = {}
        self._buffers: Dict[tuple, torch.Tensor] = {}
        # warmed signature → its synthetic host inputs (a function), which
        # reload_vault re-captures it with
        self._warmed: Dict[tuple, Callable[[], Dict]] = {}
        self._runner_lock = threading.Lock()
        on_card = self.device.type == "cuda"
        self.cuda_graphs = bool(cuda_graphs) and on_card
        self.programs = self._make_programs(self._vault_sharded)
        # a data position's single-device programs (_positions)
        self._position_programs = (
            None if mesh is None else SignalPrograms(
                self.det_cfg, self.cfg, self.policy,
                use_pallas=self.use_pallas))
        self._stream = (torch.cuda.Stream(self.device) if self.cuda_graphs
                        else None)
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        # device → its runners' capture stream, graph pool and buffers
        self._lanes = {self.device: (self._stream, self._graph_pool,
                                     self._buffers)}
        self._prep_pool = None  # lazy image-prep thread pool (_prep_map)
        self.explainer = Explainer(self.cfg.gemini_api_key,
                                   self.cfg.gemini_model,
                                   self.cfg.thresholds)
        self.gemini_available = self.explainer.available
        self.init_seconds = time.perf_counter() - t0
        if self.cfg.verbose:
            tok = ("parity" if self.tokenizer_parity else
                   "HASH-FALLBACK (scores not reference-comparable; "
                   "fetch vocab assets via serve/download.py)")
            where = (f"mesh={self.mesh.shape}" if self.mesh is not None
                     else f"device={self.device}")
            print(f"MisinfoForensics ready in {self.init_seconds:.1f}s "
                  f"({where}, quant={self.quant}, "
                  f"use_pallas={self.use_pallas}, "
                  f"cuda_graphs={self.cuda_graphs}, "
                  f"vault={'loaded' if self.vault_loaded else 'absent'}, "
                  f"vault_dtype={sv.vault_dtype}, "
                  f"ckpt={self.load_report['mode']}, tokenizer={tok})")
            try:
                # host-prep sizing hint: one ~0.3 s probe, so that an
                # operator learns this host's image-traffic ceiling at boot
                rec = self.host_prep_report()
                if rec["host_bound_at_probe_res"]:
                    print(f"host-prep notice: {rec['summary']}")
            except Exception:
                pass  # the probe is advisory; never block construction

    # ----------------------------------------------------------- helpers

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _data_axis_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.data

    def _shards_vault(self, vault) -> bool:
        """Row-shard ``vault`` over the data axis: under a mesh with
        ``data > 1`` once its rows reach ``serving.vault_shard_min_rows``
        (JAX's rule); smaller vaults replicate on each data position."""
        return (self.mesh is not None and self._data_axis_size() > 1
                and vault is not None
                and vault.embeddings.shape[0]
                >= self.cfg.serving.vault_shard_min_rows)

    def _make_programs(self, sharded: bool) -> SignalPrograms:
        return SignalPrograms(
            self.det_cfg, self.cfg, self.policy, use_pallas=self.use_pallas,
            vault_mesh=self.mesh if sharded else None, data_mesh=self.mesh)

    def _place_vault(self, out: Dict[str, torch.Tensor],
                     sharded: bool) -> Dict:
        """Under a mesh, each vault array as one entry per data position:
        its row shard (``sharded``; rows padded before) or a replica on
        that position's device (one copy per distinct device)."""
        if self.mesh is None:
            return out
        devs = self.mesh.data_devices
        placed = {}
        for k, v in out.items():
            if sharded and k in _ROW_KEYS:
                placed[k] = [c.to(dev) for c, dev in
                             zip(torch.chunk(v, len(devs), dim=0), devs)]
            else:
                placed[k] = [v.to(dev) for dev in devs]
        return placed

    @staticmethod
    def _stage(a) -> torch.Tensor:
        """A request input as a host tensor; its runner copies it into the
        program's buffer (on the card from pinned memory, without a sync,
        so that a batch's inputs and programs are all enqueued before
        anything waits)."""
        return torch.from_numpy(np.ascontiguousarray(a))

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        """Lazy shared host-prep thread pool (cv2/PIL release the GIL, so
        decode/resize scale with host cores)."""
        if self._prep_pool is None:
            self._prep_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(16, os.cpu_count() or 1))
        return self._prep_pool

    def _prep_map(self, fn, items: List) -> List:
        if len(items) > 1:
            return list(self._pool().map(fn, items))
        return [fn(x) for x in items]

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
        sharded = self._shards_vault(vault)
        dev = self.device
        if vault is None:
            # 128-row dummy so program shapes stay static; no valid rows
            d = self.det_cfg.clip.projection_dim
            return self._place_vault({
                "vault_emb": torch.zeros(128, d, device=dev),
                "vault_valid": torch.zeros(128, dtype=torch.bool,
                                           device=dev),
                "vault_text_emb": torch.zeros(128, d, device=dev)}, sharded)
        sv = self.cfg.serving
        # IVF index first: its k-means needs a transient bf16 row copy on
        # the device before the vault planes occupy it; the index is
        # cached beside the vault file and invalidated by a content digest
        index = None
        # IVF and row-sharding are mutually exclusive search strategies;
        # sharding wins at scale, as in JAX
        ivf_engages = sv.vault_ivf and vault.num_articles > 0 and not sharded
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
            # gather. Rows pad to the kernel tile (row-sharded, to tile ×
            # data, so that every shard stays tile-aligned), row_valid
            # alongside.
            mult = INT4_TILE_ROWS * (self._data_axis_size() if sharded
                                     else 1)
            pre = get_or_build(vault_path, vault)
            q4 = pad_int4_vault(pre.image, multiple=mult)
            n_pad = q4.packed.shape[0]
            valid = np.zeros((n_pad,), bool)
            valid[: vault.row_valid.shape[0]] = vault.row_valid
            if pre.text is not None:
                t4 = pad_int4_vault(pre.text, multiple=mult)
            else:
                # no titles: the packed-zero plane directly, not an
                # [N, D] f32 zeros array through the quantizer
                t4 = Int4Vault(packed=np.zeros_like(q4.packed),
                               scale=np.zeros((n_pad,), np.float32))
            return self._place_vault({
                "vault_emb": self._tensor(q4.packed),
                "vault_scale": self._tensor(q4.scale),
                "vault_valid": self._tensor(valid),
                "vault_text_emb": self._tensor(t4.packed),
                "vault_text_scale": self._tensor(t4.scale)}, sharded)
        if sv.vault_dtype == "int8":
            def cast(a):
                return self._tensor(quantize_rows_int8(a))
        elif sv.vault_dtype == "bfloat16":
            def cast(a):
                return torch.from_numpy(a).to(torch.bfloat16).to(dev)
        else:
            cast = self._tensor
        emb, valid = vault.embeddings, vault.row_valid
        text = vault.text_embeddings
        if sharded:
            # invalid pad rows up to a multiple of the data axis
            pad = pad_to_multiple(emb.shape[0], self._data_axis_size()) \
                - emb.shape[0]
            emb = np.pad(emb, ((0, pad), (0, 0)))
            valid = np.pad(valid, (0, pad))
            text = None if text is None else np.pad(text, ((0, pad), (0, 0)))
        out = {"vault_emb": cast(emb), "vault_valid": self._tensor(valid)}
        out["vault_text_emb"] = (
            cast(text) if text is not None
            else torch.zeros_like(out["vault_emb"]))
        if index is not None:
            out.update(index.device_arrays(dev))
            if sv.ivf_bf16_gather:
                out["ivf_emb16"] = torch.from_numpy(vault.embeddings).to(
                    torch.bfloat16).to(dev)
        return self._place_vault(out, sharded)

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
        used = sum(_nbytes(_per_device(t)) for t in dev.values())
        if used <= self._VAULT_HBM_WARN_FRACTION * limit:
            return
        vdt = self.cfg.serving.vault_dtype
        nxt = {"int4": ("a wider data axis (more cards)"
                        if self._vault_sharded else
                        "row-sharding across cards (MisinfoForensics("
                        "mesh=...))"),
               "int8": 'vault_dtype="int4" (2× more capacity)'}.get(
            vdt, 'vault_dtype="int8" (4× capacity) or "int4" (8×)')
        logging.getLogger("misinfo_tpu_torch.engine").warning(
            "vault occupies %.0f%% of device HBM (%.2f GB of %.2f GB, "
            "dtype=%s); hot reload_vault needs ~2× headroom (or "
            "drop_first=True) — consider %s",
            100.0 * used / limit, used / 2**30, limit / 2**30, vdt, nxt)

    def _publish_vault(self, vault, dev: Dict[str, torch.Tensor],
                       sharded: bool = False) -> None:
        """Swap the serving vault in a few reference assignments (atomic
        under the GIL); a flip of the shard decision swaps the program
        set."""
        if sharded != self._vault_sharded:
            self.programs = self._make_programs(sharded)
        self.vault_loaded = vault is not None
        self.vault = vault
        self._vault_device = dev
        self._vault_sharded = sharded

    def reload_vault(self, path: Optional[str] = None,
                     drop_first: bool = False) -> Dict:
        """Hot-swap the Truth Vault without restarting the engine.

        The replacement is staged first (host load, normalization,
        quantization or IVF and their sidecars, device copies) while
        requests keep serving the old vault; a few assignments then
        publish it and, for an explicit ``path``, the engine config. A
        failed staging leaves both untouched. A missing file soft-fails
        to the vault-less dummy, as a missing vault does at start.
        Concurrent reloads serialize on a lock. Under a mesh the shard
        decision is taken again for the new vault (``vault_shard_min_rows``).

        Device memory: the staged swap holds both vaults' arrays briefly,
        2× the footprint ``memory_report()`` shows. ``drop_first=True``
        publishes the dummy before staging, so requests during the swap
        are served without a vault instead of running out of memory.

        A batch in flight during the swap may map its scores onto the new
        metadata; append-only growth keeps indices stable (its output was
        copied out of its runner when it was dispatched). The signatures
        that ``warmup()`` made are re-captured against the new vault
        before it is published (requests wait on the runners' lock
        meanwhile); every other runner is dropped. Returns
        ``{articles, rows, sharded}``."""
        with self._reload_lock:
            new_path = path if path is not None else self.cfg.paths.vault_path
            new_vault = TruthVault.load(new_path)
            if drop_first:
                with self._runner_lock:
                    self._runners = {}
                    self._publish_vault(None, self._prepare_vault(None, None))
            dev = self._prepare_vault(new_vault, vault_path=new_path)
            sharded = self._shards_vault(new_vault)
            self._warn_vault_capacity(dev)
            with self._runner_lock:
                runners = {}
                for sig, make_inputs in self._warmed.items():
                    if self.mesh is None:
                        inputs = make_inputs()
                        runner = self._new_runner(sig, inputs, dev)
                        runner.start(inputs)
                        runners[sig] = runner
                        continue
                    n = self._positions(sig, sharded)   # 0: runs eagerly
                    for d, piece in enumerate(
                            self._pieces(make_inputs(), n) if n else ()):
                        runner = self._new_runner(sig, piece, dev,
                                                  position=d)
                        runner.start(piece)
                        runners[(sig, d)] = runner
                if path is not None:  # publish config only after staging
                    self.cfg = self.cfg.replace(
                        paths=dataclasses.replace(self.cfg.paths,
                                                  vault_path=path))
                self._runners = runners
                self._publish_vault(new_vault, dev, sharded)
            return {"articles": (0 if new_vault is None
                                 else new_vault.num_articles),
                    "rows": int(_per_device(dev["vault_emb"]).shape[0]
                                * (self.mesh.data if sharded else 1)),
                    "sharded": bool(sharded)}

    def memory_report(self) -> Dict:
        """Device-memory accounting for capacity planning: detector
        params, vault planes by key and, on a card, PyTorch's allocated
        bytes against the card's total (the JAX engine's keys)."""
        shards = len(self.mesh.data_devices) if self._vault_sharded else 1
        per_dev = {k: _nbytes(_per_device(v))
                   for k, v in self._vault_device.items()}
        vault_by_key = {k: b * (shards if k in _ROW_KEYS else 1)
                        for k, b in per_dev.items()}
        out = {
            "params_bytes": self._params_bytes,
            "vault_bytes": sum(vault_by_key.values()),
            "vault_bytes_per_device": sum(per_dev.values()),
            "vault_bytes_by_key": vault_by_key,
            "vault_dtype": self.cfg.serving.vault_dtype,
            "vault_articles": (self.vault.num_articles
                               if self.vault is not None else 0),
            "vault_rows_padded": int(
                _per_device(self._vault_device["vault_emb"]).shape[0]
                * shards),
            "vault_sharded": bool(self._vault_sharded),
            "devices": 1 if self.mesh is None else self.mesh.size,
        }
        mem = self._device_memory()
        if mem is not None:
            out["hbm_in_use_bytes"], out["hbm_limit_bytes"] = mem
            out["hbm_headroom_bytes"] = mem[1] - mem[0]
        return out

    def host_prep_report(self) -> Dict:
        """Measured image-prep capacity of THIS host and the knob
        recommendation: one cached ~0.3 s probe of the ``_image_batch``
        path (preprocess/hostprobe.py), with the knobs in effect. Read by
        the verbose boot banner and ``/metrics``."""
        rec = dict(hostprobe.recommend())
        rec["active"] = {
            "fast_decode": self.cfg.serving.fast_decode,
            "device_resize": self.cfg.serving.device_resize,
            "prep_pool_workers": min(16, (os.cpu_count() or 1)),
        }
        # the link probe's numbers once one has been taken (HOST_POLICY=auto
        # takes it at boot); never taken from here: a cold probe copies MBs
        if hostprobe._link_cache is not None:
            rec["link"] = dict(hostprobe._link_cache)
        return rec

    # ------------------------------------------------------------ runners

    def _program(self, sig: tuple, vault: Dict[str, torch.Tensor],
                 position: Optional[int] = None):
        """The device program of signature ``sig`` over its input dict,
        reading ``vault``'s device arrays, through the program set
        (``SignalPrograms``). With ``position``, data position
        ``position``'s single-device program over its piece of the batch,
        with its tree and its vault replica."""
        variant, r = sig[0], sig[3]
        if variant == "caption_title_sim":
            def run(b):
                with torch.inference_mode():
                    return l2_normalize(clip_text_features(
                        self.params["clip"], b["clip_ids"].to(self.device),
                        b["clip_mask"].to(self.device), self.det_cfg.clip,
                        self.policy))
            return run
        program = "text_packed" if r and variant == "text_only" else variant
        programs, params = self.programs, self.params
        if position is not None:
            programs = self._position_programs
            params = self.params.row(position)
            vault = {k: v[position] for k, v in vault.items()}

        def run(b):
            with torch.inference_mode():
                return pack_signal_output(programs.call(
                    program, params, {**b, **vault}))
        return run

    def _lane(self, dev: torch.device) -> tuple:
        """``dev``'s capture stream, graph pool and input buffers, made at
        its first runner."""
        if dev not in self._lanes:
            self._lanes[dev] = (
                torch.cuda.Stream(dev) if self.cuda_graphs else None,
                torch.cuda.graph_pool_handle() if self.cuda_graphs else None,
                {})
        return self._lanes[dev]

    def _new_runner(self, sig: tuple, inputs: Dict[str, torch.Tensor],
                    vault: Optional[Dict[str, torch.Tensor]] = None,
                    position: Optional[int] = None) -> Runner:
        dev = (self.device if position is None
               else self.mesh.data_devices[position])
        stream, pool, buffers = self._lane(dev)
        return Runner(sig, self._program(
            sig, self._vault_device if vault is None else vault, position),
            inputs, device=dev, capture=self.cuda_graphs, stream=stream,
            pool=pool, buffers=buffers)

    def _positions(self, sig: tuple, sharded: Optional[bool] = None) -> int:
        """Over a mesh, how many data positions run ``sig``'s program as a
        single-device program each, through a runner of their own: the
        data axis (one for the caption-title program, which runs on the
        first position); 0 where the program exchanges between positions
        (a model group's partial sums, a vault row-sharded over them
        (``sharded``, default the vault's), packed rows whose requests
        straddle two positions), which then runs eagerly."""
        m = self.mesh
        sharded = self._vault_sharded if sharded is None else sharded
        if m.model > 1:
            return 0
        if m.data == 1 or sig[0] == "caption_title_sim":
            return 1
        return 0 if sharded or sig[3] else m.data

    @staticmethod
    def _pieces(inputs: Dict[str, torch.Tensor], n: int) -> List[Dict]:
        """The host inputs' leading axis in ``n`` equal pieces."""
        if n == 1:
            return [inputs]
        parts = {k: torch.chunk(v, n) for k, v in inputs.items()}
        return [{k: v[d] for k, v in parts.items()} for d in range(n)]

    def _sig(self, variant: str, n: int, inputs: Dict) -> tuple:
        """The signature ``warmup()`` lists for a program over ``inputs``:
        (variant, batch bucket, text length, packed rows), and under
        ``serving.device_resize`` the staging size (0 without images)."""
        L = inputs["roberta_ids"].shape[1] if "roberta_ids" in inputs else 0
        r = (inputs["roberta_ids"].shape[0] if "roberta_seg" in inputs
             else 0)
        sig = (variant, n, L, r)
        if self.cfg.serving.device_resize:
            sig += (inputs["image_staged"].shape[1]
                    if "image_staged" in inputs else 0,)
        return sig

    def _run(self, sig: tuple, inputs: Dict[str, torch.Tensor]):
        """Run ``sig``'s program on ``inputs`` through its runner, made (and
        on the card captured) at first use; the output is the request's
        own (copied out of the graph). Over a mesh each data position runs
        its piece of the inputs through its runner and the outputs are
        gathered on the first position's device; a program that exchanges
        between positions runs eagerly on the host inputs, which it splits
        over them (``_positions``)."""
        if self.mesh is None:
            return graphs.run(lambda: self._runners, self._runner_lock, sig,
                              inputs, lambda: self._new_runner(sig, inputs))
        n = self._positions(sig)
        if not n:
            return self._program(sig, self._vault_device)(inputs)
        outs = [graphs.run(lambda: self._runners, self._runner_lock,
                           (sig, d), piece,
                           lambda d=d, piece=piece: self._new_runner(
                               sig, piece, position=d))
                for d, piece in enumerate(self._pieces(inputs, n))]
        return torch.cat([o.to(self.device) for o in outs])

    # ------------------------------------------------------------ warmup

    _WARMUP_VARIANTS = ("full", "text_only", "visual_only")

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               text_buckets: Optional[Sequence[int]] = None,
               variants: Sequence[str] = _WARMUP_VARIANTS,
               videos: Optional[Sequence[int]] = None,
               packed: Optional[bool] = None,
               full_grid: bool = False,
               parallel: Optional[int] = None,
               progress=None) -> List[tuple]:
        """Make the runners of the serving signatures before traffic
        arrives: on the card each is one CUDA graph, captured after one
        eager pass of synthetic inputs of exactly the shapes
        ``_dispatch_group`` builds; later requests of that signature
        replay it. The JAX engine's contract and grid, in its order.

        Defaults warm the endpoints of each axis: batch buckets ``(1,
        max)``, every reachable text bucket (including the ``rb_max``
        fallback length), the three request variants and video buckets
        ``(1, max)``. Text layouts follow ``pack_text``: ``True`` → packed
        only, ``False`` → dense only, ``"auto"`` → dense unless
        ``packed=True`` or ``full_grid=True`` warms every row bucket
        auto-pack can route to. ``full_grid=True`` warms every batch and
        video bucket. ``videos=()`` skips the video programs (which cover
        ``video`` and ``video_text``). With ``serving.device_resize`` every
        image-bearing program is warmed once per ``image_staging_buckets``
        entry and signatures gain a fifth element (the staging size; 0 for
        image-less programs). A vault without title embeddings adds the
        caption-vs-headline program ``("caption_title_sim", 2, clip
        length, 0)``. ``parallel`` (or ``MISINFO_TPU_WARMUP_PARALLEL``) is
        validated and the captures run one after another (one capture
        stream; the list is the serial one). ``progress(sig)`` is called
        after each signature. Returns the warmed signatures
        ``(variant, batch, text_len, packed_rows[, staging])``
        (``packed_rows=0`` ⇒ dense)."""
        bad = set(variants) - set(self._WARMUP_VARIANTS)
        if bad:
            raise ValueError(
                f"unknown warmup variants {sorted(bad)}; valid: "
                f"{self._WARMUP_VARIANTS} (video programs are warmed via "
                "videos=[V, ...], which covers both video and video_text)")
        if parallel is None:
            parallel = int(os.environ.get("MISINFO_TPU_WARMUP_PARALLEL",
                                          "0") or 0)
        if int(parallel) != parallel or parallel < 0:
            raise ValueError(f"warmup parallel={parallel!r}: expected an "
                             "integer ≥ 0")
        rb_max, cl_len = self._rb_max, self._cl_len
        size = self.cfg.seq.image_size
        buckets = self.cfg.serving.batch_buckets
        vbuckets = self.cfg.serving.video_batch_buckets
        if full_grid:
            batch_sizes = buckets if batch_sizes is None else batch_sizes
            videos = vbuckets if videos is None else videos
        if batch_sizes is None:
            batch_sizes = (1, buckets[-1])
        if videos is None:
            videos = (1, vbuckets[-1])
        if text_buckets is None:
            text_buckets = [b for b in self._TEXT_BUCKETS if b < rb_max] \
                + [rb_max]
        pack_mode = self.cfg.serving.pack_text
        if packed is None:
            packed = pack_mode is True or (full_grid and bool(pack_mode))
        dense_text = pack_mode is not True  # True-mode never serves dense
        staging = (self.cfg.serving.image_staging_buckets
                   if self.cfg.serving.device_resize else None)
        done: List[tuple] = []

        def _sig(variant, B, L, r, S=0):
            return ((variant, B, L, r) if staging is None
                    else (variant, B, L, r, S))

        def _dispatch(sig, make_inputs):
            if sig in done:   # e.g. two batch_sizes rounding to one bucket
                return
            if sig not in self._runners and (sig, 0) not in self._runners:
                self._run(sig, make_inputs())
            self._warmed.setdefault(sig, make_inputs)
            done.append(sig)
            if progress is not None:
                try:
                    progress(sig)
                except Exception:
                    pass

        def zeros(shape, dtype=np.int32):
            return self._stage(np.zeros(shape, dtype))

        def ones(shape, dtype=np.int32):
            return self._stage(np.ones(shape, dtype))

        def _clip_tokens(n):
            return {"clip_ids": zeros((n, cl_len)),
                    "clip_mask": ones((n, cl_len))}

        def _image_sets(n):
            """[(make_image_inputs, staging size)]: functions, so that
            nothing is allocated until the signature is warmed."""
            if staging is None:
                return [((lambda n=n: {
                    "image_effnet": zeros((n, size, size, 3), np.uint8),
                    "image_clip": zeros((n, size, size, 3), np.uint8),
                }), 0)]
            row = resize_param_row(size, size, size)
            return [((lambda n=n, S=S: {
                "image_staged": zeros((n, S, S, 3), np.uint8),
                "resize_params": self._stage(np.tile(row, (n, 1)))}), S)
                for S in staging]

        for variant in variants:
            for n in batch_sizes:
                B = self._req_bucket(n, buckets)
                if variant == "visual_only":
                    for mk_img, S in _image_sets(B):
                        _dispatch(_sig(variant, B, 0, 0, S), mk_img)
                    continue
                img_sets = (_image_sets(B) if variant == "full"
                            else [((lambda: {}), 0)])
                for mk_img, S in img_sets:
                    for L in text_buckets:
                        if dense_text:
                            def mk_dense(B=B, L=L, mk_img=mk_img,
                                         variant=variant):
                                return {
                                    "roberta_ids": zeros((B, L)),
                                    "roberta_mask": ones((B, L)),
                                    **(_clip_tokens(B) if variant == "full"
                                       else {}),
                                    **mk_img(),
                                }
                            _dispatch(_sig(variant, B, L, 0, S), mk_dense)
                        if not packed:
                            continue
                        # row counts dispatch can emit: bucketed, and only
                        # those auto-pack routes to this bucket (any r ≤ B
                        # when pack_text is True, else rows*4 <= bucket*3)
                        for r in sorted({self._req_bucket(r0, buckets)
                                         for r0 in buckets}):
                            if r > B or (pack_mode is not True
                                         and r * 4 > B * 3):
                                continue

                            def mk_packed(B=B, L=L, r=r, mk_img=mk_img,
                                          variant=variant):
                                return {
                                    "roberta_ids": zeros((r, L)),
                                    "roberta_mask": ones((r, L)),
                                    "roberta_pos": zeros((r, L)),
                                    "roberta_seg": zeros((r, L)),
                                    "cls_rows": zeros((B,)),
                                    "cls_cols": zeros((B,)),
                                    **(_clip_tokens(B) if variant == "full"
                                       else {}),
                                    **mk_img(),
                                }
                            _dispatch(_sig(variant, B, L, r, S), mk_packed)
        F = self.cfg.video.max_frames
        for n in videos:
            V = self._req_bucket(n, vbuckets)
            for mk_img, S in _image_sets(V * F):
                def mk_video(V=V, mk_img=mk_img):
                    return {**mk_img(),
                            "frame_valid": ones((V, F), np.bool_)}
                _dispatch(_sig("video", V, 0, 0, S), mk_video)
                for L in text_buckets:
                    def mk_video_text(V=V, L=L, mk_video=mk_video):
                        return {**mk_video(),
                                "roberta_ids": zeros((V, L)),
                                "roberta_mask": ones((V, L)),
                                **_clip_tokens(V)}
                    _dispatch(_sig("video_text", V, L, 0, S), mk_video_text)
        vault = self.vault
        if vault is not None and vault.text_embeddings is None:
            # vaults without title embeddings compute the caption-vs-
            # headline similarity on demand (_caption_title_similarity)
            _dispatch(_sig("caption_title_sim", 2, cl_len, 0),
                      lambda: {"clip_ids": zeros((2, cl_len)),
                               "clip_mask": ones((2, cl_len))})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.cfg.verbose:
            def _fmt(sig):
                v, b, s, r = sig[:4]
                st = f"/st{sig[4]}" if len(sig) > 4 and sig[4] else ""
                return f"{v}/b{b}/S{s}" + (f"/r{r}" if r else "") + st
            what = "captured" if self.cuda_graphs else "warmed (eager)"
            print(f"warmup: {len(done)} signatures {what} "
                  + ", ".join(_fmt(sig) for sig in done))
        return done

    @property
    def _rb_max(self) -> int:
        """Effective RoBERTa row length (position table minus the offset)."""
        return min(self.cfg.seq.roberta_max_len,
                   self.det_cfg.roberta.max_position_embeddings - 2)

    @property
    def _cl_len(self) -> int:
        return min(self.cfg.seq.clip_max_len, self.det_cfg.clip.max_text_len)

    def _req_bucket(self, n: int, buckets: Optional[Sequence[int]] = None
                    ) -> int:
        """Bucket a request count (``buckets`` default: the request batch
        buckets); under a mesh the batch axis must divide evenly across
        the data axis, so a bucket rounds up to a multiple of it."""
        b = _bucket(n, self.cfg.serving.batch_buckets
                    if buckets is None else buckets)
        return pad_to_multiple(b, self._data_axis_size())

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
        return {"roberta_ids": self._stage(packed.ids),
                "roberta_mask": self._stage(packed.mask),
                "roberta_pos": self._stage(packed.position_ids),
                "roberta_seg": self._stage(packed.segment_ids),
                "cls_rows": self._stage(packed.cls_rows),
                "cls_cols": self._stage(packed.cls_cols)}

    def _stage_images(self, arrays: List, bucket: int) -> Dict:
        """Device-resize path: decoded frames (+ None padding to
        ``bucket``) → staged uint8 planes + per-image resize params; both
        224px flavors are derived on the device (ops/resize.py)."""
        size = self.cfg.seq.image_size
        arrays = arrays + [None] * (bucket - len(arrays))
        max_dim = max((max(a.shape[:2]) for a in arrays if a is not None),
                      default=size)
        S = choose_staging_bucket(max_dim,
                                  self.cfg.serving.image_staging_buckets)
        staged, params = stage_image_batch(arrays, S, size,
                                           prep_map=self._prep_map)
        return {"image_staged": self._stage(staged),
                "resize_params": self._stage(params)}

    def _image_batch(self, images: List, bucket: int) -> Dict:
        """Host decode once, then resize to both 224px flavors on the host
        or, with ``serving.device_resize``, stage the decoded frames for
        the device resize. ``None`` entries and the pads up to ``bucket``
        become zero frames (the missing-media zero-fill contract)."""
        size = self.cfg.seq.image_size
        fast = self.cfg.serving.fast_decode

        def decode(im):
            return None if im is None else decode_rgb(im, fast=fast)

        if self.cfg.serving.device_resize:
            return self._stage_images(self._prep_map(decode, images), bucket)

        def prep(im):
            arr = decode(im)
            if arr is None:
                return None, None
            return (image_to_array(arr, "effnet", size),
                    image_to_array(arr, "clip", size))

        pairs = self._prep_map(prep, images)
        pad = [None] * (bucket - len(images))
        return {"image_effnet": self._stage(
                    batch_images([p[0] for p in pairs] + pad, size)),
                "image_clip": self._stage(
                    batch_images([p[1] for p in pairs] + pad, size))}

    # ------------------------------------------------- per-signal methods
    # The reference's per-signal API; each rides the batched engine (these
    # are conveniences, the fused program is the hot path).

    def analyze_text(self, text: str) -> Dict[str, float]:
        """Reference analyze_text: the two RoBERTa heads' scores."""
        out = self._analyze_batch_internal([{"text": text}])[0]
        return {"ai_score": out["scores"]["ai_score"],
                "misinfo_score": out["scores"]["misinfo_score"]}

    def analyze_image(self, image_path) -> Dict[str, float]:
        """Reference analyze_image: the deepfake score."""
        out = self._analyze_batch_internal([{"image": image_path}])[0]
        return {"deepfake_score": out["scores"]["deepfake_score"]}

    def analyze_consistency(self, text: str, image_path) -> Dict[str, float]:
        """Reference analyze_consistency: the CLIP caption-image cosine."""
        out = self._analyze_batch_internal(
            [{"text": text, "image": image_path}])[0]
        return {"clip_similarity": out["scores"]["clip_similarity"]}

    def search_vault(self, image_path, user_caption: Optional[str] = None,
                     top_k: Optional[int] = None) -> Dict:
        """Reference search_vault: discrepancy and matches of one image
        (and its caption) against the Truth Vault."""
        if not self.vault_loaded:
            return TruthVault.empty_result()
        req = {"image": image_path}
        if user_caption:
            req["text"] = user_caption
        out = self._analyze_batch_internal([req])[0]
        return {"vault_discrepancy": out["scores"]["vault_discrepancy"],
                "matches": out["vault_matches"],
                "vault_available": True,
                "text_similarity": out["scores"]["text_similarity"]}

    def fusion_verdict(self, scores: Dict[str, float]) -> Dict:
        """Reference fusion_verdict: the fusion MLP over five signals."""
        vec = torch.tensor([[scores.get(k, 0.0) for k in (
            "ai_score", "misinfo_score", "deepfake_score", "clip_similarity",
            "vault_discrepancy")]], dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            probs = torch.softmax(fusion_apply(self.params["fusion"], vec),
                                  dim=-1)[0].cpu().numpy()
        real_p, fake_p = float(probs[0]), float(probs[1])
        verdict = 1 if fake_p > self.cfg.thresholds.fake_decision else 0
        return {"verdict": verdict,
                "confidence": fake_p if verdict == 1 else real_p,
                "fake_probability": fake_p,
                "real_probability": real_p}

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
        report = self._analyze_batch_internal([req], explanations=True)[0]
        if verbose:
            self._print_report(req, report)
        return report

    def analyze_batch(self, requests: List[Dict],
                      explanations: bool = False) -> List[Dict]:
        """Batched analyze over {text?, image?, video?} dicts: one program
        call per variant group of at most the largest batch bucket (the
        largest video batch bucket for videos)."""
        return self._analyze_batch_internal(requests, explanations)

    def analyze_stream(self, requests, batch_size: Optional[int] = None,
                       explanations: bool = False):
        """Pipelined bulk analyze: iterate ``requests`` (any iterable of
        request dicts) in ``batch_size`` groups with one batch in flight,
        yielding report dicts in input order. While batch N runs on the
        device, batch N+1's host prep and dispatch proceed."""
        batch_size = batch_size or max(self.cfg.serving.batch_buckets)
        it = iter(requests)
        pending = None
        while True:
            chunk = list(itertools.islice(it, batch_size))
            nxt = (self.analyze_batch_async(chunk, explanations)
                   if chunk else None)
            if pending is not None:
                yield from pending()
            pending = nxt
            if nxt is None:
                return

    def _analyze_batch_internal(self, requests: List[Dict],
                                explanations: bool = False) -> List[Dict]:
        with stage_timer("analyze", n_requests=len(requests)):
            return self._finalize_batch(self._dispatch_batch(requests),
                                        requests, explanations)

    def analyze_batch_async(self, requests: List[Dict],
                            explanations: bool = False):
        """Pipelined form of analyze_batch: enqueues every device program
        without a sync and returns a zero-argument ``finalize()`` that waits
        for the results and returns the report list. On the card the
        programs run asynchronously; the results' copy back is the only
        sync."""
        t0 = time.perf_counter()
        dispatches = self._dispatch_batch(requests)

        def finalize() -> List[Dict]:
            out = self._finalize_batch(dispatches, requests, explanations)
            # the async path feeds the same analyze counters as the sync one
            GLOBAL_TRACER.event("analyze", time.perf_counter() - t0,
                                n_requests=len(requests))
            return out

        return finalize

    def _dispatch_batch(self, requests: List[Dict]):
        """Group → prep → enqueue the device programs (no host sync).
        Video requests go in ``video_batch_buckets``-sized groups, each one
        program over its frames."""
        groups: Dict[str, List[int]] = {}
        for i, r in enumerate(requests):
            if "video" in r:
                v = "video_text" if r.get("text") else "video"
            elif r.get("text") and "image" in r:
                v = "full"
            elif r.get("text"):
                v = "text_only"
            elif "image" in r:
                v = "visual_only"
            else:
                raise ValueError(f"request {i} has no modality")
            groups.setdefault(v, []).append(i)
        dispatches = []
        for variant, idxs in groups.items():
            if variant.startswith("video"):
                maxv = self.cfg.serving.video_batch_buckets[-1]
                for lo in range(0, len(idxs), maxv):
                    chunk = idxs[lo:lo + maxv]
                    dispatches.append((variant, self._analyze_video_group(
                        [requests[i] for i in chunk], variant), chunk))
                continue
            maxb = self.cfg.serving.batch_buckets[-1]
            dispatches += [
                self._dispatch_group(requests, variant, idxs[lo:lo + maxb])
                for lo in range(0, len(idxs), maxb)]
        return dispatches

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
                batch.update(roberta_ids=self._stage(rb_ids),
                             roberta_mask=self._stage(rb_mask))
            if variant == "full":
                batch.update(clip_ids=self._stage(cl_ids),
                             clip_mask=self._stage(cl_mask))
        if variant in ("full", "visual_only"):
            batch.update(self._image_batch([r["image"] for r in reqs],
                                           bucket))
        out = self._run(self._sig(variant, bucket, batch), batch)
        return variant, out, idxs

    def _analyze_video_group(self, reqs: List[Dict],
                             variant: str) -> torch.Tensor:
        """V video requests → ONE [V·F]-frame program → packed result
        tensor (enqueued, no sync). Frames are sampled per video on the
        image-prep pool and resized there (or staged for the device
        resize); padded videos carry all-invalid frame masks (their rows
        are discarded)."""
        F = self.cfg.video.max_frames
        V = self._req_bucket(len(reqs), self.cfg.serving.video_batch_buckets)
        vcfg = self.cfg.video

        def sample(req):
            if req is None:
                return [], np.zeros((F,), np.bool_)
            return sample_video_frames(req["video"], F, vcfg.stride_seconds,
                                       vcfg.fps_fallback)

        padded_reqs = list(reqs) + [None] * (V - len(reqs))
        sampled = self._prep_map(sample, padded_reqs)
        valids = [np.asarray(valid, np.bool_) for _, valid in sampled]
        frames = []
        for fs, _ in sampled:
            frames += list(fs) + [None] * (F - len(fs))
        # host resize of every frame, or (device_resize) frames staged for
        # the device, which saves 2 host resizes × V·F frames
        batch = self._image_batch(frames, V * F)
        batch["frame_valid"] = self._stage(np.stack(valids))     # [V, F]
        if variant == "video_text":
            texts = [r.get("text", "") if r else "" for r in padded_reqs]
            rb_ids, rb_mask = self._tokenize_batch(texts, V)
            cl_ids, cl_mask = self.clip_tokenizer.batch(texts, self._cl_len)
            batch.update(roberta_ids=self._stage(rb_ids),
                         roberta_mask=self._stage(rb_mask),
                         clip_ids=self._stage(cl_ids),
                         clip_mask=self._stage(cl_mask))
        return self._run(self._sig(variant, V, batch), batch)

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
        if vault is not None and ("image" in req or "video" in req):
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
        batch = {"clip_ids": self._stage(ids), "clip_mask": self._stage(mask)}
        sig = ("caption_title_sim", 2, self._cl_len, 0)
        if self.cfg.serving.device_resize:
            sig += (0,)
        emb = self._run(sig, batch).cpu().numpy()
        return float(np.dot(emb[0], emb[1]))

    def _print_report(self, req: Dict, report: Dict) -> None:
        """Step-by-step forensic report (reference's verbose analyze())."""
        s = report["scores"]
        has_text = bool(req.get("text"))
        has_visual = (req.get("image") is not None
                      or bool(req.get("video")))
        print("\n" + "=" * 70)
        print(f"MISINFORMATION FORENSICS ANALYSIS ({self.device.type} engine)")
        print("=" * 70)
        print("\n[Step 1] Text Analysis (RoBERTa Dual Heads)...")
        if has_text:
            print(f"  - AI-Generated Score: {s['ai_score']:.2%}")
            print(f"  - Misinfo/Propaganda Score: {s['misinfo_score']:.2%}")
        else:
            print("  - Skipped (no text provided)")
        step2 = ("Video Forensics (Frame Sampling)" if req.get("video")
                 else "Visual Forensics (EfficientNet)")
        print(f"\n[Step 2] {step2}...")
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
