"""Flash attention over segment ids (K11): the hand-written CUDA kernel and
its plain version.

Counterpart of JAX's library TPU kernel, which ``misinfo_tpu``'s
``multi_head_attention`` calls under ``use_pallas="flash"``
(``jax/experimental/pallas/ops/tpu/flash_attention.py::flash_attention``,
``pallas_call`` in ``_flash_attention_impl``; bodies
``_flash_attention_kernel_single_batch`` and its single-step form). Its
numerics, which the plain version repeats step for step:

* ``s = q·kᵀ`` summed in f32, then ``s *= sm_scale``;
* a key is visible where ``q_seg == kv_seg`` (segment 0 equals segment 0:
  padding queries attend the padding keys) and, causal, ``col <= row``;
  an invisible score becomes ``s + MASK_VALUE`` (−0.7·f32 max);
* an online softmax over key blocks of 128 (``BLOCK``): per block the
  running max ``m_next``, ``p = exp(s − m_next)``, ``alpha = exp(m_prev −
  m_next)``, ``l_next = Σp + alpha·l_prev``, the accumulator rescaled by
  ``(alpha·l_prev)·(1/l_next)`` and ``(p in V's dtype)·V·(1/l_next)``
  added: p is rounded to V's dtype before the ``1/l`` multiply;
* causal: a block of 128 queries skips the key blocks past its own;
* one key block (``S_kv == 128``): the single-step form, ``p / l`` rounded
  to V's dtype after the division;
* the output in q's dtype.

``flash_attention`` dispatches on where q lies: a CUDA tensor launches the
kernel in ``csrc/flash_attention.cu`` (built with ``nvcc`` at first use) or
raises; a CPU tensor runs the plain version. ``launches`` counts kernel
launches. No JAX path takes a gradient through this kernel; a q, k or v
that requires one is refused by name.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from misinfo_tpu_torch import not_ported
from misinfo_tpu_torch.ops import graphs
from misinfo_tpu_torch.ops.cuda_build import build, check_tensor

HEAD_DIM = 64                   # the kernel's one head width (every tower)
BLOCK = 128                     # JAX's block_q and block_k, K11's tiles
MAX_KV = 65536                  # the kernel's tile list in shared memory
# JAX's DEFAULT_MASK_VALUE as the f32 it becomes in the kernel
MASK_VALUE = torch.tensor(-0.7 * torch.finfo(torch.float32).max,
                          dtype=torch.float32).item()
_DTYPES = (torch.bfloat16, torch.float32)

launches = 0                    # K11 launches since import (or reset)
graphs.count_launches(__name__, "launches")
build_log = ""                  # nvcc's output of the last K11 build
_lib = None


def visible(q_seg, kv_seg, causal: bool, S: int, S_kv: int, device,
            rule: str = "equal", shift: int = 0) -> Optional[torch.Tensor]:
    """[B or 1, S, S_kv] bool: the keys each query sees, or None (all).
    ``rule`` "einsum" and ``shift`` plant the checks' faults: the einsum
    path's ``kv_seg > 0`` rule, and the causal mask ``shift`` columns
    late."""
    mask = None
    if q_seg is not None:
        mask = q_seg[:, :, None] == kv_seg[:, None, :]
        if rule == "einsum":
            mask = mask & (kv_seg[:, None, :] > 0)
    if causal:
        rows = torch.arange(S, device=device)[:, None]
        cols = torch.arange(S_kv, device=device)[None, :]
        cm = (cols <= rows + shift)[None]
        mask = cm if mask is None else mask & cm
    return mask


def walked_tiles(q_seg, kv_seg, causal: bool, S: int, S_kv: int,
                 rows: int = BLOCK) -> torch.Tensor:
    """[B (1 without segment ids), S / rows]: the key tiles the kernel
    walks for each block of ``rows`` queries (128 in bf16, 32 in f32),
    as ``csrc/flash_attention.cu::plan_tiles`` chooses them: causal, the
    tiles up to the block's own 128-row block; with segment ids, those
    whose segment range meets the block's, where every row of the block
    sees its own position (else all)."""
    nt, nq = S_kv // BLOCK, S // rows
    starts = torch.arange(nq) * rows
    last = (torch.clamp(starts // BLOCK, max=nt - 1) if causal
            else torch.full((nq,), nt - 1))
    walk = torch.arange(nt)[None, :] <= last[:, None]         # [nq, nt]
    if q_seg is None:
        return walk.sum(-1)[None]
    qs, ks = q_seg.cpu(), kv_seg.cpu()
    qb = qs.reshape(qs.shape[0], nq, rows)
    kb = ks.reshape(ks.shape[0], nt, BLOCK)
    own = torch.zeros_like(qs, dtype=torch.bool)
    n = min(S, S_kv)
    own[:, :n] = qs[:, :n] == ks[:, :n]
    anchored = own.reshape(qb.shape).all(-1)                  # [B, nq]
    meets = ~((kb.amax(-1)[:, None, :] < qb.amin(-1)[:, :, None])
              | (kb.amin(-1)[:, None, :] > qb.amax(-1)[:, :, None]))
    keep = meets | ~anchored[:, :, None]
    return (walk[None] & keep).sum(-1)


def flash_core(q, k, v, q_seg=None, kv_seg=None, causal: bool = False,
               sm_scale: Optional[float] = None, keep: bool = False,
               fault: Optional[Dict] = None) -> Dict:
    """The plain version's arithmetic on q [B, S, H, D], k/v [B, S_kv, H,
    D], segment ids [B, S] / [B, S_kv] (int) → {"out": [B, S, H, D] in q's
    dtype, "acc": the f32 accumulator before that cast, [B, H, S, D]}.
    With ``keep`` also the per-key quantities ops/kernel_checks.py's band
    reads: "p_pre" (p just before its rounding to V's dtype, 0 where a
    block was skipped), "p" (each key's weight in the output), "s" and "m"
    (the scores and the running max they were taken against), all
    [B, H, S, S_kv] f32.
    ``fault`` plants a wrong kernel for the checks: "skip" (a key block
    left out), "rule" / "shift" (see ``visible``), "no_alpha" (alpha
    taken as 1), "swap_round" (p rounded on the other side of the ``1/l``
    multiply) or "no_scale" (sm_scale dropped)."""
    fault = fault or {}
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    if S_kv % BLOCK:
        raise ValueError(f"flash_attention: {S_kv} keys, not a multiple of "
                         f"{BLOCK}")
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    if fault.get("no_scale"):
        scale = 1.0
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    s = torch.matmul(qh, kh.transpose(-1, -2))              # [B, H, S, S_kv]
    if scale != 1.0:
        s = s * scale
    mask = visible(q_seg, kv_seg, causal, S, S_kv, q.device,
                   fault.get("rule", "equal"), fault.get("shift", 0))
    if mask is not None:
        s = s + torch.where(mask[:, None], 0.0, MASK_VALUE)
    nt = S_kv // BLOCK
    qblock = torch.arange(S, device=q.device) // BLOCK      # JAX's q blocks
    if nt == 1:
        # the single-step form: p / l rounded to V's dtype after the divide
        m = s.amax(-1, keepdim=True)
        p_raw = torch.exp(s - m)
        l = p_raw.sum(-1, keepdim=True)
        if fault.get("swap_round"):
            pv = p_raw.to(v.dtype).float() / l
        else:
            pv = (p_raw / l).to(v.dtype).float()
        acc = torch.matmul(pv, vh.float())
        if 0 in fault.get("skip", ()):
            acc = torch.zeros_like(acc)
        res = {"out": acc.to(q.dtype).permute(0, 2, 1, 3).contiguous(),
               "acc": acc}
        if keep:
            res.update(p_pre=p_raw / l, p=pv, s=s, m=m.expand_as(s))
        return res
    m = torch.full((B, H, S, 1), -math.inf, device=q.device)
    l = torch.zeros(B, H, S, 1, device=q.device)
    acc = torch.zeros(B, H, S, D, device=q.device)
    kept = []
    for t in range(nt):
        cols = slice(t * BLOCK, (t + 1) * BLOCK)
        run = None
        if causal:                      # JAX's below_or_on_diag
            run = ((qblock + 1) * BLOCK - 1 > t * BLOCK)[:, None]
        if t in fault.get("skip", ()):
            run = torch.zeros(S, 1, dtype=torch.bool, device=q.device)
        st = s[..., cols]
        m_next = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_next)
        alpha = (torch.ones_like(m) if fault.get("no_alpha")
                 else torch.exp(m - m_next))
        l_corr = alpha * l
        l_next = p.sum(-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        vt = vh[:, :, cols].float()
        if fault.get("swap_round"):
            o = torch.matmul((p * inv).to(v.dtype).float(), vt)
        else:
            o = torch.matmul(p.to(v.dtype).float(), vt) * inv
        new = (acc * (l_corr * inv) + o, m_next, l_next)
        if run is not None:
            new = tuple(torch.where(run, n, old)
                        for n, old in zip(new, (acc, m, l)))
        acc, m_out, l = new
        if keep:
            kept.append((p, m_next, run))
        m = m_out
    res = {"out": acc.to(q.dtype).permute(0, 2, 1, 3).contiguous(),
           "acc": acc}
    if keep:
        # each key's weight in the output: rounded p, carried by the later
        # blocks' rescales to the last max and sum
        inv_l = 1.0 / l
        ps, raws, ms = [], [], []
        for p, m_t, run in kept:
            w = p.to(v.dtype).float() * torch.exp(m_t - m) * inv_l
            if run is not None:
                w = torch.where(run, w, 0.0)
                p = torch.where(run, p, 0.0)
            ps.append(w)
            raws.append(p)
            ms.append(m_t.expand_as(p))
        res.update(p=torch.cat(ps, -1), p_pre=torch.cat(raws, -1), s=s,
                   m=torch.cat(ms, -1))
    return res


def flash_attention_plain(q, k, v, q_seg=None, kv_seg=None,
                          causal: bool = False,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """JAX's flash attention in PyTorch ops: q [B, S, H, D], k/v [B, S_kv,
    H, D], segment ids int [B, S] and [B, S_kv] (or None) → [B, S, H, D]
    in q's dtype. ``sm_scale`` defaults to 1/√D."""
    return flash_core(q, k, v, q_seg, kv_seg, causal, sm_scale)["out"]


def _library():
    """Build (once per source hash) and load K11's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("flash_attention")
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def _launch(q, k, v, q_seg, kv_seg, causal, scale) -> torch.Tensor:
    global launches
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q must be bf16 or f32, got "
                         f"{q.dtype}")
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} (the kernel takes "
                         f"{HEAD_DIM})")
    for n, what in ((S, "queries"), (S_kv, "keys")):
        if n <= 0 or n % BLOCK:
            raise ValueError(f"flash_attention: {n} {what} (the kernel takes "
                             f"a positive multiple of {BLOCK})")
    if S_kv > MAX_KV or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B} H={H} S_kv={S_kv} past the "
                         f"kernel's limits (S_kv ≤ {MAX_KV}, B, H ≤ 65,535)")
    check_tensor(q, "flash_attention: q", q.dtype, (B, S, H, D), q.device)
    for t, name in ((k, "k"), (v, "v")):
        check_tensor(t, f"flash_attention: {name}", q.dtype, (B, S_kv, H, D),
                     q.device)
    if q_seg is not None:
        check_tensor(q_seg, "flash_attention: q_seg", torch.int32, (B, S),
                     q.device)
        check_tensor(kv_seg, "flash_attention: kv_seg", torch.int32,
                     (B, S_kv), q.device)
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if q_seg is None else q_seg.data_ptr(),
        None if kv_seg is None else kv_seg.data_ptr(), out.data_ptr(),
        B, S, H, S_kv, D, int(causal), int(q.dtype == torch.float32),
        scale, MASK_VALUE, stream)
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed (B={B} S={S} H={H} "
            f"S_kv={S_kv}): {lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return out


def flash_attention(q, k, v, q_seg: Optional[torch.Tensor] = None,
                    kv_seg: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, S_kv, H, D], segment ids int32 [B, S] and
    [B, S_kv] (both or neither) → [B, S, H, D] in q's dtype. CUDA tensors
    run the kernel (D = 64, S and S_kv multiples of 128) or raise; CPU
    tensors run the plain version."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("flash_attention: q_seg and kv_seg go together")
    if any(t.requires_grad for t in (q, k, v)):
        not_ported("a gradient through flash attention (JAX's backward "
                   "kernels _flash_attention_dkv_kernel and "
                   "_flash_attention_dq_kernel; no JAX path takes it)",
                   "§2, K11-bwd")
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, q_seg, kv_seg, causal, scale)
    return _launch(q, k, v, q_seg, kv_seg, causal, scale)
