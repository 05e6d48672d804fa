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

The forward also leaves JAX's residuals (``save_residuals``): per query
row the final running max ``m`` and sum ``l``, [B, H, S] f32 (the
single-step form's ``max(s)`` and ``Σexp(s − m)``; the multi-block form's
last ``m_next`` and ``l_next``).

K11-bwd, the backward (JAX's ``_flash_attention_bwd``: ``di`` then the
kernels ``_flash_attention_dkv_kernel`` and ``_flash_attention_dq_kernel``
behind the ``custom_vjp``), in JAX's numerics:

* ``di = Σ_d o·dO`` in f32, from the forward's output in q's dtype;
* per (query block, key block) pair of 128 the scores as the forward's
  (``s = q·kᵀ`` in f32, ``s *= sm_scale``, ``s + MASK_VALUE`` where a key
  is invisible) and ``p = exp(s − m)·(1/l)``, a multiply by the
  reciprocal;
* ``dV += p.astype(dO.dtype)ᵀ·dO``; ``dp = dO·vᵀ`` in f32; ``ds = (dp −
  di)·p``, then ``ds *= sm_scale`` (before any cast); ``dK +=
  ds.astype(dO.dtype)ᵀ·q`` and ``dQ += ds.astype(k.dtype)·k``, each summed
  in f32 and cast to its input's dtype at the end;
* causal: only JAX's ``below_or_on_diag`` skip (key block ≤ query block);
  inside a walked pair a masked entry is 0 only because its ``exp``
  underflows. A kernel that also skips a pair by segment range does so
  only where every row of the query block sees its own position (then
  every p of the pair is exactly 0): a row that sees no key (the padded
  form's all-padding batch rows) has a uniform, nonzero p everywhere;
* no single-step special case: S_kv = 128 takes the same backward, only
  its ``l`` and ``m`` come from the single-step forward.

``flash_attention`` dispatches on where q lies: a CUDA tensor launches the
kernel in ``csrc/flash_attention.cu`` (built with ``nvcc`` at first use) or
raises; a CPU tensor runs the plain version. Where q, k or v requires a
gradient it goes through ``_FlashAttention``, whose backward launches the
two kernels of ``csrc/flash_attention_bwd.cu`` on CUDA tensors (the plain
version on CPU ones). ``launches`` counts forward launches,
``bwd_dkv_launches`` and ``bwd_dq_launches`` the backward's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

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
bwd_dkv_launches = 0            # K11-bwd's dK/dV kernel launches
bwd_dq_launches = 0             # K11-bwd's dQ kernel launches
graphs.count_launches(__name__, "launches", "bwd_dkv_launches",
                      "bwd_dq_launches")
build_log = ""                  # nvcc's output of the last K11 build
bwd_build_log = ""              # and of the last K11-bwd build
_lib = None
_bwd_lib = None


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


def walked_pairs(q_seg, kv_seg, causal: bool, S: int, S_kv: int,
                 rows: int = BLOCK) -> torch.Tensor:
    """[B (1 without segment ids), S / rows, S_kv / 128] bool: the key
    tiles the kernels walk for each block of ``rows`` queries (128 in
    bf16 and in the backward, 32 in the f32 forward), as
    ``csrc/flash_attention.cu::plan_tiles`` chooses them: causal, the
    tiles up to the block's own 128-row block; with segment ids, those
    whose segment range meets the block's, where every row of the block
    sees its own position (else all). ``csrc/flash_attention_bwd.cu``
    walks the same pairs from either side."""
    nt, nq = S_kv // BLOCK, S // rows
    starts = torch.arange(nq) * rows
    last = (torch.clamp(starts // BLOCK, max=nt - 1) if causal
            else torch.full((nq,), nt - 1))
    walk = torch.arange(nt)[None, :] <= last[:, None]         # [nq, nt]
    if q_seg is None:
        return walk[None]
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
    return walk[None] & keep


def walked_tiles(q_seg, kv_seg, causal: bool, S: int, S_kv: int,
                 rows: int = BLOCK) -> torch.Tensor:
    """[B (1 without segment ids), S / rows]: how many key tiles the
    kernel walks for each block of ``rows`` queries (``walked_pairs``)."""
    return walked_pairs(q_seg, kv_seg, causal, S, S_kv, rows).sum(-1)


def flash_core(q, k, v, q_seg=None, kv_seg=None, causal: bool = False,
               sm_scale: Optional[float] = None, keep: bool = False,
               fault: Optional[Dict] = None) -> Dict:
    """The plain version's arithmetic on q [B, S, H, D], k/v [B, S_kv, H,
    D], segment ids [B, S] / [B, S_kv] (int) → {"out": [B, S, H, D] in q's
    dtype, "acc": the f32 accumulator before that cast, [B, H, S, D], and
    JAX's residuals "l" and "m", [B, H, S] f32}.
    With ``keep`` also the per-key quantities ops/kernel_checks.py's band
    reads: "p_pre" (p just before its rounding to V's dtype, 0 where a
    block was skipped), "p" (each key's weight in the output), "s" and
    "m_run" (the scores and the running max they were taken against), all
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
               "acc": acc, "l": l[..., 0], "m": m[..., 0]}
        if keep:
            res.update(p_pre=p_raw / l, p=pv, s=s, m_run=m.expand_as(s))
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
           "acc": acc, "l": l[..., 0], "m": m[..., 0]}
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
                   m_run=torch.cat(ms, -1))
    return res


def flash_attention_plain(q, k, v, q_seg=None, kv_seg=None,
                          causal: bool = False,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """JAX's flash attention in PyTorch ops: q [B, S, H, D], k/v [B, S_kv,
    H, D], segment ids int [B, S] and [B, S_kv] (or None) → [B, S, H, D]
    in q's dtype. ``sm_scale`` defaults to 1/√D."""
    return flash_core(q, k, v, q_seg, kv_seg, causal, sm_scale)["out"]


def flash_di(o, do) -> torch.Tensor:
    """JAX's ``di``: Σ_d o·dO in f32 over the forward's output in its own
    dtype; o, dO [B, S, H, D] → [B, H, S] f32."""
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()


def bwd_parts(q, k, v, q_seg, kv_seg, l, m, do, di, causal: bool = False,
              sm_scale: Optional[float] = None,
              fault: Optional[Dict] = None) -> Dict:
    """The per-pair quantities of JAX's backward kernels, [B, H, S, S_kv]
    f32, 0 outside the (query block, key block) pairs JAX walks: "p" (exp(s
    − m)·(1/l)), "dp" (dO·vᵀ) and "ds" ((dp − di)·p·sm_scale); also "s"
    (the scores, masked) and "run" (the walked pairs' mask, or None).
    ``fault`` plants a wrong kernel: "rule" / "shift" (see ``visible``),
    "no_di" (di left out), "no_ds_scale" (sm_scale dropped from ds),
    "l_roll" (each row's l taken from the row before)."""
    fault = fault or {}
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else sm_scale
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3).float() for t in (q, k, v, do))
    s = torch.matmul(qh, kh.transpose(-1, -2))
    if scale != 1.0:
        s = s * scale
    mask = visible(q_seg, kv_seg, causal, S, S_kv, q.device,
                   fault.get("rule", "equal"), fault.get("shift", 0))
    if mask is not None:
        s = s + torch.where(mask[:, None], 0.0, MASK_VALUE)
    if fault.get("l_roll"):
        l = torch.roll(l, 1, dims=-1)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    run = None
    if causal:                          # JAX's below_or_on_diag
        qb = torch.arange(S, device=q.device)[:, None] // BLOCK
        kb = torch.arange(S_kv, device=q.device)[None, :] // BLOCK
        run = kb <= qb
        p = torch.where(run, p, 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = (dp if fault.get("no_di") else dp - di[..., None]) * p
    if scale != 1.0 and not fault.get("no_ds_scale"):
        ds = ds * scale
    return {"p": p, "dp": dp, "ds": ds, "s": s, "run": run}


def flash_dkv_plain(q, k, v, q_seg, kv_seg, l, m, do, di,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    fault: Optional[Dict] = None):
    """JAX's ``_flash_attention_dkv_kernel`` in PyTorch ops: (dK, dV)
    [B, S_kv, H, D] in k's and v's dtypes from q [B, S, H, D], k/v, the
    residuals l, m and di [B, H, S] f32 and dO [B, S, H, D]. Beyond
    ``bwd_parts``' faults, ``fault`` "skip_q" (query blocks of 128 left
    out) and "unrounded_p" (p not rounded to dO's dtype before dV)."""
    fault = fault or {}
    r = bwd_parts(q, k, v, q_seg, kv_seg, l, m, do, di, causal, sm_scale,
                  fault)
    p, ds = r["p"], r["ds"]
    for t in fault.get("skip_q", ()):
        rows = slice(t * BLOCK, (t + 1) * BLOCK)
        p, ds = p.clone(), ds.clone()
        p[..., rows, :] = 0.0
        ds[..., rows, :] = 0.0
    qh, doh = (t.permute(0, 2, 1, 3).float() for t in (q, do))
    pd = p if fault.get("unrounded_p") else p.to(do.dtype).float()
    dv = torch.matmul(pd.transpose(-1, -2), doh)
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), qh)
    return (dk.to(k.dtype).permute(0, 2, 1, 3).contiguous(),
            dv.to(v.dtype).permute(0, 2, 1, 3).contiguous())


def flash_dq_plain(q, k, v, q_seg, kv_seg, l, m, do, di,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   fault: Optional[Dict] = None) -> torch.Tensor:
    """JAX's ``_flash_attention_dq_kernel`` in PyTorch ops: dQ [B, S, H,
    D] in q's dtype (the arguments of ``flash_dkv_plain``). Beyond
    ``bwd_parts``' faults, ``fault`` "skip_k" (key blocks of 128 left
    out)."""
    fault = fault or {}
    ds = bwd_parts(q, k, v, q_seg, kv_seg, l, m, do, di, causal, sm_scale,
                   fault)["ds"]
    for t in fault.get("skip_k", ()):
        ds = ds.clone()
        ds[..., t * BLOCK:(t + 1) * BLOCK] = 0.0
    kh = k.permute(0, 2, 1, 3).float()
    dq = torch.matmul(ds.to(k.dtype).float(), kh)
    return dq.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_attention_bwd_plain(q, k, v, q_seg, kv_seg, o, l, m, do,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              fault: Optional[Dict] = None):
    """JAX's ``_flash_attention_bwd`` in PyTorch ops: (dQ, dK, dV) from
    the forward's inputs, its output o [B, S, H, D] in q's dtype, its
    residuals l, m [B, H, S] f32 and the output's gradient dO."""
    di = flash_di(o, do)
    args = (q, k, v, q_seg, kv_seg, l, m, do, di, causal, sm_scale, fault)
    return (flash_dq_plain(*args), *flash_dkv_plain(*args))


def _library():
    """Build (once per source hash) and load K11's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build("flash_attention")
    lib.flash_attention_launch_res.restype = ctypes.c_int
    lib.flash_attention_launch_res.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def _bwd_library():
    """Build (once per source hash) and load K11-bwd's shared library."""
    global _bwd_lib, bwd_build_log
    if _bwd_lib is not None:
        return _bwd_lib
    lib, bwd_build_log = build("flash_attention_bwd")
    for name, n_out in (("flash_dkv_launch", 2), ("flash_dq_launch", 1)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (9 + n_out) + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    _bwd_lib = lib
    return lib


def _check_args(what, q, k, v, q_seg, kv_seg):
    """Raise unless the kernels take these operands (both directions)."""
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: q must be bf16 or f32, got {q.dtype}")
    if D != HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} (the kernel takes "
                         f"{HEAD_DIM})")
    for n, name in ((S, "queries"), (S_kv, "keys")):
        if n <= 0 or n % BLOCK:
            raise ValueError(f"{what}: {n} {name} (the kernel takes a "
                             f"positive multiple of {BLOCK})")
    if S_kv > MAX_KV or B > 65535 or H > 65535:
        raise ValueError(f"{what}: B={B} H={H} S_kv={S_kv} past the "
                         f"kernel's limits (S_kv ≤ {MAX_KV}, B, H ≤ 65,535)")
    check_tensor(q, f"{what}: q", q.dtype, (B, S, H, D), q.device)
    for t, name in ((k, "k"), (v, "v")):
        check_tensor(t, f"{what}: {name}", q.dtype, (B, S_kv, H, D),
                     q.device)
    if q_seg is not None:
        check_tensor(q_seg, f"{what}: q_seg", torch.int32, (B, S), q.device)
        check_tensor(kv_seg, f"{what}: kv_seg", torch.int32, (B, S_kv),
                     q.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, q_seg, kv_seg, causal, scale,
            residuals: bool = False):
    """K11 on CUDA tensors → out, or (out, l, m) with ``residuals``."""
    global launches
    _check_args("flash_attention", q, k, v, q_seg, kv_seg)
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    out = torch.empty_like(q)
    l = m = None
    if residuals:
        l = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch_res(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        out.data_ptr(), _ptr(l), _ptr(m), B, S, H, S_kv, D, int(causal),
        int(q.dtype == torch.float32), scale, MASK_VALUE, stream)
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed (B={B} S={S} H={H} "
            f"S_kv={S_kv}): {lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return (out, l, m) if residuals else out


def _launch_bwd(name, q, k, v, q_seg, kv_seg, l, m, do, di, causal,
                scale):
    """One of K11-bwd's kernels on CUDA tensors: "dkv" → (dK, dV), "dq" →
    dQ."""
    global bwd_dkv_launches, bwd_dq_launches
    what = f"flash_attention backward ({name})"
    _check_args(what, q, k, v, q_seg, kv_seg)
    B, S, H, D = q.shape
    S_kv = k.shape[1]
    if max(S, S_kv) > MAX_KV:
        raise ValueError(f"{what}: S={S} S_kv={S_kv} past the kernel's "
                         f"limit ({MAX_KV})")
    check_tensor(do, f"{what}: dO", q.dtype, (B, S, H, D), q.device)
    for t, n in ((l, "l"), (m, "m"), (di, "di")):
        check_tensor(t, f"{what}: {n}", torch.float32, (B, H, S), q.device)
    outs = ((torch.empty_like(k), torch.empty_like(v)) if name == "dkv"
            else (torch.empty_like(q),))
    lib = _bwd_library()
    err = getattr(lib, f"flash_{name}_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        l.data_ptr(), m.data_ptr(), do.data_ptr(), di.data_ptr(),
        *(t.data_ptr() for t in outs), B, S, H, S_kv, D, int(causal),
        int(q.dtype == torch.float32), scale, MASK_VALUE,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"{what}: launch failed (B={B} S={S} H={H} S_kv={S_kv}): "
            f"{lib.flash_bwd_error_string(err).decode()}")
    if name == "dkv":
        bwd_dkv_launches += 1
        return outs
    bwd_dq_launches += 1
    return outs[0]


def flash_dkv(q, k, v, q_seg, kv_seg, l, m, do, di, causal: bool = False,
              sm_scale: Optional[float] = None):
    """K11-bwd's dK/dV kernel (the arguments of ``flash_dkv_plain``): CUDA
    tensors launch it or raise; CPU tensors run the plain version."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if not q.is_cuda:
        return flash_dkv_plain(q, k, v, q_seg, kv_seg, l, m, do, di, causal,
                               scale)
    return _launch_bwd("dkv", q, k, v, q_seg, kv_seg, l, m, do, di, causal,
                       scale)


def flash_dq(q, k, v, q_seg, kv_seg, l, m, do, di, causal: bool = False,
             sm_scale: Optional[float] = None) -> torch.Tensor:
    """K11-bwd's dQ kernel (the arguments of ``flash_dq_plain``): CUDA
    tensors launch it or raise; CPU tensors run the plain version."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if not q.is_cuda:
        return flash_dq_plain(q, k, v, q_seg, kv_seg, l, m, do, di, causal,
                              scale)
    return _launch_bwd("dq", q, k, v, q_seg, kv_seg, l, m, do, di, causal,
                       scale)


def flash_forward(q, k, v, q_seg=None, kv_seg=None, causal: bool = False,
                  sm_scale: Optional[float] = None):
    """K11 with JAX's residuals: (out [B, S, H, D], l, m [B, H, S] f32).
    CUDA tensors run the kernel or raise; CPU tensors the plain version."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if not q.is_cuda:
        r = flash_core(q, k, v, q_seg, kv_seg, causal, scale)
        return r["out"], r["l"], r["m"]
    return _launch(q, k, v, q_seg, kv_seg, causal, scale, residuals=True)


def flash_attention_bwd(q, k, v, q_seg, kv_seg, o, l, m, do,
                        causal: bool = False,
                        sm_scale: Optional[float] = None):
    """K11-bwd: (dQ, dK, dV) of flash attention (the arguments of
    ``flash_attention_bwd_plain``): ``di`` in PyTorch ops, as JAX takes it
    outside its kernels, then the dK/dV and dQ kernels (their plain
    versions on CPU tensors)."""
    do = do.contiguous()
    args = (q, k, v, q_seg, kv_seg, l, m, do, flash_di(o, do), causal,
            sm_scale)
    dk, dv = flash_dkv(*args)
    return flash_dq(*args), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with JAX's ``custom_vjp``: the forward saves q, k,
    v, the segment ids, the output and its residuals l and m, the backward
    is K11-bwd. Once differentiable, as JAX's: a backward asked to build a
    graph (``create_graph=True``) raises JAX's NotImplementedError."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        out, l, m = flash_forward(q, k, v, q_seg, kv_seg, causal, scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, l, m)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise NotImplementedError("Higher-order AD not supported "
                                      "(flash attention's backward)")
        q, k, v, q_seg, kv_seg, o, l, m = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_seg, kv_seg, o, l, m,
                                         do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, q_seg: Optional[torch.Tensor] = None,
                    kv_seg: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, S_kv, H, D], segment ids int32 [B, S] and
    [B, S_kv] (both or neither) → [B, S, H, D] in q's dtype. CUDA tensors
    run the kernel (D = 64, S and S_kv multiples of 128) or raise; CPU
    tensors run the plain version. Where q, k or v requires a gradient
    (and grad mode is on) the call goes through ``_FlashAttention``, so
    that the backward runs K11-bwd; else it is the bare launch."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("flash_attention: q_seg and kv_seg go together")
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_seg, kv_seg, causal, scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, q_seg, kv_seg, causal, scale)
    return _launch(q, k, v, q_seg, kv_seg, causal, scale)
