"""Gradients through ``use_pallas="flash"`` in the port: K11-bwd's plain
version (ops/flash_attention.py::flash_attention_bwd_plain, run through
the ``_FlashAttention`` autograd Function) held to JAX's library flash
kernel's ``custom_vjp`` (its forward rule with ``save_residuals``, then
``_flash_attention_bwd``: ``di``, ``_flash_attention_dkv_kernel`` and
``_flash_attention_dq_kernel``), jitted in TPU interpret mode on the CPU
(the rules ``jax.grad`` runs, called once each on a batch of every case
with one causal flag, which keeps this file's JAX traces to four); K11's
residuals l and m against JAX's ``save_residuals`` outputs; the attention
layer's and RoBERTa's packed text-head loss's gradients against
``jax.grad`` of the JAX package's; a second derivative refused; and the
card band's planted faults (the CUDA kernels are held to the plain version
on the card by chip_smoke.py phase 33 and tests/test_torch_cuda.py).

Tolerances: in f32 the gradients within 1e-5 of JAX's, relative to each
gradient's largest magnitude (both sides sum in f32 in other orders); in
bf16 within the card band ops/kernel_checks.py::flash_bwd_band, widened
for JAX's forward output and residuals, which are known only within their
own bands (flash_band, flash_residual_band): a bf16 output one step apart
moves di. l and m within flash_residual_band. The attention layer within
1e-5 in f32. The tiny packed text-head loss within 1e-5 and every
gradient leaf within 1e-5 absolute in f32 (the bar of
tests/test_torch_train_steps.py), the loss within 1e-2 in bf16.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as j_fa

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import roberta as j_roberta
from misinfo_tpu.ops import attention as j_attn
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.preprocess.packing import StreamPacker
from misinfo_tpu.train import losses as j_losses

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.models import roberta as t_roberta
from misinfo_tpu_torch.ops import attention as t_attn
from misinfo_tpu_torch.ops import flash_attention as K11
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops.common import Policy as TPolicy
from misinfo_tpu_torch.train import losses as t_losses
from misinfo_tpu_torch.utils.tree import leaves_with_paths

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The bands and plain versions are many [B, H, S, S] elementwise ops
    at small sizes; with every test worker's intra-op pool spinning on a
    shared host they crawl (16-33 s a band case under the suite's six
    workers, against under 0.3 s alone). One thread costs little here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
# (layout, causal): packed requests with a padding tail, the padded form
# (its last row all padding), causal without segment ids, packed causal
_KINDS = {"packed": ("packed", False), "padded": ("padded", False),
          "causal": ("none", True), "packed_causal": ("packed", True)}


def _j(t):
    """A torch tensor as a JAX array of its dtype."""
    return jnp.asarray(t.float().numpy(), _JDT[t.dtype])


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def _bhsd(t):
    return _j(t).transpose(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _case(kind: str, S: int, dtype):
    layout, causal = _KINDS[kind]
    return KC.flash_bwd_case(2, S, 2, layout, causal, dtype, seed=3,
                             device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(S: int, dtype, causal: bool):
    """JAX on the cases of every kind with this causal flag, stacked along
    the batch (one trace and one run for them all): the rules of
    ``flash_attention``'s custom_vjp, which ``jax.grad`` runs, with JAX's
    default blocks of 128 (``BlockSizes.get_default``): the forward
    ``_flash_attention_fwd`` (K11 with ``save_residuals``) and the backward
    ``_flash_attention_bwd`` (di, then the dK/dV and dQ kernels) for each
    case's ``do`` → {kind: (out, l, m, dq, dk, dv)}, [B, S, H, D] and
    [B, H, S] f32. Rows without segment ids go in with all-ones ids, which
    see every key: the same function."""
    kinds = [k for k, (_, c) in _KINDS.items() if c == causal]
    cases = [_case(k, S, dtype) for k in kinds]

    def cat(name):
        return jnp.concatenate([_bhsd(c[name]) for c in cases])

    def ids(name):
        return jnp.concatenate([
            jnp.ones(c["q"].shape[:2], jnp.int32) if c[name] is None
            else jnp.asarray(c[name].numpy()) for c in cases])

    def run(q, k, v, do, qs, ks):
        seg = j_fa.SegmentIds(q=qs, kv=ks)
        scale = 1.0 / q.shape[-1] ** 0.5
        blocks = j_fa.BlockSizes.get_default(*q.shape, k.shape[2])
        out, res = j_fa._flash_attention_fwd(q, k, v, None, seg, False,
                                             causal, scale, blocks, False)
        dq, dk, dv, _, _ = j_fa._flash_attention_bwd(
            False, causal, scale, blocks, False, res, do)
        return out, res[6], res[7], dq, dk, dv
    with pltpu.force_tpu_interpret_mode():
        res = jax.jit(run)(cat("q"), cat("k"), cat("v"), cat("do"),
                           ids("q_seg"), ids("kv_seg"))
    res = [_t(r) for r in res]
    res = [r.permute(0, 2, 1, 3) if r.dim() == 4 else r for r in res]
    out, at = {}, 0
    for kind, c in zip(kinds, cases):
        B = c["q"].shape[0]
        out[kind] = [r[at:at + B] for r in res]
        at += B
    return out


def _port_grads(case):
    """The port's forward through ``_FlashAttention`` and its gradients
    for the output gradient ``do``."""
    leaves = [case[n].clone().requires_grad_(True) for n in "qkv"]
    out = K11.flash_attention(*leaves, case["q_seg"], case["kv_seg"],
                              case["causal"])
    return out, torch.autograd.grad(out, leaves, case["do"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,S", [(k, s) for s in (256, 128)
                                    for k in _KINDS])
def test_backward_matches_jax_custom_vjp(kind, S, dtype):
    case = _case(kind, S, dtype)
    _, grads = _port_grads(case)
    assert all(g.dtype == dtype for g in grads)
    j_grads = _jax_run(S, dtype, case["causal"])[kind][3:]
    if dtype == torch.float32:
        for name, g, w in zip("qkv", grads, j_grads):
            err = (g - w).abs().max() / w.abs().max()
            assert err.item() <= 1e-5, (name, err.item())
        return
    _, o_err = KC.flash_band(case)
    rb = KC.flash_residual_band(case)
    want, band = KC.flash_bwd_band(case, o_err=o_err, l_err=rb["l_band"],
                                   m_err=rb["m_band"])
    for got in (grads, j_grads):
        err = (KC._flat(*got) - want).abs()
        assert bool((err <= band).all()), (err - band).max().item()
    if case["layout"] == "padded":  # the all-padding row: uniform p
        assert bool((case["kv_seg"][-1] == 0).all())
        assert float(grads[1][-1].float().abs().max()) > 0.0


@pytest.mark.parametrize("kind,S", [(k, s) for s in (256, 128)
                                    for k in _KINDS])
def test_residuals_match_jax_save_residuals(kind, S):
    """K11's l and m (the plain version's) against JAX's forward with
    ``save_residuals``, in f32: within flash_residual_band, and l within
    1e-5 relative."""
    case = _case(kind, S, torch.float32)
    out, l, m = K11.flash_forward(case["q"], case["k"], case["v"],
                                  case["q_seg"], case["kv_seg"],
                                  case["causal"])
    j_out, j_l, j_m = _jax_run(S, torch.float32, case["causal"])[kind][:3]
    rb = KC.flash_residual_band(case)
    for got, want, band in ((j_l, rb["l"], rb["l_band"]), (l, rb["l"],
                                                         rb["l_band"]),
                            (j_m, rb["m"], rb["m_band"]), (m, rb["m"],
                                                         rb["m_band"])):
        assert bool(((got - want).abs() <= band).all())
    np.testing.assert_allclose(l.numpy(), j_l.numpy(), rtol=1e-5)
    np.testing.assert_allclose(j_out.numpy(), out.numpy(), atol=1e-5)


def _attn_params(rng, D):
    return {n: {"kernel": rng.normal(size=(D, D)).astype(np.float32) * 0.05,
                "bias": rng.normal(size=(D,)).astype(np.float32) * 0.1}
            for n in ("q", "k", "v", "o")}


@pytest.mark.parametrize("kind", ["segments", "mask"])
def test_attention_layer_grads_match_jax(kind):
    """``multi_head_attention(use_pallas="flash")``: the gradients of a
    loss of its output with respect to the input and the q, k, v and o
    weights and biases, in f32."""
    rng = np.random.default_rng(7)
    B, S, D, H = 2, 128, 128, 2
    p = _attn_params(rng, D)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = {}
    if kind == "segments":
        seg = np.zeros((B, S), np.int32)
        seg[0, :50], seg[0, 50:110] = 1, 2
        seg[1, :] = 1
        kw["segment_ids"] = seg
    else:
        m = np.ones((B, S), np.int32)
        m[1, 85:] = 0
        kw["mask"] = m
    jp, tpol = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())

    def j_loss(params, xx):
        out = j_attn.multi_head_attention(
            params, xx, H, policy=jp, use_pallas="flash",
            **{k: jnp.asarray(v) for k, v in kw.items()})
        return jnp.sum(out * w)
    with pltpu.force_tpu_interpret_mode():
        j_gp, j_gx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
            p, jnp.asarray(x))
    tp = params_from_jax(p)
    leaves = [t for _, t in leaves_with_paths(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    out = t_attn.multi_head_attention(
        tp, tx, H, policy=tpol, use_pallas="flash",
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert out.grad_fn is not None
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [tx, *leaves])
    want = [np.asarray(j_gx), *jax.tree_util.tree_leaves(j_gp)]
    for g, jw in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=1e-5,
                                   rtol=1e-5)


# ----------------------------------------- RoBERTa's packed text-head loss

def _tiny(cfg_cls):
    return dataclasses.replace(
        cfg_cls.tiny(), hidden_size=128, num_heads=2, intermediate_size=256,
        max_position_embeddings=258, hidden_dropout=0.0)


def _packed_batch(rng, pad_id, vocab):
    """Two rows of 256 tokens packed from ragged requests (the last row
    with a padding tail) and eight CLS slots."""
    packer = StreamPacker(row_len=256, pad_id=pad_id, n_rows=2, n_slots=8)
    for n, lab in ((120, 0), (90, 1), (40, 1), (150, 0), (60, 1),
                   (25, 0)):
        seq = rng.integers(3, vocab, n).astype(np.int32)
        assert packer.add(seq, lab) is None
    packed, metas = packer.flush()
    labels = np.zeros(8, np.int32)
    valid = np.zeros(8, np.float32)
    labels[:len(metas)] = metas
    valid[:len(metas)] = 1.0
    assert (packed.segment_ids == 0).any()
    return {"input_ids": packed.ids, "attention_mask": packed.mask,
            "position_ids": packed.position_ids,
            "segment_ids": packed.segment_ids, "cls_rows": packed.cls_rows,
            "cls_cols": packed.cls_cols, "labels": labels,
            "slot_valid": valid}


@pytest.fixture(scope="module")
def text_head():
    """The tiny RoBERTa (hidden 128, two heads of 64, rows of 256 tokens)
    and a misinfo head, seeded, as numpy; and one packed batch."""
    cfg = _tiny(t_roberta.RobertaConfig)
    gen = torch.Generator().manual_seed(11)
    tree = {"roberta": t_roberta.roberta_init(gen, cfg),
            "misinfo_head": t_roberta.head_init(gen, cfg)}
    np_tree = jax.tree.map(lambda t: t.numpy(), tree)
    batch = _packed_batch(np.random.default_rng(12), cfg.pad_token_id,
                          cfg.vocab_size)
    return np_tree, batch


def _j_loss(params, batch, cfg, policy):
    hidden = j_roberta.roberta_encode(
        params["roberta"], batch["input_ids"], batch["attention_mask"], cfg,
        policy, deterministic=True, use_pallas="flash",
        position_ids=batch["position_ids"], segment_ids=batch["segment_ids"])
    pooled = hidden[batch["cls_rows"], batch["cls_cols"]]
    logits = j_roberta.head_apply(params["misinfo_head"], pooled,
                                  policy=policy,
                                  dropout_rate=cfg.head_dropout)
    return j_losses.weighted_cross_entropy(logits, batch["labels"],
                                           batch["slot_valid"])


def _t_loss(params, batch, cfg, policy):
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    hidden = t_roberta.roberta_encode(
        params["roberta"], b["input_ids"], b["attention_mask"], cfg, policy,
        use_pallas="flash", position_ids=b["position_ids"],
        segment_ids=b["segment_ids"], deterministic=True)
    pooled = hidden[b["cls_rows"].long(), b["cls_cols"].long()]
    logits = t_roberta.head_apply(params["misinfo_head"], pooled, policy,
                                  dropout_rate=cfg.head_dropout)
    return t_losses.weighted_cross_entropy(logits, b["labels"].long(),
                                           b["slot_valid"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_text_head_loss_through_flash_matches_jax(text_head, dtype,
                                                         monkeypatch):
    """The packed text-head step's loss (train/steps.py::
    make_packed_text_head_step) composed with ``roberta_encode(...,
    use_pallas="flash")``: loss and, in f32, every gradient leaf against
    ``jax.grad`` of the JAX package's; K11 forward and backward once a
    layer."""
    np_tree, batch = text_head
    prec = dict(compute_dtype=dtype, gelu_mode="erf")
    jpol, tpol = JPolicy(JPrecision(**prec)), TPolicy(TPrecision(**prec))
    jcfg, tcfg = _tiny(j_roberta.RobertaConfig), _tiny(t_roberta.RobertaConfig)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_fn = lambda p: _j_loss(p, jb, jcfg, jpol)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        # bf16 compares the loss only: its gradients are rounding-level
        # apart in bf16, and the loss alone traces faster
        res = jax.jit(jax.value_and_grad(j_fn) if dtype == "float32"
                      else j_fn)(jax.tree.map(jnp.asarray, np_tree))
    j_l, j_g = res if dtype == "float32" else (res, None)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = K11.flash_forward, K11.flash_attention_bwd
    monkeypatch.setattr(K11, "flash_forward", lambda *a: calls.update(
        fwd=calls["fwd"] + 1) or fwd(*a))
    monkeypatch.setattr(K11, "flash_attention_bwd", lambda *a: calls.update(
        bwd=calls["bwd"] + 1) or bwd(*a))
    tp = params_from_jax(np_tree)
    leaves = [t for _, t in leaves_with_paths(tp)]
    for t in leaves:
        t.requires_grad_(True)
    loss = _t_loss(tp, batch, tcfg, tpol)
    grads = torch.autograd.grad(loss, leaves)
    assert calls == {"fwd": tcfg.num_layers, "bwd": tcfg.num_layers}
    if dtype == "bfloat16":
        assert abs(loss.item() - float(j_l)) <= 1e-2
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        return
    assert abs(loss.item() - float(j_l)) <= 1e-5
    j_leaves = jax.tree_util.tree_leaves(j_g)
    assert len(j_leaves) == len(grads)
    worst = max((float(np.max(np.abs(np.asarray(a) - g.numpy()),
                              initial=0.0)), p)
                for a, g, (p, _) in zip(j_leaves, grads,
                                        leaves_with_paths(tp)))
    assert worst[0] <= 1e-5, worst


# ------------------------------------------------------- refusals, checks

def test_second_derivative_is_refused():
    """As JAX's custom_vjp ("Higher-order AD not supported"), the
    backward is once differentiable."""
    case = KC.flash_bwd_case(1, 128, 2, "packed", False, torch.float32,
                             device="cpu")
    q, k, v = (case[n].clone().requires_grad_(True) for n in "qkv")
    out = K11.flash_attention(q, k, v, case["q_seg"], case["kv_seg"])
    with pytest.raises(NotImplementedError, match="Higher-order"):
        torch.autograd.grad(out, q, case["do"], create_graph=True)
    dq, = torch.autograd.grad(out, q, case["do"])      # first order: fine
    assert dq.grad_fn is None


def test_no_grad_path_is_the_bare_call():
    case = KC.flash_case(1, 128, 2, "packed", False, device="cpu")
    q = case["q"].clone().requires_grad_(True)
    with torch.no_grad():
        out = K11.flash_attention(q, case["k"], case["v"], case["q_seg"],
                                  case["kv_seg"])
    assert out.grad_fn is None
    assert K11.flash_attention(q, case["k"], case["v"], case["q_seg"],
                               case["kv_seg"]).grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,layout,causal", [
    (2, 256, 2, "packed", False), (2, 384, 2, "padded", False),
    (2, 256, 2, "packed", True), (2, 128, 2, "packed", False),
    (2, 256, 2, "none", True)])
def test_k11_bwd_card_band_rejects_planted_faults(dtype, B, S, H, layout,
                                                  causal):
    """On the CPU the wrapper is the plain version (within the band); every
    planted fault lies outside the band: each query tile out of dK/dV, each
    seen key tile out of dQ, di out, (bf16) p unrounded before dV,
    sm_scale out of ds, (causal) the mask a column late, (packed) the
    einsum rule, l from the row before."""
    res = KC.check_flash_bwd(KC.flash_bwd_case(B, S, H, layout, causal,
                                               dtype, device="cpu"))
    nt = S // K11.BLOCK
    want = (2 * nt + 3 + (dtype == torch.bfloat16) + causal
            + (layout == "packed"))
    assert res["worst"] <= 1.0
    assert res["faults"] == want and res["nearest_fault"] > 10


def test_walked_pairs_skip_only_anchored_query_tiles():
    """The backward's pair plan: one segment per 128-token block walks only
    its own pair; the padded form's query tiles with a padding row walk
    every key tile; causal, key tile ≤ query tile."""
    seg = torch.arange(4, dtype=torch.int32).repeat_interleave(128)[None]
    assert K11.walked_pairs(seg + 1, seg + 1, False, 512, 512)[0].equal(
        torch.eye(4, dtype=torch.bool))
    mask = (torch.arange(512) < 300).to(torch.int32)[None]
    pairs = K11.walked_pairs(torch.ones_like(mask), mask, False, 512, 512)
    assert pairs[0].sum(-1).tolist() == [3, 3, 4, 4]
    assert K11.walked_pairs(None, None, True, 512, 512)[0].equal(
        torch.tril(torch.ones(4, 4, dtype=torch.bool)))
