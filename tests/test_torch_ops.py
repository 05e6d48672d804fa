"""The port's ops layer held to the JAX package on the CPU.

Same numpy inputs through both; f32 results within 1e-5 (ops/common,
attention with padding / causal / segment masks, normalize_images),
exact where the JAX tests are exact (quantization, vault top-k indices,
the packed result layout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.ops import attention as j_attn
from misinfo_tpu.ops import common as j_common
from misinfo_tpu.ops import quant as j_quant
from misinfo_tpu.ops.image_ops import normalize_images as j_normalize
from misinfo_tpu.engine import signals as j_signals
from misinfo_tpu.vault import search as j_search
from misinfo_tpu.core.config import PrecisionConfig as JPrecision

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.engine import signals as t_signals
from misinfo_tpu_torch.ops import attention as t_attn
from misinfo_tpu_torch.ops import common as t_common
from misinfo_tpu_torch.ops import quant as t_quant
from misinfo_tpu_torch.ops import serving as t_serving
from misinfo_tpu_torch.ops.image_ops import normalize_images as t_normalize
from misinfo_tpu_torch.vault import search as t_search

TOL = 1e-5          # f32 parity of single ops


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _policies(mode):
    prec = {"f32": "highest", "bf16": None}[mode]
    jc = JPrecision.highest() if prec else JPrecision()
    tc = TPrecision.highest() if prec else TPrecision()
    return j_common.Policy(jc), t_common.Policy(tc)


def _dense_params(rng, k, n):
    return {"kernel": rng.normal(size=(k, n)).astype(np.float32) * 0.2,
            "bias": rng.normal(size=(n,)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("mode,tol", [("f32", TOL), ("bf16", 2e-2)])
def test_common_ops_match(mode, tol):
    rng = np.random.default_rng(0)
    jp, tp = _policies(mode)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    p = _dense_params(rng, 32, 16)
    ln = {"scale": rng.normal(size=32).astype(np.float32),
          "bias": rng.normal(size=32).astype(np.float32)}
    tx = torch.from_numpy(x)
    pairs = [
        (j_common.dense(p, x, jp), t_common.dense(params_from_jax(p), tx, tp)),
        (j_common.layer_norm(ln, x + 3.0, policy=jp),
         t_common.layer_norm(params_from_jax(ln), tx + 3.0, policy=tp)),
        (j_common.gelu(jnp.asarray(x, jp.compute), jp),
         t_common.gelu(tx.to(tp.compute), tp)),
        (j_common.quick_gelu(jnp.asarray(x, jp.compute)),
         t_common.quick_gelu(tx.to(tp.compute))),
        (j_common.silu(jnp.asarray(x)), t_common.silu(tx)),
        (j_common.softmax_f32(x), t_common.softmax_f32(tx)),
        (j_common.l2_normalize(x), t_common.l2_normalize(tx)),
    ]
    for i, (a, b) in enumerate(pairs):
        assert _np(b).shape == _np(a).shape, i
        np.testing.assert_allclose(_np(b), _np(a), atol=tol, rtol=tol,
                                   err_msg=str(i))


@pytest.mark.parametrize("kind", ["mask", "causal", "segments", "none"])
def test_attention_matches(kind):
    rng = np.random.default_rng(1)
    B, S, D, H = 2, 9, 32, 4
    jp, tp = _policies("f32")
    p = {n: _dense_params(rng, D, D) for n in ("q", "k", "v", "o")}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if kind in ("mask", "causal"):
        m = np.ones((B, S), np.int32)
        m[1, 5:] = 0
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
        if kind == "causal":
            kw_j["causal"] = kw_t["causal"] = True
    if kind == "segments":
        seg = np.array([[1, 1, 1, 2, 2, 2, 2, 0, 0],
                        [1, 1, 1, 1, 1, 1, 1, 1, 1]], np.int32)
        kw_j["segment_ids"] = jnp.asarray(seg)
        kw_t["segment_ids"] = torch.from_numpy(seg)
    a = j_attn.multi_head_attention(p, jnp.asarray(x), H, policy=jp, **kw_j)
    b = t_attn.multi_head_attention(params_from_jax(p), torch.from_numpy(x),
                                    H, policy=tp, **kw_t)
    np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("stats", ["imagenet", "clip"])
def test_normalize_images_matches(stats):
    img = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3),
                                            dtype=np.uint8)
    a = j_normalize(jnp.asarray(img), stats, jnp.float32)
    b = t_normalize(torch.from_numpy(img), stats, torch.float32)
    np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_valid", [3, 40, 100])
def test_vault_topk_indices_equal(n_valid):
    """Exact f32 sims and top-k; with fewer valid rows than k the padded
    rows tie at −2.0 and must come back lowest index first."""
    rng = np.random.default_rng(3)
    N, D, B, K = 128, 16, 4, 5
    emb = rng.normal(size=(N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[10] = emb[7]                        # a tie between valid rows
    q = emb[[7, 2, 50, 99]] + 0.01 * rng.normal(size=(B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = np.arange(N) < n_valid
    te = rng.normal(size=(N, D)).astype(np.float32)
    cap = rng.normal(size=(B, D)).astype(np.float32)
    a = j_search.vault_search(jnp.asarray(q), jnp.asarray(emb),
                              jnp.asarray(valid), top_k=K,
                              caption_text_emb=jnp.asarray(cap),
                              vault_text_emb=jnp.asarray(te),
                              has_caption=jnp.asarray([1, 1, 0, 1], bool))
    b = t_search.vault_search(torch.from_numpy(q), torch.from_numpy(emb),
                              torch.from_numpy(valid), top_k=K,
                              caption_text_emb=torch.from_numpy(cap),
                              vault_text_emb=torch.from_numpy(te),
                              has_caption=torch.tensor([1, 1, 0, 1],
                                                       dtype=torch.bool))
    np.testing.assert_array_equal(b.top_idx.numpy(), np.asarray(a.top_idx))
    for f in ("top_sims", "vault_discrepancy", "text_similarity"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), atol=TOL)


def test_quantization_exact():
    rng = np.random.default_rng(4)
    p = _dense_params(rng, 64, 48)
    a, b = j_quant.quantize_dense(p), t_quant.quantize_dense(
        params_from_jax(p))
    np.testing.assert_array_equal(b["kernel_q"].numpy(),
                                  np.asarray(a["kernel_q"]))
    np.testing.assert_array_equal(b["w_scale"].numpy(),
                                  np.asarray(a["w_scale"]))
    x = rng.normal(size=(5, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        t_quant.dense_int8(b, torch.from_numpy(x), torch.float32).numpy(),
        np.asarray(j_quant.dense_int8(a, jnp.asarray(x), jnp.float32)))
    tree = {"layers": [{"mlp_in": _dense_params(rng, 8, 16),
                        "mlp_out": _dense_params(rng, 16, 8),
                        "attn": {"q": _dense_params(rng, 8, 8)}}],
            "head": {"mlp_in": _dense_params(rng, 8, 8)}}
    qa = jax.tree.map(np.asarray, j_quant.quantize_ffn_params(tree, 1))
    qb = t_quant.quantize_ffn_params(params_from_jax(tree), 1)
    flat_a = jax.tree_util.tree_flatten_with_path(qa)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), qb))[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, x1), (_, x2) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x1, x2)


def test_serving_transforms():
    tp_bf16, tp_f32 = t_common.Policy(), t_common.Policy(
        TPrecision.highest())
    assert t_serving.resolve_quant("auto", tp_bf16, "cuda") == "int8_ffn"
    assert t_serving.resolve_quant("auto", tp_bf16, "cpu") == "none"
    assert t_serving.resolve_quant("auto", tp_f32, "cuda") == "none"
    assert t_serving.resolve_quant("int8_ffn", tp_f32, "cpu") == "int8_ffn"
    big = torch.zeros(512, 512)
    tree = {"a": {"kernel": big, "bias": torch.zeros(512)},
            "b": [{"kernel": torch.zeros(4, 4)}]}
    out = t_serving.optimize_for_serving(tree, tp_bf16, "none")
    assert out["a"]["kernel"].dtype == torch.bfloat16
    assert out["a"]["bias"].dtype == torch.float32
    assert out["b"][0]["kernel"].dtype == torch.float32
    out8 = t_serving.optimize_for_serving(tree, tp_bf16, "int8")
    assert out8["a"]["kernel_q"].dtype == torch.int8
    assert out8["a"]["bias"].dtype == torch.float32
    assert out8["b"][0]["kernel"].dtype == torch.float32
    with pytest.raises(ValueError):
        t_serving.optimize_for_serving(tree, tp_bf16, "int4")


def test_signal_output_pack_roundtrip():
    rng = np.random.default_rng(5)
    B, K = 3, 5
    vecs = [rng.random(B).astype(np.float32) for _ in range(10)]
    idx = np.array([[0, 1, 2, 3, 4], [-1, 7, 2 ** 30, 5, 6], [9] * 5],
                   np.int32)
    sims = rng.random((B, K)).astype(np.float32)
    verdict = np.array([1, 0, 1], np.int32)
    fields = vecs[:6] + [verdict] + vecs[7:] + [sims, idx]
    a = j_signals.pack_signal_output(j_signals.SignalOutput(
        *[jnp.asarray(f) for f in fields]))
    b = t_signals.pack_signal_output(t_signals.SignalOutput(
        *[torch.from_numpy(f) for f in fields]))
    np.testing.assert_array_equal(b.numpy().view(np.int32),
                                  np.asarray(a).view(np.int32))
    out = t_signals.unpack_signal_output(b.numpy())
    np.testing.assert_array_equal(out.vault_top_idx, idx)
    np.testing.assert_array_equal(out.verdict, verdict)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_int8_dense_below_kernel_rows_matches_jax(mode, monkeypatch):
    """``dense`` on int8 params ({kernel_q, w_scale, bias}) at M = 4 rows
    takes the plain dense_int8, as JAX's dense_int8_dispatch does below
    256 rows: bitwise equal (integer products, IEEE scales). From 256 rows
    it takes dense_int8 too while the dense kernel is off (the CPU's
    "auto"), and the int8 dense kernel K2 (its plain version on the CPU)
    once MISINFO_TPU_INT8_PALLAS enables it: bitwise equal to JAX's K2 in
    interpret mode."""
    rng = np.random.default_rng(9)
    p = j_quant.quantize_dense(_dense_params(rng, 64, 48))
    jpol = (j_common.Policy(JPrecision.highest()) if mode == "f32"
            else j_common.DEFAULT_POLICY)
    tpol = (t_common.Policy(TPrecision.highest()) if mode == "f32"
            else t_common.DEFAULT_POLICY)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    want = j_common.dense(p, jnp.asarray(x), jpol)
    got = t_common.dense(params_from_jax(jax.tree.map(np.asarray, p)),
                         torch.from_numpy(x), tpol)
    assert got.dtype == tpol.compute
    np.testing.assert_array_equal(_np(got), _np(want))
    big = rng.normal(size=(2, 128, 64)).astype(np.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    got = t_common.dense(tp, torch.from_numpy(big), tpol)
    np.testing.assert_array_equal(_np(got), _np(j_quant.dense_int8(
        p, jnp.asarray(big), jpol.compute)))
    monkeypatch.setenv("MISINFO_TPU_INT8_PALLAS", "all")
    from misinfo_tpu.ops.pallas_int8 import int8_dense_pallas
    got = t_common.dense(tp, torch.from_numpy(big), tpol)
    want = int8_dense_pallas(jnp.asarray(big), p["kernel_q"],
                             p["w_scale"], p["bias"], out_dtype=jpol.compute,
                             interpret=True)
    assert got.shape == (2, 128, 48)
    np.testing.assert_array_equal(_np(got), _np(want))
