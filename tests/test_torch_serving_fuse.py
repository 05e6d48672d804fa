"""The serving QKV fuse held to the JAX package's, on the CPU.

* ``fuse_qkv_params`` / ``unfuse_qkv_params``: the port's fused tree equal
  to JAX's leaf for leaf, and the round trip giving the tree back exactly
  with every leaf contiguous.
* ``optimize_for_serving`` with JAX's signature (F12): every ``fuse`` ×
  ``quant`` × ``cast`` gives JAX's tree, int8 ``kernel_q`` and
  ``w_scale`` exactly, other leaves exactly too; under ``mesh=``
  ``quant="auto"`` resolves to "none" in both packages.
* ``deoptimize_params`` unfuses (F13): a fused int8 JAX tree carried
  across by ``params_from_jax`` deoptimizes to JAX's q/k/v tree exactly.
* ``multi_head_attention`` serves a fused dict (F14): against JAX's fused
  attention within 1e-5 in f32 and within JAX's bf16 band 2e-2
  (tests/test_serving_opt.py), with the padding mask, causal masking and
  segment packing; against the port's own unfused attention bit for bit,
  also through the fused attention kernel's plain version (K3,
  ``use_pallas=True``).
* The ``full`` program: JAX's engine and the port's on one fused f32 tree
  within 1e-3 (the mixed batch, so the packed and visual programs too);
  the port's fused int8 tree equal to its unfused int8 tree bit for bit.
* K2's plain version on a fused weight (N = 3D) equal to the three
  unfused products bit for bit (``kernel_checks.check_int8_dense_fused``,
  which the card runs on the kernel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.ops import attention as j_attention
from misinfo_tpu.ops import serving as j_serving
from misinfo_tpu.ops.common import DEFAULT_POLICY as J_BF16
from misinfo_tpu.ops.common import F32_POLICY as J_F32
from misinfo_tpu.ops.common import Policy as JPolicy

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.engine import signals as t_signals
from misinfo_tpu_torch.models.detector import (
    DetectorConfig as TDetectorConfig, detector_init)
from misinfo_tpu_torch.ops import attention as t_attention
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops import serving as t_serving
from misinfo_tpu_torch.ops.common import DEFAULT_POLICY as T_BF16
from misinfo_tpu_torch.ops.common import F32_POLICY as T_F32
from misinfo_tpu_torch.ops.common import Policy as TPolicy
from misinfo_tpu_torch.ops.quant import quantize_params

from test_torch_engine import assert_close, build_engines, requests, run_both

D, H, S, B = 64, 4, 16, 2


def _tree(rng):
    """Two tower layers whose attention and FFN denses pass the int8 size
    gate (512 × 512, 512 × 1,024), LayerNorms, and a small head."""
    def dense(k, n):
        return {"kernel": rng.normal(size=(k, n)).astype(np.float32) * 0.02,
                "bias": rng.normal(size=(n,)).astype(np.float32) * 0.01}
    layer = lambda: {                                           # noqa: E731
        "attn": {n: dense(512, 512) for n in "qkvo"},
        "mlp_in": dense(512, 1024), "mlp_out": dense(1024, 512),
        "ln": {"scale": np.ones(512, np.float32),
               "bias": np.zeros(512, np.float32)}}
    return {"layers": [layer(), layer()], "head": dense(512, 2)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _as_numpy(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _dtype_name(t):
    return (str(t.dtype).removeprefix("torch.") if isinstance(t, torch.Tensor)
            else np.asarray(t).dtype.name)


def assert_same_tree(got, want):
    """Same paths, dtypes, shapes and values (exact)."""
    g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert _dtype_name(a) == _dtype_name(b), path
        np.testing.assert_array_equal(_as_numpy(a), _as_numpy(b), str(path))


@pytest.fixture(scope="module")
def tree():
    return _tree(np.random.default_rng(3))


def test_fuse_and_unfuse_match_jax(tree):
    fused = t_serving.fuse_qkv_params(params_from_jax(tree))
    assert_same_tree(fused, j_serving.fuse_qkv_params(tree))
    assert set(fused["layers"][0]["attn"]) == {"qkv", "o"}
    assert fused["layers"][0]["attn"]["qkv"]["kernel"].shape == (512, 1536)
    back = t_serving.unfuse_qkv_params(fused)
    assert_same_tree(back, j_serving.unfuse_qkv_params(
        j_serving.fuse_qkv_params(tree)))
    assert_same_tree(back, tree)
    assert all(t.is_contiguous() for _, t in _leaves(back))
    # not attention: a dict without "kernel" under q is left alone
    other = {"q": {"w": torch.ones(2)}, "k": {}, "v": {}, "o": {}}
    assert t_serving.fuse_qkv_params(other) is not other
    assert set(t_serving.fuse_qkv_params(other)) == {"q", "k", "v", "o"}


@pytest.mark.parametrize("cast", [True, False])
@pytest.mark.parametrize("quant", ["none", "int8", "int8_ffn", "auto"])
@pytest.mark.parametrize("fuse", [False, True])
def test_optimize_for_serving_matches_jax(tree, fuse, quant, cast):
    """F12: JAX's keywords, defaults and order (resolve, fuse, quantize or
    cast); "auto" resolves to "none" on the CPU in both packages."""
    want = j_serving.optimize_for_serving(tree, JPolicy(), quant=quant,
                                          fuse=fuse, cast=cast)
    got = t_serving.optimize_for_serving(params_from_jax(tree), TPolicy(),
                                         quant=quant, fuse=fuse, cast=cast)
    assert_same_tree(got, want)
    attn = got["layers"][0]["attn"]
    assert ("qkv" in attn) == fuse
    if fuse and quant == "int8":
        # one scale per output column: the three unfused kernels' scales
        unfused = t_serving.optimize_for_serving(
            params_from_jax(tree), TPolicy(), quant="int8")["layers"][0][
                "attn"]
        for name in ("kernel_q", "w_scale", "bias"):
            assert torch.equal(attn["qkv"][name], torch.cat(
                [unfused[n][name] for n in "qkv"], dim=-1))


def test_optimize_for_serving_defaults_as_jax(tree):
    want = j_serving.optimize_for_serving(tree, J_F32)
    got = t_serving.optimize_for_serving(params_from_jax(tree), T_F32)
    assert_same_tree(got, want)
    # under a mesh "auto" resolves to "none" in both packages
    assert_same_tree(
        t_serving.optimize_for_serving(params_from_jax(tree), T_BF16,
                                       quant="auto", mesh=object()),
        j_serving.optimize_for_serving(tree, JPolicy(), quant="auto",
                                       mesh=object()))


def test_deoptimize_fused_int8_matches_jax(tree):
    """F13: dequantize, then unfuse, as JAX's ``deoptimize_params``."""
    served = j_serving.optimize_for_serving(tree, JPolicy(), quant="int8",
                                            fuse=True)
    want = j_serving.deoptimize_params(served)
    got = t_serving.deoptimize_params(
        params_from_jax(jax.tree.map(np.asarray, served)))
    assert set(got["layers"][1]["attn"]) == {"q", "k", "v", "o"}
    assert_same_tree(got, want)
    assert all(t.is_contiguous() for _, t in _leaves(got))
    # the bf16 fused tree likewise (upcast, unfused)
    served = j_serving.optimize_for_serving(tree, JPolicy(), fuse=True)
    assert_same_tree(t_serving.deoptimize_params(
        params_from_jax(jax.tree.map(np.asarray, served))),
        j_serving.deoptimize_params(served))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_plain_fused_equals_three_unfused(x_dtype, bias):
    """K2's plain version (what the wrapper runs on CPU tensors) on a
    fused QKV weight: bit for bit the three unfused products side by
    side, the check the card runs on the kernel."""
    KC.check_int8_dense_fused(KC.int8_dense_case(
        300, 256, 3 * 128, x_dtype, bias=bias, device="cpu"))


# ---------------------------------------------------------------- attention

@pytest.fixture(scope="module")
def attn():
    """A self-attention dict (JAX's init) and its fused form, both sides."""
    p = j_attention.attention_init(jax.random.PRNGKey(4), D, H)
    pf = j_serving.fuse_qkv_params(p)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    mask = (rng.random((B, S)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    seg = np.array([[1] * 5 + [2] * 7 + [0] * 4, [1] * 9 + [2] * 7], np.int32)
    return {"jf": pf, "t": params_from_jax(jax.tree.map(np.asarray, p)),
            "tf": params_from_jax(jax.tree.map(np.asarray, pf)), "x": x,
            "mask": mask, "segment_ids": seg}


CASES = {"mask": dict(mask=True), "causal": dict(causal=True),
         "segments": dict(segment_ids=True)}


def _kw(a, case, torch_side):
    kw = {}
    for k, v in CASES[case].items():
        if k == "causal":
            kw[k] = v
        else:
            kw[k] = torch.from_numpy(a[k]) if torch_side else jnp.asarray(a[k])
    return kw


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_fused_attention_matches_jax(attn, mode, case):
    """F14: JAX's fused branch; f32 within 1e-5, bf16 within 2e-2."""
    jpol, tpol, tol = ((J_F32, T_F32, 1e-5) if mode == "f32"
                       else (J_BF16, T_BF16, 2e-2))
    dt = jnp.float32 if mode == "f32" else jnp.bfloat16
    jkw = _kw(attn, case, False)
    causal = jkw.pop("causal", False)
    want = jax.jit(lambda p, x, kw: j_attention.multi_head_attention(
        p, x, H, policy=jpol, causal=causal, **kw))(
            attn["jf"], jnp.asarray(attn["x"], dt), jkw)
    x = torch.from_numpy(attn["x"]).to(tpol.compute)
    kw = _kw(attn, case, True)
    got = t_attention.multi_head_attention(attn["tf"], x, H, policy=tpol,
                                           **kw)
    assert got.dtype == tpol.compute
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=tol)
    # the port's unfused attention on the same weights: bit for bit
    assert torch.equal(got, t_attention.multi_head_attention(
        attn["t"], x, H, policy=tpol, **kw))
    if case != "segments":      # packed rows never take the kernel
        k3 = t_attention.multi_head_attention(attn["tf"], x, H, policy=tpol,
                                              use_pallas=True, **kw)
        assert torch.equal(k3, t_attention.multi_head_attention(
            attn["t"], x, H, policy=tpol, use_pallas=True, **kw))


def test_fused_params_refuse_cross_attention(attn):
    x = torch.from_numpy(attn["x"])
    with pytest.raises(AssertionError, match="self-attention"):
        t_attention.multi_head_attention(attn["tf"], x, H, policy=T_F32,
                                         kv=x.clone())


# ------------------------------------------------------------ full program

def test_full_program_on_a_fused_tree_matches_jax(tmp_path, monkeypatch):
    """A fused JAX tree, carried across by ``params_from_jax``, served by
    both engines in f32 parity mode: every score within 1e-3."""
    j_eng, t_eng = build_engines(
        tmp_path, "float32", "auto",
        quantize=lambda t, _: j_serving.fuse_qkv_params(t))
    assert "qkv" in t_eng.params["roberta"]["layers"][0]["attn"]
    a, b = run_both(j_eng, t_eng, monkeypatch)
    assert_close(a, b, 1e-3)


def _programs(eng, monkeypatch):
    """analyze_batch of the mixed requests → ({variant: SignalOutput},
    reports)."""
    out = {}
    prog = t_signals.signals_program

    def spy(params, batch, *, variant, **kw):
        out[variant] = prog(params, batch, variant=variant, **kw)
        return out[variant]
    monkeypatch.setattr(t_signals, "signals_program", spy)
    reports = eng.analyze_batch(requests())
    monkeypatch.setattr(t_signals, "signals_program", prog)
    return out, reports


def test_full_program_fused_int8_equals_unfused(tmp_path, monkeypatch):
    """quant="int8" (every tower dense quantized, the size gate lowered to
    the tiny widths): per-column weight scales, per-row activation scales
    and exact integer sums make each fused output column the unfused
    one, so every program's outputs are equal bit for bit."""
    det = TDetectorConfig.tiny()
    base = detector_init(0, det)
    cfg = t_config.ForensicsConfig(
        verbose=False,
        precision=dataclasses.replace(t_config.PrecisionConfig(),
                                      quant="int8"),
        seq=t_config.SequenceConfig(roberta_max_len=32, image_size=64))
    outs = []
    for fuse in (False, True):
        tree = t_serving.fuse_qkv_params(base) if fuse else base
        eng = t_forensics.MisinfoForensics(
            config=cfg, det_cfg=det, params=quantize_params(tree, 1),
            device="cpu")
        assert ("qkv" in eng.params["clip"]["vision"]["blocks"][0]["attn"]
                ) == fuse
        assert eng.params["roberta"]["layers"][0]["attn"][
            "qkv" if fuse else "q"]["kernel_q"].dtype == torch.int8
        outs.append(_programs(eng, monkeypatch))
    (u, ru), (f, rf) = outs
    assert set(u) == set(f) == {"full", "text_packed", "visual_only"}
    for variant in u:
        for a, b in zip(u[variant], f[variant]):
            assert torch.equal(a, b), variant
    assert ru == rf
