"""The int8 kernels' K-major weights and their conversion-free rounding,
on the CPU.

* The detector's serving transform with the K-major layout
  (``serving.kmajor_kernels`` after ``optimize_for_serving``, as the
  engine's transform lays out a tree on a CUDA device) gives the JAX
  tree's names, shapes and values,
  with every int8 kernel's transpose contiguous; the Whisper decoder's
  int8 weights (read by the decode-step kernels) stay [in, out]
  contiguous.
* ``csrc/int8_gemm.cuh`` quantizes by a reciprocal, with a division only
  near a half-integer, and rounds by an addition (``quant``): emulated
  here operation for operation in numpy float32 (IEEE, as on the card)
  and held bit for bit to the IEEE quotient rounded half to even, on
  random and on adversarial inputs (quotients within a few ulps of every
  half-integer up to ±127.5).
"""

import jax
import numpy as np
import pytest
import torch

from misinfo_tpu.ops import serving as j_serving
from misinfo_tpu.ops.common import Policy as JPolicy

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.models.whisper import (
    WhisperConfig, fuse_whisper_decoder_qkv, whisper_init)
from misinfo_tpu_torch.ops import serving as t_serving
from misinfo_tpu_torch.ops.common import Policy as TPolicy

R127 = np.float32(0.007874015718698502)      # f32(1/127)
MAGIC = np.float32(12582912.0)               # 1.5·2^23


def _tree(rng):
    """Two tower layers of attention and FFN denses above the int8 size
    gate (512 × 512 and 512 × 1,024), LayerNorms and a small head."""
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
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _path_key(leaf):
    return tuple(str(k) for k in leaf[0])


@pytest.mark.parametrize("quant", ["int8", "int8_ffn"])
def test_kmajor_serving_tree_equals_jax(quant):
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    want = j_serving.optimize_for_serving(tree, JPolicy(), quant=quant)
    cpu = t_serving.optimize_for_serving(
        params_from_jax(jax.tree.map(np.asarray, tree)), TPolicy(), quant)
    assert all(t.is_contiguous() for _, t in _leaves(cpu))   # CPU: as JAX's
    got = t_serving.kmajor_kernels(cpu)
    flat_w = sorted(_leaves(jax.tree.map(np.asarray, want)), key=_path_key)
    flat_g = sorted(_leaves(got), key=_path_key)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    kernels = 0
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        gv = g.float().numpy() if g.is_floating_point() else g.numpy()
        np.testing.assert_array_equal(gv, np.asarray(w, gv.dtype), str(path))
        if path[-1] == "kernel_q":
            kernels += 1
            assert g.t().is_contiguous() and not g.is_contiguous(), path
    assert kernels == (12 if quant == "int8" else 4)


def test_kmajor_stores_no_byte_twice():
    wq = torch.randint(-127, 128, (512, 1024), dtype=torch.int8)
    k = t_serving.kmajor(wq)
    assert torch.equal(k, wq) and k.t().is_contiguous()
    assert k.untyped_storage().nbytes() == wq.numel()
    assert t_serving.kmajor(k).data_ptr() == k.data_ptr()    # idempotent


def test_whisper_int8_decoder_weights_stay_n_major():
    p = whisper_init(0, WhisperConfig.tiny())
    q = t_serving.quantize_whisper_decoder(fuse_whisper_decoder_qkv(p))
    kq = [(path, t) for path, t in _leaves(q) if path[-1] == "kernel_q"]
    assert kq
    for path, t in kq:
        assert t.is_contiguous(), path


def _quant(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """``i8g::quant(v, s, __frcp_rn(s))``, float32 operation for
    operation (numpy's float32 operations round to nearest even)."""
    r = np.float32(1.0) / s
    q = v * r
    t = q + MAGIC
    near = np.abs(q - (t - MAGIC)) > np.float32(0.5 - 2.0 ** -14)
    t = np.where(near, v / s + MAGIC, t)
    return np.clip(t.view(np.int32) - np.int32(0x4B400000), -127, 127), near


def _want(v, s):
    return np.clip(np.rint(v / s), -127, 127).astype(np.int32)


def test_reciprocal_quantize_equals_division():
    rng = np.random.default_rng(2)
    rows = np.concatenate([
        rng.normal(size=(2048, 768)).astype(np.float32),
        rng.standard_cauchy(size=(512, 768)).astype(np.float32),
        (rng.normal(size=(512, 768)) * 1e-9).astype(np.float32)])
    s = np.maximum(np.abs(rows).max(axis=1, keepdims=True) * R127,
                   np.float32(1e-8)).astype(np.float32)
    got, near = _quant(rows, s)
    np.testing.assert_array_equal(got, _want(rows, s))
    assert near.mean() < 1e-3             # the division is the rare path


def test_reciprocal_quantize_at_half_integers():
    """Quotients within three ulps of every half-integer of the range."""
    rng = np.random.default_rng(3)
    amax = (rng.random(4096) * 100 + 1e-3).astype(np.float32)
    s = np.maximum(amax * R127, np.float32(1e-8)).astype(np.float32)[:, None]
    half = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5))
    up = [(half[None, :] * s).astype(np.float32)]
    down = up[:]
    for _ in range(3):
        up.append(np.nextafter(up[-1], np.float32(np.inf)))
        down.append(np.nextafter(down[-1], np.float32(-np.inf)))
    v = np.concatenate(up + down[1:], axis=1)
    v = np.clip(v, -amax[:, None], amax[:, None])
    got, near = _quant(v, np.broadcast_to(s, v.shape))
    np.testing.assert_array_equal(got, _want(v, s))
    assert near.any()                     # the fallback was exercised
