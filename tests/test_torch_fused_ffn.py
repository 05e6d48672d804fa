"""The fused FFN kernel K5 in the port: its plain version held to the JAX
package's Pallas kernel in interpret mode on the CPU, as
tests/test_pallas_kernels.py runs it (the CUDA kernel is held to its
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: the JAX test's bands, f32 within atol 3e-5 / rtol 1e-5 and
bf16 within 2e-2; the towers with ``use_pallas="ffn"`` within 5e-5 of
JAX's in f32. The card check of ops/kernel_checks.py rejects its planted
faults here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.models import clip as j_clip
from misinfo_tpu.models import roberta as j_rob
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.ops.pallas_ffn import ffn_apply as j_ffn_apply
from misinfo_tpu.ops.pallas_ffn import fused_ffn

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.models import clip as t_clip
from misinfo_tpu_torch.models import roberta as t_rob
from misinfo_tpu_torch.ops import fused_ffn as K5
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops.common import Policy as TPolicy

JP, TP = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _operands(M=12, K=64, N=128, K2=64, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            (rng.normal(size=(K, N)) * 0.1).astype(np.float32),
            (rng.normal(size=(N,)) * 0.1).astype(np.float32),
            (rng.normal(size=(N, K2)) * 0.1).astype(np.float32),
            (rng.normal(size=(K2,)) * 0.1).astype(np.float32))


def _both(ops, mode, dtype, shape=None):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, w1, b1, w2, b2 = ops
    if shape:
        x = x.reshape(*shape, -1)
    j = [jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1),
         jnp.asarray(w2, jdt), jnp.asarray(b2)]
    want = np.asarray(fused_ffn(*j, mode=mode).astype(jnp.float32))
    t = [torch.tensor(np.asarray(a.astype(jnp.float32))) for a in j]
    got = K5.fused_ffn(t[0].to(dtype), t[1].to(dtype), t[2], t[3].to(dtype),
                       t[4], mode=mode)
    assert got.dtype == dtype
    return got.float().numpy(), want


@pytest.mark.parametrize("mode", ["erf", "tanh", "quick"])
def test_plain_k5_f32_matches_jax_kernel(mode):
    got, want = _both(_operands(), mode, torch.float32)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["erf", "tanh", "quick"])
def test_plain_k5_bf16_matches_jax_kernel(mode):
    got, want = _both(_operands(seed=5), mode, torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_k5_row_padding_and_3d(dtype):
    """Odd row counts, leading dims flattened, and N = 1,536 (three
    512-column chunks, the kernel's chunk width)."""
    ops = _operands(M=9, K=64, N=1536, seed=6)
    got, want = _both(ops, "erf", dtype, shape=(3, 3))
    assert got.shape == want.shape == (3, 3, 64)
    tol = (dict(atol=3e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    np.testing.assert_allclose(got, want, **tol)


def test_ffn_apply_matches_jax():
    x, w1, b1, w2, b2 = _operands(seed=7)
    pj = ({"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
          {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)})
    pt = tuple(params_from_jax(jax.tree.map(np.asarray, p)) for p in pj)
    want = j_ffn_apply(*pj, jnp.asarray(x), policy=JP, mode="erf")
    got = K5.ffn_apply(*pt, torch.from_numpy(x), policy=TP, mode="erf")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("use_pallas", ["ffn", True])
def test_towers_with_opt_in_kernels_match_jax(use_pallas, monkeypatch):
    """RoBERTa and both CLIP towers (tiny, f32) with use_pallas="ffn" (K5
    in every FFN, einsum attention) or True (K3 in every attention)."""
    calls = []
    plain = K5.fused_ffn_plain
    monkeypatch.setattr(K5, "fused_ffn_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    rcfg, ccfg = j_rob.RobertaConfig.tiny(), j_clip.ClipConfig.tiny()
    tr = t_rob.roberta_init(torch.Generator().manual_seed(0),
                            t_rob.RobertaConfig.tiny())
    tc = t_clip.clip_init(torch.Generator().manual_seed(1),
                          t_clip.ClipConfig.tiny())
    jr, jc = (jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
              for p in (tr, tc))
    rng = np.random.default_rng(7)
    ids = rng.integers(2, 500, size=(2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    # each JAX tower jitted whole: eager dispatch of several interpret-mode
    # kernels in a row can deadlock JAX's TPU interpreter
    pairs = [
        (jax.jit(lambda: j_rob.roberta_encode(
            jr, jnp.asarray(ids), jnp.asarray(mask), rcfg, JP,
            use_pallas=use_pallas))(),
         t_rob.roberta_encode(tr, torch.from_numpy(ids),
                              torch.from_numpy(mask), t_rob.RobertaConfig.tiny(),
                              TP, use_pallas=use_pallas)),
        (jax.jit(lambda: j_clip.clip_text_features(
            jc, jnp.asarray(ids), jnp.asarray(mask), ccfg, JP,
            use_pallas))(),
         t_clip.clip_text_features(tc, torch.from_numpy(ids),
                                   torch.from_numpy(mask),
                                   t_clip.ClipConfig.tiny(), TP, use_pallas)),
        (jax.jit(lambda: j_clip.clip_image_features(
            jc, jnp.asarray(img), ccfg, JP, use_pallas))(),
         t_clip.clip_image_features(tc, torch.from_numpy(img),
                                    t_clip.ClipConfig.tiny(), TP,
                                    use_pallas))]
    for a, b in pairs:
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a),
                                   atol=5e-5, rtol=1e-4)
    layers = 3 * 2          # RoBERTa, CLIP text, CLIP vision; 2 layers each
    assert len(calls) == (layers if use_pallas == "ffn" else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,mode", [(64, 768, 3072, "tanh"),
                                        (77, 512, 2048, "quick"),
                                        (4, 512, 2048, "tanh"),
                                        (32, 384, 1536, "tanh"),
                                        (32, 1280, 5120, "tanh"),
                                        (300, 1280, 5120, "tanh"),
                                        (2464, 512, 2048, "quick")])
def test_k5_card_band_rejects_planted_faults(dtype, M, K, N, mode):
    """Every fault (a chunk, b2, the kernel's last intermediate column
    tile, the ragged last row tile, erf for tanh) leaves the band; in
    bf16 the last two shapes plant the 128-column and (CLIP text b32)
    256-column intermediate tiles, both beside a ragged 64-row tile."""
    res = KC.check_ffn(KC.ffn_case(M, K, N, mode, dtype, device="cpu"))
    chunks = N // 512
    erf = mode == "tanh"
    rows, _ = K5.tiles(M, N, K, dtype)
    ragged = M % rows > 0
    assert res["faults"] == chunks + 2 + ragged + erf
    assert res["nearest_fault"] > 4


def test_cpu_tensors_take_the_plain_version():
    before = K5.launches
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _operands())
    K5.fused_ffn(x, w1, b1, w2, b2, mode="tanh")
    assert K5.launches == before
