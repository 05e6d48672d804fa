"""The fused attention kernel K3 and the row LayerNorm kernel K4 in the
port: their plain versions held to the JAX package's Pallas kernels in
interpret mode on the CPU, as tests/test_pallas_kernels.py runs them
(the CUDA kernels are held to their plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: K3 within 2e-5 in f32 (the JAX test's band) and 2e-2 in
bf16; K4 within 2e-5; ``multi_head_attention(use_pallas=True)`` within
1e-5 of JAX's in f32 (packed rows keep the einsum path on both sides).
The card checks of ops/kernel_checks.py reject their planted faults here
too, with the plain versions in the kernels' place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.ops import attention as j_attn
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.ops.pallas_attention import fused_attention, fused_layer_norm

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.ops import attention as t_attn
from misinfo_tpu_torch.ops import fused_attention as K3
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops.common import Policy as TPolicy

_DT = {"f32": (jnp.float32, torch.float32, 2e-5),
       "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _to_torch(a, dtype):
    return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["plain", "mask", "causal", "mask_causal"])
def test_plain_k3_matches_jax_kernel(dt, kind):
    jdt, tdt, tol = _DT[dt]
    rng = np.random.default_rng(len(kind))
    B, S, H, D = 2, 16, 4, 32
    q, k, v = (jnp.asarray(rng.normal(size=(B, S, H, D)), jdt)
               for _ in range(3))
    mask = None
    if "mask" in kind:
        mask = np.ones((B, S), np.float32)
        mask[0, 10:] = 0
        mask[1, 5:] = 0
    causal = "causal" in kind
    want = fused_attention(q, k, v, mask=None if mask is None
                           else jnp.asarray(mask), causal=causal)
    got = K3.fused_attention(*(_to_torch(t, tdt) for t in (q, k, v)),
                             mask=None if mask is None
                             else torch.from_numpy(mask), causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("shape", [(4, 16, 64), (3, 768)])
def test_plain_k4_matches_jax_kernel(shape):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 3 + 5).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    want = jax.jit(fused_layer_norm)(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias))
    got = K3.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("kind", ["mask", "causal", "segments", "vision"])
def test_attention_use_pallas_matches_jax(kind, monkeypatch):
    """``use_pallas=True`` runs K3 (its plain version here) wherever rows
    are not packed; packed rows keep the einsum path, as in JAX."""
    rng = np.random.default_rng(5)
    B, S, D, H = 2, 9, 256, 4
    p = {n: {"kernel": rng.normal(size=(D, D)).astype(np.float32) * 0.05,
             "bias": rng.normal(size=(D,)).astype(np.float32) * 0.1}
         for n in ("q", "k", "v", "o")}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if kind in ("mask", "causal"):
        m = np.ones((B, S), np.int32)
        m[1, 5:] = 0
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
        kw_j["causal"] = kw_t["causal"] = kind == "causal"
    if kind == "segments":
        seg = np.array([[1, 1, 1, 2, 2, 2, 2, 0, 0], [1] * 9], np.int32)
        kw_j["segment_ids"] = jnp.asarray(seg)
        kw_t["segment_ids"] = torch.from_numpy(seg)
    tp = params_from_jax(p)
    calls = []
    plain = K3.fused_attention_plain
    monkeypatch.setattr(K3, "fused_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    jp, tpol = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())
    want = jax.jit(lambda: j_attn.multi_head_attention(
        p, jnp.asarray(x), H, policy=jp, use_pallas=True, **kw_j))()
    got = t_attn.multi_head_attention(tp, torch.from_numpy(x), H,
                                      policy=tpol, use_pallas=True, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert len(calls) == (0 if kind == "segments" else 1)


@pytest.mark.parametrize("S,k11,k3", [(128, 1, 0), (9, 0, 1)])
def test_flash_mode_takes_jax_gate(S, k11, k3, monkeypatch):
    """``use_pallas="flash"`` runs the flash kernel K11 where JAX's gate
    opens (S ≥ 128, a multiple of 128) and K3 below it, as JAX falls
    through (tests/test_torch_flash_attention.py holds both to JAX)."""
    from misinfo_tpu_torch.ops import flash_attention as K11
    x = torch.randn(1, S, 256, generator=torch.Generator().manual_seed(S))
    p = {n: {"kernel": torch.eye(256)} for n in "qkvo"}
    calls = {}
    for mod, name in ((K11, "flash_attention_plain"),
                      (K3, "fused_attention_plain")):
        plain = getattr(mod, name)
        calls[name] = []
        monkeypatch.setattr(mod, name, lambda *a, _c=calls[name], _p=plain,
                            **kw: _c.append(1) or _p(*a, **kw))
    out = t_attn.multi_head_attention(p, x, 4, use_pallas="flash")
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert (len(calls["flash_attention_plain"]),
            len(calls["fused_attention_plain"])) == (k11, k3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,mask,causal", [(2, 160, 4, True, False),
                                               (3, 77, 8, True, True),
                                               (2, 50, 12, False, False)])
def test_k3_card_band_rejects_planted_faults(dtype, B, S, H, mask, causal):
    res = KC.check_attention(KC.attention_case(B, S, H, mask, causal, dtype,
                                               device="cpu"))
    want = -(-S // KC.KEY_TILE) + mask + causal + (dtype == torch.bfloat16)
    assert res["faults"] == want and res["nearest_fault"] > 10


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_card_band_rejects_planted_faults(dtype):
    res = KC.check_layer_norm(KC.layer_norm_case(300, 768, dtype,
                                                 device="cpu"))
    assert res["faults"] == 2 and res["nearest_fault"] > 10


def test_cpu_tensors_take_the_plain_versions():
    before = (K3.launches, K3.ln_launches)
    case = KC.attention_case(1, 8, 2, True, True, device="cpu")
    K3.fused_attention(case["q"], case["k"], case["v"], case["mask"], True)
    ln = KC.layer_norm_case(6, 64, device="cpu")
    K3.fused_layer_norm(ln["x"], ln["scale"], ln["bias"])
    assert (K3.launches, K3.ln_launches) == before
