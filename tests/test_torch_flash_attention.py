"""``use_pallas="flash"`` in the port: the flash attention kernel K11's
plain version held to JAX's library TPU flash kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``) in TPU interpret
mode on the CPU, on every row, padding rows included; the attention
layer's gate and fall-through; the engine against the JAX engine in the
same mode; a model group; and the card check's band against its planted
faults (the CUDA kernel is held to the plain version on the card by
chip_smoke.py phase 32). Gradients through it are
tests/test_torch_flash_attention_bwd.py's.

Tolerances: the plain version within 1e-5 of JAX's kernel in f32, and in
bf16 within K11's card band (ops/kernel_checks.py::flash_band: the
roundings of JAX's f32 accumulator, a sum in another order, may land one
output step apart only where that accumulator lies within its error
bound of a rounding boundary); ``multi_head_attention`` within 1e-5 in
f32; the engine's scores within 1e-3 in f32 (the ROADMAP parity bar),
verdicts and vault top-k equal, and within 0.05 in bf16 (the bf16 band of
tests/test_torch_engine_bf16.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, flash_attention as j_flash)

from misinfo_tpu.core import config as j_config
from misinfo_tpu.core.config import PrecisionConfig as JPrecision
from misinfo_tpu.engine.forensics import MisinfoForensics as JEngine
from misinfo_tpu.models.detector import DetectorConfig as JDetectorConfig
from misinfo_tpu.ops import attention as j_attn
from misinfo_tpu.ops.common import Policy as JPolicy
from misinfo_tpu.vault.store import TruthVault

from misinfo_tpu_torch.checkpoints.from_jax import params_from_jax
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.core import mesh as t_mesh
from misinfo_tpu_torch.core.config import MeshConfig
from misinfo_tpu_torch.core.config import PrecisionConfig as TPrecision
from misinfo_tpu_torch.engine import forensics as t_forensics
from misinfo_tpu_torch.models.detector import (
    DetectorConfig as TDetectorConfig, detector_init)
from misinfo_tpu_torch.ops import attention as t_attn
from misinfo_tpu_torch.ops import flash_attention as K11
from misinfo_tpu_torch.ops import fused_attention as K3
from misinfo_tpu_torch.ops import kernel_checks as KC
from misinfo_tpu_torch.ops.common import Policy as TPolicy
from misinfo_tpu_torch.parallel import sharding as t_sharding
from misinfo_tpu_torch.parallel.tensor import ModelSplit

from test_torch_engine import _image, assert_close

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_flash(case):
    """JAX's library kernel on a ``KC.flash_case`` (its [B, H, S, D]
    layout), jitted in TPU interpret mode → [B, S, H, D] f32."""
    q, k, v = (jnp.asarray(case[n].float().numpy(), _JDT[case[n].dtype]
                           ).transpose(0, 2, 1, 3) for n in "qkv")
    seg = None
    if case["q_seg"] is not None:
        seg = SegmentIds(q=jnp.asarray(case["q_seg"].numpy()),
                         kv=jnp.asarray(case["kv_seg"].numpy()))
    fn = jax.jit(lambda a, b, c: j_flash(
        a, b, c, segment_ids=seg, causal=case["causal"],
        sm_scale=1.0 / a.shape[-1] ** 0.5))
    with pltpu.force_tpu_interpret_mode():
        out = fn(q, k, v)
    return torch.from_numpy(np.array(out.astype(jnp.float32))
                            ).permute(0, 2, 1, 3)


# (kind, S): packed requests with a padding tail, the padded form, causal
# without segment ids, packed and causal; S = 128 is the single-step form
_KINDS = {"packed": ("packed", False), "padded": ("padded", False),
          "causal": ("none", True), "packed_causal": ("packed", True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,S", [("packed", 256), ("padded", 256),
                                    ("causal", 256), ("packed_causal", 256),
                                    ("packed", 128), ("padded", 128)])
def test_plain_matches_jax_library_kernel(kind, S, dtype):
    layout, causal = _KINDS[kind]
    case = KC.flash_case(2, S, 2, layout, causal, dtype, seed=3,
                         device="cpu")
    want = _jax_flash(case)
    got = K11.flash_attention(*(case[n] for n in ("q", "k", "v", "q_seg",
                                                  "kv_seg")), causal)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        _, band = KC.flash_band(case)
        assert bool((err <= band).all()), (err - band).max()
    if layout == "packed":        # padding rows attend the padding keys
        pad = case["q_seg"] == 0
        assert bool(pad.any())
        assert torch.isfinite(got[pad].float()).all()


def _attn_params(rng, D):
    return {n: {"kernel": rng.normal(size=(D, D)).astype(np.float32) * 0.05,
                "bias": rng.normal(size=(D,)).astype(np.float32) * 0.1}
            for n in ("q", "k", "v", "o")}


def _fused(p):
    return {"qkv": {n: np.concatenate([p[m][n] for m in "qkv"], axis=-1)
                    for n in ("kernel", "bias")}, "o": p["o"]}


def _count(monkeypatch, module, name):
    calls = []
    plain = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    return calls


# (kind, S, K11 calls, K3 calls): the gate opens at S = 128 and 256; at
# S = 96 "flash" falls through to K3 without segment ids and to the einsum
# path with them, as in JAX
@pytest.mark.parametrize("kind,S,k11,k3", [
    ("mask", 128, 1, 0), ("segments", 256, 1, 0), ("causal", 128, 1, 0),
    ("plain", 256, 1, 0), ("fused_qkv", 128, 1, 0), ("mask", 96, 0, 1),
    ("segments", 96, 0, 0)])
def test_attention_flash_matches_jax(kind, S, k11, k3, monkeypatch):
    rng = np.random.default_rng(S + len(kind))
    B, D, H = 2, 128, 2
    p = _attn_params(rng, D)
    if kind == "fused_qkv":
        p = _fused(p)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if kind in ("mask", "fused_qkv"):
        m = np.ones((B, S), np.int32)
        m[1, S * 2 // 3:] = 0
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if kind == "causal":
        kw_j["causal"] = kw_t["causal"] = True
    if kind == "segments":
        seg = np.zeros((B, S), np.int32)
        seg[0, :S // 3], seg[0, S // 3:S - 20] = 1, 2
        seg[1, :] = 1
        kw_j["segment_ids"] = jnp.asarray(seg)
        kw_t["segment_ids"] = torch.from_numpy(seg)
    flash = _count(monkeypatch, K11, "flash_attention_plain")
    fused = _count(monkeypatch, K3, "fused_attention_plain")
    jp, tpol = JPolicy(JPrecision.highest()), TPolicy(TPrecision.highest())
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda: j_attn.multi_head_attention(
            p, jnp.asarray(x), H, policy=jp, use_pallas="flash", **kw_j))()
    got = t_attn.multi_head_attention(params_from_jax(p),
                                      torch.from_numpy(x), H, policy=tpol,
                                      use_pallas="flash", **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert (len(flash), len(fused)) == (k11, k3)


def test_model_split_runs_k11_per_position(monkeypatch):
    """A model=2 group over ``cpu`` entries: each position runs K11 (its
    plain version) on its head before the row-split ``o`` product, equal
    to the unsplit layer within 1e-5 in f32."""
    det = _det(TDetectorConfig)
    tree = detector_init(0, det)
    mesh = t_mesh.make_mesh(MeshConfig(data=1, model=2),
                            devices=["cpu"] * 2)
    lay = tree["roberta"]["layers"][0]["attn"]
    split = t_sharding.shard_params(mesh, tree).row(0)["roberta"][
        "layers"][0]["attn"]
    assert isinstance(split, ModelSplit) and len(split) == 2
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 128, 128)).astype(np.float32))
    mask = torch.ones(2, 128, dtype=torch.int32)
    mask[1, 90:] = 0
    pol = TPolicy(TPrecision.highest())
    want = t_attn.multi_head_attention(lay, x, 2, mask, policy=pol,
                                       use_pallas="flash")
    calls = _count(monkeypatch, K11, "flash_attention_plain")
    got = t_attn.multi_head_attention(split, x, 2, mask, policy=pol,
                                      use_pallas="flash")
    assert len(calls) == 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ------------------------------------------------------------- the engine

def _det(cls):
    """DetectorConfig.tiny() with a RoBERTa of two heads of width 64 and
    rows of 128 tokens (so that JAX's flash gate opens)."""
    d = cls.tiny()
    return dataclasses.replace(d, roberta=dataclasses.replace(
        d.roberta, hidden_size=128, num_heads=2, intermediate_size=256,
        max_position_embeddings=130))


def _engines(tmp_path, precision, pack_text):
    """(JAX engine, port engine), both ``use_pallas="flash"``, over one
    seeded tree and vault (as test_torch_engine.build_engines)."""
    det = _det(TDetectorConfig)
    tree = jax.tree.map(lambda t: t.numpy(), detector_init(0, det))
    rng = np.random.default_rng(5)
    d = det.clip.projection_dim
    vault = TruthVault(rng.normal(size=(6, d)).astype(np.float32),
                       [{"title": f"article {i}", "url": f"u{i}",
                         "date": "2024"} for i in range(6)],
                       rng.normal(size=(6, d)).astype(np.float32))
    vpath = str(tmp_path / "vault.npz")
    vault.save(vpath)
    out = []
    for cfgmod, engine, det_cfg, params, kw in (
            (j_config, JEngine, _det(JDetectorConfig), tree, {}),
            (t_config, t_forensics.MisinfoForensics, det,
             params_from_jax(tree), {"device": "cpu"})):
        prec = (cfgmod.PrecisionConfig.highest() if precision == "float32"
                else cfgmod.PrecisionConfig())
        cfg = cfgmod.ForensicsConfig(
            verbose=False, precision=dataclasses.replace(prec, quant="none"),
            paths=cfgmod.ModelPaths(vault_path=vpath),
            seq=cfgmod.SequenceConfig(roberta_max_len=128, image_size=64),
            serving=cfgmod.ServingConfig(pack_text=pack_text))
        out.append(engine(config=cfg, det_cfg=det_cfg, params=params,
                          use_pallas="flash", **kw))
    return out


def _flash_requests():
    """Four full requests of 70-110 words (rows of 128 tokens) and two
    text-only ones of 80 and 15 words, and one image."""
    rng = np.random.default_rng(21)

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(0, 999, n))
    return ([{"text": words(n), "image": _image(n)} for n in (70, 85, 96,
                                                              110)]
            + [{"text": words(n)} for n in (80, 15)]
            + [{"image": _image(3)}])


@pytest.mark.parametrize("precision,pack_text", [
    ("float32", False), ("float32", True), ("bfloat16", True)])
def test_engine_flash_matches_jax(precision, pack_text, tmp_path,
                                  monkeypatch):
    """Unpacked rows run K11 over (ones, mask), packed rows over their
    segment ids; RoBERTa's two layers launch it once each per text
    program, CLIP's 32 and 17 tokens take K3 (JAX's fall-through)."""
    j_eng, t_eng = _engines(tmp_path, precision, pack_text)
    assert t_eng.use_pallas == "flash"
    flash = _count(monkeypatch, K11, "flash_attention_plain")
    fused = _count(monkeypatch, K3, "fused_attention_plain")
    reqs = _flash_requests()
    with pltpu.force_tpu_interpret_mode():
        a = j_eng.analyze_batch(reqs)
    b = t_eng.analyze_batch(reqs)
    # full and text_only programs, 2 RoBERTa layers each; CLIP text and
    # vision in full (2 + 2) and vision in visual_only (2)
    assert (len(flash), len(fused)) == (2 * 2, 4 + 2)
    if precision == "float32":
        assert_close(a, b, 1e-3)
    else:
        for ra, rb in zip(a, b):
            for k, v in ra["scores"].items():
                assert abs(v - rb["scores"][k]) < 0.05, k


# ------------------------------------------------------- the card's check

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,layout,causal", [
    (2, 256, 2, "packed", False), (2, 384, 2, "padded", False),
    (2, 256, 2, "packed", True), (2, 128, 2, "packed", False),
    (2, 256, 2, "none", True)])
def test_k11_card_band_rejects_planted_faults(dtype, B, S, H, layout,
                                              causal):
    res = KC.check_flash(KC.flash_case(B, S, H, layout, causal, dtype,
                                       device="cpu"))
    nt = S // K11.BLOCK
    want = (nt + (layout == "packed") + (nt > 1)
            + (dtype == torch.bfloat16) + causal + 1)
    assert res["err"] == 0.0
    assert res["faults"] == want and res["nearest_fault"] > 10


def test_k11_walks_fewer_tiles_where_segments_cannot_meet():
    """The kernel's tile plan (mirrored by ``walked_tiles``): segments of
    one 128-token block each walk only their own key tile; causal, the
    tiles up to the query block's own; a block with a padding query of
    the padded form (q_seg 1, kv_seg 0) walks every tile."""
    seg = torch.arange(4, dtype=torch.int32).repeat_interleave(128)[None]
    assert K11.walked_tiles(seg + 1, seg + 1, False, 512, 512).tolist() == [
        [1, 1, 1, 1]]
    assert K11.walked_tiles(None, None, True, 512, 512).tolist() == [
        [1, 2, 3, 4]]
    mask = (torch.arange(512) < 300).to(torch.int32)[None]
    ones = torch.ones_like(mask)
    assert K11.walked_tiles(ones, mask, False, 512, 512).tolist() == [
        [3, 3, 4, 4]]


def test_cpu_tensors_take_the_plain_version():
    before = K11.launches
    case = KC.flash_case(1, 128, 2, "packed", True, device="cpu")
    out = K11.flash_attention(case["q"], case["k"], case["v"],
                              case["q_seg"], case["kv_seg"], True)
    assert K11.launches == before and out.shape == case["q"].shape


def test_flash_refuses_gradients_and_half_segment_ids():
    """A first gradient runs K11-bwd (tests/test_torch_flash_attention_bwd
    .py); a second one is refused, as JAX's custom_vjp refuses it."""
    q = torch.zeros(1, 128, 2, 64, requires_grad=True)
    out = K11.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="Higher-order"):
        torch.autograd.grad(out.sum(), q, create_graph=True)
    seg = torch.ones(1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="go together"):
        K11.flash_attention(q.detach(), q.detach(), q.detach(), seg, None)
