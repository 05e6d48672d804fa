"""The port's mesh layer (core/mesh.py, parallel/) and row-sharded vault
search held to the JAX package on its 8-virtual-device CPU mesh.

* ``parse_mesh_spec`` / ``make_mesh``: the same accepted specs, shapes and
  errors as JAX's; a device list may repeat a device; the default grid
  is the card (an error without one) or the ``--device cpu`` entries.
* ``detector_pspecs``: equal to JAX's on the tiny tree, its int8 form and
  its fused-qkv form. ``shard_params``: each grid position's slice equals
  JAX's shard on that device (the fused qkv kernel is cut per third, so
  that each position keeps whole heads).
* Tensor-parallel products (parallel/tensor.py): column/row-split f32 and
  int8 denses, attention and FFN over model=2 against the unsplit ones,
  within 1e-5 (the int8 row split quantizes over the whole row, as GSPMD).
* ``vault_search_sharded`` against JAX's at N = 8 × 256, D = 64, B = 8,
  K = 5 for f32 and int4 rows: indices exact, sims within 1e-6; and equal
  bit for bit to the port's replicated search where sims tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.core import mesh as j_mesh
from misinfo_tpu.core.config import MeshConfig as JMeshConfig
from misinfo_tpu.parallel import sharding as j_sharding

from misinfo_tpu_torch.core import mesh as t_mesh
from misinfo_tpu_torch.core.config import MeshConfig, PrecisionConfig
from misinfo_tpu_torch.models.detector import DetectorConfig, detector_init
from misinfo_tpu_torch.ops import common as t_common
from misinfo_tpu_torch.ops.attention import multi_head_attention
from misinfo_tpu_torch.ops.quant import quantize_params
from misinfo_tpu_torch.ops.serving import fuse_qkv_params
from misinfo_tpu_torch.parallel import sharding as t_sharding
from misinfo_tpu_torch.parallel.tensor import ModelSplit, tp_ffn
from misinfo_tpu_torch.vault import search as t_search

CPU8 = ["cpu"] * 8
F32 = t_common.Policy(PrecisionConfig.highest())


def _need8():
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 virtual CPU devices (tests/conftest.py)")


@pytest.mark.parametrize("spec", ["8", "data=8", "data=4,model=2",
                                  "model=2", "data=-1,model=4", " data=2 "])
def test_parse_mesh_spec_matches_jax(spec):
    j, t = j_mesh.parse_mesh_spec(spec), t_mesh.parse_mesh_spec(spec)
    assert (t.data, t.model) == (j.data, j.model)


@pytest.mark.parametrize("spec", ["data=0", "model=-1", "data=-2", "x=2",
                                  "data=two", "data=2;model=2"])
def test_parse_mesh_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as je:
        j_mesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as te:
        t_mesh.parse_mesh_spec(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("data,model", [(-1, 1), (-1, 2), (4, 2), (8, 1),
                                        (2, 4), (1, 8), (-1, 3), (3, 2)])
def test_make_mesh_matches_jax(data, model):
    _need8()
    cj = JMeshConfig(data=data, model=model)
    ct = MeshConfig(data=data, model=model)
    try:
        jm = j_mesh.make_mesh(cj)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            t_mesh.make_mesh(ct, devices=CPU8)
        assert str(te.value) == str(e)
        return
    tm = t_mesh.make_mesh(ct, devices=CPU8)
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == jm.axis_names
    assert t_mesh.data_sharding(tm, 3).spec == tuple(
        j_mesh.data_sharding(jm, 3).spec)
    assert t_mesh.replicated(tm).spec == tuple(j_mesh.replicated(jm).spec)


def test_mesh_grid_repeats_devices_and_defaults(monkeypatch):
    m = t_mesh.make_mesh(MeshConfig(data=2, model=1), devices=["cpu", "cpu"])
    assert m.shape == {"data": 2, "model": 1}
    assert m.data_devices == [torch.device("cpu")] * 2
    monkeypatch.setattr(t_mesh, "_platform", "auto")
    monkeypatch.setattr(t_mesh, "_num_cpu_devices", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mesh.make_mesh()
    t_mesh.apply_device_override("cpu", "data=4,model=2")
    m = t_mesh.make_mesh(t_mesh.parse_mesh_spec("data=4,model=2"))
    assert m.shape == {"data": 4, "model": 2}
    assert {d.type for d in m.devices.flat} == {"cpu"}
    with pytest.raises(ValueError, match="mesh 3x1 != 8 devices"):
        t_mesh.make_mesh(MeshConfig(data=3))
    pieces = t_mesh.shard_batch(m, {"x": torch.arange(8).reshape(8, 1)})
    assert [p.flatten().tolist() for p in pieces["x"]] == [[0, 1], [2, 3],
                                                           [4, 5], [6, 7]]
    assert t_mesh.pad_to_multiple(5, 4) == j_mesh.pad_to_multiple(5, 4) == 8


def test_init_multihost_single_process_noop(monkeypatch):
    """No arguments and no env hints: the single-process no-op, as JAX's
    (tests/test_multichip.py::test_init_multihost_single_process_noop);
    no group is opened. A spec's absence leaves the tree as it is."""
    import torch.distributed as dist
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "MISINFO_TPU_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert t_mesh.init_multihost() is False
    assert not dist.is_initialized()
    assert t_mesh.setup_train_mesh(None, {"a": 1}, 4) == (None, {"a": 1})
    with pytest.raises(ValueError, match="process_id not given"):
        t_mesh.init_multihost("localhost:1234", 2)


def test_serving_across_processes_is_refused_as_m15(tree):
    """A model group across processes builds, and says what this process
    holds (training runs it); serving over a mesh with positions in
    another process is refused by name (ROADMAP.md M15); a mesh whose
    positions are all this process's is local."""
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.parallel.sharding import shard_params
    from misinfo_tpu_torch.serve.transcript import WhisperTranscriber
    across = t_mesh.Mesh([["cpu", "cpu"]], ranks=[[0, 1]])
    assert across.multiprocess and across.local_data == [0]
    assert across.local_model(0) == [0] and across.row_ranks(0) == [0, 1]
    with pytest.raises(NotImplementedError, match="M15"):
        shard_params(across, tree)
    two = t_mesh.Mesh([["cpu"], ["cpu"]], ranks=[[0], [1]])
    assert two.multiprocess and two.local_data == [0]
    with pytest.raises(NotImplementedError, match="M15"):
        MisinfoForensics(mesh=two, device="cpu")
    with pytest.raises(NotImplementedError, match="M15"):
        WhisperTranscriber(mesh=two, device="cpu")
    one = t_mesh.make_mesh(MeshConfig(data=2), devices=["cpu"] * 2)
    assert not one.multiprocess and one.local_data == [0, 1]
    one.require_local("serving")


# ------------------------------------------------------------ sharding

@pytest.fixture(scope="module")
def tree():
    return detector_init(0, DetectorConfig.tiny())


def _np_tree(t):
    return jax.tree.map(lambda x: x.numpy(), t)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("form", ["plain", "int8", "fused", "fused_int8"])
def test_detector_pspecs_match_jax(tree, form):
    t = tree
    if form.startswith("fused"):
        t = fuse_qkv_params(t)
    if form.endswith("int8"):
        t = quantize_params(t, min_elems=1)
    got = t_sharding.detector_pspecs(t)
    want = j_sharding.detector_pspecs(_np_tree(t))
    g, w = _flat(got), _flat(jax.tree.map(
        lambda x: t_mesh.PartitionSpec(*x), want,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert len(g) == len(w) > 0
    for (pg, sg), (pw, sw) in zip(g, w):
        assert str(pg) == str(pw) and tuple(sg) == tuple(sw), (pg, sg, sw)
    if form == "int8":
        lay = got["roberta"]["layers"][0]
        assert lay["attn"]["o"]["kernel_q"] == (("model", None))
        assert lay["mlp_in"]["w_scale"] == ("model",)


def test_shard_params_slices_match_jax_shards(tree):
    """Each grid position (d, m) of a data=4 × model=2 mesh holds JAX's
    shard of every leaf on the device at (d, m)."""
    _need8()
    jm = j_mesh.make_mesh(JMeshConfig(data=4, model=2))
    tm = t_mesh.make_mesh(MeshConfig(data=4, model=2), devices=CPU8)
    js = j_sharding.shard_params(jm, _np_tree(tree))
    ts = t_sharding.shard_params(tm, tree)
    where = {dev: pos for pos, dev in np.ndenumerate(jm.devices)}
    j_leaves = jax.tree_util.tree_leaves(js)
    n = 0
    for d in range(4):
        for m in range(2):
            t_leaves = jax.tree_util.tree_leaves(ts.grid[d][m])
            assert len(t_leaves) == len(j_leaves)
            for jl, tl in zip(j_leaves, t_leaves):
                shard = next(s for s in jl.addressable_shards
                             if where[s.device] == (d, m))
                np.testing.assert_array_equal(np.asarray(shard.data),
                                              tl.numpy())
                n += 1
    assert n == 8 * len(j_leaves)
    row = ts.row(1)["roberta"]["layers"][0]
    assert isinstance(row["attn"], ModelSplit) and len(row["attn"]) == 2
    assert "bias" not in row["attn"].parts[0]["o"]
    assert torch.equal(row["attn"].bias, tree["roberta"]["layers"][0]
                       ["attn"]["o"]["bias"])


def test_fused_qkv_splits_per_third(tree):
    fused = fuse_qkv_params(tree)
    tm = t_mesh.make_mesh(MeshConfig(data=1, model=2), devices=["cpu"] * 2)
    ts = t_sharding.shard_params(tm, fused)
    unfused = tree["roberta"]["layers"][0]["attn"]
    for m in range(2):
        got = ts.grid[0][m]["roberta"]["layers"][0]["attn"]["qkv"]["kernel"]
        want = torch.cat([torch.chunk(unfused[n]["kernel"], 2, dim=1)[m]
                          for n in "qkv"], dim=1)
        assert torch.equal(got, want)


def _tp_mesh(model=2):
    return t_mesh.make_mesh(MeshConfig(data=1, model=model),
                            devices=["cpu"] * model)


@pytest.mark.parametrize("form", ["f32", "int8", "fused"])
def test_tensor_parallel_layer_matches_unsplit(tree, form):
    """One RoBERTa layer's attention and FFN over model=2 against the
    unsplit layer: f32 within 1e-5; int8 within 1e-5 (JAX's
    test_int8_tp_sharding_composition bar)."""
    t = tree
    if form == "fused":
        t = fuse_qkv_params(t)
    if form == "int8":
        t = quantize_params(t, min_elems=1)
    lay = t["roberta"]["layers"][0]
    split = t_sharding.shard_params(_tp_mesh(), t).row(0)["roberta"][
        "layers"][0]
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32))
    mask = torch.ones(2, 9, dtype=torch.int32)
    mask[1, 6:] = 0
    want = multi_head_attention(lay["attn"], x, 4, mask, policy=F32)
    got = multi_head_attention(split["attn"], x, 4, mask, policy=F32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    if form == "int8":
        from misinfo_tpu_torch.ops.quant import dense_int8
        want = dense_int8(lay["mlp_out"], t_common.gelu(
            dense_int8(lay["mlp_in"], x, torch.float32), F32), torch.float32)
    else:
        want = t_common.dense(lay["mlp_out"], t_common.gelu(
            t_common.dense(lay["mlp_in"], x, F32), F32), F32)
    got = tp_ffn(split["mlp_in"], split["mlp_out"], x, F32,
                 lambda h: t_common.gelu(h, F32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ------------------------------------------------------- sharded vault

def _vault_case(dtype):
    rng = np.random.default_rng(3)
    N, D, B = 8 * 256, 64, 8
    emb = rng.normal(size=(N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    temb = rng.normal(size=(N, D)).astype(np.float32)
    temb /= np.linalg.norm(temb, axis=1, keepdims=True)
    valid = np.arange(N) < N - 37
    q = rng.normal(size=(B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = emb[1500]                       # a planted exact match
    cap = rng.normal(size=(B, D)).astype(np.float32)
    cap /= np.linalg.norm(cap, axis=1, keepdims=True)
    planes = {"emb": emb, "temb": temb}
    scales = {}
    if dtype == "int4":
        from misinfo_tpu.vault.int4 import quantize_rows_int4
        for k in ("emb", "temb"):
            q4 = quantize_rows_int4(planes[k])
            planes[k], scales[k] = q4.packed, q4.scale
    return q, planes, scales, valid, cap


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_vault_search_sharded_matches_jax(dtype):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from misinfo_tpu.vault.search import vault_search_sharded as j_vss
    _need8()
    K = 5
    q, planes, scales, valid, cap = _vault_case(dtype)
    jm = j_mesh.make_mesh(JMeshConfig(model=1))

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(jm, spec))
    jkw = {}
    if scales:
        jkw = dict(vault_scale=put(scales["emb"], P("data")),
                   vault_text_scale=put(scales["temb"], P("data")))
    want = jax.jit(lambda qq, v, rv, c, t, **kw: j_vss(
        qq, v, rv, mesh=jm, top_k=K, reuse_threshold=0.0,
        caption_text_emb=c, vault_text_emb=t, **kw))(
            put(q, P("data", None)), put(planes["emb"], P("data", None)),
            put(valid, P("data")), put(cap, P("data", None)),
            put(planes["temb"], P("data", None)), **jkw)

    tm = t_mesh.make_mesh(MeshConfig(data=8), devices=CPU8)

    def shards(a):
        return list(torch.chunk(torch.from_numpy(np.asarray(a)), 8))
    tkw = {}
    if scales:
        tkw = dict(vault_scale=shards(scales["emb"]),
                   vault_text_scale=shards(scales["temb"]))
    got = t_search.vault_search_sharded(
        shards(q), shards(planes["emb"]), shards(valid), mesh=tm, top_k=K,
        reuse_threshold=0.0, caption_text_emb=shards(cap),
        vault_text_emb=shards(planes["temb"]), **tkw)
    np.testing.assert_array_equal(got.top_idx.numpy(),
                                  np.asarray(want.top_idx))
    np.testing.assert_allclose(got.top_sims.numpy(),
                               np.asarray(want.top_sims), atol=1e-6)
    np.testing.assert_allclose(got.text_similarity.numpy(),
                               np.asarray(want.text_similarity), atol=1e-6)
    np.testing.assert_allclose(got.vault_discrepancy.numpy(),
                               np.asarray(want.vault_discrepancy), atol=1e-6)
    # and the port's replicated search, bit for bit
    whole = t_search.vault_search(
        torch.from_numpy(q), torch.from_numpy(planes["emb"]),
        torch.from_numpy(valid), top_k=K, reuse_threshold=0.0,
        caption_text_emb=torch.from_numpy(cap),
        vault_text_emb=torch.from_numpy(planes["temb"]),
        vault_scale=(torch.from_numpy(scales["emb"]) if scales else None),
        vault_text_scale=(torch.from_numpy(scales["temb"]) if scales
                          else None))
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def test_sharded_search_keeps_the_tie_rule():
    """Rows that tie (duplicates across shards, and the -2 fill of
    invalid rows) keep the lowest global index, as one ``topk_first``
    over all rows does."""
    rng = np.random.default_rng(8)
    N, D = 4 * 64, 16
    emb = rng.normal(size=(N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for dup in (70, 130, 250):                 # copies in later shards
        emb[dup] = emb[5]
    emb[200] = emb[71]
    valid = np.ones(N, bool)
    valid[64:128] = False                      # one whole invalid shard
    q = np.stack([emb[5], emb[71], emb[9] * 0.0 + 1.0 / 4.0])
    tm = t_mesh.make_mesh(MeshConfig(data=4), devices=["cpu"] * 4)
    shards = [list(torch.chunk(torch.from_numpy(a), 4)) for a in (emb, valid)]
    for k in (1, 5, 70):
        got = t_search.vault_search_sharded(
            torch.from_numpy(q), shards[0], shards[1], mesh=tm, top_k=k)
        want = t_search.vault_search(torch.from_numpy(q),
                                     torch.from_numpy(emb),
                                     torch.from_numpy(valid), top_k=k)
        assert torch.equal(got.top_idx, want.top_idx), k
        assert torch.equal(got.top_sims, want.top_sims), k
    s, i = t_search.sharded_vault_sims(
        torch.from_numpy(q), shards[0], [0, 64, 128, 192], shards[1], 3)
    assert i[0].tolist() == [5, 130, 250]
