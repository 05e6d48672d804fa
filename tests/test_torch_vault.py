"""The port's vault search, IVF index and sidecars held to the JAX
package's on the CPU.

``vault_search`` over every row type of ``ServingConfig.vault_dtype``
(float32, bfloat16, int8, int4 with int4 or int8 titles): top-k indices
equal, sims and text similarity within 1e-5 (only the order of f32 sums
differs). ``ivf_topk`` is fed JAX's own index arrays, because the port's
``build_ivf`` sums clusters with ``index_add_`` (no fixed order on a
card); the port's build is held to the properties that
tests/test_vault.py asserts of JAX's. Digests and both sidecars (int4,
IVF) must cross between the packages both ways.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from misinfo_tpu.vault import ivf as j_ivf
from misinfo_tpu.vault import prepack as j_prepack
from misinfo_tpu.vault import search as j_search
from misinfo_tpu.vault.int4 import quantize_rows_int4
from misinfo_tpu.vault.store import TruthVault as JVault

from misinfo_tpu_torch.vault import ivf as t_ivf
from misinfo_tpu_torch.vault import prepack as t_prepack
from misinfo_tpu_torch.vault import search as t_search
from misinfo_tpu_torch.vault.store import TruthVault as TVault

N, D, B, K = 2048, 512, 6, 5


def _rows(n, d=D, seed=0):
    r = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return r / np.linalg.norm(r, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def vault():
    """Rows, titles, validity (tail rows invalid) and queries: half of
    them near-duplicates of known rows, so the reuse gate opens."""
    emb, titles = _rows(N, seed=1), _rows(N, seed=2)
    valid = np.arange(N) < N - 100
    rng = np.random.default_rng(3)
    hits = np.array([5, 700, 1500])
    q = np.concatenate([emb[hits] + 0.01 * rng.standard_normal((3, D)),
                        rng.standard_normal((B - 3, D))]).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cap = _rows(B, seed=4)
    return dict(emb=emb, titles=titles, valid=valid, q=q, cap=cap, hits=hits)


def _planes(v, dtype, title_dtype=None):
    """(vault plane, scale, title plane, title scale) in numpy for a row
    type, as the engines place them."""
    title_dtype = title_dtype or dtype

    def cast(a, dt):
        if dt == "int8":
            return j_search.quantize_rows_int8(a), None
        if dt == "int4":
            q4 = quantize_rows_int4(a)
            return q4.packed, q4.scale
        return a, None
    e, s = cast(v["emb"], dtype)
    t, ts = cast(v["titles"], title_dtype)
    return e, s, t, ts


def _jax_search(v, e, s, t, ts, bf16=False, **kw):
    jt = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    je = jnp.asarray(e, jnp.bfloat16) if bf16 else jnp.asarray(e)
    jtt = jnp.asarray(t, jnp.bfloat16) if bf16 else jnp.asarray(t)
    return j_search.vault_search(
        jnp.asarray(v["q"]), je, jnp.asarray(v["valid"]), top_k=K,
        caption_text_emb=jnp.asarray(v["cap"]), vault_text_emb=jtt,
        has_caption=jnp.ones((B,), bool), vault_scale=jt(s),
        vault_text_scale=jt(ts), **kw)


def _torch_search(v, e, s, t, ts, bf16=False, **kw):
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    te, ttt = torch.from_numpy(e), torch.from_numpy(t)
    if bf16:
        te, ttt = te.to(torch.bfloat16), ttt.to(torch.bfloat16)
    return t_search.vault_search(
        torch.from_numpy(v["q"]), te, torch.from_numpy(v["valid"]), top_k=K,
        caption_text_emb=torch.from_numpy(v["cap"]), vault_text_emb=ttt,
        has_caption=torch.ones(B, dtype=torch.bool), vault_scale=tt(s),
        vault_text_scale=tt(ts), **kw)


def _assert_same(a, b):
    np.testing.assert_array_equal(b.top_idx.numpy(), np.asarray(a.top_idx))
    for f in ("top_sims", "vault_discrepancy", "text_similarity"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("dtype,title", [
    ("float32", None), ("bfloat16", None), ("int8", None), ("int4", None),
    ("int4", "int8")])
def test_vault_search_matches_jax(vault, dtype, title):
    e, s, t, ts = _planes(vault, dtype, title)
    bf16 = dtype == "bfloat16"
    a = _jax_search(vault, e, s, t, ts, bf16=bf16)
    b = _torch_search(vault, e, s, t, ts, bf16=bf16)
    _assert_same(a, b)
    # the planted near-duplicates clear the gate through every row type
    np.testing.assert_array_equal(b.top_idx[:3, 0].numpy(), vault["hits"])
    assert (b.vault_discrepancy[:3] > 0.9).all()
    assert (b.vault_discrepancy[3:] == 0).all()


def test_int4_and_ivf_mutually_exclusive(vault):
    e, s, t, ts = _planes(vault, "int4")
    with pytest.raises(ValueError, match="exclusive"):
        _torch_search(vault, e, s, t, ts, ivf={})


@pytest.fixture(scope="module")
def jax_index(vault):
    return j_ivf.build_ivf(vault["emb"], vault["valid"], n_clusters=16,
                           seed=0, cap_factor=1.0)   # small cap: spill used


@pytest.mark.parametrize("emb16", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("nprobe", [4, 16])
def test_ivf_topk_on_jax_index_matches_jax(vault, jax_index, emb16, dtype,
                                           nprobe):
    idx = jax_index
    assert idx.spill.size > 0
    e = (j_search.quantize_rows_int8(vault["emb"]) if dtype == "int8"
         else vault["emb"])
    e16 = vault["emb"].astype(jnp.bfloat16) if emb16 else None
    want_s, want_i = j_ivf.ivf_topk(
        jnp.asarray(vault["q"]), jnp.asarray(e), jnp.asarray(vault["valid"]),
        jnp.asarray(idx.centroids), jnp.asarray(idx.lists),
        jnp.asarray(idx.spill), top_k=K, nprobe=nprobe,
        emb16=None if e16 is None else jnp.asarray(e16))
    got_s, got_i = t_ivf.ivf_topk(
        torch.from_numpy(vault["q"]), torch.from_numpy(e),
        torch.from_numpy(vault["valid"]), torch.from_numpy(idx.centroids),
        torch.from_numpy(idx.lists), torch.from_numpy(idx.spill), top_k=K,
        nprobe=nprobe,
        emb16=None if e16 is None else torch.from_numpy(
            vault["emb"]).to(torch.bfloat16))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)


def test_vault_search_ivf_matches_jax(vault, jax_index):
    dev_j = {f"ivf_{k}": jnp.asarray(getattr(jax_index, k))
             for k in ("centroids", "lists", "spill")}
    dev_t = t_ivf.IVFIndex(*jax_index).device_arrays(device="cpu")
    e, s, t, ts = _planes(vault, "float32")
    a = _jax_search(vault, e, s, t, ts, ivf=dev_j, nprobe=4)
    b = _torch_search(vault, e, s, t, ts, ivf=dev_t, nprobe=4)
    _assert_same(a, b)


@pytest.fixture(scope="module")
def torch_index(vault):
    return t_ivf.build_ivf(vault["emb"], vault["valid"], n_clusters=16,
                           seed=0, cap_factor=1.0, device="cpu")


def test_build_ivf_every_row_exactly_once(vault, torch_index):
    idx = torch_index
    members = (idx.lists[idx.lists >= 0].tolist()
               + idx.spill[idx.spill >= 0].tolist())
    assert sorted(members) == np.flatnonzero(vault["valid"]).tolist()
    assert idx.spill.size % 8 == 0 and idx.lists.shape[1] % 8 == 0
    np.testing.assert_allclose(np.linalg.norm(idx.centroids, axis=1), 1.0,
                               atol=1e-5)


def test_build_ivf_full_probe_equals_brute_force(vault, torch_index):
    idx = torch_index
    args = [torch.from_numpy(a) for a in (
        vault["q"], vault["emb"], vault["valid"], idx.centroids, idx.lists,
        idx.spill)]
    s, i = t_ivf.ivf_topk(*args, top_k=K, nprobe=idx.n_clusters)
    exact = t_search.vault_search(args[0], args[1], args[2], top_k=K)
    np.testing.assert_array_equal(i.numpy(), exact.top_idx.numpy())
    np.testing.assert_allclose(s.numpy(), exact.top_sims.numpy(), atol=1e-5)


def test_build_ivf_near_duplicate_recall(vault):
    idx = t_ivf.build_ivf(vault["emb"], vault["valid"], n_clusters=16,
                          seed=0, device="cpu")
    rng = np.random.default_rng(11)
    rows = rng.choice(np.flatnonzero(vault["valid"]), size=16, replace=False)
    q = vault["emb"][rows] + 0.02 * rng.standard_normal((16, D))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    _, i = t_ivf.ivf_topk(
        *[torch.from_numpy(a) for a in (q, vault["emb"], vault["valid"],
                                        idx.centroids, idx.lists, idx.spill)],
        top_k=K, nprobe=idx.nprobe)
    assert (i[:, 0].numpy() == rows).mean() >= 0.95


def test_build_ivf_empty_vault_raises():
    with pytest.raises(ValueError, match="empty"):
        t_ivf.build_ivf(np.zeros((128, 32), np.float32),
                        np.zeros((128,), bool), device="cpu")


@pytest.mark.parametrize("fn", [t_ivf.build_ivf,
                                t_ivf.IVFIndex.device_arrays])
def test_ivf_entry_points_default_to_the_card(fn):
    # F10: JAX's build_ivf and device_arrays use the default device; the
    # port's entry points run on the card unless the caller asks otherwise
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("n_valid", [2048, 2000, 0])
def test_vault_digest_equals_jax(vault, n_valid):
    valid = np.arange(N) < n_valid
    assert (t_ivf.vault_digest(vault["emb"], valid)
            == j_ivf.vault_digest(vault["emb"], valid))


def _saved_vault(tmp_path, name, seed, text=True):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(300, 64)).astype(np.float32)
    meta = [{"title": f"t{i}", "url": "u", "date": "d"} for i in range(300)]
    te = rng.normal(size=(300, 64)).astype(np.float32) if text else None
    p = str(tmp_path / name)
    JVault(emb, meta, te).save(p)
    return p, JVault.load(p), TVault.load(p)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("text", [True, False])
def test_int4_sidecar_crosses_packages(tmp_path, writer, text):
    p, jv, tv = _saved_vault(tmp_path, "v.npz", 5, text)
    src, dst, src_v, dst_v = ((j_prepack, t_prepack, jv, tv)
                              if writer == "jax" else
                              (t_prepack, j_prepack, tv, jv))
    pre = src.build_prepacked(src_v)
    src.save_prepacked(p, pre)
    got = dst.load_prepacked(p, dst_v)
    assert got is not None
    np.testing.assert_array_equal(got.image.packed, pre.image.packed)
    np.testing.assert_array_equal(got.image.scale, pre.image.scale)
    assert (got.text is None) == (not text)
    if text:
        np.testing.assert_array_equal(got.text.packed, pre.text.packed)
    assert (got.digest, got.text_digest) == (pre.digest, pre.text_digest)
    # a vault with other content (same shape) makes the sidecar stale
    _, jv2, tv2 = _saved_vault(tmp_path, "other.npz", 6, text)
    assert dst.load_prepacked(p, tv2 if dst is t_prepack else jv2) is None
    with open(dst.sidecar_path(p), "wb") as f:
        f.write(b"not an npz")
    assert dst.load_prepacked(p, dst_v) is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ivf_sidecar_crosses_packages(tmp_path, writer):
    p, jv, _ = _saved_vault(tmp_path, "v.npz", 7)
    side = p + ".ivf.npz"
    if writer == "jax":
        idx = j_ivf.build_ivf(jv.embeddings, jv.row_valid, n_clusters=8)
    else:
        idx = t_ivf.build_ivf(jv.embeddings, jv.row_valid, n_clusters=8,
                              device="cpu")
    idx.save(side)
    back = (t_ivf.IVFIndex if writer == "jax" else j_ivf.IVFIndex).load(side)
    assert back is not None
    assert (back.nprobe, back.n_rows, back.digest) == (
        idx.nprobe, idx.n_rows, idx.digest)
    np.testing.assert_array_equal(back.lists, idx.lists)
    np.testing.assert_array_equal(back.spill, idx.spill)
    np.testing.assert_array_equal(back.centroids, idx.centroids)
    assert back.digest == t_ivf.vault_digest(jv.embeddings, jv.row_valid)
    with open(side, "wb") as f:
        f.write(b"not an npz")
    assert t_ivf.IVFIndex.load(side) is None


def test_prepack_cli(tmp_path, capsys):
    p, _, _ = _saved_vault(tmp_path, "v.npz", 8)
    t_prepack.main([p])
    assert "packed 300 articles" in capsys.readouterr().out
    t_prepack.main([p])
    assert "fresh" in capsys.readouterr().out
    t_prepack.main([p, "--force"])
    assert "packed 300 articles" in capsys.readouterr().out
    assert j_prepack.load_prepacked(p, JVault.load(p)) is not None
