"""The port's int4 vault (misinfo_tpu_torch/vault/int4.py) held to the JAX
package's on the CPU.

The host half must be bitwise equal, because sidecars are shared between
the packages. The plain versions of the two kernels stand in for them on
the CPU: plain K10a within 1e-5 of JAX's TPU kernel in interpret mode and
of its XLA reference (the products are exact, only the sum order
differs), plain K10b, the int8 query included, bit for bit. The band that
holds K10a to its plain version on the card (vault/int4_checks.py) must
contain JAX's result and reject every planted fault.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from misinfo_tpu.vault import int4 as J

from misinfo_tpu_torch.vault import int4 as T
from misinfo_tpu_torch.vault import int4_checks as C

N = 2 * J.INT4_TILE_ROWS


def _rows(n, d=512, seed=0):
    r = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return r / np.linalg.norm(r, axis=1, keepdims=True)


def _both(q, v4):
    """(JAX arrays, torch tensors) of one query and packed vault."""
    j = (jnp.asarray(q), jnp.asarray(v4.packed), jnp.asarray(v4.scale))
    t = (torch.from_numpy(q), torch.from_numpy(v4.packed),
         torch.from_numpy(v4.scale))
    return j, t


@pytest.mark.parametrize("n,d", [(N, 512), (100, 64), (3, 32)])
def test_host_half_bitwise_equal(n, d):
    rows = _rows(n, d, seed=n)
    rows[0] = 0.0                                    # a zero row: scale 0
    a, b = J.quantize_rows_int4(rows), T.quantize_rows_int4(rows)
    np.testing.assert_array_equal(a.packed, b.packed)
    np.testing.assert_array_equal(a.scale, b.scale)
    assert a.packed.dtype == b.packed.dtype and a.scale.dtype == b.scale.dtype
    pa, pb = J.pad_int4_vault(a), T.pad_int4_vault(b)
    np.testing.assert_array_equal(pa.packed, pb.packed)
    np.testing.assert_array_equal(pa.scale, pb.scale)
    assert pb.packed.shape[0] % T.INT4_TILE_ROWS == 0


def test_unpack_every_byte_bitwise_equal():
    """All 256 byte values: low nibble → dim j, high → dim j + D/2, each
    sign-extended (not interleaved, and widened before the subtraction)."""
    packed = np.arange(256, dtype=np.uint8).reshape(2, 128)
    want = np.asarray(J.unpack_int4(jnp.asarray(packed)))
    got = T.unpack_int4(torch.from_numpy(packed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == -8 and got.max() == 7


def test_plain_k10a_matches_jax_kernel_interpret():
    v4 = T.quantize_rows_int4(_rows(N, seed=4))
    j, t = _both(_rows(8, seed=5), v4)
    got = T.int4_sims_plain(*t).numpy()
    np.testing.assert_allclose(
        got, np.asarray(J.int4_sims_pallas(*j, interpret=True)), atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(J.int4_sims_reference(*j)), atol=1e-5)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_plain_k10b_bitwise_equal_jax_kernel_interpret(b):
    """The int8 query (qi8 and its scale) and the sims, bit for bit. This
    is the test that catches ``127.0 / t`` (a reciprocal times 127, one
    ulp off an IEEE division for a quarter of f32 inputs) and a true
    division for the scale (XLA folds ``qmax / 127.0`` into a multiply by
    f32(1/127) inside the jitted function)."""
    v4 = T.quantize_rows_int4(_rows(J.INT4_TILE_ROWS, seed=6))
    q = _rows(b, seed=8 + b) * np.float32(0.3)     # not unit: odd abs-maxes
    j, t = _both(q, v4)

    @jax.jit
    def jax_query(q):            # int4_sims_pallas_i8's own lines
        qmax = jnp.maximum(jnp.abs(q).max(axis=1, keepdims=True), 1e-12)
        qi8 = jnp.clip(jnp.round(q * (127.0 / qmax)), -127, 127)
        return qi8.astype(jnp.int8), qmax / 127.0
    want_qi8, want_qs = jax_query(j[0])
    qi8, qs = T.quantize_query_i8(t[0])
    np.testing.assert_array_equal(qi8.numpy(), np.asarray(want_qi8))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(want_qs))
    got = T.int4_sims_i8_plain(*t).numpy()
    want = np.asarray(J.int4_sims_pallas_i8(*j, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_reciprocal_trap_is_real():
    """Why quantize_query_i8 divides 0-d tensors: ``127.0 / t`` differs
    from the IEEE quotient on a good share of inputs."""
    t = torch.from_numpy(np.random.default_rng(0).uniform(
        1e-3, 0.3, 4096).astype(np.float32))
    ieee = torch.div(t.new_full((), 127.0), t)
    assert (127.0 / t != ieee).any()
    np.testing.assert_array_equal(
        ieee.numpy(), np.float32(127.0) / t.numpy())


@pytest.mark.parametrize("kind", ["plain", "i8"])
def test_documented_band_against_exact_f32(kind):
    """Cosine sims of the int4 rows vs exact f32: RMS < 0.02, max < 0.05
    (tests/test_vault_int4.py's band)."""
    v, q = _rows(4096, seed=2), _rows(16, seed=3)
    v4 = T.quantize_rows_int4(v)
    fn = T.int4_sims_plain if kind == "plain" else T.int4_sims_i8_plain
    err = fn(*_both(q, v4)[1]).numpy() - q @ v.T
    assert np.sqrt((err ** 2).mean()) < 0.02
    assert np.abs(err).max() < 0.05


@pytest.mark.parametrize("n,d", [(4096, 512), (4096 + 77, 512),
                                 (2048 + 1, 512), (4096 + 100, 768)],
                         ids=["4096", "4173", "2049", "4196-768"])
def test_card_band_holds_jax_and_rejects_faults(n, d):
    """The K10a band of the card checks (vault/int4_checks.py) contains
    JAX's reference result around the plain version, and every planted
    fault (a tile, a consumer warp's rows, the last slice's high nibbles
    or the ragged edge left out, nibbles swapped or read unsigned, the
    scale dropped) falls outside it; at 768 dims the kernel's tiles are
    of 64 rows and its warps of 16, and the faults follow them."""
    packed, scale = C.vault_case(n, d=d, seed=n)
    q = C.query_case(3, d=d)
    want = T.int4_sims_plain(q, packed, scale)
    jax_got = np.array(J.int4_sims_reference(
        jnp.asarray(q.numpy()), jnp.asarray(packed.numpy()),
        jnp.asarray(scale.numpy())))
    res = C.hold(torch.from_numpy(jax_got), want, C.band(q, packed, scale),
                 C.faults(q, packed, scale, want), "JAX reference")
    assert res["faults"] == (7 if n % C.tiles(3, d)[0] else 6)
    assert res["nearest_fault"] > 100
    # on the CPU the wrappers run the plain versions
    assert C.check_k10a(q, packed, scale)["err"] == 0.0
    assert C.check_k10b(q, packed, scale)["err"] == 0.0


@pytest.mark.parametrize("env,n,want", [
    ("auto", 4096, "plain"), ("auto", T.KERNEL_MIN_ROWS, "i8"),
    ("auto", T.KERNEL_MIN_ROWS + 128, "plain"), ("i8", 4096, "i8"),
    ("1", 4096, "i8"), ("on", 4096, "i8"), ("true", 4096, "i8"),
    ("bf16", T.KERNEL_MIN_ROWS, "plain"), ("0", T.KERNEL_MIN_ROWS, "plain")])
def test_dispatch_choices(monkeypatch, env, n, want):
    """MISINFO_TPU_INT4_PALLAS and the row count pick K10b or K10a (on the
    CPU, their plain versions), as the JAX dispatcher does on a TPU."""
    calls = []
    monkeypatch.setattr(T, "int4_sims", lambda *a: calls.append("plain"))
    monkeypatch.setattr(T, "int4_sims_i8", lambda *a: calls.append("i8"))
    monkeypatch.setenv("MISINFO_TPU_INT4_PALLAS", env)
    T.int4_vault_sims(torch.zeros(1, 512), torch.zeros(n, 256,
                                                       dtype=torch.uint8),
                      torch.zeros(n))
    assert calls == [want]


@pytest.mark.parametrize("env", ["i8", "bf16"])
def test_query_batches_past_max_batch_go_in_slices(monkeypatch, env):
    """130 query rows (past the kernels' MAX_BATCH of 64): three calls of
    64, 64 and 2 rows, whose results are concatenated; for K10b that is
    the one-call plain result bit for bit (rows are independent, the query
    quantized per row)."""
    packed, scale = C.vault_case(4096)
    q = C.query_case(130, seed=4)
    name = "int4_sims_i8" if env == "i8" else "int4_sims"
    real = getattr(T, name)
    rows = []
    monkeypatch.setattr(T, name, lambda a, p, s: rows.append(a.shape[0])
                        or real(a, p, s))
    monkeypatch.setenv("MISINFO_TPU_INT4_PALLAS", env)
    got = T.int4_vault_sims(q, packed, scale)
    assert rows == [64, 64, 2]
    want = torch.cat([real(q[lo:lo + T.MAX_BATCH], packed, scale)
                      for lo in range(0, 130, T.MAX_BATCH)])
    assert torch.equal(got, want)
    if env == "i8":
        assert torch.equal(got, T.int4_sims_i8_plain(q, packed, scale))


def test_cpu_wrappers_run_plain_and_count_nothing():
    packed, scale = C.vault_case(256)
    q = C.query_case(2)
    before = (T.launches, T.launches_i8)
    assert torch.equal(T.int4_sims(q, packed, scale),
                       T.int4_sims_plain(q, packed, scale))
    assert torch.equal(T.int4_sims_i8(q, packed, scale),
                       T.int4_sims_i8_plain(q, packed, scale))
    assert (T.launches, T.launches_i8) == before


@pytest.mark.parametrize("d", [512, 96, 160])
@pytest.mark.parametrize("i8", [True, False])
def test_kernel_walk_holds_the_plain_versions(i8, d):
    """The kernels' k-walk (vault/int4_checks.py::kernel_walk: 64-byte
    slices, low then high nibbles, the mma steps' dims; 96 and 160 dims
    leave a slice partly past D/2) covers every dim once: K10b's walk
    (16·v in s8 lanes, shifted back) equals its plain version bit for bit,
    K10a's (each step's 16 products rounded once, IEEE adds) stays in the
    band."""
    packed, scale = C.vault_case(300, d=d, seed=d)
    q = C.query_case(5, d=d)
    steps = C.walk_steps(d, i8)
    assert sorted(x for s in steps for x in s) == list(range(d))
    got = C.kernel_walk(q, packed, scale, i8)
    if i8:
        assert torch.equal(got, T.int4_sims_i8_plain(q, packed, scale))
    else:
        want = T.int4_sims_plain(q, packed, scale)
        C.hold(got, want, C.band(q, packed, scale), [], "k-walk")
