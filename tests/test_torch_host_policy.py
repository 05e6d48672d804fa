"""The port's MISINFO_TPU_HOST_POLICY=auto, link probe, profile/NaN
helpers and timing helpers held to the JAX package's.

* ``auto_policy``'s decisions equal JAX's over a grid of patched probes:
  host-bound or not, the fast decode's gain above or below 1.3×, the link
  probe absent or its delta under or over half the host resize work, each
  ``allow_*`` off, the engine's device an accelerator or not (JAX's device
  check patched to see "tpu", the port's to see "cuda"); the link probe
  runs only on the accelerator.
* ``ForensicsConfig.from_env()`` under ``MISINFO_TPU_HOST_POLICY=auto``
  gives JAX's serving fields, explicit knobs included, and
  ``host_prep_report()`` carries the link once a probe was taken.
* ``probe_link()`` is None without a card.
* ``nan_guard`` raises ``FloatingPointError`` where jitted JAX under
  ``nan_guard`` does, and not outside it or under ``nan_guard(False)``.
* ``profile_trace`` writes a Chrome trace naming ``aten::mm``.
* ``sync_fetch`` / ``time_program`` agree with JAX's on the same trees
  and call counts.
* Importing these modules and preprocess/native_bpe.py loads neither JAX
  nor torch (so nothing is built at import), and chip_smoke.py no JAX.
"""

import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misinfo_tpu.core import config as j_config
from misinfo_tpu.preprocess import hostprobe as j_hp
from misinfo_tpu.utils import timing as j_timing
from misinfo_tpu.utils import tracing as j_tracing
from misinfo_tpu_torch.core import config as t_config
from misinfo_tpu_torch.preprocess import hostprobe as t_hp
from misinfo_tpu_torch.utils import timing as t_timing
from misinfo_tpu_torch.utils import tracing as t_tracing

KNOBS = ("MISINFO_TPU_HOST_POLICY", "MISINFO_TPU_FAST_DECODE",
         "MISINFO_TPU_DEVICE_RESIZE")
RATE = 300.0                    # device images/s both recommends are given
RECOMMEND = {j_hp: j_hp.recommend, t_hp: t_hp.recommend}


def _probe(host_bound: bool, fast_gain: float) -> dict:
    """A probe at 1080p: 20 ms exact (8 ms of it resizes) on 4 cores."""
    exact = 100.0 if host_bound else 1000.0
    return {"cores": 4, "probe_resolution": 1080, "exact_ms_per_image": 20.0,
            "fast_ms_per_image": 20.0 / fast_gain, "decode_ms_per_image": 12.0,
            "exact_ceiling_images_per_s": exact,
            "fast_ceiling_images_per_s": exact * fast_gain}


def _link(delta):
    return None if delta is None else {
        "platform": "x", "staging": 640, "staged_h2d_ms_per_image": delta + 1,
        "crops_h2d_ms_per_image": 1.0, "delta_ms_per_image": delta}


def _patch(monkeypatch, probe, link, accel: bool) -> list:
    """Both packages see ``probe`` and ``link``; JAX's device is a TPU and
    the port's a CUDA card when ``accel``. Returns the link probes' call
    log."""
    calls = []
    for hp in (j_hp, t_hp):
        monkeypatch.setattr(hp, "recommend", functools.partial(
            RECOMMEND[hp], probe, device_images_per_s=RATE))
        monkeypatch.setattr(hp, "probe_link",
                            lambda hp=hp: calls.append(hp) or link)
    monkeypatch.setattr(jax, "devices", lambda *a: [types.SimpleNamespace(
        platform="tpu" if accel else "cpu")])
    monkeypatch.setattr(t_hp, "_device_platform",
                        lambda: "cuda" if accel else "cpu")
    return calls


@pytest.mark.parametrize("accel", [True, False])
@pytest.mark.parametrize("allow_fast,allow_resize",
                         list(itertools.product([True, False], repeat=2)))
def test_auto_policy_decisions_equal_jax(monkeypatch, accel, allow_fast,
                                         allow_resize):
    seen = set()
    for host_bound, gain, delta in itertools.product(
            [True, False], [1.1, 2.5], [None, 1.0, 6.0]):
        calls = _patch(monkeypatch, _probe(host_bound, gain), _link(delta),
                       accel)
        got = t_hp.auto_policy(allow_fast_decode=allow_fast,
                               allow_device_resize=allow_resize)
        want = j_hp.auto_policy(allow_fast_decode=allow_fast,
                                allow_device_resize=allow_resize)
        assert got == want, (host_bound, gain, delta)
        # the link is probed on the accelerator alone, by both alike
        assert calls == ([t_hp, j_hp] if accel and allow_resize
                         else []), (host_bound, gain, delta)
        seen.add(tuple(sorted(got)))
    assert any("fast_decode" in s for s in seen) == allow_fast
    if accel and allow_resize:
        assert any("device_resize" in s for s in seen)
    else:
        assert not any("device_resize" in s for s in seen)


@pytest.mark.parametrize("env", [
    {}, {"MISINFO_TPU_FAST_DECODE": "0"}, {"MISINFO_TPU_DEVICE_RESIZE": "0"},
    {"MISINFO_TPU_DEVICE_RESIZE": "1"},
    {"MISINFO_TPU_FAST_DECODE": "1", "MISINFO_TPU_DEVICE_RESIZE": "0"}])
def test_from_env_auto_fields_equal_jax(monkeypatch, env):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    _patch(monkeypatch, _probe(True, 2.5), _link(1.0), accel=True)
    monkeypatch.setenv("MISINFO_TPU_HOST_POLICY", "auto")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = t_config.ForensicsConfig.from_env().serving
    want = j_config.ForensicsConfig.from_env().serving
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fast_decode == (env.get("MISINFO_TPU_FAST_DECODE", "1")
                               == "1")
    assert got.device_resize == (env.get("MISINFO_TPU_DEVICE_RESIZE", "1")
                                 == "1")


def test_probe_link_is_none_without_a_card(monkeypatch):
    monkeypatch.setattr(t_hp, "_link_cache", None)
    assert not torch.cuda.is_available()
    assert t_hp.probe_link() is None and t_hp._link_cache is None
    assert t_hp._device_platform() == "cpu"


def test_host_prep_report_carries_the_link(monkeypatch, tmp_path):
    from misinfo_tpu_torch.engine.forensics import MisinfoForensics
    from misinfo_tpu_torch.models.detector import DetectorConfig
    from misinfo_tpu_torch.vault.store import TruthVault
    det = DetectorConfig.tiny()
    d = det.clip.projection_dim
    TruthVault(np.ones((2, d), np.float32),
               [{"title": "t", "url": "u", "date": "d"}] * 2,
               np.ones((2, d), np.float32)).save(str(tmp_path / "v.npz"))
    cfg = t_config.ForensicsConfig(
        verbose=False, paths=t_config.ModelPaths(
            vault_path=str(tmp_path / "v.npz")))
    monkeypatch.setattr(t_hp, "recommend", functools.partial(
        RECOMMEND[t_hp], _probe(True, 2.5)))
    eng = MisinfoForensics(cfg, det, device="cpu")
    monkeypatch.setattr(t_hp, "_link_cache", None)
    assert "link" not in eng.host_prep_report()
    link = dict(_link(1.0), platform="cuda")
    monkeypatch.setattr(t_hp, "_link_cache", link)
    rec = eng.host_prep_report()
    assert rec["link"] == link and rec["link"] is not link
    assert rec["active"]["fast_decode"] is False


# ----------------------------------------------------------- nan_guard

CASES = {  # name → (torch op, jnp op, input): the NaN or its absence
    "log": (torch.log, jnp.log, -1.0),
    "log_positive": (torch.log, jnp.log, 2.0),
    "sqrt": (torch.sqrt, jnp.sqrt, -1.0),
    "exp_inf": (torch.exp, jnp.exp, 1000.0),
    "inf_minus_inf": (lambda v: torch.exp(v) - torch.exp(v),
                      lambda v: jnp.exp(v) - jnp.exp(v), 1000.0),
    "zero_by_zero": (lambda v: v / v, lambda v: v / v, 0.0),
}


def _raises(fn) -> bool:
    try:
        fn()
    except FloatingPointError:
        return True
    return False


@pytest.mark.parametrize("case", list(CASES))
def test_nan_guard_raises_where_jax_does(case):
    t_op, j_op, x = CASES[case]
    xt, xj = torch.tensor([x, 1.0]), jnp.asarray([x, 1.0], jnp.float32)

    def guarded(guard, fn, enable=True):
        def run():
            with guard(enable):
                fn()
        return run

    want = _raises(guarded(j_tracing.nan_guard,
                           lambda: jax.jit(j_op)(xj).block_until_ready()))
    got = _raises(guarded(t_tracing.nan_guard, lambda: t_op(xt)))
    assert got == want == (case not in ("log_positive", "exp_inf"))
    assert not _raises(lambda: t_op(xt))                 # outside
    assert not _raises(guarded(t_tracing.nan_guard, lambda: t_op(xt),
                               enable=False))
    assert not torch.is_anomaly_enabled()


def test_nan_guard_nests_and_restores():
    x = torch.tensor([-1.0])
    with t_tracing.nan_guard():
        assert torch.is_anomaly_enabled()
        with t_tracing.nan_guard(False):
            torch.log(x)                                 # off in the block
            assert not torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)                                 # on again
        with t_tracing.nan_guard():
            with pytest.raises(FloatingPointError):
                torch.sqrt(x)
        with pytest.raises(FloatingPointError):
            torch.sqrt(x)
    torch.log(x)
    assert not torch.is_anomaly_enabled()
    w = torch.zeros(2, requires_grad=True)
    with t_tracing.nan_guard(), pytest.raises(FloatingPointError):
        (torch.sqrt(w) * 0).sum().backward()             # 0 · inf


def test_profile_trace_names_aten_mm(tmp_path):
    a, b = torch.randn(16, 8), torch.randn(8, 4)
    for n in range(2):
        with t_tracing.profile_trace(str(tmp_path)):
            (a @ b).sum()
        assert len(os.listdir(tmp_path)) == n + 1        # one file a trace
    for name in os.listdir(tmp_path):
        with open(tmp_path / name) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::mm" for e in events)


# --------------------------------------------------------------- timing

def _trees():
    """(name, JAX tree, the port's tree): array leaves where JAX puts them,
    dict keys out of order, an empty leaf and None before the first."""
    base = {"z": np.array([[3.0, 4.0]], np.float32),
            "a": [None, np.zeros((0,), np.float32), np.array(7.5, np.float32)],
            "m": {"y": np.array([1, 2], np.int32)}}

    def conv(t, f):
        if isinstance(t, dict):
            return {k: conv(v, f) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v, f) for v in t]
        return None if t is None else f(t)
    return [("mixed", conv(base, jnp.asarray), conv(base, torch.from_numpy)),
            ("numpy", base, base),
            ("bools", [np.array([True])], [torch.tensor([True])]),
            ("no_arrays", {"x": 1.5, "y": None}, {"x": 1.5, "y": None}),
            ("empty", [np.zeros((0, 3))], [torch.zeros(0, 3)])]


@pytest.mark.parametrize("name,jtree,ttree", _trees(),
                         ids=[t[0] for t in _trees()])
def test_sync_fetch_equals_jax(name, jtree, ttree):
    assert t_timing.sync_fetch(ttree) == j_timing.sync_fetch(jtree)


def test_time_program_equals_jax_in_calls_and_output():
    counts = {"jax": 0, "torch": 0}

    def make(kind, arr):
        def fn():
            counts[kind] += 1
            return {"out": arr + counts[kind]}
        return fn

    jsec, jout = j_timing.time_program(make("jax", jnp.zeros(3)), 5)
    tsec, tout = t_timing.time_program(make("torch", torch.zeros(3)), 5)
    assert counts == {"jax": 6, "torch": 6}
    assert jsec > 0 and tsec > 0
    np.testing.assert_array_equal(tout["out"].numpy(), np.asarray(jout["out"]))
    assert t_timing.sync_fetch(tout) == j_timing.sync_fetch(jout) == 6.0


# -------------------------------------------------------------- imports

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("modules,absent", [
    ("misinfo_tpu_torch.preprocess.native_bpe, "
     "misinfo_tpu_torch.preprocess.hostprobe, "
     "misinfo_tpu_torch.utils.tracing, misinfo_tpu_torch.utils.timing",
     ("jax", "misinfo_tpu", "torch")),
    ("chip_smoke", ("jax", "misinfo_tpu"))])
def test_imports_load_no_jax(modules, absent):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys, {modules}; print(sorted(m for m "
         f"in sys.modules if m.split('.')[0] in {absent!r}))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
