"""The transcriber's isolated host-prep worker held to the JAX package's.

- End to end (tests/test_transcript_e2e.py's
  ``test_transcript_host_isolation_matches_inline``, on the port): the
  tiny Whisper trained in JAX transcribes the WAV to the same text with
  ``MISINFO_TPU_TRANSCRIPT_ISOLATION`` at 0 (inline) and at 1 (the worker
  process, twice: the pool is reused), and the worker's mels equal JAX's
  inline host prep exactly.
- The environment values 0/off/false run inline, auto/1 (and unset) go
  to the pool, in both packages' ``_host_prep``.
- ``warmup()`` starts the worker process (not with isolation off); the
  pool is a spawned process with its niceness raised by 10 by
  ``_isolation_worker_init``, and imports neither JAX, nor the JAX
  package, nor torch.
- A pool that fails gives the inline result, JAX's warning, and is given
  up for the process (``_POOL`` None, ``_POOL_BROKEN`` True), as JAX's.
"""

import concurrent.futures as cf
import logging
import os
import types

import numpy as np
import pytest

from misinfo_tpu.serve import transcript as j_tr

from misinfo_tpu_torch.serve import transcript as t_tr

from test_torch_transcript import TEXT, _make_audio, _write_wav, trained  # noqa: F401

ENV = "MISINFO_TPU_TRANSCRIPT_ISOLATION"


@pytest.fixture(scope="module", autouse=True)
def fresh_pool():
    """Each package's class-level pool starts unmade and is shut down at
    the end of the module."""
    saved = [(c, c._POOL, c._POOL_BROKEN)
             for c in (t_tr.WhisperTranscriber, j_tr.WhisperTranscriber)]
    for c, _, _ in saved:
        c._POOL, c._POOL_BROKEN = None, False
    yield
    for c, pool, broken in saved:
        if c._POOL is not None and c._POOL is not pool:
            c._POOL.shutdown()
        c._POOL, c._POOL_BROKEN = pool, broken


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("isolation") / "speech.wav"
    _write_wav(path, np.tile(_make_audio(), 2))
    return str(path)


def _child(expr: str):
    """Evaluate ``expr`` in the port's worker process."""
    return t_tr.WhisperTranscriber._host_pool().submit(eval, expr).result()


def test_port_transcript_isolation_matches_inline(trained, monkeypatch):  # noqa: F811
    params, cfg, wav, _ = trained
    monkeypatch.setenv(ENV, "0")
    tr = t_tr.WhisperTranscriber(params, config=cfg, device="cpu")
    assert tr.transcribe(wav) == TEXT
    assert t_tr.WhisperTranscriber._POOL is None
    inline = tr._host_prep(wav)

    monkeypatch.setenv(ENV, "1")
    assert tr.transcribe(wav) == TEXT      # worker-process prep
    pool = t_tr.WhisperTranscriber._POOL
    assert pool is not None
    assert tr.transcribe(wav) == TEXT      # pool reuse
    assert t_tr.WhisperTranscriber._POOL is pool
    worker = tr._host_prep(wav)
    np.testing.assert_array_equal(worker, inline)
    # JAX's inline host prep on the same file: the same mels exactly
    monkeypatch.setenv(ENV, "0")
    want = j_tr.WhisperTranscriber._host_prep(
        types.SimpleNamespace(cfg=cfg, decode_cfg=tr.decode_cfg), wav)
    np.testing.assert_array_equal(worker, want)


def test_warmup_starts_the_worker(trained, monkeypatch):  # noqa: F811
    """warmup() starts the worker process ahead of the first request (the
    executor spawns it at its first task); not with isolation off."""
    params, cfg, _, _ = trained
    tr = t_tr.WhisperTranscriber(params, config=cfg, device="cpu")
    cls = t_tr.WhisperTranscriber
    saved = cls._POOL
    try:
        cls._POOL = None
        monkeypatch.setenv(ENV, "off")
        assert tr.warmup((1,)) == [1]
        assert cls._POOL is None
        monkeypatch.setenv(ENV, "auto")
        tr.warmup((1,))
        assert cls._POOL is not None and len(cls._POOL._processes) == 1
    finally:
        if cls._POOL is not None and cls._POOL is not saved:
            cls._POOL.shutdown()
        cls._POOL = saved


def test_worker_is_spawned_niced_and_device_free():
    pid = _child("__import__('os').getpid()")
    assert pid != os.getpid()
    assert _child("__import__('os').nice(0)") == min(os.nice(0) + 10, 19)
    assert _child("__import__('multiprocessing').get_start_method()"
                  ) == "spawn"
    _child("__import__('misinfo_tpu_torch.preprocess.audio').__name__")
    mods = _child("sorted(__import__('sys').modules)")
    assert "misinfo_tpu_torch.preprocess.audio" in mods
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")
                or m == "misinfo_tpu" or m.startswith("misinfo_tpu.")
                or m == "torch" or m.startswith("torch.")]
    assert _child("__import__('os').getpid()") == pid       # one worker


class _Pool:
    """A pool stand-in: runs the function in this process, or raises."""

    def __init__(self, fail=False):
        self.fail, self.calls = fail, 0

    def submit(self, fn, *args):
        self.calls += 1
        if self.fail:
            raise RuntimeError("worker died")
        fut = cf.Future()
        fut.set_result(fn(*args))
        return fut


def _stub(module, pool):
    """A transcriber stand-in with a class of its own, for
    ``WhisperTranscriber._host_prep`` of ``module``."""
    own = {k: v for k, v in vars(module.WhisperTranscriber).items()
           if k in ("_host_prep", "_give_up_pool")}
    cls = type("Stub", (), {
        "_POOL": pool, "_POOL_BROKEN": False,
        "_host_pool": classmethod(lambda c: c._POOL), **own})
    obj = cls()
    obj.cfg = types.SimpleNamespace(max_source_positions=64)
    obj.decode_cfg = types.SimpleNamespace(max_windows=4)
    return obj


@pytest.mark.parametrize("value,isolated", [
    ("0", False), ("off", False), ("false", False), ("auto", True),
    ("1", True), (None, True)])
def test_isolation_values_match_jax(wav, monkeypatch, value, isolated):
    if value is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, value)
    out = []
    for module in (j_tr, t_tr):
        pool = _Pool()
        out.append(_stub(module, pool)._host_prep(wav))
        assert pool.calls == int(isolated), module.__name__
    np.testing.assert_array_equal(out[0], out[1])
    assert out[1].shape == (2, 128, 80)


def test_broken_pool_runs_inline_with_a_warning(wav, monkeypatch, caplog):
    monkeypatch.setenv(ENV, "1")
    out, records = [], []
    for module in (j_tr, t_tr):
        stub = _stub(module, _Pool(fail=True))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            out.append(stub._host_prep(wav))
        records.append([(r.levelno, r.getMessage(), r.exc_info is not None)
                        for r in caplog.records])
        assert type(stub)._POOL is None and type(stub)._POOL_BROKEN
        assert stub._host_pool() is None      # given up: inline from now on
    np.testing.assert_array_equal(out[0], out[1])
    assert records[0] == records[1] == [
        (logging.WARNING, "transcript host worker failed; running inline",
         True)]
