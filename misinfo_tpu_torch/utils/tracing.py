"""Tracing and structured observability.

Host copy of ``misinfo_tpu/utils/tracing.py``, importable without JAX;
held to the original by tests/test_torch_host.py:

  * `Tracer` — structured per-stage event log (one event per analyze stage)
    with counters: verdicts/sec, per-signal latency, and rolling-window
    p50/p95/p99 stage latency
  * `stage_timer` — context manager feeding the tracer
  * `profile_trace` — torch.profiler around a block (the card's kernels
    too, where there is one), written as a Chrome/Perfetto trace
  * `nan_guard` — torch's ``jax_debug_nans``: inside it an op whose
    floating output holds a NaN raises ``FloatingPointError``
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

# Bounds for a long-running server: the event log and the per-stage latency
# reservoirs are rolling windows, so tracer memory is O(1) in uptime (the
# cumulative counters remain exact since process start).
MAX_EVENTS = 4096
RESERVOIR = 512


class Tracer:
    def __init__(self, sink=None):
        self.events = deque(maxlen=MAX_EVENTS)
        self.counters: Dict[str, float] = defaultdict(float)
        # recent per-stage durations backing the latency percentiles
        self._durations: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=RESERVOIR))
        self.sink = sink
        # event() runs on request threads while /metrics scrapes call
        # summary() from the ThreadingHTTPServer — snapshot under a lock so
        # a scrape never observes a deque/dict mid-mutation.
        self._lock = threading.Lock()

    def event(self, stage: str, seconds: float, **fields) -> None:
        ev = {"stage": stage, "seconds": seconds, "ts": time.time(), **fields}
        with self._lock:
            self.events.append(ev)
            self.counters[f"{stage}_seconds"] += seconds
            self.counters[f"{stage}_count"] += 1
            self._durations[stage].append(seconds)
            for k, v in fields.items():
                if isinstance(v, (int, float)):
                    self.counters[f"{stage}_{k}"] += v
        if self.sink:
            self.sink(json.dumps(ev))

    def incr(self, counter: str, n: float = 1) -> None:
        """Count-only bump (no duration): outcome counters like the
        gemini error classes must not seed the latency reservoirs, or
        /metrics would show fake 0-ms percentiles next to real ones."""
        with self._lock:
            self.counters[counter] += n

    def rate(self, stage: str) -> float:
        with self._lock:
            secs = self.counters.get(f"{stage}_seconds", 0.0)
            n = self.counters.get(f"{stage}_count", 0.0)
        return n / secs if secs > 0 else 0.0

    @staticmethod
    def _quantiles_of(stage: str, xs) -> Dict[str, float]:
        if not xs:
            return {}
        xs = sorted(xs)
        n = len(xs)
        # nearest-rank: rank = ceil(q*n), 1-indexed
        pick = lambda q: xs[min(n - 1, max(0, math.ceil(q * n) - 1))]  # noqa: E731
        return {f"{stage}_p50_ms": pick(0.50) * 1e3,
                f"{stage}_p95_ms": pick(0.95) * 1e3,
                f"{stage}_p99_ms": pick(0.99) * 1e3}

    def quantiles(self, stage: str) -> Dict[str, float]:
        """p50/p95/p99 latency (ms) over the last ≤RESERVOIR events of
        ``stage`` (nearest-rank on the rolling window — the live-dashboard
        companion to the exact cumulative mean in the counters)."""
        with self._lock:
            window = self._durations.get(stage)
            xs = list(window) if window else []
        return self._quantiles_of(stage, xs)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            windows = {s: list(w) for s, w in self._durations.items()}
        for stage, xs in windows.items():
            out.update(self._quantiles_of(stage, xs))
        secs = out.get("analyze_seconds", 0.0)
        reqs = out.get("analyze_n_requests", out.get("analyze_count", 0.0))
        out["verdicts_per_sec"] = reqs / secs if secs > 0 else 0.0
        return out


GLOBAL_TRACER = Tracer()


@contextlib.contextmanager
def stage_timer(stage: str, tracer: Optional[Tracer] = None, **fields
                ) -> Iterator[None]:
    tracer = tracer or GLOBAL_TRACER
    t0 = time.perf_counter()
    try:
        yield
    finally:
        tracer.event(stage, time.perf_counter() - t0, **fields)


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/misinfo_tpu_trace") -> Iterator[None]:
    """torch.profiler over the block, with the CUDA activity where a card
    is present; on exit, as the block ends or raises, writes a
    Chrome/Perfetto trace (view it in Perfetto or chrome://tracing) into
    ``log_dir`` as ``trace_<pid>_<n>.json``, a new ``n`` per trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        n = 0
        while os.path.exists(path := os.path.join(
                log_dir, f"trace_{os.getpid()}_{n}.json")):
            n += 1
        prof.export_chrome_trace(path)


@functools.lru_cache(maxsize=None)
def _nan_check():
    """The TorchDispatchMode class that checks every op's floating outputs
    for NaN while its ``on`` is set (made at first use, so that importing
    this module does not import torch)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class NanCheck(TorchDispatchMode):
        on = True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.on:
                for t in tree_leaves(out):
                    if (isinstance(t, torch.Tensor)
                            and (t.is_floating_point() or t.is_complex())
                            and t.device.type != "meta"
                            and bool(torch.isnan(t).any())):
                        raise FloatingPointError(
                            f"invalid value (nan) encountered in {func}")
            return out

    return NanCheck


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """JAX's ``jax_debug_nans`` for torch: inside the block (with
    ``enable``), an op that leaves a NaN in a floating output raises
    ``FloatingPointError`` naming the op, forward and backward alike, and
    autograd's anomaly mode is on for the backward's traceback. Each op
    then waits for its result to check it, so this is a debugging tool.
    On exit the previous state returns; a nested ``nan_guard(False)``
    turns the check off for its block."""
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    outer = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, _nan_check())]
    with torch.autograd.set_detect_anomaly(enable):
        if outer:
            prev, outer[-1].on = outer[-1].on, enable
            try:
                yield
            finally:
                outer[-1].on = prev
        elif enable:
            with _nan_check()():
                yield
        else:
            yield
