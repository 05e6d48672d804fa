"""Runners: one program of one signature over static input buffers.

The port's counterpart of a jitted executable per signature. A runner
holds the program's input buffers (allocated outside any graph pool, and
shared by an owner's runners where name, shape and dtype agree); a call
copies the request's host inputs into them and runs the program:

* on the card, the program is captured once as a CUDA graph after one
  eager pass on the capture stream (the pass builds the kernels' libraries,
  sizes their per-stream scratch, ``ops/cuda_build.py``, and brings cuBLAS
  and cuDNN to their algorithms), and every later call replays it; the
  output is copied out in the same stream right after the replay, so a
  batch in flight keeps its result when the next replay overwrites the
  graph's output, and graphs may share one memory pool and replay in any
  order;
* on the CPU, and on the card when capture is off, the program runs
  eagerly over the same buffers.

The first call of a runner returns the eager pass's outputs. A capture
that fails raises with the signature; there is no eager retry. The
kernels' launch counters are Python increments in their wrappers, so a
replay counts nothing by itself: each wrapper registers its counters
(``count_launches``), and the registered counters' change during the
capture is recorded, undone, and added at every replay (the capture must
not race another thread's launches, or their counts land in the graph's).
"""

from __future__ import annotations

import contextlib
import gc
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# "module.counter" → (wrapper module, counter) of every hand kernel's
# launch count, registered by each wrapper where it defines its counters
_COUNTERS: Dict[str, Tuple[str, str]] = {}


def count_launches(module: str, *names: str) -> None:
    """Register the module-level launch counters ``names`` of ``module``
    (a kernel wrapper's ``__name__``), so that a replay adds to them."""
    for n in names:
        _COUNTERS[f"{module.rsplit('.', 1)[-1]}.{n}"] = (module, n)


def launch_counts() -> Dict[str, int]:
    """Every registered counter, by "module.counter"."""
    return {k: getattr(sys.modules[m], n) for k, (m, n) in _COUNTERS.items()}


def counts_since(before: Dict[str, int]) -> Dict[str, int]:
    """The counters that changed since ``before`` (``launch_counts()``),
    by how much; a counter registered since then started at 0."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v != before.get(k, 0)}


def add_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` ("module.counter" → n) to the counters."""
    for k, d in delta.items():
        m, n = _COUNTERS[k]
        mod = sys.modules[m]
        setattr(mod, n, getattr(mod, n) + d)


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


def clone(out):
    """A copy of a program's output (a tensor or a tuple of tensors)."""
    if isinstance(out, tuple):
        return tuple(t.clone() for t in out)
    return out.clone()


@contextlib.contextmanager
def on_stream(stream, device):
    """Run the block on ``stream`` (None: the current stream), ordered after
    the current stream's work so far and before its later work. Yields the
    caller's stream (None without ``stream``)."""
    if stream is None:
        yield None
        return
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield cur
    cur.wait_stream(stream)


def hand_over(out, cur):
    """Outputs made on a runner's stream, to be used on ``cur``."""
    if cur is not None:
        for t in _tensors(out):
            t.record_stream(cur)
    return out


def capture(fn: Callable[[], object], sig, pool=None,
            generators: Sequence[torch.Generator] = ()):
    """Capture ``fn()`` on the current (non-default) stream as one CUDA
    graph in ``pool`` → (graph, its outputs, the launch counters' change
    per replay). The counters are left as they were before the capture.
    A failure raises RuntimeError naming ``sig``."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    # no cyclic garbage collection while capturing: it may free another
    # graph (an engine or runner held in a reference cycle), whose
    # destruction is not permitted during a capture and invalidates it;
    # "thread_local" lets other threads' CUDA work go on meanwhile
    collecting = gc.isenabled()
    gc.disable()
    try:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException as e:
            try:
                graph.capture_end()
            except Exception:
                pass
            raise RuntimeError(f"CUDA-graph capture of {sig} failed: "
                               f"{e}") from e
        finally:
            delta = counts_since(before)
            add_counts({k: -d for k, d in delta.items()})     # undone
        graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    return graph, out, delta


class Runner:
    """``program(static) -> tensor or tuple of tensors`` for one signature
    ``sig``. ``inputs`` (name → tensor) give the buffers' shapes and
    dtypes; ``buffers`` ((name, shape, dtype) → tensor), where given, is
    shared with the owner's other runners, which then share every buffer of
    one name, shape and dtype (safe where, as in ``run``, one lock covers
    every runner's copy-in, run and copy-out on one stream). ``capture``
    turns on the CUDA graph (a CUDA ``device`` only); ``stream`` is the
    stream it is captured and replayed on (the caller's current stream
    waits for it), ``pool`` the graph memory pool."""

    def __init__(self, sig, program: Callable, inputs: Dict[str, torch.Tensor],
                 *, device, capture: bool = False,
                 stream: Optional["torch.cuda.Stream"] = None, pool=None,
                 buffers: Optional[Dict[tuple, torch.Tensor]] = None):
        self.sig = sig
        self.program = program
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self.stream = stream if self.device.type == "cuda" else None
        self.pool = pool
        buffers = {} if buffers is None else buffers
        self.static = {}
        for k, v in inputs.items():
            key = (k, tuple(v.shape), v.dtype)
            if key not in buffers:
                buffers[key] = torch.empty(v.shape, dtype=v.dtype,
                                           device=self.device)
            self.static[k] = buffers[key]
        self.graph = None
        self.out = None
        self.delta: Dict[str, int] = {}

    def copy_in(self, inputs: Dict[str, torch.Tensor]) -> None:
        """Copy each input into its buffer: from pinned host memory without
        a sync on the card. Shapes and dtypes must be the buffers'."""
        if set(inputs) != set(self.static):
            raise ValueError(f"runner {self.sig}: inputs {sorted(inputs)}, "
                             f"buffers {sorted(self.static)}")
        for k, v in inputs.items():
            dst = self.static[k]
            if v.shape != dst.shape or v.dtype != dst.dtype:
                raise ValueError(
                    f"runner {self.sig}: input {k} is {v.dtype} "
                    f"{tuple(v.shape)}, its buffer {dst.dtype} "
                    f"{tuple(dst.shape)}")
            if dst.is_cuda and not v.is_cuda:
                v = v.pin_memory()
            dst.copy_(v, non_blocking=dst.is_cuda)

    def start(self, inputs: Dict[str, torch.Tensor]):
        """The first call: copy in, run eagerly (the warm pass), capture when
        capture is on. Returns the eager pass's outputs."""
        with on_stream(self.stream, self.device) as cur:
            self.copy_in(inputs)
            out = self.program(self.static)
            if self.capture:
                self.graph, self.out, self.delta = capture(
                    lambda: self.program(self.static), self.sig, self.pool)
            return hand_over(out, cur)

    def __call__(self, inputs: Dict[str, torch.Tensor]):
        """Copy in and run: replay the graph and copy its output out, or run
        the program eagerly where there is no graph."""
        with on_stream(self.stream, self.device) as cur:
            self.copy_in(inputs)
            if self.graph is None:
                return hand_over(self.program(self.static), cur)
            self.graph.replay()
            add_counts(self.delta)
            return hand_over(clone(self.out), cur)


def run(runners: Callable[[], Dict], lock, sig,
        inputs: Dict[str, torch.Tensor], make: Callable[[], Runner]):
    """Run the runner of ``sig`` in ``runners()`` on ``inputs``, made with
    ``make()`` (and on the card captured) at first use. The dict is read
    under ``lock``, so that a call that waited on the lock uses the dict
    its owner published meanwhile (``reload_vault``'s)."""
    with lock:
        table = runners()
        runner = table.get(sig)
        if runner is None:
            runner = make()
            out = runner.start(inputs)
            table[sig] = runner
            return out
        return runner(inputs)
