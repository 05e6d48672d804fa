"""True-completion device timing helpers: the port of
``misinfo_tpu/utils/timing.py``.

A PyTorch call on a CUDA tensor returns once its kernels are enqueued on
the stream, not when they have run, so a host clock read after a loop of
calls measures the enqueue. Timing must close on DATA:

  * copying an output element to the host cannot finish before the
    kernel that wrote it, and
  * a CUDA stream runs its work in order, so reading from the LAST
    enqueued call's output implies every earlier call on that stream has
    finished too.

`sync_fetch` performs that one-element read (slicing to a single element
on the device first). `time_program` wraps the enqueue-N-calls-then-read-
once loop: the one read's round trip amortizes across the calls, so use
enough of them that it is noise. A program that spans streams or devices
must join them onto the stream of its last output (the engine's do).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator, Tuple


def _leaves(tree: Any) -> Iterator[Any]:
    """The leaves of ``tree`` in JAX's order: dicts by sorted key, lists
    and tuples in order, None an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def sync_fetch(tree: Any) -> float:
    """Force true completion of all device work enqueued so far.

    Reads one element of the first non-empty tensor (or array) leaf of
    ``tree`` to the host, which cannot return before the call that wrote
    it, and everything enqueued on its stream before that call, has run.
    Returns the element as a float so callers can also use it as a cheap
    sanity probe. Falls back to ``torch.cuda.synchronize()`` for a tree
    without one.
    """
    import numpy as np
    import torch

    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.numel():
                return float(leaf.reshape(-1)[0].item())
        elif hasattr(leaf, "dtype") and getattr(leaf, "size", 0):
            elem = leaf.reshape(-1)[0] if getattr(leaf, "ndim", 0) else leaf
            return float(np.asarray(elem).reshape(()).astype(np.float64))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return 0.0


def time_program(fn: Callable[[], Any], iters: int) -> Tuple[float, Any]:
    """Time ``iters`` enqueues of ``fn`` with one trailing data sync.

    ``fn`` is called once for warmup (kernel builds, allocator growth;
    synced), then ``iters`` times without per-iteration sync; a single
    ``sync_fetch`` on the last output closes the measurement. Returns
    ``(seconds_total, last_out)``.
    """
    out = fn()
    sync_fetch(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync_fetch(out)
    return time.perf_counter() - t0, out
