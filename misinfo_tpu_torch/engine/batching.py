"""Request-queue micro-batching server (SURVEY.md §7 design move 2).

Copy of ``misinfo_tpu/engine/batching.py`` (it imports no JAX) over the
port's engine: ``analyze_batch_async`` enqueues the programs on the card
and its ``finalize()`` makes the one copy back.

The reference dashboard handles requests strictly serially through one
global engine (reference forensics_dashboard.py:91-94). Here concurrent
callers enqueue requests; a collector thread drains the queue every
`max_wait_ms`, groups by modality variant, pads to the nearest batch
bucket and executes ONE fused program per group — so N concurrent
dashboard/API calls cost ~1 program launch instead of N. A second
(finalizer) thread owns the device wait + result fetch + report
formatting, so batch N+1's host prep overlaps batch N's finalization
and the steady-state cycle costs max(dispatch, finalize), not the sum;
a bounded hand-off queue (depth 2) backpressures the collector when
the finalizer falls behind.

Usage:
    server = BatchingEngine(engine)
    future = server.submit({"text": ..., "image": ...})
    report = future.result()
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional


class BatchingEngine:
    def __init__(self, engine, max_wait_ms: Optional[float] = None,
                 max_batch: Optional[int] = None):
        self.engine = engine
        self.max_wait = (max_wait_ms if max_wait_ms is not None
                         else engine.cfg.serving.max_wait_ms) / 1000.0
        self.max_batch = max_batch or max(engine.cfg.serving.batch_buckets)
        self._q: "queue.Queue" = queue.Queue()
        # dispatched-but-unfinalized batches; maxsize bounds the device
        # queue depth (collector blocks on put when the finalizer falls
        # behind — backpressure instead of unbounded in-flight work)
        self._fin_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="misinfo-batcher")
        self._finalizer = threading.Thread(target=self._fin_loop, daemon=True,
                                           name="misinfo-finalizer")
        self._thread.start()
        self._finalizer.start()

    def submit(self, request: Dict) -> Future:
        if self._closed:
            raise RuntimeError("BatchingEngine is closed")
        fut: Future = Future()
        self._q.put((request, fut))
        return fut

    def analyze(self, **request) -> Dict:
        """Synchronous convenience mirroring engine.analyze kwargs."""
        req = {k: v for k, v in {
            "text": request.get("text"),
            "image": request.get("image_path"),
            "video": request.get("video_path"),
        }.items() if v}
        return self.submit(req).result()

    def close(self, timeout: float = 60.0) -> None:
        """Drain-and-stop shutdown contract (VERDICT r4 #7): stop
        accepting new work, process every already-submitted request,
        finalize all in-flight batches — each finalize ends in a device
        result fetch, so returning implies the device queue this engine
        filled is fully executed — and join both threads. No thread is
        ever abandoned inside a device call (a crash at interpreter
        teardown); a hang past `timeout` raises
        instead of silently leaking the thread. Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._finalizer.join(timeout=timeout)
        if self._thread.is_alive() or self._finalizer.is_alive():
            raise RuntimeError(
                "BatchingEngine.close: worker threads did not drain within "
                f"{timeout}s — a device call or finalize is stuck")
        # fail any submit() that raced the close flag
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("BatchingEngine closed"))

    # ------------------------------------------------------------ internals

    def _drain(self) -> List:
        items = []
        try:
            items.append(self._q.get(timeout=self.max_wait))
        except queue.Empty:
            return items
        deadline = threading.Event()
        # gather whatever arrived within the micro-batching window
        while len(items) < self.max_batch:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                if deadline.wait(self.max_wait):
                    break
                try:
                    items.append(self._q.get_nowait())
                except queue.Empty:
                    break
        return items

    @staticmethod
    def _finish(p) -> None:
        futures, finalize = p
        try:
            for fut, res in zip(futures, finalize()):
                fut.set_result(res)
        except Exception as e:
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)

    def _put_fin(self, p) -> None:
        """Hand a dispatched batch to the finalizer; the bounded queue
        blocks (backpressure) when it falls behind. A plain blocking put
        cannot deadlock — `_fin_loop` keeps draining for as long as this
        (collector) thread is alive — and keeps engine-side finalization
        single-threaded (an inline-at-shutdown fallback would run
        finalize from two threads at once)."""
        self._fin_q.put(p)

    def _loop(self) -> None:
        # Dispatch half of the two-thread pipeline: drain + host prep +
        # device enqueue (engine.analyze_batch_async returns without a
        # device sync). Finalization — device wait, the result's copy
        # back, report formatting, explanations — runs on the finalizer
        # thread, so the steady-state cycle costs max(dispatch, finalize)
        # instead of their sum (a single thread serializes the two).
        while True:
            items = self._drain()
            if not items:
                # drain-and-stop: exit only once stopped AND the request
                # queue is empty, so close() completes all submitted work
                if self._stop.is_set() and self._q.empty():
                    break
                continue
            requests = [r for r, _ in items]
            futures = [f for _, f in items]
            try:
                finalize = self.engine.analyze_batch_async(
                    requests, explanations=True)
            except Exception as e:
                for fut in futures:
                    fut.set_exception(e)
                continue
            self._put_fin((futures, finalize))

    def _fin_loop(self) -> None:
        # exit only once the collector can no longer put (stopped AND
        # dead) and everything pending is finalized
        while not (self._stop.is_set() and not self._thread.is_alive()
                   and self._fin_q.empty()):
            try:
                p = self._fin_q.get(timeout=0.05)
            except queue.Empty:
                continue
            self._finish(p)
