"""Request micro-batching for inference serving (the PyTorch port's own
copy of ``avion_tpu.serve.batcher``; the port imports nothing of the JAX
package).  ``fn`` runs on the worker thread, so thread-local torch state
(``torch.inference_mode``, the current CUDA device) must be entered
inside ``fn``, not by the caller.

A single worker thread owns the device and feeds it batches, while an
HTTP front end with many request threads submits items and blocks on
futures.  Coalescing many concurrent 1-item requests into one device
batch is what keeps the tensor cores busy at serving time.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Sequence


class MicroBatcher:
    """Coalesce concurrent requests into device batches.

    ``fn([items]) -> [results]`` runs on the single worker thread (the
    only thread that touches the device).  ``submit`` returns a
    ``Future``; ``__call__`` blocks for the result.

    Batching policy: the worker blocks for the first item, then keeps
    collecting until ``max_batch`` items are queued or ``max_wait_ms``
    has elapsed since the first item — the standard
    latency/throughput knob (0 = no added latency, batches form only
    from genuinely concurrent arrivals).
    """

    def __init__(self, fn: Callable[[List[Any]], Sequence[Any]], *,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 name: str = "batcher"):
        self.fn = fn
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._closed = False
        # observability: batch-size histogram + latency samples
        self.n_requests = 0
        self.n_batches = 0
        self.batch_hist: collections.Counter = collections.Counter()
        self.latency_s: collections.deque = collections.deque(maxlen=1024)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"{name}-worker")
        self._worker.start()

    # -- client side ----------------------------------------------------

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError(f"{self.name} is closed")
            self._queue.append((item, fut, time.perf_counter()))
            self.n_requests += 1
            self._cv.notify()
        return fut

    def __call__(self, item: Any, timeout: float = 60.0) -> Any:
        return self.submit(item).result(timeout=timeout)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)

    # -- worker side ----------------------------------------------------

    def _take_batch(self):
        """Block for the first item, then fill until max_batch or the
        wait budget expires."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(timeout=0.1)
            if not self._queue:
                return None  # closed and drained
            deadline = time.perf_counter() + self.max_wait
            while (len(self._queue) < self.max_batch and not self._closed):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch = [self._queue.popleft()
                     for _ in range(min(len(self._queue), self.max_batch))]
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            t_in = [b[2] for b in batch]
            try:
                results = self.fn(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"{self.name}: fn returned {len(results)} results "
                        f"for {len(items)} items")
            except Exception as e:  # noqa: BLE001 — propagate per-request
                for f in futs:
                    if not f.set_running_or_notify_cancel():
                        continue
                    f.set_exception(e)
                continue
            now = time.perf_counter()
            with self._lock:
                self.n_batches += 1
                self.batch_hist[len(items)] += 1
                for t in t_in:
                    self.latency_s.append(now - t)
            for f, r in zip(futs, results):
                if f.set_running_or_notify_cancel():
                    f.set_result(r)

    # -- metrics --------------------------------------------------------

    def metrics(self) -> dict:
        with self._lock:
            lat = sorted(self.latency_s)
            pct = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
                   if lat else 0.0)
            return {
                "requests": self.n_requests,
                "batches": self.n_batches,
                "mean_batch": (self.n_requests / self.n_batches
                               if self.n_batches else 0.0),
                "batch_hist": dict(self.batch_hist),
                "latency_p50_ms": round(pct(0.50) * 1e3, 3),
                "latency_p95_ms": round(pct(0.95) * 1e3, 3),
                "latency_p99_ms": round(pct(0.99) * 1e3, 3),
            }
