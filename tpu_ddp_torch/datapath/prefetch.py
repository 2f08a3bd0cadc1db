"""Opt-in bounded background prefetcher of the loader's batches
(``--prefetch-batches N``).

Counterpart of ``tpu_ddp/datapath/prefetch.py`` (``BackgroundPrefetcher``
:38-133): the *identical* ``epoch_batches`` generator runs on a daemon
thread into a bounded queue, so the batches are bit for bit those of the
synchronous path (same index math, same gather); the thread only moves WHEN
a batch is gathered, never WHAT it holds. It takes precedence over the
native ring (``--prefetch-depth``), as in the JAX trainer.

With ``telemetry=`` it sets the JAX prefetcher's gauges (:114-120) at each
get and at close: ``datapath/prefetch_occupancy`` (the mean queue depth a
get found), ``datapath/prefetch_put_wait_total_s`` (the producer's time
blocked on a full queue) and ``datapath/prefetch_get_wait_total_s`` (the
consumer's on an empty one). ``Trainer`` also times the consumer's wait
itself (``data_wait``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator

_SENTINEL_DONE = object()
_PUT_POLL_S = 0.1


class BackgroundPrefetcher:
    """Iterate ``make_iter()`` on a background thread through a bounded
    queue of ``depth`` items. Iterable; ``close()`` is idempotent and safe
    mid-epoch (the producer is told to stop and the queue is drained so it
    can see the stop flag). An exception in the producer is raised at the
    consumer's next get."""

    def __init__(self, make_iter: Callable[[], Iterator[Any]], *, depth: int,
                 telemetry=None) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._telemetry = telemetry
        self._put_wait_total = 0.0
        self._get_wait_total = 0.0
        self._occupancy_total = 0
        self._gets = 0
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(make_iter,),
                                        name="tpu-ddp-torch-data-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_PUT_POLL_S)
            except queue.Full:
                continue
            self._put_wait_total += time.perf_counter() - t0
            return True
        return False

    def _produce(self, make_iter: Callable[[], Iterator[Any]]) -> None:
        try:
            for item in make_iter():
                if not self._put(item) or self._stop.is_set():
                    return
        except BaseException as e:  # raised at the consumer's next get
            self._put(e)
            return
        self._put(_SENTINEL_DONE)

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        self._occupancy_total += self._q.qsize()
        item = self._q.get()
        self._get_wait_total += time.perf_counter() - t0
        self._gets += 1
        self._emit_gauges()
        if item is _SENTINEL_DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def _emit_gauges(self) -> None:
        tel = self._telemetry
        if tel is None:
            return
        tel.gauge("datapath/prefetch_occupancy").set(
            self._occupancy_total / max(self._gets, 1))
        tel.gauge("datapath/prefetch_put_wait_total_s").set(round(self._put_wait_total, 6))
        tel.gauge("datapath/prefetch_get_wait_total_s").set(round(self._get_wait_total, 6))

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        self._emit_gauges()
