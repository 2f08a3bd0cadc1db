"""Opt-in bounded background prefetcher of the loader's batches
(``--prefetch-batches N``).

Counterpart of ``tpu_ddp/datapath/prefetch.py`` (``BackgroundPrefetcher``
:38-133): the *identical* ``epoch_batches`` generator runs on a daemon
thread into a bounded queue, so the batches are bit for bit those of the
synchronous path (same index math, same gather); the thread only moves WHEN
a batch is gathered, never WHAT it holds. It takes precedence over the
native ring (``--prefetch-depth``), as in the JAX trainer.

The JAX prefetcher's ``datapath/*`` gauges (queue occupancy, the producer's
and the consumer's wait) go to telemetry, which the port does not have yet:
this one takes no telemetry argument, and ``Trainer`` times the consumer's
wait itself (``data_wait``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

_SENTINEL_DONE = object()
_PUT_POLL_S = 0.1


class BackgroundPrefetcher:
    """Iterate ``make_iter()`` on a background thread through a bounded
    queue of ``depth`` items. Iterable; ``close()`` is idempotent and safe
    mid-epoch (the producer is told to stop and the queue is drained so it
    can see the stop flag). An exception in the producer is raised at the
    consumer's next get."""

    def __init__(self, make_iter: Callable[[], Iterator[Any]], *, depth: int) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(make_iter,),
                                        name="tpu-ddp-torch-data-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_PUT_POLL_S)
            except queue.Full:
                continue
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
        item = self._q.get()
        if item is _SENTINEL_DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
