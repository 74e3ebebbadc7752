"""Background-thread prefetcher, counterpart of
mcgaze_tpu/data/prefetch.py::BatchPrefetcher: one thread runs a producer
iterator (decode, then the host->device copy) a few items ahead of the
consumer. An exception in the producer is raised to the consumer.
"""
from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref
from typing import Iterator, Optional


class BatchPrefetcher:
    """Wraps an iterator; yields its items in order, produced ahead."""

    _SENTINEL = object()

    def __init__(self, batches: Iterator, prefetch: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._done = False                          # sentinel consumed

        def worker():
            try:
                for batch in batches:
                    if self._stop.is_set():
                        return
                    while True:                     # interruptible put
                        try:
                            self._q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            if self._stop.is_set():
                                return
                    del batch
            except BaseException as e:              # raised to the consumer
                self._err = e
            finally:
                # never block forever on the sentinel: a closed consumer
                # may have left the queue full
                while True:
                    try:
                        self._q.put_nowait(self._SENTINEL)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            break
                        time.sleep(0.01)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name='batch-prefetch')
        self._thread.start()
        # join the producer before interpreter teardown even if the owner
        # never calls close()
        ref = weakref.ref(self)
        self._atexit = atexit.register(
            lambda: (lambda s: s and s.close(timeout=2.0))(ref()))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:                              # exhausted stays exhausted
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._done = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0):
        """Stop the producer, drop queued items, join. Idempotent."""
        self._stop.set()
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        atexit.unregister(self._atexit)
