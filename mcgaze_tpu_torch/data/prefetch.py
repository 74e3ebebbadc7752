"""Background-thread prefetcher, counterpart of
mcgaze_tpu/data/prefetch.py: `BatchPrefetcher` runs a producer iterator
(decode, then the host->device copy) a few items ahead of the consumer in
one thread; an exception in the producer is raised to the consumer.
`device_put_batches` (the train loop's entry) copies each host batch
through pinned memory to the device, one batch ahead of the step.
"""
from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref
from typing import Iterator, Optional

import numpy as np
import torch


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


class DeviceBatches:
    """Iterator of device batches from a BatchPrefetcher whose producer
    copies on a side CUDA stream: each batch's copy is waited for on the
    consumer's current stream before the batch is handed over."""

    def __init__(self, prefetcher: BatchPrefetcher, device: torch.device):
        self._pf = prefetcher
        self._device = device

    def __iter__(self):
        return self

    def __next__(self):
        batch, done = next(self._pf)
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def close(self, timeout: float = 5.0):
        self._pf.close(timeout)


def device_put_batches(batches: Iterator[dict], device) -> DeviceBatches:
    """Host numpy batches -> dicts of tensors on `device`, produced one
    batch ahead by a background thread. On a CUDA device each
    array goes through pinned memory and is copied without blocking, on a
    stream of its own, so the copy overlaps the step in flight."""
    device = torch.device(device)
    copy_stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                   else None)

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if copy_stream is None:
            return {k: v.to(device) for k, v in host.items()}, None
        with torch.cuda.stream(copy_stream):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    return DeviceBatches(BatchPrefetcher(map(put, batches), prefetch=1),
                         device)
