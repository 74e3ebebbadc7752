"""Pipelined eval loop, counterpart of mcgaze_tpu/evaluation/pipeline.py:
a background thread decodes (and copies to the device) videos ahead of
consumption, submit() enqueues a video's device work without waiting, and
up to `depth` videos stay in flight before finish() reads the oldest one
back. Results come out in input order."""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

from ..data.prefetch import BatchPrefetcher


def run_pipelined(items: Iterable, produce: Callable, submit: Callable,
                  finish: Callable, prefetch: int = 4,
                  depth: int = 1) -> Iterator:
    """items: iterable of (key, payload_in); produce(i, key, payload_in)
    -> (key, decoded) runs in the prefetch thread; submit(key, decoded) ->
    pending; finish(key, pending) -> result. Yields results in input
    order with up to `depth` items in flight."""
    decoded = BatchPrefetcher(
        (produce(i, key, payload) for i, (key, payload)
         in enumerate(items)),
        prefetch=max(prefetch, depth))
    try:
        inflight = deque()
        for key, payload in decoded:
            inflight.append((key, submit(key, payload)))
            if len(inflight) >= max(depth, 1):
                k, pending = inflight.popleft()
                yield finish(k, pending)
        while inflight:
            k, pending = inflight.popleft()
            yield finish(k, pending)
    finally:
        decoded.close()
