"""The measured window and its end-to-end metrics.

The loops are those of the port's tools/analysis_tools/benchmark.py
(default mode: a batch handed over from the host, the forward, one
read-back a batch) and train_bench.py (step mode: steps queued back to
back on device-resident batches, one loss read-back at the end), at
commit 8553edb, rewritten to run for a fixed time instead of a count:
every call started before the deadline is finished and counted, and the
window ends when the last one has.

  eval   eval_clips_per_s    clips whose outputs reached the host over the
                             whole window
         eval_batch_p95_ms   95th percentile over every batch of the
                             window, each timed from its hand-over to its
                             outputs on the host
  train  train_clips_per_s   clips of the completed steps over the whole
                             window, closed by a sync on the last loss
"""
from __future__ import annotations

import contextlib
import statistics
import time


def _range(name: str, traced: bool):
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function('gazebench.' + name)


def run(entry, seconds: float, first: int = 0, count: int | None = None,
        traced: bool = False) -> dict:
    """Calls of the entry from index `first`, until `seconds` have passed
    (or `count` calls). Returns {'seconds', 'calls', 'clips', 'host_s',
    'latency_s', 'first'}; host_s is the time a call spent inside the
    entry's own call (eval: hand-over and enqueue; train: the step's host
    work), latency_s (eval) from hand-over to outputs on the host."""
    host, lat = [], []
    i = first
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        if entry.mode == 'eval':
            with _range('entry', traced):
                handle = entry.submit(i)
            t1 = time.perf_counter()
            with _range('readback', traced):
                entry.readback(i, handle)
            t2 = time.perf_counter()
            lat.append(t2 - t0)
        else:
            with _range('step', traced):
                entry.step(i)
            t1 = t2 = time.perf_counter()
        host.append(t1 - t0)
        i += 1
        done = i - first
        if (count is not None and done >= count) or (
                count is None and t2 >= deadline):
            break
    if entry.mode != 'eval':
        with _range('sync', traced):
            entry.sync()
    end = time.perf_counter()
    return dict(seconds=end - start, calls=i - first, first=first,
                clips=(i - first) * entry.clips_per_call, host_s=host,
                latency_s=lat)


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method); the
    one value of a window of one call."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[-1]


def end_to_end(mode: str, win: dict, setup_s: float) -> dict:
    m = dict(setup_s=dict(value=setup_s, unit='s'))
    rate = win['clips'] / win['seconds']
    if mode == 'eval':
        m['eval_clips_per_s'] = dict(value=rate, unit='clips/s')
        m['eval_batch_p95_ms'] = dict(value=1e3 * p95(win['latency_s']),
                                      unit='ms')
    else:
        m['train_clips_per_s'] = dict(value=rate, unit='clips/s')
    return m
