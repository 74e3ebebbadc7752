"""Device-throughput timing, counterpart of mcgaze_tpu/utils/benchmarking.py.

`serial_chain_time` times fn as a serial chain: fn(eps) folds a 0-d f32
tensor derived from its outputs back into its inputs, so each iteration
depends on the one before, and one completion barrier ends each chain.
On a CUDA card the barrier is torch.cuda.synchronize on eps's device and
the chain is back-to-back launches on one stream with the host's launch
work included: a host-bound forward measures at its host rate, as it runs
in the eval and serving paths. On the CPU the barrier is a no-op (every op
has finished when it returns). Used by the port's
tools/analysis_tools/*_bench.py and step_breakdown.py.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def _barrier(eps) -> None:
    if isinstance(eps, torch.Tensor) and eps.is_cuda:
        torch.cuda.synchronize(eps.device)


def serial_chain_time(fn: Callable, iters: int = 20, warmup: int = 3,
                      repeats: int = 1, device='cpu') -> float:
    """Seconds per iteration of fn, serial-chained through its eps.

    fn(eps: 0-d f32 tensor on `device`) -> 0-d f32 tensor. `warmup` calls
    first, then `repeats` chains of `iters` calls, each started from a zero
    eps and ended by one barrier; returns the fastest chain's seconds per
    call (the least-noise estimate of the sustained rate)."""
    eps = torch.zeros((), dtype=torch.float32, device=device)
    for _ in range(warmup):
        eps = fn(eps)
    _barrier(eps)
    best = float('inf')
    for _ in range(max(repeats, 1)):
        start = time.perf_counter()
        eps = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            eps = fn(eps)
        _barrier(eps)                      # one completion barrier a chain
        best = min(best, (time.perf_counter() - start) / iters)
    return best
