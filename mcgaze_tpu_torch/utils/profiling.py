"""Per-iteration timing, counterpart of
mcgaze_tpu/utils/profiling.py::IterTimer (mmcv IterTimerHook semantics)."""
from __future__ import annotations

import time
from typing import Any

import torch


class IterTimer:
    """data_time = the gap between the end of one iteration and the start
    of the next; time = one whole iteration. `after_iter(sync=t)` waits
    for the card when t is a CUDA tensor, so the time covers the device
    work and not only its enqueue."""

    def __init__(self):
        self._last_end = None
        self._iter_start = None
        self.data_time = 0.0
        self.time = 0.0

    def before_iter(self):
        now = time.perf_counter()
        self.data_time = 0.0 if self._last_end is None else now - self._last_end
        self._iter_start = now

    def after_iter(self, sync: Any = None):
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        now = time.perf_counter()
        self.time = now - (self._iter_start or now)
        self._last_end = now
