"""Training-loop hooks, counterpart of mcgaze_tpu/train/hooks.py: the EMA
update (reference mmdet/core/hook/ema.py), the NaN guard (checkloss_hook)
and a TextLoggerHook-style console + jsonl logger. The validation hook
waits for distribution (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import datetime
import json
import math
import os.path as osp
import time
from typing import Any, Dict, Optional

import torch


@torch.no_grad()
def ema_update(ema: dict, params: dict, momentum: float) -> dict:
    """In place, by name: ema = (1 - momentum) * ema + momentum * param."""
    names = list(ema)
    vals = [ema[n] for n in names]
    torch._foreach_mul_(vals, 1.0 - momentum)
    torch._foreach_add_(vals, [params[n].detach() for n in names],
                        alpha=momentum)
    return ema


class CheckInvalidLoss:
    """Raise on a non-finite loss every `interval` iterations."""

    def __init__(self, interval: int = 50):
        self.interval = interval

    def after_iter(self, step: int, logs: Dict[str, Any]):
        if step % self.interval:
            return
        loss = float(logs['loss'])
        if not math.isfinite(loss):
            raise FloatingPointError(
                f'loss became non-finite ({loss}) at iter {step}')


class TextLogger:
    """Iter [i/max], lr, eta and every log value, on the console and as
    one json line per log interval in <work_dir>/train_log.jsonl."""

    def __init__(self, work_dir: Optional[str], max_iters: int,
                 interval: int = 50):
        self.max_iters = max_iters
        self.interval = interval
        self.path = (osp.join(work_dir, 'train_log.jsonl')
                     if work_dir else None)
        self._t0 = time.time()
        self._start_step = None

    def after_iter(self, step: int, logs: Dict[str, Any], lr: float,
                   timer=None):
        if self._start_step is None:
            self._start_step = step - 1
            self._t0 = time.time()
        if step % self.interval and step != self.max_iters:
            return
        done = step - self._start_step
        per_iter = (time.time() - self._t0) / max(done, 1)
        eta = datetime.timedelta(
            seconds=int(per_iter * (self.max_iters - step)))
        scalars = {k: round(float(v), 4) for k, v in logs.items()}
        line = dict(step=step, lr=round(float(lr), 6),
                    sec_per_iter=round(per_iter, 3), **scalars)
        if timer is not None:
            line['time'] = round(timer.time, 3)
            line['data_time'] = round(timer.data_time, 3)
        parts = ', '.join(f'{k}: {v}' for k, v in scalars.items())
        print(f'Iter [{step}/{self.max_iters}] lr: {lr:.2e}, '
              f'eta: {eta}, {parts}')
        if self.path:
            with open(self.path, 'a') as f:
                f.write(json.dumps(line) + '\n')
