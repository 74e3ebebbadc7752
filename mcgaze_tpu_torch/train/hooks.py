"""Training-loop hooks, counterpart of mcgaze_tpu/train/hooks.py: the EMA
update (reference mmdet/core/hook/ema.py), the NaN guard (checkloss_hook),
the validation hook (EvalHook: the video eval with the live weights,
rank-sharded over the processes) and a TextLoggerHook-style console +
jsonl logger.
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


def full_model(model: torch.nn.Module, model_cfg, mesh, device
               ) -> torch.nn.Module:
    """`model` itself, or under a model axis an MCGazeModel holding the
    full weights gathered over the model group (a collective: every rank
    calls it)."""
    if mesh is None or mesh.n_model == 1:
        return model
    from ..models.mcgaze import MCGazeModel
    from ..parallel.tensor_parallel import gather_state_dict
    full = MCGazeModel(model_cfg)
    full.load_state_dict(gather_state_dict(model, mesh), strict=True)
    return full.to(device)


class ValidationHook:
    """Every `interval` iterations, the gaze video eval of the val set with
    the live training weights, scored by MAE (built by the train CLI's
    --validate only, as the reference ships EvalHook disabled).

    Several processes: each evaluates its rank-strided share of the
    videos; after a barrier the results are gathered in video order, and
    rank 0 scores and logs them. Every rank calls after_iter at each
    interval, since the gather is a collective. Under a model axis every
    rank first gathers the split weights into a full model of its own
    (full_model), so no model-axis collective runs while the ranks hold
    different videos."""

    def __init__(self, cfg, json_path: str, img_root: str,
                 interval: int = 1000, max_videos: int = 0,
                 l2cs: bool = False, work_dir: Optional[str] = None,
                 device='cuda'):
        from ..parallel.distributed import (process_index,
                                            shard_across_processes)

        self.cfg = cfg
        self.interval = interval
        self.l2cs = l2cs
        self.device = device
        self.rank0 = process_index() == 0
        self.path = (osp.join(work_dir, 'val_log.jsonl')
                     if work_dir and self.rank0 else None)
        with open(json_path) as f:
            self.anno = json.load(f)
        videos = self.anno['videos']
        self.videos = videos[:max_videos] if max_videos else videos
        self.local_videos = shard_across_processes(self.videos)
        self.img_root = img_root

    def evaluate(self, model: torch.nn.Module, mesh=None
                 ) -> Optional[Dict[str, float]]:
        """The metrics on rank 0, None elsewhere. `model` is the live
        (unwrapped) model, sharded over `mesh`'s model axis if it has
        one; it is in eval mode for the call."""
        from ..evaluation.driver import VideoGazeEvaluator
        from ..evaluation.forward import bind_forward, make_eval_forward
        from ..evaluation.mae import evaluate_results
        from ..parallel.distributed import barrier, gather_objects

        net = full_model(model, self.cfg.model, mesh, self.device)
        was_training = model.training
        model.eval()
        net.eval()
        try:
            _, fwd, fwd_dedup = make_eval_forward(
                self.cfg.model, device=self.device, model=net)
            evaluator = VideoGazeEvaluator(
                bind_forward(fwd, self.device, fwd_dedup), self.cfg.eval_cfg)
            results = list(evaluator.run_videos_from_paths(
                (v['id'], [osp.join(self.img_root, n)
                           for n in v['file_names']])
                for v in self.local_videos))
        finally:
            model.train(was_training)
        barrier('validation_gather')
        results = gather_objects(results)
        if not self.rank0:
            return None
        return evaluate_results(results, self.anno, l2cs=self.l2cs)

    def after_iter(self, step: int, state) -> Optional[Dict[str, float]]:
        if step % self.interval:
            return None
        t0 = time.time()
        metrics = self.evaluate(state.model, getattr(state, 'mesh', None))
        if metrics is None:                     # ranks other than 0
            return None
        parts = ', '.join(f'{k}: {v:.4f}' for k, v in metrics.items())
        print(f'Validation [iter {step}] ({len(self.videos)} videos, '
              f'{time.time() - t0:.1f}s): {parts}')
        if self.path:
            with open(self.path, 'a') as f:
                f.write(json.dumps(dict(step=step, **{
                    k: round(float(v), 4) for k, v in metrics.items()}))
                    + '\n')
        return metrics


class TextLogger:
    """Iter [i/max], lr, eta and every log value, on the console and as
    one json line per log interval in <work_dir>/train_log.jsonl; `quiet`
    (ranks other than 0) prints nothing."""

    def __init__(self, work_dir: Optional[str], max_iters: int,
                 interval: int = 50, quiet: bool = False):
        self.max_iters = max_iters
        self.interval = interval
        self.quiet = quiet
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
        if not self.quiet:
            print(f'Iter [{step}/{self.max_iters}] lr: {lr:.2e}, '
                  f'eta: {eta}, {parts}')
        if self.path:
            with open(self.path, 'a') as f:
                f.write(json.dumps(line) + '\n')
