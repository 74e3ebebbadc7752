"""Faults planted under the timed path, for the check to catch: each a
(module, attribute, wrapper) that wraps a function of the program looked
up at call time. The check's CPU tests plant each one in a whole run;
`python3 -m gazebench.control --fault <i>` reads the numbers a fault gives
at the cell's own size on the card (a training cell's upper readings).

  eval    an answer altered where it is produced (the first slot's or
          clip's output); half of the batch left out (its second half a
          copy of the first); gaze eval also one slot's boxes moved by a
          quarter of their longer side
  train   a step that leaves its state unchanged; half of the batch left
          out, the loss a mean over the rest; one leaf's gradient doubled
          on its way to the optimizer
"""
from __future__ import annotations

import contextlib
import importlib

import torch


def _altered_gaze(orig):
    def last_stage(out):
        boxes, scores, gazes = orig(out)
        gazes = dict(gazes)
        gazes['fusion'] = gazes['fusion'].clone()
        gazes['fusion'][0] = -gazes['fusion'][0]
        return boxes, scores, gazes
    return last_stage


def _moved_box(orig):
    def last_stage(out):
        boxes, scores, gazes = orig(out)
        boxes = boxes.clone()
        b = boxes[0]
        side = torch.maximum(b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])
        b[..., 0::2] += (side / 4).unsqueeze(-1)
        return boxes, scores, gazes
    return last_stage


def _half_gaze(orig):
    def last_stage(out):
        def half(t):
            n = t.shape[0]
            return torch.cat([t[:n - n // 2], t[:n // 2]])
        boxes, scores, gazes = orig(out)
        return half(boxes), half(scores), {k: half(v)
                                           for k, v in gazes.items()}
    return last_stage


def _altered_tracks(orig):
    def tracks(*args, **kw):
        out = dict(orig(*args, **kw))
        out['blink'] = out['blink'].clone()
        out['blink'][0] = 1 - out['blink'][0]
        return out
    return tracks


def _half_tracks(orig):
    def tracks(*args, **kw):
        out = orig(*args, **kw)
        b = out['scores'].shape[0]
        return {k: torch.cat([v[:b - b // 2], v[:b // 2]])
                for k, v in out.items()}
    return tracks


def _unchanged(orig):
    def apply_update(state, oc, sched):
        before = [p.detach().clone() for p in state.model.parameters()]
        norm = orig(state, oc, sched)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return norm
    return apply_update


def _half_batch(orig):
    def loss_fn(cfg, model, batch):
        b = batch['imgs'].shape[0]
        return orig(cfg, model, {k: v[:b // 2] for k, v in batch.items()})
    return loss_fn


def _altered_gradient(orig):
    def apply_update(state, oc, sched):
        p = dict(state.model.named_parameters())[
            'roi_head.bbox_head.0.ffn.layers.1.weight']
        if p.grad is not None:
            p.grad.mul_(2.0)
        return orig(state, oc, sched)
    return apply_update


FAULTS = {
    'gaze_eval': [('mcgaze_tpu_torch.evaluation.forward', '_last_stage',
                   _altered_gaze),
                  ('mcgaze_tpu_torch.evaluation.forward', '_last_stage',
                   _half_gaze),
                  ('mcgaze_tpu_torch.evaluation.forward', '_last_stage',
                   _moved_box)],
    'query_eval': [('mcgaze_tpu_torch.models.query_detector',
                    'topk_tracks_batched', _altered_tracks),
                   ('mcgaze_tpu_torch.models.query_detector',
                    'topk_tracks_batched', _half_tracks)],
    'gaze_train': [('mcgaze_tpu_torch.train.loop', 'apply_update',
                    _unchanged),
                   ('mcgaze_tpu_torch.train.loop', 'loss_fn', _half_batch),
                   ('mcgaze_tpu_torch.train.loop', 'apply_update',
                    _altered_gradient)],
}


@contextlib.contextmanager
def planted(entry: str, index: int):
    """The entry's fault `index` planted for the block."""
    module, name, wrap = FAULTS[entry][index]
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)
