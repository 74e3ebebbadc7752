"""Checkpoint files, counterpart of mcgaze_tpu/utils/checkpoint.py, as
torch.save files:

  ckpt_<step>.pth        {'state_dict': the model under the reference mmdet
                          names, 'meta': {'step'}}: what eval loads, in the
                          layout of an mmcv checkpoint, so
                          clean_reference_state_dict reads it
  ckpt_<step>_train.pth  what resume needs beside it: the optimizer state,
                          the step and the EMA copy (or None)
"""
from __future__ import annotations

import os
import os.path as osp
import re
from typing import Any

import torch

_CKPT = re.compile(r'ckpt_(\d+)\.pth')


def save_checkpoint(work_dir: str, step: int, state_dict: dict,
                    train_state: Any = None,
                    max_to_keep: int | None = None) -> str:
    """Write ckpt_<step>.pth and, with train_state, ckpt_<step>_train.pth.
    With max_to_keep, remove the files of all but the newest max_to_keep
    steps (the JAX save_checkpoint's pruning; the reference
    CheckpointHook's max_keep_ckpts). Returns the model file's path."""
    path = osp.abspath(osp.join(work_dir, f'ckpt_{step}.pth'))
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({'state_dict': cpu, 'meta': {'step': step}}, path)
    if train_state is not None:
        torch.save(train_state, train_path(path))
    if max_to_keep:
        steps = sorted(int(m.group(1)) for m in map(_CKPT.fullmatch,
                                                    os.listdir(work_dir))
                       if m)
        for s in steps[:-max_to_keep]:
            old = osp.join(work_dir, f'ckpt_{s}.pth')
            for f in (old, train_path(old)):
                if osp.exists(f):
                    os.remove(f)
    return path


def train_path(path: str) -> str:
    """ckpt_<step>.pth -> ckpt_<step>_train.pth."""
    return path[:-len('.pth')] + '_train.pth'


def require_pth(path: str) -> None:
    """SystemExit where `path` is not a torch .pth file (an orbax
    checkpoint directory of the JAX package, say)."""
    if not path.endswith(('.pth', '.pt')):
        raise SystemExit(f'{path}: the port reads torch .pth checkpoints (a '
                         'reference mmdet one or the port\'s '
                         'ckpt_<step>.pth)')


def ema_weights(path: str) -> dict:
    """The EMA copy of the parameters that the train CLI keeps in the
    `ema` entry of ckpt_<step>_train.pth beside `path`; SystemExit where
    there is none."""
    tpath = train_path(path)
    averaged = (restore_checkpoint(tpath).get('ema')
                if osp.exists(tpath) else None)
    if averaged is None:
        raise SystemExit(f'{tpath} holds no ema weights: train with '
                         'optim.ema_momentum > 0 to produce them')
    return averaged


def restore_checkpoint(path: str) -> Any:
    """What save_checkpoint wrote at `path` (tensors, numbers, dicts), on
    the CPU."""
    return torch.load(path, map_location='cpu', weights_only=True)


def find_latest_checkpoint(work_dir: str) -> str | None:
    """The model file of the highest step in work_dir, for auto-resume."""
    if not osp.isdir(work_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(work_dir):
        m = _CKPT.fullmatch(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = osp.join(work_dir, name), int(m.group(1))
    return best
