"""The fixed query -> GT assignment as masks, counterpart of
mcgaze_tpu/train/targets.py.

The reference assigns query 0 <-> face, 1 <-> eyes, 2 <-> head on frames
with 3 GT boxes, and only query 2 <-> head on head-only frames. The dataset
already emits GT in that slot layout:
    gt_boxes (B, T, 3, 4) xyxy, row q is query q's target (zeros if absent)
    gt_valid (B, T, 3)    1 where the slot has a GT
    gt_gazes (B, T, 3, 3) per-slot gaze (head-only frames carry it in slot 2)
so assignment is the identity and the losses weight by gt_valid.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ClipTargets(NamedTuple):
    boxes: torch.Tensor   # (N, Q, 4) xyxy
    valid: torch.Tensor   # (N, Q) float 0/1
    gazes: torch.Tensor   # (N, Q, 3)
    whwh: torch.Tensor    # (N, 4)


def flatten_targets(gt_boxes, gt_valid, gt_gazes, img_whwh) -> ClipTargets:
    """(B, T, ...) -> (N = B*T, ...) f32 targets."""
    b, t = gt_valid.shape[:2]
    n = b * t
    return ClipTargets(
        boxes=gt_boxes.reshape(n, *gt_boxes.shape[2:]).to(torch.float32),
        valid=gt_valid.reshape(n, *gt_valid.shape[2:]).to(torch.float32),
        gazes=gt_gazes.reshape(n, *gt_gazes.shape[2:]).to(torch.float32),
        whwh=img_whwh.reshape(n, 4).to(torch.float32),
    )


def slot_layout_from_counts(boxes_list, gazes_list):
    """Host side: one frame's GT list -> fixed-slot numpy arrays.

    boxes_list holds k in {0, 1, 3} boxes; 3 are (face, eyes, head) in
    annotation order, 1 is head-only. Returns (boxes (3, 4), valid (3,),
    gazes (3, 3))."""
    out_b = np.zeros((3, 4), np.float32)
    out_v = np.zeros((3,), np.float32)
    out_g = np.zeros((3, 3), np.float32)
    k = len(boxes_list)
    if k == 3:
        out_b[:] = np.asarray(boxes_list, np.float32)
        out_g[:] = np.asarray(gazes_list, np.float32)
        out_v[:] = 1.0
    elif k == 1:
        out_b[2] = np.asarray(boxes_list[0], np.float32)
        out_g[2] = np.asarray(gazes_list[0], np.float32)
        out_v[2] = 1.0
    elif k != 0:
        raise ValueError(f'frames must carry 0, 1 or 3 GT boxes, got {k}')
    return out_b, out_v, out_g
