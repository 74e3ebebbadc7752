"""On-device gaze MAE, counterpart of mcgaze_tpu/evaluation/mae_device.py
(the tensor twin of evaluation/mae.py::gaze_error).

Every video's (pred, gt) tracks are concatenated into ONE flat (N, 3)
pair; the per-video smoothing stencil and the angular math run as f32
tensor work on one device (video boundaries handled by a segment-id mask,
so the edge handling of smooth_filter is exact), and one readback returns
the three frame-weighted buckets.

Numerics: f32 against the numpy scorer's float64; the buckets agree within
1e-3 deg on unit-scale tracks (tests/test_torch_port_cli.py). acos near
|dot| = 1 is the sensitive spot: its argument is clamped to [-1, 1].
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.env import resolve_device


def _score_flat(pred, gt, vid, smooth: bool = True, l2cs: bool = False):
    """pred/gt (N, 3) f32, vid (N,) int video segment ids, one device.
    Returns the (6,) tensor (err_sum_360, n_360, err_sum_90, n_90,
    err_sum_20, n_20)."""
    alpha = 0.6
    if smooth:
        no = torch.zeros(1, dtype=torch.bool, device=vid.device)
        same_prev = torch.cat([no, vid[1:] == vid[:-1]])
        same_next = torch.cat([vid[:-1] == vid[1:], no])
        xp = torch.roll(pred, 1, 0) * same_prev[:, None]
        xn = torch.roll(pred, -1, 0) * same_next[:, None]
        cnt = same_prev.float() + same_next.float()
        out = alpha * pred + (1 - alpha) * (xp + xn) / cnt.clamp_min(
            1.0)[:, None]
        out = out / torch.linalg.norm(out, dim=1,
                                      keepdim=True).clamp_min(1e-12)
        # length-1 videos pass through unchanged (smooth_filter's T < 2
        # early return, not even renormalised)
        pred = torch.where((cnt > 0)[:, None], out, pred)

    gtn = gt / torch.linalg.norm(gt, dim=1, keepdim=True).clamp_min(1e-12)
    dots = torch.clamp((pred * gtn).sum(1), -1.0, 1.0)
    err = torch.rad2deg(torch.arccos(dots))

    yaw = torch.rad2deg(torch.atan2(gtn[:, 0], -gtn[:, 2]).abs())
    front90 = yaw <= 90
    front20 = yaw <= 20
    if l2cs:
        pitch = torch.rad2deg(torch.arcsin(gtn[:, 1].clamp(-1.0, 1.0)).abs())
        front20 = front20 & (pitch <= 20)
    m90, m20 = front90.float(), front20.float()
    return torch.stack([err.sum(), torch.tensor(float(err.shape[0]),
                                                device=err.device),
                        (err * m90).sum(), m90.sum(),
                        (err * m20).sum(), m20.sum()])


def gaze_error_device(eval_data: list, anno_data: dict,
                      gaze_name: str = 'fusion_gazes',
                      smooth: bool = True, l2cs: bool = False,
                      device='cuda') -> dict:
    """mae.gaze_error with the angular math on `device` ('cuda' by
    default; refuses without a card). Same bucket semantics: per-video
    mean x frame count = per-frame error sums, frame-weighted across
    videos."""
    device = resolve_device(device)
    preds, gts, vids = [], [], []
    for anno_id, video in enumerate(eval_data):
        p = np.asarray(video[gaze_name], np.float32)
        gt_row = anno_id * 3 if l2cs else anno_id
        g = np.asarray(anno_data['annotations'][gt_row]['gaze'], np.float32)
        assert len(g) == len(p), (anno_id, len(g), len(p))
        preds.append(p)
        gts.append(g)
        vids.append(np.full(len(p), anno_id, np.int64))
    if not preds:
        return dict(mae360=0.0, front90=0.0, front20=0.0, frames=0)
    out = _score_flat(
        torch.from_numpy(np.concatenate(preds)).to(device),
        torch.from_numpy(np.concatenate(gts)).to(device),
        torch.from_numpy(np.concatenate(vids)).to(device),
        smooth=smooth, l2cs=l2cs)
    e360, f360, e90, f90, e20, f20 = out.cpu().tolist()
    return dict(
        mae360=e360 / max(f360, 1),
        front90=e90 / max(f90, 1),
        front20=e20 / max(f20, 1),
        frames=int(f360),
    )
