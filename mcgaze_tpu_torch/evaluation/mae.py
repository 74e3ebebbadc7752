"""Offline gaze MAE scoring (numpy; no accelerator needed). A copy of
mcgaze_tpu/evaluation/mae.py, so the port imports nothing of the JAX
package.

Re-implements the reference eval math so regenerated results JSONs score
identically:
  * smooth_filter        -> tools/calculate_mae_gaze360.py:16-29
  * angular error        -> tools/calculate_mae_gaze360.py:77-94
  * front-90 / front-20  -> tools/calculate_mae_gaze360.py:110-188
  * l2cs variant (GT row anno_id*3, front-20 also requires |pitch|<=20deg)
                         -> tools/calculate_mae_l2cs.py

The headline metric "MAE-Front180" is the `front90` bucket here (frames
whose GT yaw magnitude <= 90 deg), frame-count-weighted over videos.
"""
from __future__ import annotations

import numpy as np


def smooth_filter(gaze: np.ndarray, alpha: float = 0.6) -> np.ndarray:
    """Temporal smoothing of a (T, 3) gaze track with edge handling.

    out[t] = a*x[t] + (1-a)*(x[t-1]+x[t+1])/2, one-sided at the ends,
    then renormalised to unit vectors. T < 2 passes through unchanged.
    """
    x = np.asarray(gaze, dtype=np.float64)
    if x.shape[0] < 2:
        return x
    out = alpha * x
    out[0] += (1 - alpha) * x[1]
    out[-1] += (1 - alpha) * x[-2]
    out[1:-1] += (1 - alpha) * (x[:-2] + x[2:]) / 2
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def yaw_pitch_to_vector(x: np.ndarray) -> np.ndarray:
    x = np.reshape(x, (-1, 2))
    out = np.zeros((x.shape[0], 3))
    out[:, 0] = np.cos(x[:, 1]) * np.sin(x[:, 0])
    out[:, 1] = np.sin(x[:, 1])
    out[:, 2] = -np.cos(x[:, 1]) * np.cos(x[:, 0])
    return out


def yaw_degrees(target: np.ndarray) -> np.ndarray:
    """|yaw| in degrees of (N, 3) gaze vectors (or (N, 2) yaw/pitch)."""
    t = np.asarray(target, dtype=np.float64)
    if t.shape[-1] == 3:
        t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        yaw = np.arctan2(t[..., 0], -t[..., 2])
    else:
        yaw = t[..., 0]
    return np.degrees(np.abs(yaw))


def pitch_degrees(target: np.ndarray) -> np.ndarray:
    t = np.asarray(target, dtype=np.float64)
    if t.shape[-1] == 3:
        t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        pitch = np.arcsin(np.clip(t[..., 1], -1.0, 1.0))
    else:
        pitch = t[..., 1]
    return np.degrees(np.abs(pitch))


def mean_angular_error_deg(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean acos(<target_hat, pred>) in degrees over rows.

    Note: following the reference (calculate_mae_gaze360.py:77-94) only the
    *target* is re-normalised; pred is assumed unit (it is produced by
    smooth_filter or the model's normalising head).
    """
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if pred.shape[-1] == 2:
        pred = yaw_pitch_to_vector(pred)
    if target.shape[-1] == 2:
        target = yaw_pitch_to_vector(target)
    target = target / np.linalg.norm(target, axis=1, keepdims=True)
    dots = np.sum(pred * target, axis=1)
    # torch.acos NaNs silently when |dot|>1 from fp error; clip instead.
    dots = np.clip(dots, -1.0, 1.0)
    return float(np.degrees(np.mean(np.arccos(dots))))


def gaze_error(eval_data: list,
               anno_data: dict,
               gaze_name: str = 'fusion_gazes',
               smooth: bool = True,
               l2cs: bool = False) -> dict:
    """Frame-weighted MAE buckets over per-video prediction dicts.

    eval_data: list of dicts as written by the eval driver (one per video,
      with `gaze_name` -> list of per-frame 3-vectors).
    anno_data: the COCO-VID test json (annotations[i]['gaze'] tracks).
    l2cs: use GT annotation row `anno_id*3` and the pitch<=20 extra
      condition for the front-20 bucket (calculate_mae_l2cs.py:110,132-139).

    Returns dict(mae360=, front90=, front20=) in degrees; `front90` is the
    published MAE-Front180.
    """
    tot = {k: 0.0 for k in ('f360', 'f90', 'f20', 'e360', 'e90', 'e20')}
    for anno_id, video in enumerate(eval_data):
        pred = np.asarray(video[gaze_name], dtype=np.float64)
        gt_row = anno_id * 3 if l2cs else anno_id
        gt = np.asarray(anno_data['annotations'][gt_row]['gaze'],
                        dtype=np.float64)
        assert len(gt) == len(pred), (anno_id, len(gt), len(pred))
        n = len(pred)
        if smooth:
            pred = smooth_filter(pred)

        yaw = yaw_degrees(gt)
        front90 = yaw <= 90
        front20 = yaw <= 20
        if l2cs:
            front20 = front20 & (pitch_degrees(gt) <= 20)

        tot['f360'] += n
        tot['e360'] += mean_angular_error_deg(pred, gt) * n
        if front90.any():
            k = int(front90.sum())
            tot['f90'] += k
            tot['e90'] += mean_angular_error_deg(pred[front90],
                                                 gt[front90]) * k
        if front20.any():
            k = int(front20.sum())
            tot['f20'] += k
            tot['e20'] += mean_angular_error_deg(pred[front20],
                                                 gt[front20]) * k

    return dict(
        mae360=tot['e360'] / max(tot['f360'], 1),
        front90=tot['e90'] / max(tot['f90'], 1),
        front20=tot['e20'] / max(tot['f20'], 1),
        frames=int(tot['f360']),
    )


def evaluate_results(eval_data: list, anno_data: dict,
                     l2cs: bool = False) -> dict:
    """Headline metric dict for tools/test.py --eval mae: the published
    'MAE-Front180' is the front90 bucket on the fusion gaze."""
    m = gaze_error(eval_data, anno_data, 'fusion_gazes', smooth=True,
                   l2cs=l2cs)
    return {
        'MAE-360': m['mae360'],
        'MAE-Front180': m['front90'],
        'MAE-Front20': m['front20'],
        'frames': float(m['frames']),
    }
