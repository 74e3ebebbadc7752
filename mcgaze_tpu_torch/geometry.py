"""Box and gaze geometry on tensors.

PyTorch counterpart of mcgaze_tpu/geometry.py (same formulas, same
constants): the box converters, the DeltaXYWH decoder with
clip_border=False and its encoder, aligned GIoU, and the yaw/pitch <->
unit-vector maps. Every function
works over any leading dims and a trailing coordinate dim.
"""
from __future__ import annotations

import math

import torch

# DeltaXYWHBBoxCoder(target_means=0, target_stds=(.5, .5, 1, 1),
# clip_border=False) of the shipped configs; wh_ratio_clip is mmdet's
# default.
DELTA_MEANS = (0.0, 0.0, 0.0, 0.0)
DELTA_STDS = (0.5, 0.5, 1.0, 1.0)
WH_RATIO_CLIP = 16.0 / 1000.0

_consts: dict = {}


def device_const(values, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """`values` as a `dtype` tensor on `device`, made once a device and
    dtype: a copy from host memory may not run while a CUDA graph is being
    captured (evaluation/forward.py::EvalGraphs). Made outside inference
    mode, so a training step can save it for its backward after an eval
    call made it."""
    key = (tuple(values), dtype, device)
    t = _consts.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _consts[key] = torch.as_tensor(values, dtype=dtype,
                                               device=device)
    return t


def bbox_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5, cy + h * 0.5], dim=-1)


def bbox_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5,
                        x2 - x1, y2 - y1], dim=-1)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means=DELTA_MEANS, stds=DELTA_STDS,
               wh_ratio_clip: float = WH_RATIO_CLIP) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas against (..., 4) xyxy base boxes:
    denormalise, clamp dw/dh to +-|log(wh_ratio_clip)|, shift and scale
    the box. Returns (..., 4) xyxy."""
    means = device_const(means, deltas.dtype, deltas.device)
    stds = device_const(stds, deltas.dtype, deltas.device)
    dx, dy, dw, dh = (deltas * stds + means).unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)

    x1, y1, x2, y2 = rois.unbind(-1)
    px = (x1 + x2) * 0.5
    py = (y1 + y2) * 0.5
    pw = x2 - x1
    ph = y2 - y1

    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    return torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                        gx + gw * 0.5, gy + gh * 0.5], dim=-1)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means=DELTA_MEANS, stds=DELTA_STDS) -> torch.Tensor:
    """Inverse of delta2bbox: (..., 4) xyxy proposals and targets ->
    normalised (dx, dy, dw, dh)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    means = device_const(means, deltas.dtype, deltas.device)
    stds = device_const(stds, deltas.dtype, deltas.device)
    return (deltas - means) / stds


def giou(pred: torch.Tensor, target: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Aligned generalised IoU of (..., 4) xyxy boxes -> (...,), as mmdet
    bbox_overlaps(mode='giou', is_aligned=True)."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    overlap = wh[..., 0] * wh[..., 1]

    area_p = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    area_t = ((target[..., 2] - target[..., 0]) *
              (target[..., 3] - target[..., 1]))
    union = (area_p + area_t - overlap).clamp_min(eps)
    ious = overlap / union

    enc_lt = torch.minimum(pred[..., :2], target[..., :2])
    enc_rb = torch.maximum(pred[..., 2:], target[..., 2:])
    enc_wh = (enc_rb - enc_lt).clamp_min(0.0)
    enc_area = (enc_wh[..., 0] * enc_wh[..., 1]).clamp_min(eps)
    return ious - (enc_area - union) / enc_area


def yaw_pitch_to_vector(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) [yaw, pitch] -> (..., 3) unit gaze vector (Gaze360
    convention: cos(p) sin(y), sin(p), -cos(p) cos(y))."""
    yaw, pitch = x[..., 0], x[..., 1]
    return torch.stack([torch.cos(pitch) * torch.sin(yaw),
                        torch.sin(pitch),
                        -torch.cos(pitch) * torch.cos(yaw)], dim=-1)


def vector_to_yaw_pitch(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) gaze vector -> (..., 2) [yaw, pitch] (normalises first)."""
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    yaw = torch.atan2(x[..., 0], -x[..., 2])
    pitch = torch.asin(x[..., 1].clamp(-1.0, 1.0))
    return torch.stack([yaw, pitch], dim=-1)
