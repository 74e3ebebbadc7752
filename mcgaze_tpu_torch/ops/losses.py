"""Losses on tensors, counterpart of mcgaze_tpu/ops/losses.py (same
formulas): masked, static-shape forms of the reference losses, where the
reference gathers the positive rows and these multiply by weights instead.

  * sigmoid focal loss  -> mmdet/models/losses/focal_loss.py
  * L1 / GIoU           -> mmdet/models/losses/{smooth_l1_loss,iou_loss}.py
  * gaze arccos loss    -> mmdet/models/losses/gaze_arccos_loss.py
  * gaze cos loss       -> mmdet/models/losses/gaze_cos_loss.py (1 - cos)
  * gaze pinball loss   -> mmdet/models/losses/gaze_pinball_loss.py
  * gaze temporal loss  -> mmdet/models/losses/gaze_temp_loss.py

Reductions follow mmcv `weight_reduce_loss`: elementwise loss * weight,
summed, divided by `avg_factor`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry import giou


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weight: torch.Tensor | None = None,
                       gamma: float = 2.0, alpha: float = 0.25,
                       avg_factor=1.0) -> torch.Tensor:
    """Binary sigmoid focal loss, targets in {0, 1}; returns
    sum(loss * weight) / avg_factor."""
    p = torch.sigmoid(logits)
    t = targets.to(logits.dtype)
    pt = (1.0 - p) * t + p * (1.0 - t)
    focal_weight = (alpha * t + (1.0 - alpha) * (1.0 - t)) * pt ** gamma
    # numerically stable BCE with logits
    bce = (F.relu(logits) - logits * t
           + torch.log1p(torch.exp(-logits.abs())))
    loss = bce * focal_weight
    if weight is not None:
        loss = loss * weight
    return loss.sum() / avg_factor


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            weight: torch.Tensor | None = None,
            avg_factor=1.0) -> torch.Tensor:
    loss = (pred - target).abs()
    if weight is not None:
        loss = loss * weight
    return loss.sum() / avg_factor


def giou_loss(pred: torch.Tensor, target: torch.Tensor,
              weight: torch.Tensor | None = None, avg_factor=1.0,
              eps: float = 1e-7) -> torch.Tensor:
    """pred/target (..., 4) xyxy; weight (...,) per box."""
    loss = 1.0 - giou(pred, target, eps=eps)
    if weight is not None:
        loss = loss * weight
    return loss.sum() / avg_factor


def _positives(weight: torch.Tensor, avg_factor):
    """The mean's denominator: the positive rows, at least 1, unless the
    caller gives one (a count over every process)."""
    return weight.sum().clamp_min(1.0) if avg_factor is None else avg_factor


def arccos_gaze_loss(pred: torch.Tensor, target: torch.Tensor,
                     weight: torch.Tensor, eps: float = 1e-6,
                     avg_factor=None) -> torch.Tensor:
    """Mean angle between pred and target (N, 3) over the rows with
    weight 1; 0 when no row is positive."""
    denom = (torch.linalg.norm(pred, dim=-1) *
             torch.linalg.norm(target, dim=-1))
    sim = (pred * target).sum(-1) / denom.clamp_min(eps)
    sim = sim.clamp(-1.0 + eps, 1.0 - eps)
    angle = torch.arccos(sim)
    return (angle * weight).sum() / _positives(weight, avg_factor)


def cos_gaze_loss(pred: torch.Tensor, target: torch.Tensor,
                  weight: torch.Tensor, avg_factor=None) -> torch.Tensor:
    """Mean (1 - cos) over positive rows; pred/target arrive unit-norm."""
    cos = (pred * target).sum(-1).clamp(-1.0, 1.0)
    return ((1.0 - cos) * weight).sum() / _positives(weight, avg_factor)


def pinball_gaze_loss(pred: torch.Tensor, target: torch.Tensor,
                      weight: torch.Tensor, var=0.0,
                      q: float = 0.1, avg_factor=None) -> torch.Tensor:
    """Quantile loss at q and 1 - q, each a mean over every element of the
    positive rows. The gaze head predicts no `var`, so it is 0 and the two
    terms collapse to a plain L1 mean."""
    d = pred.shape[-1]
    q_lo = target - (pred - var)
    q_hi = target - (pred + var)
    lo = torch.maximum(q * q_lo, (q - 1.0) * q_lo)
    hi = torch.maximum((1.0 - q) * q_hi, -q * q_hi)
    denom = _positives(weight, avg_factor) * d
    return ((lo * weight[:, None]).sum() +
            (hi * weight[:, None]).sum()) / denom


# config-selectable per-clue gaze losses: (pred (N,3), target (N,3),
# weight (N,), avg_factor=None) -> scalar
GAZE_LOSSES = {
    'arccos': arccos_gaze_loss,
    'cos': cos_gaze_loss,
    'pinball': pinball_gaze_loss,
}


def temporal_gaze_loss(pred: torch.Tensor, avg_factor=None) -> torch.Tensor:
    """Second-order temporal smoothness over a clip, pred (B, T, D):
    |2p_t - p_{t-1} - p_{t+1}|_1 with one-sided |2p_0 - 2p_1| and
    |2p_T - 2p_{T-1}| at the ends; mean over (B, T), or the sum divided by
    avg_factor where the caller gives one."""
    first = (2 * pred[:, 0] - 2 * pred[:, 1]).abs().sum(-1)
    last = (2 * pred[:, -1] - 2 * pred[:, -2]).abs().sum(-1)
    mid = (2 * pred[:, 1:-1] - pred[:, 2:] - pred[:, :-2]).abs().sum(-1)
    terms = torch.cat([first[:, None], mid, last[:, None]], dim=1)
    return terms.mean() if avg_factor is None else terms.sum() / avg_factor
