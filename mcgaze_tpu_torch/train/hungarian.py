"""Clip-level Hungarian matching for the query detector, counterpart of
mcgaze_tpu/train/hungarian.py (reference inference_hungarian_assigner.py
:127-183 and instblink_roi_head.py:241-259):

  * one assignment per clip: per-frame DETR costs (focal cls + L1 + GIoU)
    of each instance track, zero where the track is absent, averaged over
    its present frames; padded instance slots get the uniform PAD_COST;
  * each track goes to a distinct query; a matched query is foreground in
    the frames where its track is present, every other query background.

The costs are computed on the device, batched over stages, clips and
frames. The solve runs on the host, as the reference's scipy call does:
`solve_assignments` copies every (M, Q) cost matrix of a step to the host
at once, solves each with `hungarian`, this module's numpy copy of the JAX
package's Jonker-Volgenant solver (the same f32 arithmetic and the same
first-index argmin, so ties resolve as in JAX), and copies the assignments
back at once. A loop of tensor operations on the card would be thousands
of tiny launches per step.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..geometry import bbox_xyxy_to_cxcywh, giou

INF = np.float32(1e9)
# Cost of a padded (invalid) instance column: uniform across queries, so it
# shifts every assignment of that column alike and cannot move the rows of
# the real columns.
PAD_COST = 1e4


def hungarian(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of `cost` (M, N), M <= N: (M,) int64, the column
    of each row. Shortest augmenting paths with potentials, the JAX
    `hungarian` step for step in float32 (1-indexed working arrays, column
    0 the virtual root)."""
    m, n = cost.shape
    if m > n:
        raise ValueError(f'need rows <= cols, got {cost.shape}')
    c = np.asarray(cost, np.float32)
    u = np.zeros(m + 1, np.float32)
    v = np.zeros(n + 1, np.float32)
    p = np.zeros(n + 1, np.int64)        # p[j]: row matched to column j
    cols = np.arange(1, n + 1)
    for i in range(1, m + 1):
        p[0] = i
        minv = np.full(n + 1, INF, np.float32)
        used = np.zeros(n + 1, bool)
        way = np.zeros(n + 1, np.int64)
        j0 = 0
        while p[j0] != 0:
            used[j0] = True
            i0 = p[j0]
            cur = np.empty(n + 1, np.float32)
            cur[0] = INF
            cur[1:] = c[i0 - 1] - u[i0] - v[cols]
            better = ~used & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            scan = np.where(used, INF, minv)
            j1 = int(np.argmin(scan))
            delta = scan[j1]
            u[p[used]] += delta
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0 = j1
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.zeros(m + 1, np.int64)
    col_of_row[p[1:]] = np.arange(1, n + 1)
    return col_of_row[1:] - 1


def solve_assignments(costs: torch.Tensor):
    """costs (..., M, N) on any device -> ((..., M) int64 assignments on
    the same device, host seconds spent in the solves). One copy to the
    host and one back, whatever the leading shape."""
    host = costs.detach().float().cpu().numpy()
    t0 = time.perf_counter()
    flat = host.reshape(-1, *host.shape[-2:])
    match = np.stack([hungarian(x) for x in flat]).reshape(host.shape[:-1])
    seconds = time.perf_counter() - t0
    return torch.from_numpy(match).to(costs.device), seconds


def focal_cls_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                   alpha: float = 0.25, gamma: float = 2.0,
                   eps: float = 1e-12) -> torch.Tensor:
    """mmdet FocalLossCost: (..., N, C) logits, (..., M) labels ->
    (..., N, M)."""
    p = torch.sigmoid(cls_logits.float())
    neg = -torch.log1p(-p + eps) * (1 - alpha) * p.pow(gamma)
    pos = -torch.log(p + eps) * alpha * (1 - p).pow(gamma)
    cost = pos - neg
    idx = gt_labels.long()[..., None, :].expand(*cost.shape[:-1],
                                                gt_labels.shape[-1])
    return torch.gather(cost, -1, idx)


def l1_bbox_cost(pred_cxcywh: torch.Tensor,
                 gt_cxcywh: torch.Tensor) -> torch.Tensor:
    """mmdet BBoxL1Cost: (..., N, 4), (..., M, 4) -> (..., N, M)."""
    return (pred_cxcywh[..., :, None, :]
            - gt_cxcywh[..., None, :, :]).abs().sum(-1)


def giou_cost(pred_xyxy: torch.Tensor, gt_xyxy: torch.Tensor) -> torch.Tensor:
    """mmdet IoUCost(giou): -GIoU, (..., N, 4), (..., M, 4) -> (..., N, M)."""
    n, m = pred_xyxy.shape[-2], gt_xyxy.shape[-2]
    pp = pred_xyxy[..., :, None, :].expand(*pred_xyxy.shape[:-1], m, 4)
    gg = gt_xyxy[..., None, :, :].expand(*gt_xyxy.shape[:-2], n, m, 4)
    return -giou(pp, gg)


def clip_cost_matrix(cls_logits, boxes, whwh, gt_boxes, gt_labels,
                     gt_present, inst_valid, cls_weight: float = 2.0,
                     l1_weight: float = 5.0,
                     iou_weight: float = 2.0) -> torch.Tensor:
    """Track-level costs of B clips at once.

    cls_logits (B, T, N, C); boxes (B, T, N, 4) absolute xyxy; whwh (B, 4);
    gt_boxes (B, M, T, 4); gt_labels (B, M); gt_present (B, M, T) bool;
    inst_valid (B, M) bool. Returns (B, M, N): the per-frame costs masked by
    presence and averaged over present frames; PAD_COST on invalid slots.
    """
    whwh = whwh.float()[:, None, None, :]
    gtb = gt_boxes.float().transpose(1, 2)                    # (B, T, M, 4)
    boxes = boxes.float()
    t = boxes.shape[1]
    labels = gt_labels[:, None, :].expand(-1, t, -1)
    c = (cls_weight * focal_cls_cost(cls_logits, labels)
         + l1_weight * l1_bbox_cost(bbox_xyxy_to_cxcywh(boxes / whwh),
                                    bbox_xyxy_to_cxcywh(gtb / whwh))
         + iou_weight * giou_cost(boxes, gtb))               # (B, T, N, M)
    present = gt_present.transpose(1, 2)[:, :, None, :].float()
    count = gt_present.sum(-1).float().clamp_min(1.0)        # (B, M)
    cost = (c * present).sum(1) / count[:, None, :]          # (B, N, M)
    cost = torch.where(inst_valid[:, None, :], cost,
                       torch.full_like(cost, PAD_COST))
    return cost.transpose(1, 2)


def clip_targets_from_match(match, gt_boxes, gt_labels, gt_present,
                            inst_valid, gt_blinks, num_queries: int,
                            num_classes: int) -> dict:
    """Scatter B clip matches into dense per-frame query targets.

    match (B, M); gt_boxes (B, M, T, 4); gt_labels (B, M); gt_present
    (B, M, T); inst_valid (B, M); gt_blinks (B, M, T) or None. Returns
    labels (B, T, N) int64 (num_classes = background), bbox_targets
    (B, T, N, 4), pos_mask (B, T, N) f32 and, with gt_blinks,
    blink_targets (B, T, N) f32. A matched query is background in the
    frames where its track is absent."""
    b, m, t = gt_present.shape
    n = num_queries
    valid = inst_valid.bool()
    # invalid slots scatter into the dropped column n
    q = torch.where(valid, match, torch.full_like(match, n))
    pos = gt_present.transpose(1, 2) & valid[:, None, :]      # (B, T, M)
    idx = q[:, None, :].expand(b, t, m)

    def scatter(fill, values, extra=()):
        out = torch.full((b, t, n + 1, *extra), fill, dtype=values.dtype,
                         device=values.device)
        index = idx.reshape(b, t, m, *([1] * len(extra))).expand(
            b, t, m, *extra)
        return out.scatter(2, index, values)[:, :, :n]

    labels = scatter(num_classes, torch.where(
        pos, gt_labels.long()[:, None, :].expand(b, t, m),
        torch.full_like(idx, num_classes)))
    bbox = scatter(0.0, torch.where(
        pos[..., None], gt_boxes.float().transpose(1, 2),
        torch.zeros((), device=gt_boxes.device)), (4,))
    out = dict(labels=labels, bbox_targets=bbox,
               pos_mask=scatter(0.0, pos.float()))
    if gt_blinks is not None:
        out['blink_targets'] = scatter(0.0, torch.where(
            pos, gt_blinks.float().transpose(1, 2),
            torch.zeros((), device=gt_blinks.device)))
    return out
