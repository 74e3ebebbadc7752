"""Deep-supervision loss of the query detector, counterpart of
mcgaze_tpu/train/query_criterion.py (instblink_roi_head.py:229-281,
dii_head.py head_loss, blink_head.py:119-134). Per stage:

  match      clip-level Hungarian per clip on detached predictions
  loss_cls   focal over every (query, class), one-hot of the matched label
             (background rows all zero) * 2.0 / num_pos
  loss_bbox  L1(boxes / whwh, gt / whwh) on positives * 5.0 / num_pos
  loss_iou   (1 - GIoU) on positives * 2.0 / num_pos
  loss_blink focal(blink_logits, blink target) on positives * 5.0 / num_pos
             (sigmoid(logit) = P(blink): the reference's `1 - targets` is
             mmcv's label encoding, not a flip)

num_pos is the positive count of the whole batch: in a data-parallel run it
is summed over the processes before dividing
(parallel/distributed.py::global_normalizer), so DDP's gradient mean
equals the JAX single-program loss; `num_pos` logs that global count.
`total_loss` computes the
cost matrices of every stage first and solves them in one host round trip
(train/hungarian.py::solve_assignments); the JAX step solves each stage
inside its jitted program, on the same costs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.query_detector import QueryDetectorConfig
from ..ops import losses as L
from ..parallel.distributed import global_normalizer, process_count
from .hungarian import (clip_cost_matrix, clip_targets_from_match,
                        solve_assignments)


def _clips(stage_out: dict, batch: dict, t: int):
    """(cls_logits (B, T, Q, C), boxes (B, T, Q, 4), whwh (B, T, 4))."""
    n, q, c = stage_out['cls_logits'].shape
    b = n // t
    return (stage_out['cls_logits'].reshape(b, t, q, c),
            stage_out['boxes'].reshape(b, t, q, 4),
            batch['whwh'].reshape(b, t, 4))


def stage_costs(cfg: QueryDetectorConfig, stage_out: dict, batch: dict,
                clip_length: int) -> torch.Tensor:
    """(B, M, Q) matching costs of one stage, on detached predictions."""
    cls_logits, boxes, whwh = _clips(stage_out, batch, clip_length)
    return clip_cost_matrix(
        cls_logits.detach(), boxes.detach(), whwh[:, 0], batch['gt_boxes'],
        batch['gt_labels'], batch['gt_present'], batch['inst_valid'],
        cfg.match_cls_weight, cfg.match_l1_weight, cfg.match_iou_weight)


def stage_targets(cfg: QueryDetectorConfig, stage_out: dict, batch: dict,
                  match: torch.Tensor) -> dict:
    """clip_targets_from_match of one stage's match (B, M)."""
    return clip_targets_from_match(
        match, batch['gt_boxes'], batch['gt_labels'], batch['gt_present'],
        batch['inst_valid'], batch.get('gt_blinks'),
        num_queries=stage_out['cls_logits'].shape[1],
        num_classes=cfg.num_classes)


def stage_losses(cfg: QueryDetectorConfig, stage_out: dict, batch: dict,
                 clip_length: int, match: torch.Tensor,
                 tg: dict | None = None,
                 num_pos: torch.Tensor | None = None) -> dict:
    """Losses of one stage at a given match (B, M); tg and num_pos (the
    avg_factor, global_normalizer of the positives) are computed here when
    None.

    stage_out: cls_logits (B*T, Q, C), boxes (B*T, Q, 4), blink_logits
    (B*T, Q) when cfg.with_blink. batch: gt_boxes (B, M, T, 4) xyxy,
    gt_labels (B, M), gt_present (B, M, T) bool, inst_valid (B, M) bool,
    gt_blinks (B, M, T) (optional), whwh (B*T, 4)."""
    n, q, _ = stage_out['cls_logits'].shape
    if tg is None:
        tg = stage_targets(cfg, stage_out, batch, match)
    labels = tg['labels'].reshape(n, q)
    bbox_targets = tg['bbox_targets'].reshape(n, q, 4)
    pos = tg['pos_mask'].reshape(n, q)
    if num_pos is None:
        num_pos = global_normalizer(pos.sum())

    out = {}
    # one_hot of num_classes + 1 columns, the background one dropped
    onehot = F.one_hot(labels, cfg.num_classes + 1)[..., :cfg.num_classes]
    out['loss_cls'] = cfg.loss_cls_weight * L.sigmoid_focal_loss(
        stage_out['cls_logits'].reshape(-1), onehot.reshape(-1).float(),
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha, avg_factor=num_pos)
    whwh_n = batch['whwh'][:, None, :]
    out['loss_bbox'] = cfg.loss_bbox_weight * L.l1_loss(
        stage_out['boxes'] / whwh_n, bbox_targets / whwh_n,
        weight=pos[..., None], avg_factor=num_pos)
    out['loss_iou'] = cfg.loss_iou_weight * L.giou_loss(
        stage_out['boxes'].reshape(-1, 4), bbox_targets.reshape(-1, 4),
        weight=pos.reshape(-1), avg_factor=num_pos)
    if cfg.with_blink and 'blink_logits' in stage_out:
        out['loss_blink'] = cfg.loss_blink_weight * L.sigmoid_focal_loss(
            stage_out['blink_logits'].reshape(-1),
            tg['blink_targets'].reshape(-1), weight=pos.reshape(-1),
            gamma=cfg.focal_gamma, alpha=cfg.focal_alpha,
            avg_factor=num_pos)
    out['num_pos'] = num_pos * process_count()
    return out


def total_loss(cfg: QueryDetectorConfig, model_out: dict, batch: dict,
               clip_length: int):
    """Sum over stages (stage weights all 1.0). Returns (scalar, logs,
    host seconds of the assignment solves)."""
    stages = model_out['stages']
    costs = torch.stack([stage_costs(cfg, s, batch, clip_length)
                         for s in stages])                 # (S, B, M, Q)
    matches, solve_s = solve_assignments(costs)
    tgs = [stage_targets(cfg, s, batch, m) for s, m in zip(stages, matches)]
    # every stage's global positive count in one allreduce
    norms = global_normalizer(torch.stack([tg['pos_mask'].sum()
                                           for tg in tgs]))
    logs = {}
    total = 0.0
    for i, (stage_out, match) in enumerate(zip(stages, matches)):
        for name, val in stage_losses(cfg, stage_out, batch, clip_length,
                                      match, tgs[i], norms[i]).items():
            logs[f'stage{i}_{name}'] = val
            if name != 'num_pos':
                total = total + val
    logs['loss'] = total
    return total, logs, solve_s
