"""Deep-supervision loss over the refinement stages, counterpart of
mcgaze_tpu/train/criterion.py:

  per stage s, per clue q in (face, eyes, head):
    loss_cls  = focal(logits_q, valid_q) * 2.0            / num_pos_q
    loss_bbox = L1(box_q/whwh, gt_q/whwh)[pos] * 5.0      / num_pos_q
    loss_iou  = (1 - GIoU(box_q, gt_q))[pos]   * 2.0      / num_pos_q
    {face,eyes,head}_gaze = arccos(pred_q, gaze_q)[pos]   * 6.0 (mean)
    final_gaze = arccos(fusion, gaze_head)[pos_head] * 6.0
               + temporal(fusion over clip) * 1.0

with the weights of ModelConfig; logs are keyed `stage{i}_{name}`.

num_pos and the gaze means' positive counts are the global ones: in a
data-parallel run each is summed over the processes before dividing
(parallel/distributed.py::global_normalizer), so DDP's gradient mean
equals the JAX package's single-program loss over the global batch.
"""
from __future__ import annotations

import torch

from ..models.mcgaze import ModelConfig
from ..ops import losses as L
from ..parallel.distributed import global_normalizer
from .targets import ClipTargets

CLUES = ('face', 'eyes', 'head')


def normalizers(tg: ClipTargets) -> torch.Tensor:
    """(Q + 1,) avg_factors: each clue's positive count, then the temporal
    loss's (clip, frame) count, all global (one allreduce)."""
    n = torch.tensor([float(tg.valid.shape[0])], device=tg.valid.device)
    return global_normalizer(torch.cat([tg.valid.sum(0), n]))


def stage_losses(cfg: ModelConfig, stage_out: dict, tg: ClipTargets,
                 clip_length: int, norms: torch.Tensor | None = None
                 ) -> dict:
    """Losses of one refinement stage: {name: scalar tensor}. norms: the
    stage's `normalizers` (computed here when None)."""
    out = {}
    q = tg.valid.shape[1]
    logits = stage_out['cls_logits'][..., 0]          # (N, Q)
    boxes = stage_out['boxes']                        # (N, Q, 4)
    if norms is None:
        norms = normalizers(tg)

    for qi, clue in enumerate(CLUES[:q]):
        valid = tg.valid[:, qi]
        num_pos = norms[qi]
        out[f'{clue}_loss_cls'] = cfg.loss_cls_weight * L.sigmoid_focal_loss(
            logits[:, qi], valid, gamma=cfg.focal_gamma,
            alpha=cfg.focal_alpha, avg_factor=num_pos)
        out[f'{clue}_loss_bbox'] = cfg.loss_bbox_weight * L.l1_loss(
            boxes[:, qi] / tg.whwh, tg.boxes[:, qi] / tg.whwh,
            weight=valid[:, None], avg_factor=num_pos)
        out[f'{clue}_loss_iou'] = cfg.loss_iou_weight * L.giou_loss(
            boxes[:, qi], tg.boxes[:, qi], weight=valid, avg_factor=num_pos)

    gaze = stage_out['gaze']
    gaze_loss = L.GAZE_LOSSES[cfg.gaze_loss_type]
    for qi, clue in enumerate(CLUES):
        out[f'{clue}_gaze_loss'] = cfg.loss_gaze_weight * gaze_loss(
            gaze[clue], tg.gazes[:, qi], tg.valid[:, qi],
            avg_factor=norms[qi])
    # the fusion is trained against the head slot's gaze
    out['final_gaze_loss'] = cfg.loss_gaze_weight * gaze_loss(
        gaze['fusion'], tg.gazes[:, 2], tg.valid[:, 2], avg_factor=norms[2])
    out['final_gaze_temp'] = cfg.loss_temp_weight * L.temporal_gaze_loss(
        gaze['fusion'].reshape(-1, clip_length, 3), avg_factor=norms[-1])
    return out


def total_loss(cfg: ModelConfig, model_out: dict, tg: ClipTargets,
               clip_length: int):
    """Sum of the stage losses weighted by stage_loss_weights. Returns
    (scalar, logs {'stage{i}_{name}': value, 'loss': total})."""
    logs = {}
    total = torch.zeros((), dtype=torch.float32, device=tg.valid.device)
    norms = normalizers(tg)
    for i, stage_out in enumerate(model_out['stages']):
        w = cfg.stage_loss_weights[i]
        for name, val in stage_losses(cfg, stage_out, tg, clip_length,
                                      norms).items():
            val = val * w
            logs[f'stage{i}_{name}'] = val
            total = total + val
    logs['loss'] = total
    return total, logs
