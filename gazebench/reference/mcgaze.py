"""Plain reference of MCGaze (arXiv 2310.18131; zgchen33/MCGaze,
configs/multiclue_gaze/multiclue_gaze_r50_gaze360.py): its eval forward,
its training loss and three steps of its optimizer, in f32 plain PyTorch
over a state dict of the reference names.

    frames -> ResNet-50 (frozen BN) -> FPN -> 3 learned proposals (face,
    eyes, head) -> num_stages x [FPN RoIAlign -> STQI interaction -> cls
    and reg towers -> box decode -> gaze head (per-clue gaze, confidences
    on detached features, learned 9 -> 3 fusion, unit vectors)]

Loss per stage (mmdet's sigmoid focal, L1, GIoU; MCGaze's arccos and
temporal gaze losses) and the optimizer (AdamW, backbone lr x0.1, stem and
layer1 frozen, global-norm clip, linear warmup) as the published config
states them. Semantics checked against the port at commit 8553edb; no
code of it is imported.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import common as C

CLUES = ('face', 'eyes', 'head')
GAZE_NAMES = ('eyes', 'face', 'fusion', 'head')   # the packed order


def param_specs(m: dict):
    """[(name, shape, init)] of the model of config `m`."""
    c, ffn = m['channels'], m['ffn_channels']
    out = C.resnet50_specs() + C.fpn_specs(c) + C.proposal_specs(
        m['num_queries'], c)
    for s in range(m['num_stages']):
        p = f'roi_head.bbox_head.{s}.'
        out += C.interaction_specs(p, c, ffn, m['dyn_feat_channels'],
                                   m['roi_size'])
        out += C.tower_specs(p + 'cls_fcs', c, m['num_cls_fcs'])
        out += C.tower_specs(p + 'reg_fcs', c, m['num_reg_fcs'])
        for clue in CLUES[:m['num_queries']]:
            out += C.linear_specs(f'{p}{clue}_fc_cls', c, 1)
            out += C.linear_specs(f'{p}{clue}_fc_reg', c, 4)
    for s in range(m['num_stages']):
        p = f'roi_head.gaze_head.{s}.'
        for clue in CLUES:
            out += C.tower_specs(f'{p}gaze_{clue}_fcs', c, 2)
            out += C.tower_specs(f'{p}gaze_{clue}_confidence', c, 2)
            out += C.linear_specs(f'{p}fc_{clue}', c, 3)
            out += C.linear_specs(f'{p}fc_{clue}_confidence', c, 3)
        out += C.linear_specs(p + 'fc_gaze', 9, 3)
    return out


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def gaze_head(obj, p, s, prec):
    """obj (N, 3, C) -> {fusion, face, eyes, head} unit vectors (N, 3),
    and raw_norm (N, 4): each vector's length before it was normalised, in
    GAZE_NAMES order."""
    pre = f'roi_head.gaze_head.{s}.'
    gazes, confs = [], []
    for i, clue in enumerate(CLUES):
        g = C.tower(obj[:, i], p, f'{pre}gaze_{clue}_fcs', prec, 2)
        gazes.append(C.linear(g, p, f'{pre}fc_{clue}', prec))
        f = C.tower(obj[:, i].detach(), p, f'{pre}gaze_{clue}_confidence',
                    prec, 2)
        confs.append(C.linear(f, p, f'{pre}fc_{clue}_confidence', prec))
    fused = C.linear(torch.cat([cf * g for cf, g in zip(confs, gazes)], -1),
                     p, pre + 'fc_gaze', prec)
    raw = dict(fusion=fused, face=gazes[0], eyes=gazes[1], head=gazes[2])
    out = {k: _unit(v) for k, v in raw.items()}
    out['raw_norm'] = torch.stack([torch.linalg.norm(raw[k], dim=-1)
                                   for k in GAZE_NAMES], -1)
    return out


def heads(feats, whwh, p, m, prec, t, frame_idx=None):
    """The refinement stages over a pyramid; whwh (N, 4) a slot. Returns a
    list of dict(logits (N, Q), boxes (N, Q, 4), gaze) a stage."""
    n = whwh.shape[0]
    q, c = m['num_queries'], m['channels']
    boxes = C.proposals(p, whwh)
    query = p['rpn_head.init_proposal_features.weight'][None].expand(n, q, c)
    stages = []
    for s in range(m['num_stages']):
        pre = f'roi_head.bbox_head.{s}.'
        rois = boxes.detach()
        roi_feat = C.roi_align(feats, rois, frame_idx, m['roi_size'],
                               m['sampling_ratio'], m['strides'],
                               m['finest_scale'])
        roi_feat = roi_feat.reshape(n * q, m['roi_size'], m['roi_size'], c)
        obj, _ = C.interaction(query, roi_feat, p, pre, prec, t,
                               m['num_heads'], m['dyn_feat_channels'])
        cls_feat = C.tower(obj, p, pre + 'cls_fcs', prec,
                           m['num_cls_fcs']).reshape(n, q, c)
        reg_feat = C.tower(obj, p, pre + 'reg_fcs', prec,
                           m['num_reg_fcs']).reshape(n, q, c)
        clues = CLUES[:q]
        logits = torch.cat([C.linear(cls_feat[:, i], p,
                                     f'{pre}{clue}_fc_cls', prec)
                            for i, clue in enumerate(clues)], -1)
        deltas = torch.stack([C.linear(reg_feat[:, i], p,
                                       f'{pre}{clue}_fc_reg', prec)
                              for i, clue in enumerate(clues)], 1)
        boxes = C.delta2bbox(rois, deltas)
        obj = obj.reshape(n, q, c)
        stages.append(dict(logits=logits, boxes=boxes,
                           gaze=gaze_head(obj, p, s, prec)))
        query = obj
    return stages


@torch.no_grad()
def eval_forward(p, m, frames_u8, whwh_u, sel, t, prec):
    """The deduplicated eval forward: frames (U, H, W, 3) uint8, whwh_u
    (U, 4), sel (N,) slot -> frame. Returns (N, 31) f32 rows: the program's
    packed 27 (boxes 12, scores 3, gazes eyes, face, fusion, head 3 each),
    then the four gazes' lengths before normalising."""
    feats = C.features(frames_u8, whwh_u, p, prec)
    sel = sel.long()
    last = heads(feats, whwh_u[sel], p, m, prec, t, sel)[-1]
    n = sel.shape[0]
    return torch.cat([last['boxes'].reshape(n, 12),
                      torch.sigmoid(last['logits'])]
                     + [last['gaze'][k] for k in GAZE_NAMES]
                     + [last['gaze']['raw_norm']], 1)


# ------------------------------------------------------------------ train

def _giou(a, b, eps=1e-7):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = (area_a + area_b - inter).clamp_min(eps)
    enc = (torch.maximum(a[..., 2:], b[..., 2:])
           - torch.minimum(a[..., :2], b[..., :2])).clamp_min(0.0)
    enc_area = (enc[..., 0] * enc[..., 1]).clamp_min(eps)
    return inter / union - (enc_area - union) / enc_area


def _focal(logits, t, gamma, alpha):
    prob = torch.sigmoid(logits)
    pt = (1 - prob) * t + prob * (1 - t)
    weight = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    bce = F.relu(logits) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    return (bce * weight).sum()


def _arccos(pred, target, weight, eps=1e-6):
    denom = (torch.linalg.norm(pred, dim=-1)
             * torch.linalg.norm(target, dim=-1)).clamp_min(eps)
    sim = ((pred * target).sum(-1) / denom).clamp(-1 + eps, 1 - eps)
    return (torch.arccos(sim) * weight).sum()


def _temporal(pred):
    first = (2 * pred[:, 0] - 2 * pred[:, 1]).abs().sum(-1)
    last = (2 * pred[:, -1] - 2 * pred[:, -2]).abs().sum(-1)
    mid = (2 * pred[:, 1:-1] - pred[:, 2:] - pred[:, :-2]).abs().sum(-1)
    return torch.cat([first[:, None], mid, last[:, None]], 1).sum()


def loss(p, m, batch, prec):
    """The deep-supervision loss of one batch (imgs (B, T, H, W, 3) uint8,
    img_whwh (B, T, 4), gt_boxes (B, T, 3, 4), gt_valid (B, T, 3),
    gt_gazes (B, T, 3, 3)): every stage's focal, L1, GIoU, per-clue arccos,
    fusion arccos against the head's gaze and temporal terms, summed."""
    lw = m['loss_weights']
    b, t = batch['imgs'].shape[:2]
    n = b * t
    imgs = batch['imgs'].reshape(n, *batch['imgs'].shape[2:])
    whwh = batch['img_whwh'].reshape(n, 4).float()
    gt = batch['gt_boxes'].reshape(n, 3, 4).float()
    valid = batch['gt_valid'].reshape(n, 3).float()
    gaze_t = batch['gt_gazes'].reshape(n, 3, 3).float()
    feats = C.features(imgs, whwh, p, prec)
    stages = heads(feats, whwh, p, m, prec, t)
    pos = valid.sum(0).clamp_min(1.0)
    total = 0.0
    for st in stages:
        for qi in range(3):
            v = valid[:, qi]
            total = total + lw['cls'] * _focal(
                st['logits'][:, qi], v, m['focal_gamma'],
                m['focal_alpha']) / pos[qi]
            total = total + lw['bbox'] * ((st['boxes'][:, qi] / whwh
                                           - gt[:, qi] / whwh).abs()
                                          * v[:, None]).sum() / pos[qi]
            total = total + lw['iou'] * ((1 - _giou(st['boxes'][:, qi],
                                                    gt[:, qi])) * v
                                         ).sum() / pos[qi]
        for qi, clue in enumerate(CLUES):
            total = total + lw['gaze'] * _arccos(
                st['gaze'][clue], gaze_t[:, qi], valid[:, qi]) / pos[qi]
        total = total + lw['gaze'] * _arccos(
            st['gaze']['fusion'], gaze_t[:, 2], valid[:, 2]) / pos[2]
        total = total + lw['temporal'] * _temporal(
            st['gaze']['fusion'].reshape(b, t, 3)) / n
    return total


def param_group(name: str) -> str:
    """'frozen' (stem and layer1), 'backbone' or 'head'."""
    if name.startswith(('backbone.conv1.', 'backbone.bn1.',
                        'backbone.layer1.')):
        return 'frozen'
    return 'backbone' if name.startswith('backbone.') else 'head'


def is_leaf(name: str) -> bool:
    """A parameter, not a BatchNorm statistic."""
    return not name.endswith(('running_mean', 'running_var'))


def warmup_lr(o: dict, step: int) -> float:
    """mmcv's step schedule with linear warmup from warmup_ratio."""
    lr = o['lr'] * o['lr_gamma'] ** sum(step >= s for s in o['lr_steps'])
    if step < o['warmup_iters']:
        lr *= 1 - (1 - step / o['warmup_iters']) * (1 - o['warmup_ratio'])
    return lr


def train_steps(p0, m, o, batches, prec):
    """Steps of AdamW from the state dict p0 over `batches`: every
    trainable leaf's gradient (a leaf autograd leaves without one counts
    0), clipped by the global norm, lr warmed up, backbone at lr x0.1.
    Returns (losses, {leaf: first clipped gradient's norm}, {leaf: norm
    of its change after the last step})."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    live = [k for k in p if is_leaf(k) and param_group(k) != 'frozen']
    for k in live:
        p[k].requires_grad_(True)
    groups = [dict(params=[p[k] for k in live if param_group(k) == g],
                   lr_mult=mult)
              for g, mult in (('backbone', o['backbone_lr_mult']),
                              ('head', 1.0))]
    opt = torch.optim.AdamW(groups, lr=o['lr'], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=o['weight_decay'],
                            foreach=False)
    losses, first = [], None
    for step, batch in enumerate(batches):
        for k in live:
            p[k].grad = None
        value = loss(p, m, batch, prec)
        value.backward()
        losses.append(float(value.detach()))
        for k in live:
            if p[k].grad is None:
                p[k].grad = torch.zeros_like(p[k])
        norm = torch.sqrt(sum(p[k].grad.double().pow(2).sum() for k in live))
        factor = 1.0 if norm < o['grad_clip_norm'] else \
            o['grad_clip_norm'] / float(norm)
        for k in live:
            p[k].grad.mul_(factor)
        if step == 0:
            first = {k: float(p[k].grad.double().norm()) for k in live}
        lr = warmup_lr(o, step)
        for g in opt.param_groups:
            g['lr'] = lr * g['lr_mult']
        opt.step()
    change = {k: float((p[k].detach() - p0[k]).double().norm()) for k in live}
    return losses, first, change


def median(values) -> float:
    return float(np.median(np.asarray(list(values), np.float64)))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> tuple:
    """Per leaf, |prog norm - ref norm| over max(ref norm, the median
    leaf's ref norm); over `keep` when given. Returns (the worst gap, its
    leaf, the median leaf's gap)."""
    names = [k for k in ref if keep is None or k in keep]
    floor = median(ref[k] for k in names)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            for k in names}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, median(gaps.values())


def moved_leaves(first: dict) -> set:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's."""
    floor = 1e-3 * median(first.values())
    return {k for k, v in first.items() if v >= floor}


def angle_deg(a, b):
    """Degrees between vectors (..., 3), in float64."""
    a, b = a.double(), b.double()
    cross = torch.linalg.norm(torch.cross(a, b, dim=-1), dim=-1)
    return torch.rad2deg(torch.atan2(cross, (a * b).sum(-1)))


def eval_gaps(prog: torch.Tensor, ref: torch.Tensor, size: float) -> dict:
    """Packed rows of the program and the reference -> per output, the gap
    of each (slot, clue): box (its largest coordinate gap over the image
    size, and over the reference box's longer side), score, gaze angle
    (degrees, the four gaze outputs; as `gaze_raw`, in radians times the
    reference vector's length before normalising, which takes out the
    amplification of a vector normalised from near zero). Returns the
    flat gaps of each (entries/common.py::worst reduces them)."""
    n = prog.shape[0]
    gap = (prog[:, :12] - ref[:, :12]).abs().reshape(n, 3, 4).amax(-1)
    rb = ref[:, :12].reshape(n, 3, 4)
    side = torch.maximum(rb[..., 2] - rb[..., 0], rb[..., 3] - rb[..., 1])
    score = (prog[:, 12:15] - ref[:, 12:15]).abs()
    gaze = angle_deg(prog[:, 15:27].reshape(n, 4, 3),
                     ref[:, 15:27].reshape(n, 4, 3))
    return dict(box=(gap / size).flatten(),
                box_rel=(gap / side.abs().clamp_min(1.0)).flatten(),
                score=score.flatten(), gaze_deg=gaze.flatten(),
                gaze_raw=(torch.deg2rad(gaze) * ref[:, 27:31]).flatten())
