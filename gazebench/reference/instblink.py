"""Plain reference of InstBlink (Zeng et al., CVPR 2023, "Real-time
Multi-person Eyeblink Detection in the Wild for Untrimmed Video"; the
MPEblink release's instblink_roi_head.py and blink_head.py) at
configs/instblink/instblink_r50_mpeblink.py's sizes, in f32 plain PyTorch
over a state dict of the reference names.

    frames -> ResNet-50 (frozen BN) -> FPN -> 100 learned proposals
    -> 6 x [FPN RoIAlign -> STQI interaction -> cls tower + fc_cls,
            reg tower + fc_reg -> box decode; blink tower + fc_blink on
            the post-attention feature]
    -> per clip: sigmoid scores averaged over its frames, the top k
       (query, class) pairs, their boxes and blink probabilities

Semantics checked against the port at commit 8553edb; no code of it is
imported.
"""
from __future__ import annotations

import torch

from . import common as C


def param_specs(m: dict):
    c, ffn = m['channels'], m['ffn_channels']
    out = C.resnet50_specs() + C.fpn_specs(c) + C.proposal_specs(
        m['num_queries'], c)
    for s in range(m['num_stages']):
        p = f'roi_head.bbox_head.{s}.'
        out += C.interaction_specs(p, c, ffn, m['dyn_feat_channels'],
                                   m['roi_size'])
        out += C.tower_specs(p + 'cls_fcs', c, m['num_cls_fcs'])
        out += C.tower_specs(p + 'reg_fcs', c, m['num_reg_fcs'])
        out += C.linear_specs(p + 'fc_cls', c, m['num_classes'])
        out += C.linear_specs(p + 'fc_reg', c, 4)
    for s in range(m['num_stages']):
        p = f'roi_head.blink_head.{s}.'
        out += C.tower_specs(p + 'blink_fcs', c, 2)
        out += C.linear_specs(p + 'fc_blink', c, 1)
    return out


@torch.no_grad()
def eval_forward(p, m, frames_u8, whwh, clips, prec):
    """frames (clips * T, H, W, 3) uint8, whwh (clips * T, 4). Returns the
    last stage over every query: mean_scores (clips, Q * classes), boxes
    (clips, T, Q, 4), blink probabilities (clips, T, Q)."""
    n = frames_u8.shape[0]
    t = n // clips
    q, c = m['num_queries'], m['channels']
    whwh = whwh.float()
    feats = C.features(frames_u8, whwh, p, prec)
    boxes = C.proposals(p, whwh)
    query = p['rpn_head.init_proposal_features.weight'][None].expand(n, q, c)
    for s in range(m['num_stages']):
        pre = f'roi_head.bbox_head.{s}.'
        rois = boxes
        roi_feat = C.roi_align(feats, rois, None, m['roi_size'],
                               m['sampling_ratio'], m['strides'],
                               m['finest_scale'])
        roi_feat = roi_feat.reshape(n * q, m['roi_size'], m['roi_size'], c)
        obj, attn_feat = C.interaction(query, roi_feat, p, pre, prec, t,
                                       m['num_heads'],
                                       m['dyn_feat_channels'])
        logits = C.linear(C.tower(obj, p, pre + 'cls_fcs', prec,
                                  m['num_cls_fcs']), p, pre + 'fc_cls',
                          prec).reshape(n, q, m['num_classes'])
        deltas = C.linear(C.tower(obj, p, pre + 'reg_fcs', prec,
                                  m['num_reg_fcs']), p, pre + 'fc_reg',
                          prec).reshape(n, q, 4)
        boxes = C.delta2bbox(rois, deltas)
        bp = f'roi_head.blink_head.{s}.'
        blink = C.linear(C.tower(attn_feat, p, bp + 'blink_fcs', prec, 2), p,
                         bp + 'fc_blink', prec)[..., 0]
        query = obj.reshape(n, q, c)
    scores = torch.sigmoid(logits).reshape(clips, t, -1).mean(1)
    return dict(mean_scores=scores, boxes=boxes.reshape(clips, t, q, 4),
                blink=torch.sigmoid(blink).reshape(clips, t, q))


def topk_gaps(prog: dict, ref: dict, classes: int, size: float) -> dict:
    """The program's top-k tracks against the reference's whole last stage,
    judged at the queries the program chose: `rank`, by how much the
    reference's score of the program's choice at rank j lies below the
    reference's j-th best; `score`, |program score - reference score of
    that choice|; `box` (largest coordinate, in image sizes and, as
    `box_rel`, in the reference box's longer side) and `blink`
    (probability) at those queries. Flat gaps (entries/common.py::worst
    reduces them)."""
    ms = ref['mean_scores']
    best = torch.sort(ms, dim=-1, descending=True).values
    k = prog['scores'].shape[-1]
    flat = prog['query_idx'].long() * classes + prog['labels'].long()
    chosen = torch.gather(ms, 1, flat)
    qi = prog['query_idx'].long()
    b, t = ref['boxes'].shape[:2]
    rb = torch.gather(ref['boxes'], 2, qi[:, None, :, None].expand(b, t, k, 4))
    rl = torch.gather(ref['blink'], 2, qi[:, None, :].expand(b, t, k))
    gap = (prog['boxes'] - rb).abs().amax(-1)
    side = torch.maximum(rb[..., 2] - rb[..., 0], rb[..., 3] - rb[..., 1])
    return dict(rank=(best[:, :k] - chosen).clamp_min(0).flatten(),
                score=(prog['scores'] - chosen).abs().flatten(),
                box=(gap / size).flatten(),
                box_rel=(gap / side.abs().clamp_min(1.0)).flatten(),
                blink=(prog['blink'] - rl).abs().flatten())
