"""The TeViT / InstBlink query detector, counterpart of
mcgaze_tpu/models/query_detector.py:

    frames (N, H, W, 3) -> ResNet-50 (InstBlink) or MsgShifT (TeViT)
      -> FPN -> 100 learned proposals
      -> num_stages x [FPN RoIAlign -> GenericSTQIHead -> delta decode
                       -> BlinkHead on the post-attention feature]

The stage head is the gaze STQIHead's spatio-temporal interaction with the
generic heads (one fc_cls -> num_classes, one fc_reg -> 4). The blink head
is a chained 2x(Linear-LN-ReLU) tower and fc_blink; with
`blink_reference_semantics` it computes the reference's shipped
fc_blink(ReLU(x)) and leaves the tower unused (the tower stays declared, so
one state dict loads either way). The state dict's keys are the reference
mmdet names (backbone.*, neck.*, rpn_head.*, roi_head.bbox_head.{s}.*,
roi_head.blink_head.{s}.blink_fcs.{0,1,3,4}, fc_blink). MsgShifT's DropPath
runs only in a forward given train=True and a torch.Generator for its
masks (models/msgshift.py).

RoIAlign: roi_impl 'auto' launches the CUDA kernel on a CUDA device (its
gradient is the backward kernel) and takes the plain version on the CPU;
'mm' takes the plain version everywhere (ops/roi_align_cuda.py).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry import bbox_cxcywh_to_xyxy, delta2bbox
from ..ops.roi_align import roi_align_fpn_mm
from ..ops.roi_align_cuda import roi_align_fpn
from ..utils.env import resolve_device
from ..utils.profiling import span
from .fpn import FPN
from .heads import _FFN, DynamicConv, MultiheadAttention, mlp_tower
from .layers import LayerNorm, Linear, cast_param, init_weights
from .mcgaze import DTYPES, _RPNHead
from .msgshift import MsgShifT
from .resnet import ResNet

RESNET50_CHANNELS = (256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class QueryDetectorConfig:
    """The JAX QueryDetectorConfig's fields, with the same defaults (the
    InstBlink R-50 model on MPEblink and its losses and matcher)."""
    backbone: str = 'resnet50'           # 'resnet50' | 'msgshift'
    num_stages: int = 6
    clip_length: int = 11
    num_queries: int = 100
    num_classes: int = 1
    channels: int = 256
    ffn_channels: int = 2048
    num_heads: int = 8
    dyn_feat_channels: int = 64
    num_cls_fcs: int = 1
    num_reg_fcs: int = 3
    roi_size: int = 7
    sampling_ratio: int = 2
    strides: Tuple[int, ...] = (4, 8, 16, 32)
    finest_scale: float = 56.0
    with_blink: bool = True
    # True: the reference's shipped blink computation fc_blink(ReLU(x))
    blink_reference_semantics: bool = False
    max_per_img: int = 10
    dtype: str = 'float32'
    roi_impl: str = 'auto'
    msg_num_tokens: int = 32
    msg_shift_strides: Tuple[int, ...] = (1, -1, 2, -2)
    msg_drop_path_rate: float = 0.1
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 5.0
    loss_iou_weight: float = 2.0
    loss_blink_weight: float = 5.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    match_cls_weight: float = 2.0
    match_l1_weight: float = 5.0
    match_iou_weight: float = 2.0
    max_instances: int = 8

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


class GenericSTQIHead(nn.Module):
    """One refinement stage: shared attention over the queries of a frame,
    then over the frames of each query, DynamicConv, FFN, towers and the
    generic cls/reg heads."""

    def __init__(self, channels=256, num_heads=8, ffn_channels=2048,
                 feat_channels=64, roi_size=7, num_classes=1, num_cls_fcs=1,
                 num_reg_fcs=3):
        super().__init__()
        self.num_classes = num_classes
        self.attention = MultiheadAttention(channels, num_heads)
        self.attention_norm = LayerNorm(channels)
        self.instance_interactive_conv = DynamicConv(channels, feat_channels,
                                                     roi_size)
        self.instance_interactive_conv_norm = LayerNorm(channels)
        self.ffn = _FFN(channels, ffn_channels)
        self.ffn_norm = LayerNorm(channels)
        self.cls_fcs = mlp_tower(channels, num_cls_fcs)
        self.reg_fcs = mlp_tower(channels, num_reg_fcs)
        self.fc_cls = Linear(channels, num_classes)
        self.fc_reg = Linear(channels, 4)

    def forward(self, roi_feat, query, clip_length: int):
        """roi_feat (N*Q, S, S, C); query (N, Q, C), N = B*T. Returns
        (cls_logits (N, Q, num_classes), deltas (N, Q, 4), obj (N, Q, C),
        attn_feat (N, Q, C)): attn_feat is the post-attention feature the
        blink head reads."""
        n, nq, c = query.shape
        t = clip_length
        b = n // t
        q = self.attention_norm(self.attention(query))
        q = q.reshape(b, t, nq, c).transpose(1, 2).reshape(b * nq, t, c)
        q = self.attention_norm(self.attention(q))
        q = q.reshape(b, nq, t, c).transpose(1, 2).reshape(n, nq, c)
        attn_feat = q

        flat_q = q.reshape(n * nq, c)
        iic = self.instance_interactive_conv(flat_q, roi_feat)
        obj = self.instance_interactive_conv_norm(flat_q + iic)
        obj = self.ffn_norm(obj + self.ffn(obj))

        cls_logits = self.fc_cls(self.cls_fcs(obj)).reshape(
            n, nq, self.num_classes)
        deltas = self.fc_reg(self.reg_fcs(obj)).reshape(n, nq, 4)
        return cls_logits, deltas, obj.reshape(n, nq, c), attn_feat


class BlinkHead(nn.Module):
    """Per-query blink logit: 2x(Linear-no-bias, LN, ReLU) then fc_blink.
    reference_semantics=True computes fc_blink(ReLU(x)), the tower unused."""

    def __init__(self, channels=256, reference_semantics=False):
        super().__init__()
        self.reference_semantics = reference_semantics
        self.blink_fcs = mlp_tower(channels, 2)
        self.fc_blink = Linear(channels, 1)

    def forward(self, feat):
        """feat (..., C) -> blink logits (...,)."""
        x = F.relu(feat) if self.reference_semantics else self.blink_fcs(feat)
        return self.fc_blink(x)[..., 0]


class _QueryRoIHead(nn.Module):
    def __init__(self, cfg: QueryDetectorConfig):
        super().__init__()
        self.bbox_head = nn.ModuleList(
            GenericSTQIHead(cfg.channels, cfg.num_heads, cfg.ffn_channels,
                            cfg.dyn_feat_channels, cfg.roi_size,
                            cfg.num_classes, cfg.num_cls_fcs,
                            cfg.num_reg_fcs)
            for _ in range(cfg.num_stages))
        if cfg.with_blink:
            self.blink_head = nn.ModuleList(
                BlinkHead(cfg.channels, cfg.blink_reference_semantics)
                for _ in range(cfg.num_stages))


class QueryDetector(nn.Module):
    """Per-stage predictions over B clips of T frames; eval reads the
    last stage."""

    def __init__(self, cfg: QueryDetectorConfig):
        super().__init__()
        if cfg.roi_impl not in ('auto', 'mm'):
            raise ValueError(f"roi_impl={cfg.roi_impl!r}: 'auto' or 'mm'")
        self.cfg = cfg
        if cfg.backbone == 'msgshift':
            self.backbone = MsgShifT(num_msg_tokens=cfg.msg_num_tokens,
                                     shift_strides=cfg.msg_shift_strides,
                                     drop_path_rate=cfg.msg_drop_path_rate)
            widths = self.backbone.stage_channels
        elif cfg.backbone == 'resnet50':
            self.backbone = ResNet(50)
            widths = RESNET50_CHANNELS
        else:
            raise ValueError(f'backbone={cfg.backbone!r}: '
                             "'resnet50' or 'msgshift'")
        self.neck = FPN(in_channels=widths, out_channels=cfg.channels)
        self.rpn_head = _RPNHead(cfg.num_queries, cfg.channels)
        self.roi_head = _QueryRoIHead(cfg)

    def extract_features(self, imgs: torch.Tensor,
                         clip_length: int | None = None, train: bool = False,
                         generator: torch.Generator | None = None,
                         normalize=None) -> tuple:
        """(N, H, W, 3) normalised NHWC frames -> 4 NHWC FPN levels.
        MsgShifT rolls its messengers over clips of clip_length frames;
        train=True turns its DropPath on, drawing from `generator`.
        normalize: as MCGazeModel.extract_features."""
        drop = train and self.cfg.msg_drop_path_rate > 0.0
        if self.cfg.backbone == 'msgshift' and drop and generator is None:
            raise ValueError('MsgShifT DropPath (train=True) needs a '
                             'torch.Generator for its masks')
        with span('mcgaze.backbone'):
            if normalize is not None:
                with span('mcgaze.device_normalize'):
                    imgs = normalize(imgs)
            x = imgs.to(self.cfg.torch_dtype).permute(0, 3, 1, 2)
            if self.cfg.backbone != 'msgshift':
                levels = self.backbone(x)
            else:
                levels = self.backbone(x, clip_length or self.cfg.clip_length,
                                       generator if drop else None)
        with span('mcgaze.fpn'):
            return self.neck(levels)

    def run_heads(self, feats: tuple, img_whwh: torch.Tensor,
                  clip_length: int | None = None) -> dict:
        cfg = self.cfg
        t = clip_length or cfg.clip_length
        dtype = cfg.torch_dtype
        n = img_whwh.shape[0]
        q = cfg.num_queries
        roi_align = roi_align_fpn if cfg.roi_impl == 'auto' \
            else roi_align_fpn_mm

        with span('mcgaze.heads'):
            boxes = (bbox_cxcywh_to_xyxy(
                self.rpn_head.init_proposal_bboxes.weight)[None]
                * img_whwh[:, None, :])
            query = cast_param(self.rpn_head.init_proposal_features.weight,
                               dtype)[None].expand(n, q, cfg.channels)

            stages = []
            for stage in range(cfg.num_stages):
                with span('mcgaze.heads.stage', stage):
                    # boxes are fed forward detached between stages
                    # (instblink_roi_head.py:142)
                    rois = boxes.detach().to(torch.float32).contiguous()
                    roi_feat = roi_align(feats, rois, None, cfg.roi_size,
                                         cfg.sampling_ratio, cfg.strides,
                                         cfg.finest_scale)
                    roi_feat = roi_feat.reshape(n * q, cfg.roi_size,
                                                cfg.roi_size, cfg.channels)
                    cls_logits, deltas, obj, attn_feat = \
                        self.roi_head.bbox_head[stage](roi_feat, query, t)
                    boxes = delta2bbox(rois, deltas.to(torch.float32))
                    out = dict(cls_logits=cls_logits.to(torch.float32),
                               boxes=boxes)
                    if cfg.with_blink:
                        out['blink_logits'] = self.roi_head.blink_head[
                            stage](attn_feat).to(torch.float32)
                    stages.append(out)
                    query = obj
        return dict(stages=stages)

    def forward(self, imgs: torch.Tensor, img_whwh: torch.Tensor,
                clip_length: int | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """imgs (N, H, W, 3) normalised, N = B*T; img_whwh (N, 4). Returns
        {'stages': [dict(cls_logits (N, Q, C), boxes (N, Q, 4) absolute
        xyxy, blink_logits (N, Q) when with_blink)]}. train and generator:
        MsgShifT's DropPath (extract_features)."""
        return self.run_heads(
            self.extract_features(imgs, clip_length, train, generator),
            img_whwh, clip_length)


def _topk(scores: torch.Tensor, k: int):
    """lax.top_k over the last axis: the k largest, ties to the lower
    index. A stable descending sort keeps equal scores in index order,
    which torch.topk does not promise."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def topk_tracks(stage_out: dict, clip_length: int, max_per_img: int,
                num_classes: int) -> dict:
    """Test-time track selection of one clip (instblink_roi_head.py:
    351-383): sigmoid scores averaged over the T frames, the top k of the
    flattened (query, class) scores. stage_out has leading dim N = T.
    Returns dict(scores (K,), labels (K,), boxes (T, K, 4), query_idx (K,),
    blink (T, K) when present)."""
    cls = torch.sigmoid(stage_out['cls_logits'])
    mean_scores = cls.reshape(clip_length, -1).mean(0)
    scores, flat_idx = _topk(mean_scores, max_per_img)
    qi = flat_idx // num_classes
    out = dict(scores=scores, labels=flat_idx % num_classes,
               boxes=stage_out['boxes'][:, qi], query_idx=qi)
    if 'blink_logits' in stage_out:
        out['blink'] = torch.sigmoid(stage_out['blink_logits'][:, qi])
    return out


def topk_tracks_batched(stage_out: dict, b: int, clip_length: int,
                        max_per_img: int, num_classes: int) -> dict:
    """topk_tracks over b clips at once (leading dim N = b*T). Returns
    dict(scores (b, K), labels (b, K), boxes (b, T, K, 4), query_idx
    (b, K), blink (b, T, K) when present)."""
    t, k = clip_length, max_per_img
    cls = torch.sigmoid(stage_out['cls_logits'])
    q = cls.shape[1]
    mean_scores = cls.reshape(b, t, q * num_classes).mean(1)
    scores, flat_idx = _topk(mean_scores, k)
    qi = flat_idx // num_classes
    boxes = stage_out['boxes'].reshape(b, t, q, 4)
    boxes = torch.gather(boxes, 2, qi[:, None, :, None].expand(b, t, k, 4))
    out = dict(scores=scores, labels=flat_idx % num_classes, boxes=boxes,
               query_idx=qi)
    if 'blink_logits' in stage_out:
        blink = torch.sigmoid(stage_out['blink_logits']).reshape(b, t, q)
        out['blink'] = torch.gather(blink, 2, qi[:, None, :].expand(b, t, k))
    return out


def init_query_model(cfg: QueryDetectorConfig, seed: int = 0,
                     device: str | torch.device = 'cuda') -> QueryDetector:
    """A model with seeded random weights (flax's default init scales:
    lecun-normal kernels, zero biases, N(0, 1) proposal features, whole-
    image proposal boxes), in eval mode on `device`. Drawn on the CPU from
    a torch.Generator, so a seed gives the same weights on every device."""
    device = resolve_device(device)
    model = QueryDetector(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        model.rpn_head.init_proposal_bboxes.weight.copy_(
            torch.tensor([0.5, 0.5, 1.0, 1.0]).expand(cfg.num_queries, 4))
        model.rpn_head.init_proposal_features.weight.normal_(
            0.0, 1.0, generator=gen)
        if cfg.backbone == 'msgshift':
            # flax's truncated_normal(0.02) of the JAX MsgShifT
            nn.init.trunc_normal_(model.backbone.msg_tokens, std=0.02,
                                  a=-0.04, b=0.04, generator=gen)
    return model.to(device).eval()
