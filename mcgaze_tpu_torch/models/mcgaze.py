"""MCGaze, counterpart of mcgaze_tpu/models/mcgaze.py:

    frames (N, H, W, 3) -> ResNet -> FPN -> 3 learned proposals
      -> num_stages x [FPN RoIAlign -> STQIHead -> delta decode -> GazeHead]

`extract_features` (per-frame backbone + FPN) and `run_heads` (the query
stages) are split, so the eval driver computes the pyramid once per unique
frame and maps each clip slot to its frame through `frame_idx`. The state
dict's keys are the reference mmdet names (backbone.*, neck.*, rpn_head.*,
roi_head.bbox_head.{s}.*, roi_head.gaze_head.{s}.*).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..geometry import bbox_cxcywh_to_xyxy, delta2bbox
from ..ops.roi_align import roi_align_fpn_mm
from ..ops.roi_align_cuda import roi_align_fpn
from ..utils.env import resolve_device
from ..utils.profiling import span
from .fpn import FPN
from .heads import GazeHead, STQIHead
from .layers import cast_param, init_weights
from .resnet import ResNet

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX ModelConfig's fields, with the same defaults (the
    full-width gaze360 R50 model and its losses)."""
    backbone_depth: int = 50
    num_stages: int = 4
    clip_length: int = 7
    num_queries: int = 3
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
    gaze_dim: int = 3
    dtype: str = 'float32'
    # each stage's two attention passes and their LNs in one call
    # (ops/stqi_attention.py, the CUDA kernel on a card); forward only on
    # a card, same state dict
    fused_attention: bool = False
    batched_clue_heads: bool = False
    # 'auto': the CUDA kernel on a CUDA device, the plain version on the
    # CPU (ops/roi_align_cuda.py::roi_align_fpn); 'mm': the plain version
    # everywhere (the kernel's reference)
    roi_impl: str = 'auto'
    # 'plain': cuDNN convolutions with unfused FrozenBN; 'fused': every
    # stride-1 bottleneck through the fused chain (ops/fused_bottleneck.py,
    # the CUDA kernel on a card); same state dict
    backbone_impl: str = 'plain'
    # loss weights (configs/multiclue_gaze/multiclue_gaze_r50_gaze360.py)
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 5.0
    loss_iou_weight: float = 2.0
    loss_gaze_weight: float = 6.0
    loss_temp_weight: float = 1.0
    # per-clue gaze loss: 'arccos' (shipped configs) | 'cos' | 'pinball'
    # (ops/losses.py::GAZE_LOSSES)
    gaze_loss_type: str = 'arccos'
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    stage_loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


class _RPNHead(nn.Module):
    """FixedEmbeddingRPNHead: learned boxes (normalised cxcywh, init = the
    whole image) and learned query features."""

    def __init__(self, num_queries: int, channels: int):
        super().__init__()
        self.init_proposal_bboxes = nn.Embedding(num_queries, 4)
        self.init_proposal_features = nn.Embedding(num_queries, channels)


class _RoIHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.bbox_head = nn.ModuleList(
            STQIHead(cfg.channels, cfg.num_heads, cfg.ffn_channels,
                     cfg.dyn_feat_channels, cfg.roi_size, cfg.num_queries,
                     cfg.num_cls_fcs, cfg.num_reg_fcs, cfg.fused_attention,
                     cfg.batched_clue_heads)
            for _ in range(cfg.num_stages))
        self.gaze_head = nn.ModuleList(
            GazeHead(cfg.channels, cfg.gaze_dim, cfg.batched_clue_heads)
            for _ in range(cfg.num_stages))


class MCGazeModel(nn.Module):
    """Per-stage predictions; eval reads the last stage."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone_impl not in ('plain', 'fused'):
            raise ValueError(f'backbone_impl={cfg.backbone_impl!r}: '
                             "'plain' or 'fused'")
        if cfg.roi_impl not in ('auto', 'mm'):
            raise ValueError(f"roi_impl={cfg.roi_impl!r}: 'auto' or 'mm'")
        self.cfg = cfg
        self.backbone = ResNet(cfg.backbone_depth,
                               fused_blocks=cfg.backbone_impl == 'fused')
        self.neck = FPN(out_channels=cfg.channels)
        self.rpn_head = _RPNHead(cfg.num_queries, cfg.channels)
        self.roi_head = _RoIHead(cfg)

    def extract_features(self, imgs: torch.Tensor, normalize=None) -> tuple:
        """(N, H, W, 3) normalised NHWC frames -> 4 NHWC-contiguous FPN
        levels. The backbone runs channels_last: the NCHW view of an NHWC
        tensor already is. normalize: a function the frames go through
        first, inside the backbone's span (the eval forwards' u8
        normalisation on the device)."""
        with span('mcgaze.backbone'):
            if normalize is not None:
                with span('mcgaze.device_normalize'):
                    imgs = normalize(imgs)
            x = imgs.to(self.cfg.torch_dtype).permute(0, 3, 1, 2)
            levels = self.backbone(x)
        with span('mcgaze.fpn'):
            return self.neck(levels)

    def run_heads(self, feats: tuple, img_whwh: torch.Tensor,
                  clip_length: int | None = None,
                  frame_idx: torch.Tensor | None = None) -> dict:
        """Query stages over a pyramid. img_whwh (N, 4) per slot; feats
        hold N frames, or U unique frames and frame_idx (N,) int32 maps
        each slot to its frame."""
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
                    # (detach_proposal_list, multiclue_gaze_roi_head.py:134)
                    rois = boxes.detach().to(torch.float32).contiguous()
                    roi_feat = roi_align(feats, rois, frame_idx,
                                         cfg.roi_size, cfg.sampling_ratio,
                                         cfg.strides, cfg.finest_scale)
                    roi_feat = roi_feat.reshape(n * q, cfg.roi_size,
                                                cfg.roi_size, cfg.channels)
                    cls_logits, deltas, obj = self.roi_head.bbox_head[stage](
                        roi_feat, query, t)
                    boxes = delta2bbox(rois, deltas.to(torch.float32))
                    gaze = self.roi_head.gaze_head[stage](obj)
                    stages.append(dict(
                        cls_logits=cls_logits.to(torch.float32), boxes=boxes,
                        gaze={k: v.to(torch.float32)
                              for k, v in gaze.items()}))
                    query = obj
        return dict(stages=stages)

    def forward(self, imgs: torch.Tensor, img_whwh: torch.Tensor,
                clip_length: int | None = None) -> dict:
        """imgs (N, H, W, 3) normalised, N = B*T; img_whwh (N, 4) [w, h,
        w, h] of each frame's un-padded shape. Returns {'stages': [dict(
        cls_logits (N,Q,1), boxes (N,Q,4) xyxy, gaze {fusion, face, eyes,
        head} -> (N,3) unit vectors)]}."""
        return self.run_heads(self.extract_features(imgs), img_whwh,
                              clip_length)


def init_model(cfg: ModelConfig, seed: int = 0,
               device: str | torch.device = 'cuda') -> MCGazeModel:
    """A model with seeded random weights (flax's default init scales),
    in eval mode on `device`. The weights are drawn on the CPU from a
    torch.Generator, so a seed gives the same weights on every device."""
    device = resolve_device(device)
    model = MCGazeModel(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        model.rpn_head.init_proposal_bboxes.weight.copy_(
            torch.tensor([0.5, 0.5, 1.0, 1.0]).expand(cfg.num_queries, 4))
        model.rpn_head.init_proposal_features.weight.normal_(
            0.0, 1.0, generator=gen)
    return model.to(device).eval()
