"""YOLOv5 head detector of the demo, counterpart of
mcgaze_tpu/models/yolov5.py.

The reference demo vendors a YOLOv5 fork and runs `crowdhuman_yolov5m.pt`
for per-frame head boxes (labels `cls x1 y1 x2 y2` in original-image
pixels, class 1 = head). This module builds the network of its
`models/yolov5m.yaml` (Focus stem, C3 stages, SPP, PANet neck, a 3-level
anchor Detect head, SiLU) as torch modules under yolov5's own state dict
names (`model.{i}.conv.weight`, ..., `model.24.m.{i}.weight`), so a
CrowdHuman state dict loads with `load_yolo_weights`; plus the v4
anchor decode, class-aware NMS and the letterbox.

Layout: `YoloV5` takes NHWC frames and returns NHWC level maps, as the JAX
module does; inside, the convolutions run NCHW (channels_last). The
blocks (ConvBlock, Bottleneck, C3, SPP, Focus) take and return NCHW.

NMS keeps the JAX `nms_static` semantics (top-k by score, then greedy
suppression in score order) with a launch count that does not grow with
k: the top-k and the k x k overlap matrix of a whole batch are computed on
the device, brought to the host in one copy, and the greedy pass runs in
numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),       # P3/8
    ((30, 61), (62, 45), (59, 119)),      # P4/16
    ((116, 90), (156, 198), (373, 326)),  # P5/32
)
STRIDES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 2            # crowdhuman: 0=person, 1=head
    depth_multiple: float = 0.67    # yolov5m
    width_multiple: float = 0.75
    anchors: Tuple = DEFAULT_ANCHORS
    img_size: int = 640
    dtype: str = 'float32'

    def width(self, c: int) -> int:
        return int(math.ceil(c * self.width_multiple / 8) * 8)

    def depth(self, n: int) -> int:
        return max(round(n * self.depth_multiple), 1) if n > 1 else n


class ConvBlock(nn.Module):
    """Conv + BN + SiLU (yolov5 common.Conv)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBlock(c, c, 1)
        self.cv2 = ConvBlock(c, c, 3)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions (yolov5 common.C3)."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBlock(cin, c_, 1)
        self.cv2 = ConvBlock(cin, c_, 1)
        self.cv3 = ConvBlock(2 * c_, cout, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, shortcut) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling, kernels (5, 9, 13)."""

    def __init__(self, cin: int, cout: int, kernels: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = cin // 2
        self.cv1 = ConvBlock(cin, c_, 1)
        self.cv2 = ConvBlock(c_ * (len(kernels) + 1), cout, 1)
        self.m = nn.ModuleList(nn.MaxPool2d(k, 1, k // 2) for k in kernels)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))


class Focus(nn.Module):
    """Space-to-depth stem: 2x2 pixel de-interleave then a 3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBlock(cin * 4, cout, 3)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   1))


class _Detect(nn.Module):
    """yolov5's Detect: one 1x1 conv per level (its anchors come from the
    config, `YoloConfig.anchors`)."""

    def __init__(self, channels: Sequence[int], outputs: int):
        super().__init__()
        self.m = nn.ModuleList(nn.Conv2d(c, outputs, 1) for c in channels)


class YoloV5(nn.Module):
    """Backbone + PANet; forward(x (N, H, W, 3) f32 in [0, 1]) -> the
    three raw Detect maps, NHWC (N, H/s, W/s, na * (5 + nc))."""

    def __init__(self, cfg: YoloConfig = YoloConfig()):
        super().__init__()
        if cfg.dtype != 'float32':
            raise ValueError(f'YoloConfig.dtype={cfg.dtype!r}: the port\'s '
                             "YoloV5 runs 'float32'")
        self.cfg = cfg
        w, d = cfg.width, cfg.depth
        na, no = len(cfg.anchors[0]), cfg.num_classes + 5
        # the yaml's Upsample and Concat layers (11, 12, 15, 16, 19, 22)
        # hold no weights: forward wires them, an Identity keeps the index
        skip = nn.Identity
        layers = [
            Focus(3, w(64)),                                    # 0
            ConvBlock(w(64), w(128), 3, 2),                     # 1
            C3(w(128), w(128), d(3)),                           # 2
            ConvBlock(w(128), w(256), 3, 2),                    # 3
            C3(w(256), w(256), d(9)),                           # 4  P3
            ConvBlock(w(256), w(512), 3, 2),                    # 5
            C3(w(512), w(512), d(9)),                           # 6  P4
            ConvBlock(w(512), w(1024), 3, 2),                   # 7
            SPP(w(1024), w(1024)),                              # 8
            C3(w(1024), w(1024), d(3), False),                  # 9
            ConvBlock(w(1024), w(512), 1, 1),                   # 10
            skip(), skip(),                                     # 11, 12
            C3(w(1024), w(512), d(3), False),                   # 13
            ConvBlock(w(512), w(256), 1, 1),                    # 14
            skip(), skip(),                                     # 15, 16
            C3(w(512), w(256), d(3), False),                    # 17
            ConvBlock(w(256), w(256), 3, 2),                    # 18
            skip(),                                             # 19
            C3(w(512), w(512), d(3), False),                    # 20
            ConvBlock(w(512), w(512), 3, 2),                    # 21
            skip(),                                             # 22
            C3(w(1024), w(1024), d(3), False),                  # 23
            _Detect((w(256), w(512), w(1024)), na * no),        # 24
        ]
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        m = self.model
        x = x.permute(0, 3, 1, 2)
        x = m[2](m[1](m[0](x)))
        p3 = m[4](m[3](x))
        p4 = m[6](m[5](p3))
        x = m[9](m[8](m[7](p4)))
        t10 = m[10](x)
        x = m[13](torch.cat([_upsample2(t10), p4], 1))          # 11, 12
        t14 = m[14](x)
        o17 = m[17](torch.cat([_upsample2(t14), p3], 1))        # 15, 16
        o20 = m[20](torch.cat([m[18](o17), t14], 1))            # 19
        o23 = m[23](torch.cat([m[21](o20), t10], 1))            # 22
        return [conv(f).permute(0, 2, 3, 1)
                for conv, f in zip(m[24].m, (o17, o20, o23))]


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode='nearest')


def init_yolo(cfg: YoloConfig = YoloConfig(), seed: int = 0,
              device='cuda') -> YoloV5:
    """A YoloV5 with seeded random weights (torch's default init), in eval
    mode on `device`. The weights are drawn on the CPU."""
    from ..utils.env import resolve_device
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = YoloV5(cfg)
    return model.to(device).eval()


def load_yolo_weights(model: YoloV5, state_dict: dict) -> YoloV5:
    """A yolov5 state dict (`model.{i}.*` names, or `model.model.{i}.*`)
    into `model`, strictly. yolov5's Detect keeps its anchors as buffers
    (`model.24.anchors` in strides, `model.24.anchor_grid` in pixels); they
    are checked against the config's anchors and not loaded."""
    sd = {}
    for k, v in state_dict.items():
        sd[k[len('model.'):] if k.startswith('model.model.') else k] = v
    anchors = torch.tensor(model.cfg.anchors, dtype=torch.float32)
    grid = sd.pop('model.24.anchor_grid', None)
    scaled = sd.pop('model.24.anchors', None)
    strides = torch.tensor(STRIDES, dtype=torch.float32).view(-1, 1, 1)
    for name, value, expect in (('anchor_grid', grid, anchors),
                                ('anchors', scaled, anchors / strides)):
        if value is not None and not torch.allclose(
                value.float().cpu().reshape(expect.shape), expect):
            raise ValueError(f'model.24.{name} of the state dict does not '
                             f'match YoloConfig.anchors {model.cfg.anchors}')
    model.load_state_dict(sd, strict=True)
    return model


def decode_predictions(cfg: YoloConfig, level_maps: Sequence[torch.Tensor]):
    """Raw NHWC maps -> (N, total_anchors, 5+nc) [xc, yc, w, h, obj,
    cls...] in input-image pixels (yolov5 v4 decode: xy = (2s - 0.5 +
    grid) * stride, wh = (2s)^2 * anchor)."""
    no = cfg.num_classes + 5
    na = len(cfg.anchors[0])
    outs = []
    for li, fmap in enumerate(level_maps):
        n, h, w, _ = fmap.shape
        stride = STRIDES[li]
        p = torch.sigmoid(fmap.reshape(n, h, w, na, no).float())
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=fmap.device),
            torch.arange(w, dtype=torch.float32, device=fmap.device),
            indexing='ij')
        grid = torch.stack([gx, gy], -1)[None, :, :, None]   # (1,H,W,1,2)
        anchors = torch.tensor(cfg.anchors[li], dtype=torch.float32,
                               device=fmap.device)[None, None, None]
        xy = (p[..., :2] * 2.0 - 0.5 + grid) * stride
        wh = (p[..., 2:4] * 2.0) ** 2 * anchors
        out = torch.cat([xy, wh, p[..., 4:]], -1)
        outs.append(out.reshape(n, h * w * na, no))
    return torch.cat(outs, 1)


def nms_candidates(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
                   iou_thres: float = 0.45, max_det: int = 300):
    """The device half of NMS, batched: boxes (B, A, 4), scores (B, A) ->
    (order (B, k) candidate indices by descending score, ties in index
    order as lax.top_k gives them; their scores (B, k); overlaps (B, k, k)
    bool, IoU > iou_thres), k = min(max_det, A)."""
    k = min(max_det, boxes_xyxy.shape[1])
    scores_k, order = torch.sort(scores, dim=1, descending=True,
                                 stable=True)
    scores_k, order = scores_k[:, :k], order[:, :k]
    bx = torch.gather(boxes_xyxy, 1, order[..., None].expand(-1, -1, 4))
    area = (bx[..., 2] - bx[..., 0]).clamp_min(0) * \
        (bx[..., 3] - bx[..., 1]).clamp_min(0)
    lt = torch.maximum(bx[:, :, None, :2], bx[:, None, :, :2])
    rb = torch.minimum(bx[:, :, None, 2:], bx[:, None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area[:, :, None] + area[:, None, :] - inter).clamp_min(
        1e-9)
    return order, scores_k, iou > iou_thres


def greedy_keep(overlaps: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """(k, k) bool overlaps of candidates sorted by descending score, and
    their scores -> keep (k,) bool: candidate i survives iff no
    higher-ranked kept candidate overlaps it (the scan of the JAX
    nms_static). The walk stops at the first zero score: the rest are
    zero, come last and can only suppress each other, and a zero score
    stays zero whether kept or not."""
    keep = np.zeros(overlaps.shape[0], bool)
    for i in range(int(np.count_nonzero(scores))):
        keep[i] = not (overlaps[i, :i] & keep[:i]).any()
    return keep


def nms_static(boxes_xyxy, scores, iou_thres=0.45, max_det=300):
    """Class-agnostic NMS of one image, the JAX nms_static's outputs:
    boxes (A, 4), scores (A,) -> (candidate boxes (k, 4), their scores
    with suppressed ones 0 (k,), candidate indices (k,)), as tensors on
    the inputs' device."""
    order, scores_k, overlaps = nms_candidates(boxes_xyxy[None],
                                               scores[None], iou_thres,
                                               max_det)
    keep = torch.from_numpy(greedy_keep(overlaps[0].cpu().numpy(),
                                        scores_k[0].cpu().numpy()))
    keep = keep.to(scores.device)
    return (boxes_xyxy[order[0]], torch.where(keep, scores_k[0], 0.0),
            order[0])


def postprocess(cfg: YoloConfig, preds, conf_thres=0.25, iou_thres=0.45,
                max_det=300):
    """(B, A, 5+nc) decoded predictions -> per-class NMS'd detections as
    numpy: boxes (B, k, 4) xyxy, scores (B, k) with 0 marking empty slots,
    classes (B, k). Class-aware through yolov5's coordinate offset (boxes
    moved by class * 4096). One device -> host copy for the batch."""
    xy, wh = preds[..., :2], preds[..., 2:4]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    cls_scores = preds[..., 5:] * preds[..., 4:5]      # obj * cls conf
    best_score, best_cls = cls_scores.max(-1)
    best_score = torch.where(best_score >= conf_thres, best_score, 0.0)
    off_boxes = boxes + (best_cls.float() * 4096.0)[..., None]
    order, scores_k, overlaps = nms_candidates(off_boxes, best_score,
                                               iou_thres, max_det)
    picked = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    cls_k = torch.gather(best_cls, 1, order)
    k = order.shape[1]
    flat = torch.cat([picked.reshape(-1, k * 4), scores_k,
                      cls_k.float(), overlaps.reshape(-1, k * k).float()],
                     1).cpu().numpy()
    picked = flat[:, :4 * k].reshape(-1, k, 4)
    scores_k = flat[:, 4 * k:5 * k]
    cls_k = flat[:, 5 * k:6 * k].astype(np.int64)
    overlaps = flat[:, 6 * k:].reshape(-1, k, k) > 0.5
    keep = np.stack([greedy_keep(o, s) for o, s in zip(overlaps, scores_k)])
    return picked, np.where(keep, scores_k, 0.0).astype(np.float32), cls_k


def letterbox(img: np.ndarray, size: int = 640, pad_value: int = 114):
    """Aspect-preserving resize onto a size x size canvas. Returns
    (canvas, scale, (dx, dy)). cv2 resizes only where the frame is not
    already at its target size."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    if (nh, nw) == (h, w):
        resized = img
    else:
        import cv2
        resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    canvas = np.full((size, size, 3), pad_value, np.uint8)
    dy, dx = (size - nh) // 2, (size - nw) // 2
    canvas[dy:dy + nh, dx:dx + nw] = resized
    return canvas, r, (dx, dy)


class HeadDetector:
    """Frames -> head boxes: letterbox on the host, the u8 canvases to the
    model's device in one copy, YoloV5 + decode + NMS there, one copy
    back."""

    def __init__(self, model: YoloV5, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 300):
        self.model = model
        self.cfg = model.cfg
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def detect(self, imgs: torch.Tensor):
        """(B, S, S, 3) u8 RGB canvases on the device -> postprocess's
        (boxes, scores, classes) in canvas pixels, numpy."""
        maps = self.model(imgs.float() / 255.0)
        preds = decode_predictions(self.cfg, maps)
        return postprocess(self.cfg, preds, self.conf_thres, self.iou_thres,
                           self.max_det)

    def __call__(self, frames_bgr: Sequence[np.ndarray],
                 head_class: int = 1):
        """frames (BGR uint8) -> list of (M, 5) [x1,y1,x2,y2,score] head
        boxes in original-image pixels."""
        from ..evaluation.forward import to_device
        size = self.cfg.img_size
        canvases, metas = [], []
        for f in frames_bgr:
            canvas, r, (dx, dy) = letterbox(f[..., ::-1], size)
            canvases.append(canvas)
            metas.append((r, dx, dy, f.shape[1], f.shape[0]))
        boxes, scores, classes = self.detect(
            to_device(np.stack(canvases), self.device))
        out = []
        for i, (r, dx, dy, w, h) in enumerate(metas):
            m = (scores[i] > 0) & (classes[i] == head_class)
            b = boxes[i][m]
            b[:, [0, 2]] = np.clip((b[:, [0, 2]] - dx) / r, 0, w)
            b[:, [1, 3]] = np.clip((b[:, [1, 3]] - dy) / r, 0, h)
            out.append(np.concatenate([b, scores[i][m, None]], -1))
        return out
