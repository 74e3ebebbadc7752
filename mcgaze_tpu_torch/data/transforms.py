"""Clip-consistent frame, box and gaze transforms (host-side numpy),
counterpart of mcgaze_tpu/data/transforms.py:

  gaze360: CenterCrop(ratio) -> Resize(keep_ratio) -> Flip -> Normalize
           (ImageNet) -> pad to a fixed canvas
  l2cs:    Resize(keep_ratio) -> Flip -> Normalize -> pad

Evaluation crops at a fixed ratio and never flips. Training samples one
`ClipParams` (crop ratio, flip) per clip and applies it to every frame.

cv2 is imported inside `resize_keep_ratio`, and only when the size
changes, so frames already at the eval scale need no OpenCV.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclasses.dataclass
class ClipParams:
    """Per-clip random augmentation, sampled once per clip."""
    crop_ratio: Optional[float] = None   # in [crop_size, 1]; None: no crop
    flip: bool = False


def sample_clip_params(rng: np.random.RandomState, crop_size: float | None,
                       flip_ratio: float) -> ClipParams:
    """crop_size: the lower bound of the relative crop range (0.68) or
    None. One ratio is shared by h and w, as the reference samples it."""
    ratio = None
    if crop_size is not None:
        ratio = float(crop_size + rng.rand() * (1.0 - crop_size))
    flip = bool(rng.rand() < flip_ratio)
    return ClipParams(crop_ratio=ratio, flip=flip)


def crop_offsets(h: int, w: int, ratio: float):
    """(ch, cw, off_h, off_w) of the deterministic centre crop (reference
    CenterCrop: size = int(dim*ratio + 0.5), offset = int(margin/2 + 0.5))."""
    ch = int(h * ratio + 0.5)
    cw = int(w * ratio + 0.5)
    off_h = int(max(h - ch, 0) / 2 + 0.5)
    off_w = int(max(w - cw, 0) / 2 + 0.5)
    return ch, cw, off_h, off_w


def crop_box_geometry(boxes: np.ndarray, valid: np.ndarray,
                      off_w: int, off_h: int, cw: int, ch: int):
    """GT arithmetic of the centre crop: shift the (3, 4) slot boxes into
    the crop and clip them; when a 3-GT frame loses face or eyes, copy the
    head box into both slots (the reference's repair of corrupted
    samples); decide keep/reject. Returns (boxes, valid, ok), ok False when
    the crop killed every GT (the caller resamples)."""
    boxes = boxes - np.array([off_w, off_h, off_w, off_h], np.float32)
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, cw)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ch)
    alive = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    valid = valid.copy()
    n_gt = int(valid.sum())
    ok = True
    if n_gt == 3:
        if not alive[list(np.where(valid > 0)[0])].all():
            boxes[0] = boxes[2]
            boxes[1] = boxes[2]
            alive[:] = True
    elif n_gt == 1 and not alive[2]:
        ok = False
    ok = ok and (bool((alive & (valid > 0)).any()) or n_gt == 0)
    valid = valid * alive.astype(np.float32)
    boxes = boxes * valid[:, None]
    return boxes, valid, ok


def center_crop(img: np.ndarray, ratio: float) -> np.ndarray:
    h, w = img.shape[:2]
    ch, cw, off_h, off_w = crop_offsets(h, w, ratio)
    return img[off_h:off_h + ch, off_w:off_w + cw]


def rescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmcv.rescale_size: fit (h, w) into `scale` keeping aspect ratio.
    Returns (new_w, new_h)."""
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * f + 0.5), int(h * f + 0.5)


def resize_keep_ratio(img: np.ndarray, scale: Tuple[int, int]):
    """Returns (img, scale_factor (4,) [wf, hf, wf, hf]). A frame already
    at its target size comes back as a copy, without cv2."""
    h, w = img.shape[:2]
    new_w, new_h = rescale_size(h, w, scale)
    if (new_w, new_h) == (w, h):
        img = img.copy()
    else:
        import cv2
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    sf = np.array([new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
    return img, sf


def normalize(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def pad_to_canvas(img: np.ndarray, canvas: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to a fixed canvas."""
    h, w = img.shape[:2]
    out = np.zeros((canvas[0], canvas[1], img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


def resize_boxes(boxes: np.ndarray, sf: np.ndarray, new_w: int,
                 new_h: int) -> np.ndarray:
    """Scale xyxy boxes by sf [wf, hf, wf, hf] and clip to the new size."""
    boxes = boxes * sf
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, new_w)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, new_h)
    return boxes


def flip_geometry(w: int, boxes: np.ndarray | None,
                  gazes: np.ndarray | None):
    """Horizontal flip of xyxy boxes in an image of width w, and gaze x
    negated (reference RandomFlip.gaze_flip)."""
    if boxes is not None:
        flipped = boxes.copy()
        flipped[:, 0] = w - boxes[:, 2]
        flipped[:, 2] = w - boxes[:, 0]
        boxes = flipped
    if gazes is not None:
        gazes = gazes.copy()
        gazes[:, 0] = -gazes[:, 0]
    return boxes, gazes


def hflip(img: np.ndarray, boxes: np.ndarray | None,
          gazes: np.ndarray | None):
    """Horizontal flip of the image, its boxes and gazes."""
    img = img[:, ::-1]
    boxes, gazes = flip_geometry(img.shape[1], boxes, gazes)
    return img, boxes, gazes


def _as_params(params) -> ClipParams:
    """A ClipParams, or a bare crop ratio (None: no crop), never flipped."""
    return params if isinstance(params, ClipParams) else \
        ClipParams(crop_ratio=params)


def process_frame_geometry(orig_hw: Tuple[int, int], params,
                           scale: Tuple[int, int],
                           boxes: np.ndarray | None = None,
                           valid: np.ndarray | None = None,
                           gazes: np.ndarray | None = None) -> dict:
    """The box, gaze and shape arithmetic of process_frame, without
    pixels. Returns dict(img_shape, whwh, scale_factor, boxes, valid,
    gazes, ok)."""
    params = _as_params(params)
    h, w = orig_hw
    ok = True
    if params.crop_ratio is not None:
        ch, cw, off_h, off_w = crop_offsets(h, w, params.crop_ratio)
        if boxes is not None:
            boxes, valid, ok = crop_box_geometry(boxes, valid, off_w,
                                                 off_h, cw, ch)
        h, w = ch, cw
    new_w, new_h = rescale_size(h, w, scale)
    sf = np.array([new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
    if boxes is not None:
        boxes = resize_boxes(boxes, sf, new_w, new_h)
    if params.flip:
        boxes, gazes = flip_geometry(new_w, boxes, gazes)
    return dict(img_shape=(new_h, new_w),
                whwh=np.array([new_w, new_h, new_w, new_h], np.float32),
                scale_factor=sf, boxes=boxes, valid=valid, gazes=gazes,
                ok=ok)


def process_frame(img: np.ndarray, params, scale: Tuple[int, int],
                  canvas: Tuple[int, int],
                  boxes: np.ndarray | None = None,
                  valid: np.ndarray | None = None,
                  gazes: np.ndarray | None = None) -> dict:
    """HxWx3 RGB uint8 -> dict(img (canvas, 3) f32 normalised and padded,
    img_shape (h, w) after resize, whwh (4,), scale_factor (4,), boxes,
    valid, gazes, ok). params: a ClipParams (training), or a crop ratio or
    None (evaluation: no flip); boxes (3, 4) slot layout, valid (3,) and
    gazes (3, 3) follow the frame when given."""
    params = _as_params(params)
    ok = True
    if params.crop_ratio is not None:
        h, w = img.shape[:2]
        ch, cw, off_h, off_w = crop_offsets(h, w, params.crop_ratio)
        img = img[off_h:off_h + ch, off_w:off_w + cw]
        if boxes is not None:
            nh, nw = img.shape[:2]
            boxes, valid, ok = crop_box_geometry(boxes, valid, off_w, off_h,
                                                 nw, nh)
    img, sf = resize_keep_ratio(img, scale)
    h, w = img.shape[:2]
    if boxes is not None:
        boxes = resize_boxes(boxes, sf, w, h)
    if params.flip:
        img, boxes, gazes = hflip(img, boxes, gazes)
    return dict(img=pad_to_canvas(normalize(img), canvas), img_shape=(h, w),
                whwh=np.array([w, h, w, h], np.float32), scale_factor=sf,
                boxes=boxes, valid=valid, gazes=gazes, ok=ok)
