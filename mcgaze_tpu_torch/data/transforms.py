"""Test-time frame transforms (host-side numpy), the subset of
mcgaze_tpu/data/transforms.py that evaluation runs: CenterCrop(ratio) ->
Resize(keep_ratio) -> Normalize(ImageNet) -> pad to a fixed canvas.

cv2 is imported inside `resize_keep_ratio`, and only when the size
changes, so frames already at the eval scale need no OpenCV.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def crop_offsets(h: int, w: int, ratio: float):
    """(ch, cw, off_h, off_w) of the deterministic centre crop (reference
    CenterCrop: size = int(dim*ratio + 0.5), offset = int(margin/2 + 0.5))."""
    ch = int(h * ratio + 0.5)
    cw = int(w * ratio + 0.5)
    off_h = int(max(h - ch, 0) / 2 + 0.5)
    off_w = int(max(w - cw, 0) / 2 + 0.5)
    return ch, cw, off_h, off_w


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


def process_frame(img: np.ndarray, crop_ratio: float | None,
                  scale: Tuple[int, int], canvas: Tuple[int, int]) -> dict:
    """HxWx3 RGB uint8 -> dict(img (canvas, 3) f32 normalised and padded,
    img_shape (h, w) after resize, whwh (4,), scale_factor (4,))."""
    if crop_ratio is not None:
        img = center_crop(img, crop_ratio)
    img, sf = resize_keep_ratio(img, scale)
    h, w = img.shape[:2]
    return dict(img=pad_to_canvas(normalize(img), canvas), img_shape=(h, w),
                whwh=np.array([w, h, w, h], np.float32), scale_factor=sf)
