"""Gaze360/l2cs clip dataset and batch iterator (host side), counterpart of
mcgaze_tpu/data/dataset.py. Batches are numpy arrays of static shapes:

  imgs (B, T, H, W, 3) float32 | img_whwh (B, T, 4) |
  gt_boxes (B, T, 3, 4) | gt_valid (B, T, 3) | gt_gazes (B, T, 3, 3)

A clip is a clip_length-frame window centred on an annotated frame, over
the video's annotated frames, padded with the first/last of them; one
ClipParams is sampled per clip.

Two paths give the same stream (same RNG draws, geometry and pixels):
with the native C++ loader (data/native_loader.py), each batch's clip
geometry and crop rejection run on the host without decoding, then one
loader call decodes and augments all B*T frames into the batch, as u8
when DataConfig.ship_uint8 is set (the train step normalises them);
without it, cv2 decodes frame by frame and the Python transforms yield
normalised f32. cv2 is imported only where a frame is decoded, so the
config loader, which imports DataConfig, needs no OpenCV.
"""
from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Iterator, Optional, Tuple

import numpy as np

from ..evaluation.mae import yaw_pitch_to_vector
from ..train.targets import slot_layout_from_counts
from . import transforms as T
from .coco_vid import CocoVid


@dataclasses.dataclass(frozen=True)
class DataConfig:
    ann_file: str = 'data/gaze360/train.json'
    img_prefix: str = 'data/gaze360/train_rawframes/'
    clip_length: int = 7
    scale: Tuple[int, int] = (224, 224)
    canvas: Tuple[int, int] = (224, 224)
    crop_size: Optional[float] = 0.68    # None for the l2cs setting
    flip_ratio: float = 0.5
    batch_size: int = 32
    gaze_dim: int = 3
    # ship raw uint8 frames and normalise in the train step; read by the
    # native loader only (the Python path yields normalised f32 frames)
    ship_uint8: bool = True


class Gaze360ClipDataset:
    def __init__(self, cfg: DataConfig, seed: int = 0,
                 use_native: Optional[bool] = None):
        """use_native: True requires the C++ loader (raises where it
        cannot be built), False decodes with cv2 in Python, None uses the
        loader where it builds."""
        self.cfg = cfg
        self.api = CocoVid(cfg.ann_file)
        self.rng = np.random.RandomState(seed)
        self._native = None
        if use_native is not False:
            from .native_loader import NativeClipLoader
            try:
                self._native = NativeClipLoader()
            except (RuntimeError, OSError):
                if use_native:
                    raise
        # (vid_id, frame) pairs of frames with at least one GT box
        self.index = []
        self.video_frames = {}       # vid_id -> sorted annotated frames
        self.video_frame_sets = {}   # vid_id -> frozenset of the same
        for vid_id in self.api.get_vid_ids():
            anns = self.api.anns_of_video(vid_id)
            if anns and 'bboxes' not in anns[0]:
                raise ValueError(
                    f'{cfg.ann_file}: annotations carry no "bboxes"; '
                    'training needs the bbox-bearing train/test JSONs of '
                    'the reference release (gaze-only JSONs serve MAE '
                    'scoring only)')
            length = self.api.load_vid(vid_id)['length']
            frames = [f for f in range(length)
                      if any(a['bboxes'][f] is not None for a in anns)]
            self.video_frames[vid_id] = frames
            self.video_frame_sets[vid_id] = frozenset(frames)
            self.index.extend((vid_id, f) for f in frames)

    def __len__(self):
        return len(self.index)

    def _frame_gt(self, vid_id: int, frame: int):
        """(boxes (3,4), valid (3,), gazes (3,3)) in original image
        coordinates."""
        boxes, gazes = [], []
        for ann in self.api.anns_of_video(vid_id):
            bb = ann['bboxes'][frame]
            if bb is None:
                continue
            x1, y1, w, h = bb
            x1 = max(float(x1), 0.0)
            y1 = max(float(y1), 0.0)
            boxes.append([x1, y1, x1 + w, y1 + h])
            g = np.asarray(ann['gaze'][frame], np.float32)
            if g.shape[-1] == 2:
                g = yaw_pitch_to_vector(g)[0].astype(np.float32)
            gazes.append(g)
        return slot_layout_from_counts(boxes, gazes)

    def _clip_frames(self, vid_id: int, frame: int) -> list:
        """The clip_length window over annotated frames, first/last-padded."""
        t = self.cfg.clip_length
        if t % 2 == 0:
            raise ValueError(f'clip_length must be odd, got {t}')
        frames = self.video_frames[vid_id]
        fset = self.video_frame_sets[vid_id]
        half = t // 2
        pre = [frame - i for i in range(1, half + 1)
               if frame - i >= frames[0] and (frame - i) in fset]
        pre += [frames[0]] * (half - len(pre))
        post = [frame + i for i in range(1, half + 1)
                if frame + i <= frames[-1] and (frame + i) in fset]
        post += [frames[-1]] * (half - len(post))
        return sorted(pre + [frame] + post)

    def _load_image(self, vid_id: int, frame: int) -> np.ndarray:
        import cv2
        name = self.api.load_vid(vid_id)['file_names'][frame]
        img = cv2.imread(osp.join(self.cfg.img_prefix, name))
        if img is None:
            raise FileNotFoundError(osp.join(self.cfg.img_prefix, name))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def get_clip(self, idx: int):
        """One augmented training clip, or None when the sampled crop
        killed every GT box (the caller resamples)."""
        vid_id, frame = self.index[idx]
        clip = self._clip_frames(vid_id, frame)
        params = T.sample_clip_params(self.rng, self.cfg.crop_size,
                                      self.cfg.flip_ratio)
        t = self.cfg.clip_length
        out = dict(
            imgs=np.zeros((t, *self.cfg.canvas, 3), np.float32),
            img_whwh=np.zeros((t, 4), np.float32),
            gt_boxes=np.zeros((t, 3, 4), np.float32),
            gt_valid=np.zeros((t, 3), np.float32),
            gt_gazes=np.zeros((t, 3, 3), np.float32),
        )
        for i, f in enumerate(clip):
            boxes, valid, gazes = self._frame_gt(vid_id, f)
            img = self._load_image(vid_id, f)
            r = T.process_frame(img, params, self.cfg.scale, self.cfg.canvas,
                                boxes=boxes, valid=valid, gazes=gazes)
            if not r['ok']:
                return None
            out['imgs'][i] = r['img']
            out['img_whwh'][i] = r['whwh']
            out['gt_boxes'][i] = r['boxes']
            out['gt_valid'][i] = r['valid']
            out['gt_gazes'][i] = r['gazes']
        return out

    def _clip_geometry(self, idx: int, params: T.ClipParams):
        """The GT and shape arithmetic of one clip without decoding (the
        frame size comes from the annotation JSON), or None when the crop
        killed every GT box (the caller resamples before any decode)."""
        vid_id, frame = self.index[idx]
        clip = self._clip_frames(vid_id, frame)
        vid = self.api.load_vid(vid_id)
        orig_hw = (vid['height'], vid['width'])
        t = self.cfg.clip_length
        out = dict(
            img_whwh=np.zeros((t, 4), np.float32),
            gt_boxes=np.zeros((t, 3, 4), np.float32),
            gt_valid=np.zeros((t, 3), np.float32),
            gt_gazes=np.zeros((t, 3, 3), np.float32),
        )
        paths = []
        for i, f in enumerate(clip):
            boxes, valid, gazes = self._frame_gt(vid_id, f)
            r = T.process_frame_geometry(orig_hw, params, self.cfg.scale,
                                         boxes=boxes, valid=valid,
                                         gazes=gazes)
            if not r['ok']:
                return None
            out['img_whwh'][i] = r['whwh']
            out['gt_boxes'][i] = r['boxes']
            out['gt_valid'][i] = r['valid']
            out['gt_gazes'][i] = r['gazes']
            paths.append(osp.join(self.cfg.img_prefix, vid['file_names'][f]))
        out['paths'] = paths
        out['params'] = params
        return out

    def batches(self, batch_size: int | None = None,
                seed: int = 0) -> Iterator[dict]:
        """Infinite shuffled stream of stacked (B, T, ...) batches. With the
        native loader, geometry and crop rejection first (no decode), then
        one loader call per batch."""
        bs = batch_size or self.cfg.batch_size
        if self._native is None:
            yield from self._batches_python(bs, seed)
            return
        t = self.cfg.clip_length
        canvas = self.cfg.canvas
        u8 = self.cfg.ship_uint8 and self._native.has_u8
        load = self._native.load_u8 if u8 else self._native.load
        order_rng = np.random.RandomState(seed)
        clips = []
        while True:
            perm = order_rng.permutation(len(self.index))
            for idx in perm:
                params = T.sample_clip_params(self.rng, self.cfg.crop_size,
                                              self.cfg.flip_ratio)
                clip = self._clip_geometry(int(idx), params)
                while clip is None:
                    params = T.sample_clip_params(
                        self.rng, self.cfg.crop_size, self.cfg.flip_ratio)
                    clip = self._clip_geometry(
                        int(order_rng.randint(len(self.index))), params)
                clips.append(clip)
                if len(clips) < bs:
                    continue
                imgs = np.empty((bs, t, *canvas, 3),
                                np.uint8 if u8 else np.float32)
                load([p for c in clips for p in c['paths']],
                     [c['params'].crop_ratio for c in clips
                      for _ in range(t)],
                     [c['params'].flip for c in clips for _ in range(t)],
                     self.cfg.scale, canvas,
                     out=imgs.reshape(bs * t, *canvas, 3))
                yield dict(
                    imgs=imgs,
                    **{k: np.stack([c[k] for c in clips])
                       for k in ('img_whwh', 'gt_boxes', 'gt_valid',
                                 'gt_gazes')})
                clips = []

    def _batches_python(self, bs: int, seed: int) -> Iterator[dict]:
        order_rng = np.random.RandomState(seed)
        clips = []
        while True:
            perm = order_rng.permutation(len(self.index))
            for idx in perm:
                clip = self.get_clip(int(idx))
                while clip is None:
                    clip = self.get_clip(
                        int(order_rng.randint(len(self.index))))
                clips.append(clip)
                if len(clips) == bs:
                    yield {k: np.stack([c[k] for c in clips])
                           for k in clips[0]}
                    clips = []
