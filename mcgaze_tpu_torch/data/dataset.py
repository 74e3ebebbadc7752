"""Gaze360/l2cs clip dataset and batch iterator (host side), counterpart of
mcgaze_tpu/data/dataset.py on its pure-Python path. Batches are numpy
arrays of static shapes:

  imgs (B, T, H, W, 3) float32 | img_whwh (B, T, 4) |
  gt_boxes (B, T, 3, 4) | gt_valid (B, T, 3) | gt_gazes (B, T, 3, 3)

A clip is a clip_length-frame window centred on an annotated frame, over
the video's annotated frames, padded with the first/last of them; one
ClipParams is sampled per clip. cv2 is imported where a frame is decoded,
so the config loader, which imports DataConfig, needs no OpenCV. The C++
loader's binding is ROADMAP Queue 1, item 8.
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
    def __init__(self, cfg: DataConfig, seed: int = 0):
        self.cfg = cfg
        self.api = CocoVid(cfg.ann_file)
        self.rng = np.random.RandomState(seed)
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

    def batches(self, batch_size: int | None = None,
                seed: int = 0) -> Iterator[dict]:
        """Infinite shuffled stream of stacked (B, T, ...) batches."""
        bs = batch_size or self.cfg.batch_size
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
