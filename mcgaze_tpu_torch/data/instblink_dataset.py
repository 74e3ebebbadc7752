"""MPEblink clip dataset for the InstBlink query detector, counterpart of
mcgaze_tpu/data/instblink_dataset.py (reference mmdet/datasets/
{mpeblink,blink_sampled}.py):

  * COCO-VID annotations over instance tracks with per-frame `bboxes` (xywh,
    None where absent) and per-frame `blinks_binary`;
  * the training index is every (video, frame) with a visible instance;
    blink_sampled keeps only frames where some instance is mid-blink;
  * a clip is clip_length frames at interval 2 around the index frame,
    clamped to the video's annotated frames and padded with its first or
    last one;
  * Resize (keep_ratio, or the test-time exact warp), RandomFlip latched
    per clip, Normalize (or raw u8 with ship_uint8) and a zero pad to a
    fixed canvas;
  * instance tracks in `max_instances` slots with `inst_valid`, per-frame
    visibility in `gt_present`: the layout train/hungarian.py and
    train/query_criterion.py read.

cv2 is imported where a frame is decoded or warped, not with the module.
"""
from __future__ import annotations

import dataclasses
import os.path as osp
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np

from . import transforms as T
from .coco_vid import CocoVid

FRAME_INTERVAL = 2   # mpeblink.py:284


@dataclasses.dataclass(frozen=True)
class InstBlinkDataConfig:
    ann_file: str = 'data/mpeblink/annotations/train.json'
    img_prefix: str = 'data/mpeblink/train_rawframes/'
    clip_length: int = 11
    scale: Tuple[int, int] = (640, 360)      # mmcv img_scale (long, short)
    canvas: Tuple[int, int] = (384, 640)     # (h, w) padded to /32
    flip_ratio: float = 0.5
    batch_size: int = 4                      # samples_per_gpu
    max_instances: int = 8
    with_blinks: bool = True
    blink_sampled: bool = False
    keep_ratio: bool = True                  # False: test-time exact warp
    # raw u8 frames, normalised on the device by the train step
    ship_uint8: bool = False


def read_rgb(path: str) -> np.ndarray:
    """One frame from disk as HxWx3 RGB uint8 (cv2)."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def warp_exact(img: np.ndarray, scale):
    """Resize keep_ratio=False: warp to (short, long) of `scale`. Returns
    (img, scale_factor (4,) [wf, hf, wf, hf])."""
    import cv2
    h, w = img.shape[:2]
    new_w, new_h = max(scale), min(scale)
    out = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    sf = np.array([new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
    return out, sf


class InstBlinkClipDataset:
    def __init__(self, cfg: InstBlinkDataConfig, seed: int = 0):
        self.cfg = cfg
        self.api = CocoVid(cfg.ann_file)
        self.rng = np.random.RandomState(seed)
        cat_ids = self.api.get_cat_ids()
        self.cat2label = {c: i for i, c in enumerate(cat_ids)}
        self.num_classes = len(cat_ids)
        self._warned_truncation = False
        self.index = []          # (vid_id, frame)
        self.video_frames = {}   # vid_id -> frames with >=1 instance
        for vid_id in self.api.get_vid_ids():
            anns = self.api.anns_of_video(vid_id)
            length = self.api.load_vid(vid_id)['length']
            frames = [f for f in range(length)
                      if any(a['bboxes'][f] is not None for a in anns)]
            self.video_frames[vid_id] = frames
            if cfg.blink_sampled and cfg.with_blinks:
                # a blink of ANY instance at the frame counts, even one
                # whose box is None there (blink_sampled.py:146-161)
                frames = [f for f in frames
                          if any(a['blinks_binary'][f] == 1 for a in anns)]
            self.index.extend((vid_id, f) for f in frames)

    def __len__(self):
        return len(self.index)

    def _clip_frames(self, vid_id: int, frame: int) -> list:
        """clip_length frames at FRAME_INTERVAL around `frame`, padded with
        the video's first/last annotated frame (mpeblink.py:285-293)."""
        t = self.cfg.clip_length
        if t % 2 == 0:
            raise ValueError(f'clip_length must be odd, got {t}')
        frames = self.video_frames[vid_id]
        fset = frozenset(frames)
        half = t // 2
        pre = [frame - FRAME_INTERVAL * i for i in range(1, half + 1)
               if frame - FRAME_INTERVAL * i >= frames[0]
               and (frame - FRAME_INTERVAL * i) in fset]
        pre += [frames[0]] * (half - len(pre))
        post = [frame + FRAME_INTERVAL * i for i in range(1, half + 1)
                if frame + FRAME_INTERVAL * i <= frames[-1]
                and (frame + FRAME_INTERVAL * i) in fset]
        post += [frames[-1]] * (half - len(post))
        return sorted(pre + [frame] + post)

    def _track_gt(self, vid_id: int, clip: list):
        """Slot-layout GT over the clip's frames: (boxes (M, T, 4) xyxy in
        original coordinates, labels (M,), present (M, T), valid (M,),
        blinks (M, T))."""
        cfg = self.cfg
        m, t = cfg.max_instances, len(clip)
        boxes = np.zeros((m, t, 4), np.float32)
        labels = np.zeros((m,), np.int64)
        present = np.zeros((m, t), bool)
        valid = np.zeros((m,), bool)
        blinks = np.zeros((m, t), np.float32)
        anns = sorted(self.api.anns_of_video(vid_id), key=lambda a: a['id'])
        if len(anns) > m and not self._warned_truncation:
            self._warned_truncation = True
            warnings.warn(
                f'video {vid_id} has {len(anns)} GT tracks but '
                f'max_instances={m}: the overflow tracks are dropped and '
                'queries that detect them are supervised as background. '
                'Raise InstBlinkDataConfig.max_instances to cover the '
                'densest video.')
        for si, ann in enumerate(anns[:m]):
            valid[si] = True
            labels[si] = self.cat2label[ann['category_id']]
            for fi, f in enumerate(clip):
                bb = ann['bboxes'][f]
                if bb is None:
                    continue
                x1, y1, w, h = bb
                boxes[si, fi] = [max(float(x1), 0.0), max(float(y1), 0.0),
                                 float(x1) + float(w), float(y1) + float(h)]
                present[si, fi] = True
                if cfg.with_blinks:
                    blinks[si, fi] = float(ann['blinks_binary'][f])
        # a slot with no visible frame in this clip carries no signal
        valid &= present.any(-1)
        return boxes, labels, present, valid, blinks

    def _load_image(self, vid_id: int, frame: int) -> np.ndarray:
        name = self.api.load_vid(vid_id)['file_names'][frame]
        return read_rgb(osp.join(self.cfg.img_prefix, name))

    def _resize(self, img: np.ndarray, boxes2d: Optional[np.ndarray]):
        """keep_ratio rescale into cfg.scale, or the exact warp."""
        cfg = self.cfg
        if cfg.keep_ratio:
            img, sf = T.resize_keep_ratio(img, cfg.scale)
            h, w = img.shape[:2]
            if boxes2d is not None:
                boxes2d = T.resize_boxes(boxes2d, sf, w, h)
            return img, boxes2d, sf
        img, sf = warp_exact(img, cfg.scale)
        if boxes2d is not None:
            boxes2d = boxes2d * sf
        return img, boxes2d, sf

    def get_clip(self, idx: int) -> dict:
        """One training clip, the flip drawn once for all its frames."""
        cfg = self.cfg
        vid_id, frame = self.index[idx]
        clip = self._clip_frames(vid_id, frame)
        t = cfg.clip_length
        flip = bool(self.rng.rand() < cfg.flip_ratio)
        boxes, labels, present, valid, blinks = self._track_gt(vid_id, clip)
        out = dict(
            imgs=np.zeros((t, *cfg.canvas, 3),
                          np.uint8 if cfg.ship_uint8 else np.float32),
            whwh=np.zeros((t, 4), np.float32),
            gt_labels=labels.astype(np.int32),
            gt_present=present,
            inst_valid=valid,
        )
        gt_boxes = np.zeros_like(boxes)
        for fi, f in enumerate(clip):
            img = self._load_image(vid_id, f)
            img, frame_boxes, _sf = self._resize(img, boxes[:, fi].copy())
            if flip:
                img, frame_boxes, _ = T.hflip(img, frame_boxes, None)
            h, w = img.shape[:2]
            out['imgs'][fi] = T.pad_to_canvas(
                img if cfg.ship_uint8 else T.normalize(img), cfg.canvas)
            out['whwh'][fi] = [w, h, w, h]
            gt_boxes[:, fi] = frame_boxes
        out['gt_boxes'] = gt_boxes * present[..., None]
        if cfg.with_blinks:
            out['gt_blinks'] = blinks
        return out

    def batches(self, batch_size: int | None = None,
                seed: int = 0) -> Iterator[dict]:
        """Infinite shuffled batches (numpy): imgs (B*T, H, W, 3), whwh
        (B*T, 4), the GT fields with a leading B."""
        bs = batch_size or self.cfg.batch_size
        t = self.cfg.clip_length
        order_rng = np.random.RandomState(seed)
        clips = []
        while True:
            for idx in order_rng.permutation(len(self.index)):
                clips.append(self.get_clip(int(idx)))
                if len(clips) == bs:
                    batch = {k: np.stack([c[k] for c in clips])
                             for k in clips[0]}
                    batch['imgs'] = batch['imgs'].reshape(
                        bs * t, *batch['imgs'].shape[2:])
                    batch['whwh'] = batch['whwh'].reshape(bs * t, 4)
                    yield batch
                    clips = []

    def video_paths(self, vid_id: int) -> list:
        vid = self.api.load_vid(vid_id)
        return [osp.join(self.cfg.img_prefix, n) for n in vid['file_names']]
