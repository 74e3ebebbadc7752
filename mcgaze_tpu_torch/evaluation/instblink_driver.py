"""Whole-video inference for the InstBlink query detector, counterpart of
mcgaze_tpu/evaluation/instblink_driver.py. The reference ships the per-clip
forward with top-k selection (instblink_roi_head.py:285-426) and the
FaceLinkerCalculator (face_linker_calculator.py); this driver composes
them:

  1. the video in clip_length windows at stride clip_length - overlap, the
     last one right-aligned (evaluation/driver.py::clip_slices);
  2. per window: the forward and the top-k query tracks on the device,
     clip_batch windows per launch where the forward has `.batched`
     (padded to a power of two by repeating the last window), and every
     window's outputs packed into one tensor, read back once per video;
  3. each window's tracks linked to the previous window's by a Hungarian
     solve on the negated mean IoU over the overlap frames;
  4. overlap frames average the linked tracks' boxes and blink
     probabilities;
  5. per-track results in the ytvis layout: score the mean window score,
     category by majority vote, per-frame xywh boxes, per-frame blink
     probabilities and the converted blink events.

Videos round-robin over the cards of the process (driver.py::eval_devices),
each video's frames and forwards on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..data import transforms as T
from .driver import _take, clip_slices, eval_devices
from .forward import to_device
from .track_eval import blinks_to_events


@dataclasses.dataclass(frozen=True)
class InstBlinkEvalConfig:
    clip_length: int = 11
    overlap: int = 3
    max_per_img: int = 10
    # 0.0 keeps every track, as the reference protocol does
    score_threshold: float = 0.0
    blink_threshold: float = 0.5
    # windows per launch through the forward's `.batched`, padded to pow2
    clip_batch: int = 8
    # ship raw u8 frames where the forward declares accepts_uint8
    ship_uint8: bool = True


def clip_windows(num_frames: int, clip_len: int, stride: int):
    """[(start, overlap_with_previous)], the last window right-aligned."""
    return [(s, o) for s, _, o in clip_slices(num_frames, clip_len, stride)]


def _pairwise_frame_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (K, F, 4), b (K2, F, 4) xyxy -> (K, K2) mean IoU over frames."""
    a_ = a[:, None]
    b_ = b[None]
    lt = np.maximum(a_[..., :2], b_[..., :2])
    rb = np.minimum(a_[..., 2:], b_[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a_[..., 2] - a_[..., 0], 0, None) * \
        np.clip(a_[..., 3] - a_[..., 1], 0, None)
    area_b = np.clip(b_[..., 2] - b_[..., 0], 0, None) * \
        np.clip(b_[..., 3] - b_[..., 1], 0, None)
    union = np.maximum(area_a + area_b - inter, 1e-7)
    return (inter / union).mean(-1)


class InstBlinkVideoEvaluator:
    """forward_fn(imgs (T, H, W, 3), whwh (T, 4)) -> dict of scores (K,),
    labels (K,), boxes (T, K, 4) xyxy, blink (T, K) (topk_tracks), as
    tensors (bind_query_forward) or numpy; optional `.batched(imgs (Kq*T,
    ...), whwh, kq)` with the topk_tracks_batched layout, `.accepts_uint8`
    and `.device`."""

    def __init__(self, forward_fn: Callable,
                 cfg: InstBlinkEvalConfig = InstBlinkEvalConfig(),
                 data_cfg=None):
        """data_cfg (InstBlinkDataConfig): scale, canvas and keep_ratio of
        the path-based API (run_videos_from_paths)."""
        self.forward = forward_fn
        self.cfg = cfg
        self.data_cfg = data_cfg
        # the native loader (None: not tried yet; False: cannot be built,
        # decode with cv2), and which decoder the last video went through
        self._native = None
        self.decoder = None

    def _want_u8(self) -> bool:
        return (self.cfg.ship_uint8
                and getattr(self.forward, 'accepts_uint8', False))

    def _decode_video(self, paths: list):
        """Decode, resize (keep_ratio or the exact warp) and pad one video:
        in the native C++ pool, or with cv2 where that library cannot be
        built or lacks the exact warp. Sets `decoder` to 'native' or 'cv2'.
        Returns (imgs (F, H, W, 3) u8|f32, whwh (F, 4), sfs (F, 4))."""
        dc = self.data_cfg
        if dc is None:
            raise ValueError('the path-based API needs data_cfg')
        native = self._native
        if native is None:
            from ..data.native_loader import NativeClipLoader
            try:
                native = self._native = NativeClipLoader()
            except (RuntimeError, OSError):
                native = self._native = False
        if native is not False and not dc.keep_ratio and not native.has_warp:
            native = False
        if native is False:
            from ..data.instblink_dataset import read_rgb, warp_exact
            imgs, whwh, sfs = [], [], []
            for p in paths:
                img = read_rgb(p)
                if dc.keep_ratio:
                    img, sf = T.resize_keep_ratio(img, dc.scale)
                else:
                    img, sf = warp_exact(img, dc.scale)
                h, w = img.shape[:2]
                imgs.append(T.pad_to_canvas(
                    img if self._want_u8() else T.normalize(img), dc.canvas))
                whwh.append([w, h, w, h])
                sfs.append(sf)
            self.decoder = 'cv2'
            return (np.stack(imgs), np.asarray(whwh, np.float32),
                    np.asarray(sfs, np.float32))
        load = (native.load_u8 if self._want_u8() and native.has_u8
                else native.load)
        imgs, meta = load(paths, None, None, dc.scale, dc.canvas,
                          keep_ratio=dc.keep_ratio)
        new_h = meta[:, 4].astype(np.float32)
        new_w = meta[:, 5].astype(np.float32)
        whwh = np.stack([new_w, new_h, new_w, new_h], -1)
        sfs = np.stack([new_w / meta[:, 3], new_h / meta[:, 2],
                        new_w / meta[:, 3], new_h / meta[:, 2]],
                       -1).astype(np.float32)
        self.decoder = 'native'
        return imgs, whwh, sfs

    def run_videos_from_paths(self, videos, prefetch: int = 4,
                              devices=None):
        """Pipelined eval over (video_id, paths) pairs: a background thread
        decodes the next videos and, where the forward has a `.device`,
        copies their frames there while the current video computes. Videos
        round-robin over `devices` (driver.py::eval_devices), up to one in
        flight per device. Yields each video's list of track dicts in input
        order, as run_video gives them on the same frames."""
        from .pipeline import run_pipelined

        devices = eval_devices(self.forward, devices)

        def produce(i, vid, paths):
            imgs, whwh, sfs = self._decode_video(paths)
            device = devices[i % len(devices)]
            if device is not None:
                imgs, whwh = to_device(imgs, device), to_device(whwh, device)
            return vid, (imgs, whwh, sfs)

        def submit(vid, payload):
            imgs, whwh, sfs = payload
            return sfs, self._submit_video(imgs, whwh)

        def finish(vid, pending):
            sfs, sub = pending
            return self._finish_video(sub, sfs, vid)

        yield from run_pipelined(videos, produce, submit, finish,
                                 prefetch=prefetch, depth=len(devices))

    def _submit_video(self, frames, whwh):
        """Enqueue every window of one video and pack the outputs (tensors)
        into one flat f32 tensor, so _finish_video reads back once."""
        cfg = self.cfg
        f = len(frames)
        t = min(cfg.clip_length, f)
        windows = clip_windows(f, t, max(t - cfg.overlap, 1))
        outs = self._forward_windows(frames, whwh, windows, t)
        if not isinstance(outs[0]['boxes'], torch.Tensor):
            return windows, t, f, outs, None, None
        layout, flats, off = [], [], 0
        for out in outs:
            entry = {}
            for key in sorted(out):
                v = out[key]
                entry[key] = (off, tuple(v.shape), v.dtype)
                flats.append(v.float().reshape(-1))
                off += v.numel()
            layout.append(entry)
        return windows, t, f, None, torch.cat(flats), layout

    def _finish_video(self, pending, scale_factors, video_id):
        windows, t, f, outs, packed, layout = pending
        if outs is None:
            flat = packed.cpu().numpy()      # the one readback
            outs = []
            for entry in layout:
                out = {}
                for key, (off, shape, dtype) in entry.items():
                    size = int(np.prod(shape)) if shape else 1
                    arr = flat[off:off + size].reshape(shape)
                    if not dtype.is_floating_point:
                        arr = arr.astype(np.int64)   # labels, exact < 2^24
                    out[key] = arr
                outs.append(out)
        return self._stitch(windows, t, f, outs, scale_factors, video_id)

    def _forward_windows(self, frames, whwh, windows, t):
        """One output dict per window (scores (K,), labels (K,), boxes
        (T, K, 4), blink (T, K) where the model has a blink head)."""
        batched = getattr(self.forward, 'batched', None)
        if batched is None or len(windows) == 1:
            return [self.forward(frames[s:s + t], whwh[s:s + t])
                    for s, _ in windows]
        outs = []
        cb = max(self.cfg.clip_batch, 1)
        starts = [s for s, _ in windows]
        for i in range(0, len(starts), cb):
            chunk = starts[i:i + cb]
            k = len(chunk)
            kp = 1 if k <= 1 else 1 << (k - 1).bit_length()
            padded = chunk + [chunk[-1]] * (kp - k)
            sel = np.concatenate([np.arange(s, s + t) for s in padded])
            out = batched(_take(frames, sel), _take(whwh, sel), kp)
            outs.extend({key: val[j] for key, val in out.items()}
                        for j in range(k))
        return outs

    def run_video(self, frames_preprocessed, whwh, scale_factors,
                  video_id: int) -> list:
        """frames_preprocessed (F, H, W, 3); whwh (F, 4); scale_factors
        (F, 4) resized / original. Returns the per-track result dicts."""
        pending = self._submit_video(frames_preprocessed, whwh)
        return self._finish_video(pending, scale_factors, video_id)

    def _stitch(self, windows, t, f, window_outs, scale_factors,
                video_id: int) -> list:
        """Link each window's tracks to the previous window's over the
        overlap frames, average the overlaps, assemble the results."""
        cfg = self.cfg
        k = cfg.max_per_img
        boxes_v = np.zeros((k, f, 4), np.float32)
        blink_v = np.zeros((k, f), np.float32)
        counts = np.zeros((k, f), np.float32)
        scores_acc = [[] for _ in range(k)]
        labels_acc = [[] for _ in range(k)]

        prev_boxes = None          # (K, T, 4) previous window, video order
        prev_start = 0
        has_blink = False
        for (start, overlap), out in zip(windows, window_outs):
            sl = slice(start, start + t)
            # back to original-resolution coordinates (rescale=True)
            boxes = np.asarray(out['boxes']) / scale_factors[sl][:, None, :]
            scores = np.asarray(out['scores'])
            labels = np.asarray(out['labels'])
            has_blink = 'blink' in out
            blink = np.asarray(out.get('blink',
                                       np.zeros((t, k), np.float32)))
            tracks = boxes.transpose(1, 0, 2)                # (K, T, 4)

            if prev_boxes is not None and overlap > 0:
                ov_prev = prev_boxes[:, start - prev_start:
                                     start - prev_start + overlap]
                cost = -_pairwise_frame_iou(ov_prev, tracks[:, :overlap])
                rows, cols = linear_sum_assignment(cost)
                order = np.empty(k, np.int64)
                order[cols] = rows                           # new -> video
            else:
                order = np.arange(k)

            for new_i in range(k):
                vid_i = int(order[new_i])
                scores_acc[vid_i].append(float(scores[new_i]))
                labels_acc[vid_i].append(int(labels[new_i]))
                boxes_v[vid_i, sl] += tracks[new_i]
                blink_v[vid_i, sl] += blink[:, new_i]
                counts[vid_i, sl] += 1.0
            inv = np.empty(k, np.int64)
            inv[order] = np.arange(k)
            prev_boxes = tracks[inv]
            prev_start = start

        covered = counts > 0
        counts = np.maximum(counts, 1.0)
        boxes_v /= counts[..., None]
        blink_v /= counts

        results = []
        for vid_i in range(k):
            if not scores_acc[vid_i]:
                continue
            score = float(np.mean(scores_acc[vid_i]))
            if score < cfg.score_threshold:
                continue
            xywh = []
            for fi in range(f):
                b = boxes_v[vid_i, fi]
                if not covered[vid_i, fi] or not np.isfinite(b).all():
                    xywh.append(None)
                else:
                    xywh.append([float(b[0]), float(b[1]),
                                 float(b[2] - b[0]), float(b[3] - b[1])])
            res = dict(video_id=video_id, score=score,
                       category_id=int(np.bincount(
                           labels_acc[vid_i]).argmax()) + 1,
                       bboxes=xywh)
            if has_blink:
                res['blink_scores'] = [float(x) for x in blink_v[vid_i]]
                res['blinks_converted'] = blinks_to_events(
                    blink_v[vid_i], cfg.blink_threshold)
            results.append(res)
        return results
