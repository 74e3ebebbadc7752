"""Video gaze evaluation driver, counterpart of
mcgaze_tpu/evaluation/driver.py (reference tools/test_gaze360_gaze.py):

  per video: 7-frame clips at stride 4, the last one right-aligned
  -> batched forward (clip counts padded to powers of two; with a
     `.dedup` forward, one unique-frame window per chunk plus the
     slot -> frame map `sel`)
  -> one device -> host copy of the whole video's packed (N, 27) output
  -> boxes rescaled by 1/scale_factor, boxes scoring < 0.5 zeroed, frames
     shared by two clips averaged
  -> per-video dict {video_id, fusion_gazes, {face,eyes,head}_{bboxes,
     gazes,score}} with xywh boxes (zero boxes -> None)

Decoding from image paths goes through the native C++ loader
(data/native_loader.py: decode, crop, resize, pad and, for a forward that
declares accepts_uint8, raw u8 frames) and falls back to cv2 and the
Python transforms where that library cannot be built; `decoder` records
which one ran. Videos round-robin over the cards of the process
(`eval_devices`), each video's frames and forwards on one card.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data import transforms as T
from .forward import to_device

PERSON_THRESHOLD = 0.5


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    clip_length: int = 7
    stride: int = 4
    scale: Tuple[int, int] = (224, 224)
    canvas: Tuple[int, int] = (224, 224)
    crop_ratio: Optional[float] = 0.84  # mid of reference's U[0.68, 1)
    # 'fixed': every frame cropped at crop_ratio; 'reference': per-frame
    # ratio ~ U[crop_size, 1) from a seeded RNG
    crop_mode: str = 'fixed'
    crop_size: float = 0.68
    crop_seed: int = 0
    clip_batch: int = 8
    # ship raw uint8 frames when the forward declares accepts_uint8 (it
    # normalises on the device)
    ship_uint8: bool = True
    # send each chunk's unique frames + the slot -> frame map to the
    # forward's .dedup, so backbone + FPN run once per frame
    dedup_frames: bool = True


def clip_slices(video_length: int, clip_len: int, stride: int):
    """[(start, length, overlap_with_previous)] per clip."""
    if video_length <= clip_len:
        return [(0, video_length, 0)]
    clip_num = math.ceil((video_length - clip_len) / stride) + 1
    out = []
    for i in range(clip_num):
        if i != clip_num - 1:
            start = i * stride
            overlap = clip_len - stride
        else:
            start = video_length - clip_len
            rem = (video_length - clip_len) % stride
            overlap = clip_len - rem if rem else clip_len - stride
        out.append((start, clip_len, 0 if i == 0 else overlap))
    return out


def crop_ratios(cfg: EvalConfig, num_frames: int, video_id: int):
    """Per-frame crop ratios for one video, or None when cropping is off
    (crop_ratio=None, the l2cs setting)."""
    if cfg.crop_ratio is None:
        if cfg.crop_mode == 'reference':
            raise ValueError(
                "crop_mode='reference' with crop_ratio=None is "
                'contradictory: reference mode samples a per-frame crop, '
                'crop_ratio=None turns cropping off')
        return None
    if cfg.crop_mode == 'reference':
        rng = np.random.RandomState(cfg.crop_seed + video_id)
        return (cfg.crop_size +
                rng.rand(num_frames) * (1.0 - cfg.crop_size)).tolist()
    if cfg.crop_mode != 'fixed':
        raise ValueError(f'crop_mode {cfg.crop_mode!r}')
    return [cfg.crop_ratio] * num_frames


def preprocess_frames(frames: list, cfg: EvalConfig, ratios=None):
    """HxWx3 RGB uint8 frames -> (imgs (F, canvas, 3) f32 normalised,
    whwh (F, 4), scale_factors (F, 4))."""
    if ratios is None:
        ratios = [cfg.crop_ratio] * len(frames)
    imgs, whwh, sfs = [], [], []
    for fr, ratio in zip(frames, ratios):
        r = T.process_frame(fr, ratio, cfg.scale, cfg.canvas)
        imgs.append(r['img'])
        whwh.append(r['whwh'])
        sfs.append(r['scale_factor'])
    return np.stack(imgs), np.stack(whwh), np.stack(sfs)


def preprocess_frames_u8(frames: list, cfg: EvalConfig, ratios=None):
    """preprocess_frames without the normalise: u8 frames, normalised on
    the device by the forward."""
    if ratios is None:
        ratios = [cfg.crop_ratio] * len(frames)
    imgs, whwh, sfs = [], [], []
    for fr, ratio in zip(frames, ratios):
        if ratio is not None:
            fr = T.center_crop(fr, ratio)
        fr, sf = T.resize_keep_ratio(fr, cfg.scale)
        h, w = fr.shape[:2]
        imgs.append(T.pad_to_canvas(fr, cfg.canvas))
        whwh.append(np.array([w, h, w, h], np.float32))
        sfs.append(sf)
    return np.stack(imgs), np.stack(whwh), np.stack(sfs)


def eval_devices(forward, devices=None) -> list:
    """The devices videos round-robin over: `devices` when given; else, for
    a forward on a card in a single-process run, every visible card; else
    the forward's own device (one process per card under a launcher; a
    CPU forward; None for a forward without `.device`)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    device = getattr(forward, 'device', None)
    if device is not None and device.type == 'cuda':
        from ..parallel.distributed import process_count
        if process_count() == 1 and torch.cuda.device_count() > 1:
            return [torch.device('cuda', i)
                    for i in range(torch.cuda.device_count())]
    return [device]


def pack_outputs(boxes, scores, gazes):
    """Forward outputs -> (gaze_names, flat (N, 27) f32 tensor): one packed
    tensor, so a video's results come back in one copy."""
    names = tuple(sorted(gazes))
    n = boxes.shape[0]
    flat = torch.cat(
        [boxes.reshape(n, 12).float(), scores.reshape(n, 3).float()] +
        [gazes[m].reshape(n, 3).float() for m in names], dim=1)
    return names, flat


class VideoGazeEvaluator:
    """Stitches batched clip predictions into per-video tracks.

    forward_fn(imgs (K*T, H, W, 3), whwh (K*T, 4), T) ->
        (boxes (K*T, 3, 4), scores (K*T, 3), gazes dict of (K*T, 3)),
    as tensors (bind_forward); optional `.dedup`, `.accepts_uint8` and
    `.device` attributes.
    """

    def __init__(self, forward_fn: Callable, cfg: EvalConfig = EvalConfig()):
        self.forward = forward_fn
        self.cfg = cfg
        # the native loader (None: not tried yet; False: cannot be built,
        # decode with cv2), and which decoder the last video went through
        self._native = None
        self.decoder = None
        # cumulative host seconds per phase (decode and device_put run in
        # the prefetch thread, the rest in the caller's)
        self.phase_seconds: dict = {}

    def _phase(self, name: str, t0: float):
        self.phase_seconds[name] = (self.phase_seconds.get(name, 0.0)
                                    + time.perf_counter() - t0)

    def _submit_clips(self, imgs, whwh, starts, length):
        """Enqueue clips [start:start+length] as one batched forward
        without waiting for the device. The clip count is padded to the
        next power of two (capped at clip_batch) by repeating the last
        clip. Returns (k, k_pad, gaze_names, flat) with flat the packed
        (k_pad*length, 27) tensor on the device."""
        cfg = self.cfg
        k = len(starts)
        k_pad = min(cfg.clip_batch,
                    1 if k <= 1 else 1 << (k - 1).bit_length())
        starts = list(starts) + [starts[-1]] * (k_pad - k)
        dedup = getattr(self.forward, 'dedup', None)
        if dedup is not None and cfg.dedup_frames:
            # unique-frame window: starts within a chunk ascend by at most
            # stride, so the span is fixed per (k_pad, length); the tail
            # slack repeats the last frame (computed, never selected)
            lo = starts[0]
            span = cfg.stride * (k_pad - 1) + length
            idx = np.minimum(np.arange(lo, lo + span), imgs.shape[0] - 1)
            sel = np.concatenate(
                [np.arange(s - lo, s - lo + length) for s in starts])
            boxes, scores, gazes = dedup(_take(imgs, idx), sel,
                                         _take(whwh, idx), length)
        else:
            sel = np.concatenate(
                [np.arange(s, s + length) for s in starts])
            boxes, scores, gazes = self.forward(_take(imgs, sel),
                                                _take(whwh, sel), length)
        names, flat = pack_outputs(boxes, scores, gazes)
        return k, k_pad, names, flat

    @staticmethod
    def _split_flat(flat, k, k_pad, names, length):
        """(k_pad*length, 27) numpy -> (boxes, scores, gazes) per clip."""
        boxes = flat[:, :12].reshape(k_pad, length, 3, 4)[:k]
        scores = flat[:, 12:15].reshape(k_pad, length, 3)[:k]
        gazes = {m: flat[:, 15 + 3 * i:18 + 3 * i].reshape(
                     k_pad, length, 3)[:k]
                 for i, m in enumerate(names)}
        return boxes, scores, gazes

    def _decode_video(self, paths: list, video_id: int):
        """Read, crop, resize, normalise (or, for a forward that declares
        accepts_uint8, leave u8) and pad one video's frames: in the native
        C++ thread pool, or with cv2 and the Python transforms where the
        native library cannot be built. Sets `decoder` to 'native' or
        'cv2'. Returns (imgs, whwh, sfs, num_frames)."""
        cfg = self.cfg
        native = self._native
        if native is None:
            from ..data.native_loader import NativeClipLoader
            try:
                native = self._native = NativeClipLoader()
            except (RuntimeError, OSError):
                native = self._native = False
        f = len(paths)
        crop = crop_ratios(cfg, f, video_id)
        if native is False:
            import cv2
            frames = []
            for p in paths:
                img = cv2.imread(p)
                if img is None:
                    raise FileNotFoundError(p)
                frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            imgs, whwh, sfs = preprocess_frames(frames, cfg, crop)
            self.decoder = 'cv2'
            return imgs, whwh, sfs, f
        load = (native.load_u8
                if (cfg.ship_uint8 and native.has_u8
                    and getattr(self.forward, 'accepts_uint8', False))
                else native.load)
        imgs, meta = load(paths, crop, None, cfg.scale, cfg.canvas)
        new_h = meta[:, 4].astype(np.float32)
        new_w = meta[:, 5].astype(np.float32)
        whwh = np.stack([new_w, new_h, new_w, new_h], -1)
        sfs = np.stack([new_w / meta[:, 3], new_h / meta[:, 2],
                        new_w / meta[:, 3], new_h / meta[:, 2]],
                       -1).astype(np.float32)
        self.decoder = 'native'
        return imgs, whwh, sfs, f

    def run_video_from_paths(self, paths: list, video_id: int) -> dict:
        imgs, whwh, sfs, f = self._decode_video(paths, video_id)
        return self._run_preprocessed(imgs, whwh, sfs, f, video_id)

    def run_videos_from_paths(self, videos, prefetch: int = 4,
                              devices=None):
        """Pipelined eval over (video_id, paths) pairs: a background thread
        decodes the next videos and, when the forward has a `.device`,
        copies each one's frames there (pinned memory, non-blocking) while
        the current video computes. Videos round-robin over `devices`
        (eval_devices; default every visible card of a single-process run),
        up to one video in flight per device, the forward running where
        the frames lie; with one device this is the one-device path. Yields
        per-video result dicts in input order."""
        from .pipeline import run_pipelined

        devices = eval_devices(self.forward, devices)

        def produce(i, vid, paths):
            t0 = time.perf_counter()
            imgs, whwh, sfs, f = self._decode_video(paths, vid)
            self._phase('decode', t0)
            device = devices[i % len(devices)]
            if device is not None:
                t0 = time.perf_counter()
                imgs = to_device(imgs, device)
                whwh = to_device(whwh, device)
                self._phase('device_put', t0)
            return vid, (imgs, whwh, sfs, f)

        def submit(vid, payload):
            imgs, whwh, sfs, f = payload
            return sfs, f, self._submit_video(imgs, whwh, f)

        def finish(vid, pending):
            sfs, f, sub = pending
            return self._finish_video(sub, sfs, f, vid)

        yield from run_pipelined(videos, produce, submit, finish,
                                 prefetch=prefetch, depth=len(devices))

    def run_video(self, frames: list, video_id: int) -> dict:
        cfg = self.cfg
        f = len(frames)
        prep = (preprocess_frames_u8
                if cfg.ship_uint8 and getattr(self.forward,
                                              'accepts_uint8', False)
                else preprocess_frames)
        imgs, whwh, sfs = prep(frames, cfg, crop_ratios(cfg, f, video_id))
        return self._run_preprocessed(imgs, whwh, sfs, f, video_id)

    def _run_preprocessed(self, imgs, whwh, sfs, f, video_id) -> dict:
        return self._finish_video(self._submit_video(imgs, whwh, f),
                                  sfs, f, video_id)

    def _submit_video(self, imgs, whwh, f):
        """Enqueue every chunk of one video; the read-back happens in
        _finish_video."""
        cfg = self.cfg
        slices = clip_slices(f, cfg.clip_length, cfg.stride)
        length = slices[0][1]
        starts = [s[0] for s in slices]
        t0 = time.perf_counter()
        pending = [self._submit_clips(imgs, whwh,
                                      starts[i:i + cfg.clip_batch], length)
                   for i in range(0, len(starts), cfg.clip_batch)]
        self._phase('submit', t0)
        return pending, slices, starts, length

    def _finish_video(self, submitted, sfs, f, video_id) -> dict:
        pending, slices, starts, length = submitted
        t0 = time.perf_counter()
        # one device -> host copy for the whole video
        whole = torch.cat([p[3] for p in pending], 0).cpu().numpy()
        all_boxes, all_scores, all_gazes = [], [], []
        row = 0
        for k, k_pad, names, _ in pending:
            nrows = k_pad * length
            b, s, g = self._split_flat(whole[row:row + nrows], k, k_pad,
                                       names, length)
            row += nrows
            all_boxes.append(b)
            all_scores.append(s)
            all_gazes.append(g)
        self._phase('collect', t0)
        t0 = time.perf_counter()
        boxes = np.concatenate(all_boxes)          # (K, T, 3, 4)
        scores = np.concatenate(all_scores)        # (K, T, 3)
        gazes = {k: np.concatenate([g[k] for g in all_gazes])
                 for k in all_gazes[0]}

        # boxes back to pre-resize (cropped-image) coords (rescale=True)
        for ki, s0 in enumerate(starts):
            boxes[ki] /= sfs[s0:s0 + length][:, None, :]

        # stitch into (3, F, 5) / (3, F, 3) video tracks
        vb = np.zeros((3, f, 5), np.float32)
        vg = np.zeros((3, f, 3), np.float32)
        vf = np.zeros((1, f, 3), np.float32)
        for ki, (start, length, overlap) in enumerate(slices):
            cb = np.concatenate([boxes[ki], scores[ki][..., None]],
                                -1).transpose(1, 0, 2)     # (3, T, 5)
            mask = cb[..., -1:] < PERSON_THRESHOLD
            cb[..., :4] = np.where(mask, 0.0, cb[..., :4])
            cg = np.stack([gazes['face'][ki], gazes['eyes'][ki],
                           gazes['head'][ki]], 1).transpose(1, 0, 2)
            cf = gazes['fusion'][ki][None]                 # (1, T, 3)
            if ki == 0:
                vb[:, :length] = cb
                vg[:, :length] = cg
                vf[:, :length] = cf
                continue
            new = length - overlap
            end = start + length
            # non-overlapping tail: direct assignment
            vb[:, end - new:end] = cb[:, -new:]
            vg[:, end - new:end] = cg[:, -new:]
            vf[:, end - new:end] = cf[:, -new:]
            # overlap: average; boxes invalid on either side -> zeros
            o1 = vb[:, start:start + overlap]
            o2 = cb[:, :overlap]
            m = np.logical_or(o1[..., -1:] < PERSON_THRESHOLD,
                              o2[..., -1:] < PERSON_THRESHOLD)
            avg = (o1 + o2) / 2
            avg[..., :4] = np.where(m, 0.0, avg[..., :4])
            vb[:, start:start + overlap] = avg
            vg[:, start:start + overlap] = (
                vg[:, start:start + overlap] + cg[:, :overlap]) / 2
            vf[:, start:start + overlap] = (
                vf[:, start:start + overlap] + cf[:, :overlap]) / 2

        out = self._to_result(video_id, vb, vg, vf)
        self._phase('stitch', t0)
        return out

    @staticmethod
    def _to_result(video_id, vb, vg, vf) -> dict:
        obj = dict(video_id=video_id, category_id=1, fusion_gazes=[])
        for clue in ('face', 'eyes', 'head'):
            obj[f'{clue}_bboxes'] = []
            obj[f'{clue}_gazes'] = []
            obj[f'{clue}_score'] = []
        f = vb.shape[1]
        for t in range(f):
            obj['fusion_gazes'].append(vf[0, t].tolist())
            for qi, clue in enumerate(('face', 'eyes', 'head')):
                b = vb[qi, t, :4]
                if float(b.sum()) == 0.0:
                    obj[f'{clue}_bboxes'].append(None)
                else:
                    obj[f'{clue}_bboxes'].append(
                        [float(b[0]), float(b[1]),
                         float(b[2] - b[0]), float(b[3] - b[1])])
                obj[f'{clue}_gazes'].append(vg[qi, t].tolist())
                obj[f'{clue}_score'].append(float(vb[qi, t, 4]))
        return obj


def _take(x, idx: np.ndarray):
    """x[idx] for a host array or a (device) tensor."""
    if isinstance(x, torch.Tensor):
        return x[torch.from_numpy(idx).to(x.device)]
    return x[idx]
