"""Train-step throughput, counterpart of tools/analysis_tools/train_bench.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.train_bench
        [--batch 32] [--image 224] [--iters 10] [--warmup 2]
        [--dtypes float32 bfloat16] [--device cuda|cpu]
    python -m mcgaze_tpu_torch.tools.analysis_tools.train_bench --e2e
        [--family gaze|query] [--blink-sampled] [--videos 8]
        [--frames 56] [--roofline-only] [--roofline-iters 5]
        [--ship-uint8 | --no-ship-uint8]

Step mode: the port's train step (train/loop.py::make_train_step; the full
gaze model, its forward, backward, clip and AdamW update) on one synthetic
batch that stays on the device, ms per step and clips/s per --dtypes. The
step is eager PyTorch: the JAX tool times a compiled step, and the port
has no compiled one (ROADMAP 8c). Each step's launches queue behind the
last; one loss readback ends the timed run.

--e2e: the training input path as well: fabricated rawframes on disk
(smooth noise, PNGs through the native loader or cv2 where OpenCV is
installed, else .npy frames under npy_frames.npy_frames(); the line names
the decoder it measured), the train dataset's decode and clip
augmentation, the prefetch thread's copy to the device, and the step.
First the host roofline, the dataset's batches alone (no device); with
--roofline-only nothing else. `pct_of_host_roofline` is the train run's
frames/s over the roofline's. --family query runs InstBlink on
MPEblink-shaped frames (640x360, 4 clips of 11 frames by default, blink
labels; --blink-sampled restricts the index to blink frames). The steps
launch K1 and K3 once per stage each.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import shutil
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--image', type=int, default=224)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--warmup', type=int, default=2)
    ap.add_argument('--dtypes', nargs='+',
                    default=['float32', 'bfloat16'])
    ap.add_argument('--e2e', action='store_true')
    ap.add_argument('--family', default='gaze',
                    choices=('gaze', 'query'),
                    help="with --e2e: 'query' measures InstBlink training "
                         'over the MPEblink-shaped input path (batch '
                         'default 4 clips of 11 frames)')
    ap.add_argument('--blink-sampled', action='store_true',
                    help='with --family query: index blink-bearing frames '
                         'only')
    ap.add_argument('--videos', type=int, default=8)
    ap.add_argument('--frames', type=int, default=56)
    ap.add_argument('--roofline-iters', type=int, default=5)
    ap.add_argument('--roofline-only', action='store_true')
    ap.add_argument('--ship-uint8', action=argparse.BooleanOptionalAction,
                    default=True,
                    help='with --e2e: raw u8 batches normalised in the step '
                         '(the native loader\'s path); --no-ship-uint8: '
                         'host-normalised f32')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def _synth_batch(args, device):
    """A gaze batch of random normalised frames and fixed boxes."""
    import torch

    from ...train.targets import slot_layout_from_counts

    rng = np.random.RandomState(0)
    b, t, img = args.batch, 7, args.image
    imgs = rng.randn(b, t, img, img, 3).astype(np.float32)
    whwh = np.tile(np.array([img] * 4, np.float32), (b, t, 1))
    boxes = np.zeros((b, t, 3, 4), np.float32)
    valid = np.zeros((b, t, 3), np.float32)
    gazes = np.zeros((b, t, 3, 3), np.float32)
    bl = [[40, 40, 180, 200], [60, 80, 120, 110], [20, 30, 200, 210]]
    gl = [[0, 0, -1]] * 3
    sb, sv, sg = slot_layout_from_counts(bl, gl)
    boxes[:], valid[:], gazes[:] = sb, sv, sg
    return {k: torch.from_numpy(v).to(device) for k, v in dict(
        imgs=imgs, img_whwh=whwh, gt_boxes=boxes, gt_valid=valid,
        gt_gazes=gazes).items()}


def bench_step(args, device):
    """The eager step on a device-resident synthetic batch."""
    from ...models.mcgaze import ModelConfig
    from ...train.loop import OptimConfig, create_train_state, make_train_step

    batch = _synth_batch(args, device)
    rows = []
    for dtype in args.dtypes:
        cfg = ModelConfig(dtype=dtype)
        oc = OptimConfig()
        state = create_train_state(cfg, oc, seed=0, device=device)
        step = make_train_step(cfg, oc)
        for _ in range(args.warmup):
            logs = step(state, batch)
        if args.warmup:
            float(logs['loss'])
        start = time.perf_counter()
        for _ in range(args.iters):
            logs = step(state, batch)
        loss = float(logs['loss'])             # one completion barrier
        dt = (time.perf_counter() - start) / args.iters
        row = dict(mode='eager_step', dtype=dtype,
                   ms_per_step=round(dt * 1e3, 2),
                   clips_per_sec=round(args.batch / dt, 1),
                   loss=round(loss, 4))
        print(json.dumps(row))
        rows.append(row)
        del state
    return rows


def _frames(root, vid, n, rng, hw):
    """n fabricated smooth frames of video vid (benchmark.smooth_frame,
    npy_frames.write_image); their names under root."""
    from .benchmark import smooth_frame
    from .npy_frames import write_image
    return [osp.relpath(write_image(osp.join(root, f'{vid:03d}', f'{f:05d}'),
                                    smooth_frame(rng, hw)), root)
            for f in range(n)]


def fabricate_rawframes(root, num_videos, frames, hw=(480, 640)):
    """Rawframes + a COCO-VID json with 3 clue tracks per video, as the JAX
    tool's fixture (smooth frames: raw noise overstates decode cost)."""
    rng = np.random.RandomState(0)
    h, w = hw
    videos, annotations = [], []
    ann_id = 1
    for vid in range(1, num_videos + 1):
        names = _frames(root, vid, frames, rng, hw)
        videos.append(dict(id=vid, width=w, height=h, length=frames,
                           file_names=names))
        gaze = rng.randn(frames, 3)
        gaze /= np.linalg.norm(gaze, axis=1, keepdims=True)
        for bb in ([w * .3, h * .2, w * .2, h * .2],
                   [w * .32, h * .24, w * .16, h * .06],
                   [w * .25, h * .1, w * .3, h * .45]):
            annotations.append(dict(id=ann_id, video_id=vid,
                                    category_id=1,
                                    bboxes=[list(bb)] * frames,
                                    gaze=gaze.tolist()))
            ann_id += 1
    ann = osp.join(root, 'train.json')
    with open(ann, 'w') as f:
        json.dump(dict(videos=videos, annotations=annotations,
                       categories=[dict(id=1, name='person_face')]), f)
    return ann, root + '/'


def fabricate_mpeblink_rawframes(root, num_videos, frames, hw=(360, 640)):
    """MPEblink-shaped fixture: 640x360 rawframes, 2 face tracks per video
    with None-box occlusions and binary blink labels."""
    rng = np.random.RandomState(0)
    h, w = hw
    videos, annotations = [], []
    ann_id = 1
    for vid in range(1, num_videos + 1):
        names = _frames(root, vid, frames, rng, hw)
        videos.append(dict(id=vid, width=w, height=h, length=frames,
                           file_names=names))
        for inst in range(2):
            bboxes, blinks_binary = [], []
            for f in range(frames):
                if inst == 1 and f % 9 == 0:
                    bboxes.append(None)          # occlusion
                    blinks_binary.append(0)
                else:
                    bboxes.append([w * .2 + inst * w * .3, h * .2,
                                   w * .15, h * .3])
                    blinks_binary.append(1 if f % 7 in (3, 4) else 0)
            annotations.append(dict(
                id=ann_id, video_id=vid, category_id=1, bboxes=bboxes,
                blinks_binary=blinks_binary, blinks=[[3, 4]]))
            ann_id += 1
    ann = osp.join(root, 'train.json')
    with open(ann, 'w') as f:
        json.dump(dict(videos=videos, annotations=annotations,
                       categories=[dict(id=1, name='person_face')]), f)
    return ann, root + '/'


def _roofline(ds, frames_per_step, iters, mode, decoder):
    """Host batches alone: ms per batch, frames/s and clips/s."""
    stream = ds.batches(seed=1)
    next(stream)                                 # warm caches
    t0 = time.perf_counter()
    for _ in range(iters):
        next(stream)
    dt = (time.perf_counter() - t0) / iters
    row = dict(mode=mode, ms_per_batch=round(dt * 1e3, 1),
               frames_per_sec=round(frames_per_step / dt, 1),
               clips_per_sec=round(ds.cfg.batch_size / dt, 1),
               decoder=decoder)
    print(json.dumps(row))
    return row


def _train(args, ds, make_state_step, frames_per_step, roofline, mode,
           device, decoder):
    """Prefetched batches through the step, per --dtypes."""
    from ...data.prefetch import device_put_batches

    rows = []
    for dtype in args.dtypes:
        state, step = make_state_step(dtype)
        prefetched = device_put_batches(ds.batches(seed=2), device)
        try:
            for _ in range(args.warmup):
                logs = step(state, next(prefetched))
            if args.warmup:
                float(logs['loss'])              # drain the warmup work
            t0 = time.perf_counter()
            for _ in range(args.iters):
                logs = step(state, next(prefetched))
            loss = float(logs['loss'])           # one completion barrier
            dt = (time.perf_counter() - t0) / args.iters
        finally:
            prefetched.close()
        fps = frames_per_step / dt
        row = dict(mode=mode, dtype=dtype, ms_per_step=round(dt * 1e3, 1),
                   frames_per_sec=round(fps, 1),
                   clips_per_sec=round(ds.cfg.batch_size / dt, 1),
                   pct_of_host_roofline=round(
                       100 * fps / roofline['frames_per_sec'], 1),
                   loss=round(loss, 4), decoder=decoder)
        print(json.dumps(row))
        rows.append(row)
        del state
    return rows


def _decoder(ds):
    """The decoder the dataset reads its frames with: the native loader
    when the gaze dataset holds one, else cv2, or the .npy readers where
    OpenCV is absent."""
    from .npy_frames import NPY_DECODE, have_cv2
    if getattr(ds, '_native', None) is not None:
        return 'native'
    return 'cv2' if have_cv2() else NPY_DECODE


def bench_e2e(args, device):
    """Sustained gaze training over the input path (module docstring)."""
    from ...data.dataset import DataConfig, Gaze360ClipDataset
    from ...models.mcgaze import ModelConfig
    from ...train.loop import OptimConfig, create_train_state, make_train_step
    from .npy_frames import frame_readers

    root = tempfile.mkdtemp(prefix='train_e2e_')
    try:
        print(f'[train_bench] fabricating {args.videos}x{args.frames} '
              f'rawframes under {root}')
        ann, prefix = fabricate_rawframes(root, args.videos, args.frames)
        img = args.image
        dcfg = DataConfig(ann_file=ann, img_prefix=prefix,
                          scale=(img, img), canvas=(img, img),
                          crop_size=0.68, flip_ratio=0.5,
                          batch_size=args.batch, ship_uint8=args.ship_uint8)
        with frame_readers():
            ds = Gaze360ClipDataset(dcfg)
            decoder = _decoder(ds)
            frames_per_step = args.batch * dcfg.clip_length
            roofline = _roofline(ds, frames_per_step, args.roofline_iters,
                                 'host_roofline', decoder)
            if args.roofline_only:
                return [roofline]

            def make(dtype):
                cfg, oc = ModelConfig(dtype=dtype), OptimConfig()
                return (create_train_state(cfg, oc, seed=0, device=device),
                        make_train_step(cfg, oc))

            return [roofline] + _train(args, ds, make, frames_per_step,
                                       roofline, 'train_e2e', device,
                                       decoder)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_e2e_query(args, device):
    """Sustained InstBlink training over the input path: 640x360 decode,
    interval-2 windows (and blink_sampled oversampling), the step."""
    from ...data.instblink_dataset import (InstBlinkClipDataset,
                                           InstBlinkDataConfig)
    from ...models.query_detector import QueryDetectorConfig
    from ...train.loop import OptimConfig
    from ...train.query_loop import (create_query_train_state,
                                     make_query_train_step)
    from .npy_frames import frame_readers

    root = tempfile.mkdtemp(prefix='train_e2e_query_')
    try:
        print(f'[train_bench] fabricating {args.videos}x{args.frames} '
              f'MPEblink rawframes under {root}')
        ann, prefix = fabricate_mpeblink_rawframes(root, args.videos,
                                                   args.frames)
        dcfg = InstBlinkDataConfig(
            ann_file=ann, img_prefix=prefix, batch_size=args.batch,
            blink_sampled=args.blink_sampled, ship_uint8=args.ship_uint8)
        with frame_readers():
            ds = InstBlinkClipDataset(dcfg)
            decoder = _decoder(ds)
            frames_per_step = args.batch * dcfg.clip_length
            roofline = _roofline(ds, frames_per_step, args.roofline_iters,
                                 'host_roofline_query', decoder)
            if args.roofline_only:
                return [roofline]

            def make(dtype):
                cfg, oc = QueryDetectorConfig(dtype=dtype), OptimConfig()
                return (create_query_train_state(cfg, oc, seed=0,
                                                 device=device),
                        make_query_train_step(cfg, oc))

            return [roofline] + _train(args, ds, make, frames_per_step,
                                       roofline, 'train_e2e_query', device,
                                       decoder)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    """Returns the printed rows."""
    args = parse_args(argv)
    from ...utils.env import resolve_device
    device = resolve_device(args.device)
    if args.e2e:
        if args.family == 'query':
            if args.batch == 32:
                args.batch = 4      # the reference's samples_per_gpu
            return bench_e2e_query(args, device)
        return bench_e2e(args, device)
    return bench_step(args, device)


if __name__ == '__main__':
    main()
