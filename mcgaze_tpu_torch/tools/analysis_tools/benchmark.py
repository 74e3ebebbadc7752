"""Inference speed over the port's eval path, counterpart of
tools/analysis_tools/benchmark.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.benchmark <config>
        [checkpoint] [--json J --root R] [--iters 50] [--warmup 5]
        [--batch 32] [--synthetic] [--dtype D] [--device cuda|cpu]
    python -m mcgaze_tpu_torch.tools.analysis_tools.benchmark <config> --e2e
        [--e2e-videos 8] [--e2e-frames 56] [--serial] [--decode-only]
        [--ship-uint8 | --no-ship-uint8] [--no-dedup] [--batch 32]

Default mode: frames/s and clips/s of the batched clip forward
(test_gaze360_gaze.py::build_forward) on `--batch` clips of the config's
canvas, random frames (`--synthetic`, or when --json is absent) or the
dataset's first frames through the eval preprocessing, handed over from
the host each iteration and its boxes read back, as the JAX tool does.

--e2e: the whole eval path per video, as tools/test_gaze360_gaze.py runs
it: decode, preprocessing, the copy to the device, the batched forward
and the overlap stitching (evaluation/driver.py::VideoGazeEvaluator,
pipelined unless --serial), over the dataset's videos or fabricated ones.
Every (chunk, clip length) shape the run meets is run once before the
clock starts. Fabricated frames are smooth noise (scipy's Gaussian
filter, as camera frames compress, not raw noise), written as PNGs where
OpenCV is installed and decoded by the native loader or cv2; where it is
not, as .npy frames read under npy_frames.npy_frames()
(npy_frames.write_image, frame_readers). The decoder the run measured is
printed. With the fused configuration
(--cfg-options model.backbone_impl=fused model.fused_attention=True) the
forward runs K1, K4 and K5.

The device defaults to `cuda` and is refused without a card
(utils/env.py::resolve_device); --device cpu runs on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os.path as osp
import shutil
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('checkpoint', nargs='?', default=None)
    ap.add_argument('--json', default='data/gaze360/test.json')
    ap.add_argument('--root', default='data/gaze360/test_rawframes/')
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--warmup', type=int, default=5)
    ap.add_argument('--batch', type=int, default=32,
                    help='clips per forward')
    ap.add_argument('--synthetic', action='store_true',
                    help='random frames instead of the dataset')
    ap.add_argument('--dtype', default=None)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument('--cfg-options', nargs='+', default=None,
                    help="config overrides 'a.b=val'")
    ap.add_argument('--no-dedup', action='store_true',
                    help='with --e2e: turn off the driver\'s unique-frame '
                         'dedup (EvalConfig.dedup_frames)')
    ap.add_argument('--e2e', action='store_true',
                    help='the whole eval path per video (decode -> '
                         'preprocess -> H2D -> forward -> stitch), over '
                         'fabricated videos when the dataset is absent')
    ap.add_argument('--e2e-videos', type=int, default=8)
    ap.add_argument('--serial', action='store_true',
                    help='with --e2e: no decode-ahead pipeline')
    ap.add_argument('--ship-uint8', dest='ship_uint8', default=None,
                    action='store_true',
                    help='with --e2e: ship uint8 frames (default: the '
                         "config's EvalConfig.ship_uint8)")
    ap.add_argument('--no-ship-uint8', dest='ship_uint8',
                    action='store_false',
                    help='with --e2e: ship host-normalised f32 frames')
    ap.add_argument('--decode-only', action='store_true',
                    help='with --e2e: host decode + preprocess alone')
    ap.add_argument('--e2e-frames', type=int, default=56,
                    help='frames per fabricated video')
    return ap.parse_args(argv)


def load_cfg(args):
    from ...utils.cfg_options import apply_overrides
    from ...utils.config import load_config
    return apply_overrides(load_config(args.config), args.cfg_options)


def smooth_frame(rng, hw=(480, 640)) -> np.ndarray:
    """An HxWx3 uint8 frame of noise blurred with sigma 3 over each
    channel: raw noise barely compresses and overstates decode cost."""
    from scipy.ndimage import gaussian_filter
    noise = rng.randint(0, 255, (*hw, 3)).astype(np.uint8)
    return gaussian_filter(noise, sigma=(3.0, 3.0, 0.0))


def main(argv=None):
    """Returns dict(fps, clips_per_s, ms) (default mode) or the --e2e
    run's dict(mode, frames_per_s, frames, videos, seconds, phases,
    decoder)."""
    args = parse_args(argv)
    from ...utils.env import resolve_device
    device = resolve_device(args.device)
    if args.e2e:
        return bench_e2e(args, device)

    from ..test_gaze360_gaze import build_forward

    cfg = load_cfg(args)
    forward = build_forward(cfg, args.checkpoint, args.dtype, device=device)
    t = cfg.model.clip_length
    h, w = cfg.eval_cfg.canvas
    n = args.batch * t

    if args.synthetic or not osp.exists(args.json):
        if not args.synthetic:
            print(f'[benchmark] {args.json} not found -> synthetic frames')
        rng = np.random.RandomState(0)
        imgs = rng.randn(n, h, w, 3).astype(np.float32)
    else:
        import cv2

        from ...evaluation.driver import preprocess_frames
        with open(args.json) as f:
            anno = json.load(f)
        frames = []
        for video in anno['videos']:
            for name in video['file_names']:
                img = cv2.imread(osp.join(args.root, name))
                if img is None:
                    print(f'[benchmark] unreadable frame skipped: {name}')
                    continue
                frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
                if len(frames) == n:
                    break
            if len(frames) == n:
                break
        if not frames:
            print(f'[benchmark] no readable frames under {args.root} -> '
                  'synthetic frames')
            rng = np.random.RandomState(0)
            frames = list(rng.randint(0, 255, (1, h, w, 3), np.uint8))
        frames = (frames * ((n + len(frames) - 1) // len(frames)))[:n]
        imgs, _, _ = preprocess_frames(frames, cfg.eval_cfg)
    whwh = np.tile(np.asarray([[w, h, w, h]], np.float32), (n, 1))

    for _ in range(args.warmup):
        out = forward(imgs, whwh, t)
        out[0].cpu()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = forward(imgs, whwh, t)
        # one readback each iteration, as the JAX tool's loop does
        out[0].cpu()
    dt = time.perf_counter() - t0

    fps = args.iters * n / dt
    print(f'Overall fps: {fps:.1f} frames/s '
          f'({fps / t:.1f} clips/s, batch {args.batch} clips, '
          f'{dt / args.iters * 1e3:.1f} ms/forward, '
          f'device {device.type})')
    return dict(fps=fps, clips_per_s=fps / t, ms=dt / args.iters * 1e3)


def shape_signatures(videos, clip_length, eval_cfg) -> dict:
    """{(clip length, chunk sizes): one (vid, paths)} over the videos: one
    video of each shape set the timed run meets."""
    from ...evaluation.driver import clip_slices

    def sig(paths):
        slices = clip_slices(len(paths), clip_length, eval_cfg.stride)
        starts = [s[0] for s in slices]
        kps = set()
        for i in range(0, len(starts), eval_cfg.clip_batch):
            k = len(starts[i:i + eval_cfg.clip_batch])
            kps.add(min(eval_cfg.clip_batch,
                        1 if k <= 1 else 1 << (k - 1).bit_length()))
        return (slices[0][1], tuple(sorted(kps)))

    warm = {}
    for vid, paths in videos:
        warm.setdefault(sig(paths), (vid, paths))
    return warm


def bench_e2e(args, device):
    """The eval path per video (module docstring)."""
    from ...evaluation.driver import VideoGazeEvaluator
    from ..test_gaze360_gaze import build_forward
    from .npy_frames import frame_readers, write_image

    cfg = load_cfg(args)
    eval_cfg = dataclasses.replace(cfg.eval_cfg, clip_batch=args.batch,
                                   dedup_frames=not args.no_dedup)
    if args.ship_uint8 is not None:
        eval_cfg = dataclasses.replace(eval_cfg,
                                       ship_uint8=args.ship_uint8)
    evaluator = VideoGazeEvaluator(
        build_forward(cfg, args.checkpoint, args.dtype, device=device),
        eval_cfg)

    root = None
    readers = contextlib.nullcontext()
    if osp.exists(args.json):
        with open(args.json) as f:
            anno = json.load(f)
        videos = [(v['id'],
                   [osp.join(args.root, n) for n in v['file_names']])
                  for v in anno['videos'][:args.e2e_videos]]
    else:
        print(f'[benchmark] {args.json} not found -> fabricated videos')
        rng = np.random.RandomState(0)
        root = tempfile.mkdtemp(prefix='bench_e2e_')
        videos = [(vid, [write_image(osp.join(root, f'{vid:03d}', f'{f:05d}'),
                                     smooth_frame(rng))
                         for f in range(args.e2e_frames)])
                  for vid in range(args.e2e_videos)]
        readers = frame_readers()
    t = cfg.model.clip_length
    try:
        with readers:
            if args.decode_only:
                evaluator._decode_video(videos[0][1], videos[0][0])
                t0 = time.perf_counter()
                frames = 0
                for vid, paths in videos:
                    evaluator._decode_video(paths, vid)
                    frames += len(paths)
                dt = time.perf_counter() - t0
                print(f'E2E decode-only roofline: {frames / dt:.1f} '
                      f'frames/s ({frames / dt / t:.1f} clips/s equivalent, '
                      f'{len(videos)} videos, {frames} frames, {dt:.2f}s '
                      'total)')
                print(f'E2E decoder: {evaluator.decoder}')
                return dict(mode='decode_only', frames_per_s=frames / dt,
                            frames=frames, videos=len(videos), seconds=dt,
                            phases={}, decoder=evaluator.decoder)

            # run every (clip length, chunk) shape once through the
            # measured path before the clock starts
            for vid, paths in shape_signatures(videos, t, eval_cfg).values():
                if args.serial:
                    evaluator.run_video_from_paths(paths, vid)
                else:
                    list(evaluator.run_videos_from_paths([(vid, paths)]))
            evaluator.phase_seconds.clear()
            t0 = time.perf_counter()
            frames = 0
            if args.serial:
                for vid, paths in videos:
                    evaluator.run_video_from_paths(paths, vid)
                    frames += len(paths)
            else:
                for _res, (vid, paths) in zip(
                        evaluator.run_videos_from_paths(videos), videos):
                    frames += len(paths)
            dt = time.perf_counter() - t0
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
    mode = 'serial' if args.serial else 'pipelined'
    print(f'E2E eval path ({mode}): {frames / dt:.1f} frames/s '
          f'({frames / dt / t:.1f} clips/s equivalent, {len(videos)} '
          f'videos, {frames} frames, {dt:.2f}s total)')
    phases = ' '.join(f'{k}={v:.2f}s'
                      for k, v in sorted(evaluator.phase_seconds.items()))
    print(f'E2E host phases (cumulative; decode/device_put in the '
          f'producer thread): {phases}')
    print(f'E2E decoder: {evaluator.decoder}')
    return dict(mode=mode, frames_per_s=frames / dt, frames=frames,
                videos=len(videos), seconds=dt,
                phases=dict(evaluator.phase_seconds),
                decoder=evaluator.decoder)


if __name__ == '__main__':
    main()
