"""Per-person video gaze demo, counterpart of demo/gaze_demo.py (the
reference `MCGaze_demo/demo.ipynb`, cells 1-6): frames + head labels ->
gaze-arrow mp4.

  1. read per-frame head boxes (labels/%d.txt, `cls x1 y1 x2 y2`, cls 1 =
     head) and group consecutive frames with a constant person count into
     segments; within a segment person i is the i-th head sorted by x;
  2. per person: a square head crop at 0.8 x the larger box side around
     the box center, run through VideoGazeEvaluator (7-frame clips, stride
     4, overlap-averaged);
  3. draw the fused gaze as an arrow from the head center along (-gx, -gy)
     scaled by the box size, and write the mp4.

    python -m mcgaze_tpu_torch.demo.gaze_demo --work demo_work
        --config configs/multiclue_gaze/multiclue_gaze_r50_l2cs.py
        --checkpoint <ckpt.pth> --out new_video.mp4 [--device cuda|cpu]

(run mcgaze_tpu_torch.demo.head_det first for demo_work/{frames,labels}.)
Reading the frames, drawing and writing the mp4 need OpenCV. --device
defaults to the card and refuses without one.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

ARROW_COLOR = (230, 253, 11)     # BGR, notebook cell 5


def read_labels(path, head_class=1):
    """labels txt -> (M, 4) xyxy head boxes sorted by x1."""
    boxes = []
    if osp.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts and int(float(parts[0])) == head_class:
                    boxes.append([float(v) for v in parts[1:5]])
    boxes.sort(key=lambda b: b[0])
    return boxes


def group_segments(frame_boxes):
    """Consecutive frames with constant person count -> segments
    [{'frame_id': [...], 'persons': [per-person list of boxes]}]."""
    segments = []
    cur = None
    for fid, boxes in enumerate(frame_boxes):
        n = len(boxes)
        if cur is None or n != len(cur['persons']):
            if cur is not None:
                segments.append(cur)
            cur = dict(frame_id=[], persons=[[] for _ in range(n)])
        cur['frame_id'].append(fid)
        for i in range(n):
            cur['persons'][i].append(boxes[i])
    if cur is not None:
        segments.append(cur)
    return segments


def square_crop(img, box, margin=0.8):
    """Square crop of side 2*l, l = margin * max(box h, box w), centered on
    the box center, clamped to the image (notebook cell 4)."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = box
    cy, cx = int(y1 + y2) // 2, int(x1 + x2) // 2
    l = int(max(y2 - y1, x2 - x1) * margin)
    l = max(l, 1)
    return img[max(0, cy - l):min(cy + l, h),
               max(0, cx - l):min(cx + l, w)]


def draw_gaze(img, box, gaze, scale=1.0):
    import cv2
    x1, y1, x2, y2 = box
    cy, cx = int(y1 + y2) // 2, int(x1 + x2) // 2
    l = int(max(y2 - y1, x2 - x1) * scale)
    thick = max(5, int(l * 0.01))
    cv2.arrowedLine(img, (cx, cy),
                    (int(cx - l * gaze[0]), int(cy - l * gaze[1])),
                    ARROW_COLOR, thickness=thick)


def segment_gazes(evaluator, frames_bgr, segments, margin=0.8):
    """Per segment and person: the RGB square crops of its boxes through
    evaluator.run_video; sets seg['gazes'] to one (F, 3) fused-gaze array
    per person. Returns the segments."""
    for seg in segments:
        seg['gazes'] = []
        for boxes in seg['persons']:
            crops = [
                np.ascontiguousarray(
                    square_crop(frames_bgr[fid], box, margin)[..., ::-1])
                for fid, box in zip(seg['frame_id'], boxes)]
            res = evaluator.run_video(crops, video_id=0)
            seg['gazes'].append(np.asarray(res['fusion_gazes']))
    return segments


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--work', default='demo_work',
                   help='dir with frames/ and labels/ from head_det')
    p.add_argument('--config',
                   default='configs/multiclue_gaze/'
                           'multiclue_gaze_r50_l2cs.py')
    p.add_argument('--checkpoint', default=None,
                   help='torch .pth (omit for seeded random weights)')
    p.add_argument('--out', default='new_video.mp4')
    p.add_argument('--fps', type=float, default=25.0)
    p.add_argument('--crop-margin', type=float, default=0.8)
    p.add_argument('--dtype', default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(segments, frames, out)."""
    from ..evaluation.driver import VideoGazeEvaluator
    from ..tools.test_gaze360_gaze import build_forward
    from ..utils.cfg_options import apply_overrides
    from ..utils.config import load_config

    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    forward = build_forward(cfg, args.checkpoint, args.dtype,
                            device=args.device)
    evaluator = VideoGazeEvaluator(forward, cfg.eval_cfg)
    import cv2

    frames_dir = osp.join(args.work, 'frames')
    labels_dir = osp.join(args.work, 'labels')
    n_frames = len([f for f in os.listdir(frames_dir)
                    if f.endswith('.jpg')])
    frames = [cv2.imread(osp.join(frames_dir, f'{i}.jpg'))
              for i in range(n_frames)]
    frame_boxes = [read_labels(osp.join(labels_dir, f'{i}.txt'))
                   for i in range(n_frames)]
    segments = group_segments(frame_boxes)
    print(f'{n_frames} frames, {len(segments)} constant-person segments')

    segment_gazes(evaluator, frames, segments, args.crop_margin)
    for seg in segments:
        for j, fid in enumerate(seg['frame_id']):
            for boxes, gazes in zip(seg['persons'], seg['gazes']):
                draw_gaze(frames[fid], boxes[j], gazes[j])

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*'mp4v'),
                             args.fps, (w, h))
    try:
        for fr in frames:
            writer.write(fr)
    finally:
        writer.release()
    print(f'wrote {args.out}')
    return dict(segments=segments, frames=n_frames, out=args.out)


if __name__ == '__main__':
    main()
