"""Write augmented training clips with their GT drawn, counterpart of
tools/misc/browse_dataset.py:

    python -m mcgaze_tpu_torch.tools.misc.browse_dataset <config>
        --output-dir DIR [--num-clips 4] [--seed 0] [--cfg-options ...]

Each browsed clip of the port's train dataset (data/dataset.py, after the
whole train-time augmentation: crop, resize, flip, pad) becomes per-frame
PNGs with the face, eyes and head GT boxes and the head-gaze arrow drawn,
as the JAX tool draws them. Drawing and writing need OpenCV, imported
inside main; it runs on the CPU and touches no device.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

CLUE_COLORS = {0: (0, 200, 255), 1: (0, 255, 0), 2: (255, 80, 80)}  # BGR
CLUE_NAMES = {0: 'face', 1: 'eyes', 2: 'head'}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Browse a dataset')
    p.add_argument('config')
    p.add_argument('--output-dir', required=True)
    p.add_argument('--num-clips', type=int, default=4)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--cfg-options', nargs='+', default=None)
    return p.parse_args(argv)


def draw_clip(imgs, boxes, valid, gazes):
    """(T,H,W,3) normalized, (T,3,4) xyxy, (T,3), (T,3,3) -> BGR uint8."""
    import cv2

    from ...data.transforms import IMAGENET_MEAN, IMAGENET_STD
    out = []
    for t in range(imgs.shape[0]):
        img = imgs[t] * IMAGENET_STD + IMAGENET_MEAN
        img = np.clip(img, 0, 255).astype(np.uint8)[:, :, ::-1].copy()
        for q in range(boxes.shape[1]):
            if valid[t, q] <= 0:
                continue
            x1, y1, x2, y2 = (int(round(v)) for v in boxes[t, q])
            cv2.rectangle(img, (x1, y1), (x2, y2), CLUE_COLORS[q], 1)
            cv2.putText(img, CLUE_NAMES[q], (x1, max(y1 - 2, 8)),
                        cv2.FONT_HERSHEY_PLAIN, 0.8, CLUE_COLORS[q], 1)
        # head-slot gaze arrow from the head-box centre along (-gx, -gy),
        # the reference's rendering convention; a flipped frame negates
        # gx, so the arrow mirrors with it
        if valid[t, 2] > 0:
            gx, gy = float(gazes[t, 2, 0]), float(gazes[t, 2, 1])
            cx = int(round((boxes[t, 2, 0] + boxes[t, 2, 2]) / 2))
            cy = int(round((boxes[t, 2, 1] + boxes[t, 2, 3]) / 2))
            ln = 0.4 * (boxes[t, 2, 2] - boxes[t, 2, 0])
            cv2.arrowedLine(img, (cx, cy),
                            (int(round(cx - ln * gx)),
                             int(round(cy - ln * gy))),
                            (255, 255, 0), 2)
        out.append(img)
    return out


def main(argv=None):
    args = parse_args(argv)
    import cv2

    from ...data.dataset import Gaze360ClipDataset
    from ...utils.cfg_options import apply_overrides
    from ...utils.config import load_config

    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    ds = Gaze360ClipDataset(cfg.data_train, seed=args.seed)
    print(f'dataset: {len(ds)} annotated frames')
    batches = ds.batches(batch_size=1, seed=args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    for ci in range(args.num_clips):
        b = next(batches)
        frames = draw_clip(b['imgs'][0], b['gt_boxes'][0],
                           b['gt_valid'][0], b['gt_gazes'][0])
        d = osp.join(args.output_dir, f'clip_{ci:03d}')
        os.makedirs(d, exist_ok=True)
        for t, img in enumerate(frames):
            cv2.imwrite(osp.join(d, f'{t:02d}.png'), img)
        print(f'wrote {d} ({len(frames)} frames)')


if __name__ == '__main__':
    main()
