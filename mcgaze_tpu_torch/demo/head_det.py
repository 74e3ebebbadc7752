"""Head detection stage of the demo, counterpart of demo/head_det.py
(reference `MCGaze_demo/head_det.py` + its vendored YOLOv5): mp4 ->
frames/%d.jpg + labels/%d.txt, one line `1 x1 y1 x2 y2 [conf]` per head in
original-image pixels (class 1 = head, the CrowdHuman convention), the
format demo/gaze_demo.py reads.

    python -m mcgaze_tpu_torch.demo.head_det in.mp4 crowdhuman_yolov5m.pt
        [--out-dir demo_work] [--batch 8] [--img-size 640]
        [--device cuda|cpu]

The detector is the port's YOLOv5m (models/yolov5.py), run over batches
of frames. The weights are a yolov5 state dict (.pt/.pth), or a yolov5
checkpoint whose 'model' entry is the pickled model (which needs the
yolov5 sources importable to unpickle). Reading the video and writing the
frames need OpenCV. --device defaults to the card and refuses without
one.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp


def load_yolo_state_dict(path: str) -> dict:
    """A yolov5 weights file -> its state dict: a saved state dict, a
    {'state_dict': ...} checkpoint, or a yolov5 checkpoint with the pickled
    model under 'model' (its `.float().state_dict()`)."""
    import torch
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(ckpt, dict) and 'model' in ckpt and hasattr(
            ckpt['model'], 'state_dict'):
        return ckpt['model'].float().state_dict()
    if isinstance(ckpt, dict) and 'state_dict' in ckpt:
        return ckpt['state_dict']
    if isinstance(ckpt, dict) and all(hasattr(v, 'shape')
                                      for v in ckpt.values()):
        return ckpt
    raise ValueError(f'{path}: neither a yolov5 state dict nor a yolov5 '
                     'checkpoint')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('video', help='input mp4')
    p.add_argument('weights', help='CrowdHuman YOLOv5m weights (.pt/.pth)')
    p.add_argument('--out-dir', default='demo_work',
                   help='writes <out>/frames and <out>/labels')
    p.add_argument('--conf-thres', type=float, default=0.25)
    p.add_argument('--iou-thres', type=float, default=0.45)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--img-size', type=int, default=640,
                   help='letterbox canvas (stride-32 multiple)')
    p.add_argument('--save-conf', action='store_true')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def build_detector(weights: str, img_size: int = 640,
                   conf_thres: float = 0.25, iou_thres: float = 0.45,
                   device='cuda'):
    from ..models.yolov5 import (HeadDetector, YoloConfig, YoloV5,
                                 load_yolo_weights)
    from ..utils.env import resolve_device
    device = resolve_device(device)
    model = YoloV5(YoloConfig(img_size=img_size))
    load_yolo_weights(model, load_yolo_state_dict(weights))
    return HeadDetector(model.to(device).eval(), conf_thres, iou_thres)


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(frames, heads, detections: per frame the
    (M, 5) [x1, y1, x2, y2, conf] array)."""
    args = parse_args(argv)
    detector = build_detector(args.weights, args.img_size, args.conf_thres,
                              args.iou_thres, args.device)
    import cv2

    frames_dir = osp.join(args.out_dir, 'frames')
    labels_dir = osp.join(args.out_dir, 'labels')
    os.makedirs(frames_dir, exist_ok=True)
    os.makedirs(labels_dir, exist_ok=True)

    # stream the video one detector batch at a time: a long 1080p video
    # decoded whole would not fit in host memory
    cap = cv2.VideoCapture(args.video)
    detections = []
    try:
        while True:
            batch = []
            while len(batch) < args.batch:
                ret, frame = cap.read()
                if not ret:
                    break
                batch.append(frame)
            if not batch:
                break
            # pad the tail to the batch shape
            pad = args.batch - len(batch)
            dets = detector(batch + [batch[-1]] * pad)[:len(batch)]
            for frame, det in zip(batch, dets):
                fid = len(detections)
                cv2.imwrite(osp.join(frames_dir, f'{fid}.jpg'), frame)
                with open(osp.join(labels_dir, f'{fid}.txt'), 'w') as f:
                    for x1, y1, x2, y2, conf in det:
                        line = f'1 {x1:g} {y1:g} {x2:g} {y2:g}'
                        if args.save_conf:
                            line += f' {conf:g}'
                        f.write(line + '\n')
                detections.append(det)
    finally:
        cap.release()
    heads = sum(len(d) for d in detections)
    print(f'{len(detections)} frames from {args.video}')
    print(f'{heads} head boxes -> {labels_dir}')
    return dict(frames=len(detections), heads=heads, detections=detections)


if __name__ == '__main__':
    main()
