"""InstBlink learning proof with the port: counterpart of
tools/analysis_tools/instblink_burnin.py.

    python -m mcgaze_tpu_torch.tools.analysis_tools.instblink_burnin
        [--root DIR] [--iters 600] [--train-videos 20] [--test-videos 6]
        [--seed 0] [--device cuda|cpu]

Build the JAX tool's synthetic MPEblink-layout dataset (each video shows
one bright textured rectangle drifting over a dark noisy background, the
"face" track; on blink frames a dark horizontal band crosses it), with
the same pixels from the same seed, as .npy frames. Then drive the port's
real CLIs in this process, under npy_frames() (no OpenCV):

  mcgaze_tpu_torch.tools.train_instblink.main <cfg>       (N iters)
  mcgaze_tpu_torch.tools.test_instblink.main <cfg> <ckpt> --eval

at the first checkpoint (iters / 4) and the last, and report the track mAP
and blink action AP of each. A model that learns localises the rectangle
(track AP -> ~1) and classifies the band (blink AP well above the ~0 of
random logits). The last line is one JSON object: per checkpoint step,
track mAP, AP50, AP75 and blink action AP. --device defaults to the card
and refuses without one.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from .npy_frames import npy_frames, write_frame

H, W = 96, 128
FRAMES = 24
BOX_H, BOX_W = 28, 36

CFG = """
from mcgaze_tpu.data.instblink_dataset import InstBlinkDataConfig
from mcgaze_tpu.evaluation.instblink_driver import InstBlinkEvalConfig
from mcgaze_tpu.models.query_detector import QueryDetectorConfig
from mcgaze_tpu.train.loop import OptimConfig

model = QueryDetectorConfig(
    num_stages=3, clip_length=5, num_queries=20, num_classes=1,
    channels=64, ffn_channels=256, num_heads=4, dyn_feat_channels=32,
    with_blink=True, max_per_img=4, max_instances=2)
optim = OptimConfig(lr=5e-4, max_iters={iters}, warmup_iters=100,
                    lr_steps=({step},), grad_clip_norm=0.5)
data_train = InstBlinkDataConfig(
    ann_file='{root}/train.json', img_prefix='{root}/rawframes/',
    clip_length=5, scale=(128, 96), canvas=(96, 128), batch_size=4,
    max_instances=2)
data_test = InstBlinkDataConfig(
    ann_file='{root}/test.json', img_prefix='{root}/rawframes/',
    clip_length=5, scale=(128, 96), canvas=(96, 128), max_instances=2,
    flip_ratio=0.0, keep_ratio=False)
eval_cfg = InstBlinkEvalConfig(clip_length=5, overlap=2, max_per_img=4,
                               score_threshold=0.05)
work_dir = '{root}/work'
checkpoint_interval = {ckpt_every}
log_interval = 50
"""


def fabricate(root, n_videos, rng, split):
    """The JAX tool's videos of one split from the same RNG stream, frames
    written as .npy (the array the JAX tool hands cv2.imwrite)."""
    videos, annotations = [], []
    for i in range(n_videos):
        vid = i + 1
        # linear drift, kept in-bounds
        x0 = rng.uniform(4, W - BOX_W - 4)
        y0 = rng.uniform(4, H - BOX_H - 4)
        vx = rng.uniform(-1.5, 1.5)
        vy = rng.uniform(-1.0, 1.0)
        # two blink events of 2-3 frames, apart from each other
        starts = rng.choice(np.arange(2, FRAMES - 5, 3), 2, replace=False)
        events = sorted((int(s), int(s) + int(rng.randint(1, 3)))
                        for s in starts)
        blink_binary = np.zeros(FRAMES, np.int64)
        for s, e in events:
            blink_binary[s:e + 1] = 1

        names, bboxes = [], []
        tex = rng.randint(170, 255, (BOX_H, BOX_W, 3), np.uint8)
        for f in range(FRAMES):
            x = float(np.clip(x0 + vx * f, 2, W - BOX_W - 2))
            y = float(np.clip(y0 + vy * f, 2, H - BOX_H - 2))
            img = rng.randint(0, 60, (H, W, 3), np.uint8)
            xi, yi = int(round(x)), int(round(y))
            img[yi:yi + BOX_H, xi:xi + BOX_W] = tex
            if blink_binary[f]:
                band = BOX_H // 3
                img[yi + band:yi + 2 * band, xi:xi + BOX_W] = 20
            name = f'{split}{vid:03d}/{f:05d}.npy'
            write_frame(osp.join(root, 'rawframes', name), img)
            names.append(name)
            bboxes.append([x, y, float(BOX_W), float(BOX_H)])
        videos.append(dict(id=vid, height=H, width=W, length=FRAMES,
                           file_names=names))
        annotations.append(dict(
            id=vid, video_id=vid, category_id=1, bboxes=bboxes,
            blinks_binary=blink_binary.tolist(),
            blinks=[list(e) for e in events]))
    with open(osp.join(root, f'{split}.json'), 'w') as f:
        json.dump(dict(videos=videos, annotations=annotations,
                       categories=[dict(id=1, name='person_face')]), f)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default='work_dirs/ib_burnin')
    ap.add_argument('--iters', type=int, default=600)
    ap.add_argument('--train-videos', type=int, default=20)
    ap.add_argument('--test-videos', type=int, default=6)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the proof. Returns dict(checkpoints: {step: dict(track_mAP,
    track_AP50, track_AP75, blink_ap)}, train: the train CLI's result,
    evals: the test CLI's result per step)."""
    from ...utils.env import resolve_device
    from .. import test_instblink as test_cli
    from .. import train_instblink as train_cli

    args = parse_args(argv)
    resolve_device(args.device)
    root = osp.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    fabricate(root, args.train_videos, np.random.RandomState(args.seed),
              'train')
    fabricate(root, args.test_videos,
              np.random.RandomState(args.seed + 1000), 'test')

    ckpt_every = max(args.iters // 4, 1)
    cfg_path = osp.join(root, 'burnin_cfg.py')
    with open(cfg_path, 'w') as f:
        f.write(CFG.format(root=root, iters=args.iters,
                           step=int(args.iters * 0.75),
                           ckpt_every=ckpt_every))

    print(f'[burnin] training {args.iters} iters '
          f'({args.train_videos} videos)...', flush=True)
    steps = sorted({ckpt_every, args.iters})
    scores, evals = {}, {}
    with npy_frames():
        trained = train_cli.main([cfg_path, '--device', args.device,
                                  '--max-keep-ckpts', '4'])
        for step in steps:
            ckpt = osp.join(root, 'work', f'ckpt_{step}.pth')
            if not osp.exists(ckpt):
                continue
            evals[step] = test_cli.main(
                [cfg_path, ckpt, '--out',
                 osp.join(root, f'results_{step}.json'), '--eval',
                 '--device', args.device])
            m = evals[step]['metrics']
            scores[step] = dict(track_mAP=m['mAP'], track_AP50=m['AP50'],
                                track_AP75=m['AP75'], blink_ap=m['blink_ap'])
            print(f"[burnin] iter {step}: track mAP {m['mAP']:.4f} | "
                  f"blink action AP {m['blink_ap']:.4f}", flush=True)
    print(json.dumps({str(k): v for k, v in scores.items()}), flush=True)
    return dict(checkpoints=scores, train=trained, evals=evals)


if __name__ == '__main__':
    main()
