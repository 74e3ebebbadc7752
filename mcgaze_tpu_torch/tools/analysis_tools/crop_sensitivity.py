"""Gaze learning proof and eval-crop sensitivity with the port: counterpart
of tools/analysis_tools/crop_sensitivity.py.

    python -m mcgaze_tpu_torch.tools.analysis_tools.crop_sensitivity
        [--work DIR] [--iters 300] [--videos 12] [--frames 24]
        [--train-dtype bfloat16] [--device cuda|cpu]

  1. fabricate a gaze-learnable COCO-VID dataset (a constant gaze per
     video; a line cue drawn inside the head box along the gaze's (x, y)
     projection), the JAX tool's frames from the same seed, as .npy;
  2. train a small model through mcgaze_tpu_torch.tools.train.main;
  3. score its last checkpoint through mcgaze_tpu_torch.tools.test.main
     --eval mae --l2cs with crop_mode=fixed and crop_mode=reference
     (seeds 0 and 1);
  4. print one JSON line with the MAEs and their delta.

Everything runs in this process under npy_frames(): the frames are .npy
and no reader needs OpenCV. A model that learned scores a low MAE; random
weights score tens of degrees. --device defaults to the card and refuses
without one.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import textwrap

import numpy as np

from .npy_frames import npy_frames, write_frame

W = H = 64
HEAD = [14, 10, 40, 44]          # xywh, generous so crops keep the cue
FACE = [22, 18, 24, 20]
EYES = [24, 22, 20, 8]

# cv2's drawing works in fixed point with 16 fractional bits
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _cdiv(a, b):
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _put(mask, x, y):
    if 0 <= x < mask.shape[1] and 0 <= y < mask.shape[0]:
        mask[y, x] = True


def _line_subpixel(mask, p1, p2):
    """cv2's 8-connected line between fixed-point points (its Line2)."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    steep = abs(dy) >= abs(dx)
    if (dy if steep else dx) < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    if steep:
        x_step, y_step = _cdiv(dx << _XY_SHIFT, abs(dy) | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    else:
        x_step, y_step = _XY_ONE, _cdiv(dy << _XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    half = _XY_ONE >> 1
    _put(mask, (x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT)
    x1, y1 = x1 + half, y1 + half
    for _ in range(count + 1):
        _put(mask, x1 >> _XY_SHIFT, y1 >> _XY_SHIFT)
        x1, y1 = x1 + x_step, y1 + y_step


def _fill_convex(mask, pts):
    """cv2's FillConvexPoly (8-connected) of fixed-point vertices: the
    outline, then the spans between the two edges scanline by scanline."""
    n = len(pts)
    half = _XY_ONE >> 1
    prev = pts[-1]
    for p in pts:
        _line_subpixel(mask, prev, p)
        prev = p
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))
    y = (min(ys) + half) >> _XY_SHIFT
    ymax = min((max(ys) + half) >> _XY_SHIFT, mask.shape[0] - 1)
    edges = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=y),
             dict(idx=imin, di=n - 1, x=-_XY_ONE, dx=0, ye=y)]
    left_over = n
    while True:
        for e in edges:
            if y < e['ye']:
                continue
            idx0, idx = e['idx'], (e['idx'] + e['di']) % n
            while left_over > 0:
                left_over -= 1
                ty = (pts[idx][1] + half) >> _XY_SHIFT
                if ty > y:
                    xs, xe = pts[idx0][0], pts[idx][0]
                    e.update(ye=ty, x=xs, idx=idx,
                             dx=_cdiv((xe - xs) * 2 + (ty - y),
                                      2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e['di']) % n
            else:
                left_over -= 1
        if left_over < 0:
            break
        if y >= 0:
            a, b = sorted((edges[0]['x'], edges[1]['x']))
            x1, x2 = (a + half) >> _XY_SHIFT, (b + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < mask.shape[1]:
                mask[y, max(x1, 0):min(x2, mask.shape[1] - 1) + 1] = True
        for e in edges:
            e['x'] += e['dx']
        y += 1
        if y > ymax:
            break


def _disc(mask, cx, cy, r):
    """cv2.circle(..., r, thickness=-1): every pixel within r."""
    yy, xx = np.mgrid[:mask.shape[0], :mask.shape[1]]
    mask |= (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r


def thick_line_mask(shape, p0, p1, thickness):
    """The pixels cv2.line(img, p0, p1, color, thickness) paints, for
    integer end points and thickness > 1 (8-connected): a rectangle of
    half-width (thickness + 1) / 2 around the segment, filled as cv2 fills
    it, and a disc at each end."""
    mask = np.zeros(shape, bool)
    p0 = (p0[0] << _XY_SHIFT, p0[1] << _XY_SHIFT)
    p1 = (p1[0] << _XY_SHIFT, p1[1] << _XY_SHIFT)
    dx = (p0[0] - p1[0]) / _XY_ONE
    dy = (p1[1] - p0[1]) / _XY_ONE
    r2 = dx * dx + dy * dy
    width = thickness << (_XY_SHIFT - 1)
    if r2 > np.finfo(np.float64).eps:
        r = (width + (thickness & 1) * _XY_ONE * 0.5) / np.sqrt(r2)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(mask, [(p0[0] + ox, p0[1] + oy),
                            (p0[0] - ox, p0[1] - oy),
                            (p1[0] - ox, p1[1] - oy),
                            (p1[0] + ox, p1[1] + oy)])
    radius = (width + (_XY_ONE >> 1)) >> _XY_SHIFT
    for x, y in (p0, p1):
        _disc(mask, (x + (_XY_ONE >> 1)) >> _XY_SHIFT,
              (y + (_XY_ONE >> 1)) >> _XY_SHIFT, radius)
    return mask


def paint_frame(rng, gaze):
    """Noise background + a thick line from the head-box centre along the
    gaze's (x, -y) image projection, as the JAX tool draws it with cv2
    (BGR order, the array cv2.imwrite takes). The cue lies inside the head
    box, so every legal crop (>= 0.68 of the frame, centre-anchored)
    keeps it."""
    img = rng.randint(0, 40, (H, W, 3), np.uint8)
    cx = HEAD[0] + HEAD[2] // 2
    cy = HEAD[1] + HEAD[3] // 2
    gx, gy, gz = (float(v) for v in gaze)
    n = max((gx * gx + gy * gy) ** 0.5, 1e-6)
    # direction cue: thick line along the (x, -y) projection; length and
    # endpoint colour encode the z component so all 3 DoF are visible
    ln = 6 + int(10 * min(1.0, n / max(abs(gz), 1e-6)))
    ex = int(round(cx + ln * gx / n))
    ey = int(round(cy - ln * gy / n))
    img[thick_line_mask((H, W), (cx, cy), (ex, ey), 5)] = (255, 255, 255)
    for (x, y), r, color in (((ex, ey), 3, (0, 255, 0)),
                             ((cx, cy), 2, (255, 0, 0))):
        disc = np.zeros((H, W), bool)
        _disc(disc, x, y, r)
        img[disc] = color
    return img


def make_dataset(root, num_videos, length, seed):
    """The JAX tool's dataset from the same seed, frames as .npy. Returns
    (annotation JSON path, frame prefix)."""
    rng = np.random.RandomState(seed)
    videos, annotations = [], []
    ann_id = 1
    for vid in range(1, num_videos + 1):
        # constant per-video gaze, facing the camera (z < 0) so every
        # frame lands in the front-90 scorer bucket
        yaw = rng.uniform(-np.pi / 3, np.pi / 3)
        pitch = rng.uniform(-np.pi / 4, np.pi / 4)
        gaze = np.array([np.cos(pitch) * np.sin(yaw), np.sin(pitch),
                         -np.cos(pitch) * np.cos(yaw)])
        names = []
        for f in range(length):
            name = f'{vid:03d}/{f:05d}.npy'
            write_frame(osp.join(root, 'frames', name),
                        paint_frame(rng, gaze))
            names.append(name)
        videos.append(dict(id=vid, width=W, height=H, length=length,
                           file_names=names))
        for clue, box in (('face', FACE), ('eyes', EYES), ('head', HEAD)):
            annotations.append(dict(
                id=ann_id, video_id=vid, category_id=1,
                bboxes=[list(box)] * length,
                gaze=[gaze.tolist()] * length))
            ann_id += 1
    data = dict(videos=videos, annotations=annotations,
                categories=[dict(id=1, name='person_face')])
    ann = osp.join(root, 'anno.json')
    with open(ann, 'w') as f:
        json.dump(data, f)
    return ann, osp.join(root, 'frames/')


CFG = textwrap.dedent("""
    from mcgaze_tpu.data.dataset import DataConfig
    from mcgaze_tpu.evaluation.driver import EvalConfig
    from mcgaze_tpu.models.mcgaze import ModelConfig
    from mcgaze_tpu.train.loop import OptimConfig

    model = ModelConfig(clip_length=7, backbone_depth=26, num_stages=2,
                        stage_loss_weights=(1.0, 1.0), ffn_channels=512)
    optim = OptimConfig(max_iters={iters}, warmup_iters=100,
                        lr_steps=({step},))
    data_train = DataConfig(ann_file={ann!r}, img_prefix={prefix!r},
                            scale=(64, 64), canvas=(64, 64),
                            crop_size=0.68, batch_size=8)
    data_test = data_train
    eval_cfg = EvalConfig(scale=(64, 64), canvas=(64, 64), clip_batch=4)
    checkpoint_interval = {iters}
    work_dir = {work_dir!r}
""")

EVALS = (('fixed', ['eval_cfg.crop_mode=fixed']),
         ('reference_s0', ['eval_cfg.crop_mode=reference',
                           'eval_cfg.crop_seed=0']),
         ('reference_s1', ['eval_cfg.crop_mode=reference',
                           'eval_cfg.crop_seed=1']))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--work', default='work_dirs/cropsens')
    ap.add_argument('--iters', type=int, default=300)
    ap.add_argument('--videos', type=int, default=12)
    ap.add_argument('--frames', type=int, default=24)
    ap.add_argument('--train-dtype', default=None,
                    help='model.dtype of the training run only (e.g. '
                         'bfloat16); the checkpoint holds f32 weights and '
                         'scores through the f32 eval path')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the proof. Returns dict(fixed_mae, reference_mae_mean,
    reference_seeds, delta_deg, train: the train CLI's result, evals: the
    test CLI's result per crop mode)."""
    from ...utils.env import resolve_device
    from .. import test as test_cli
    from .. import train as train_cli

    args = parse_args(argv)
    resolve_device(args.device)
    work = osp.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    ann, prefix = make_dataset(work, args.videos, args.frames, seed=7)
    cfg_path = osp.join(work, 'cfg.py')
    work_dir = osp.join(work, 'train')
    with open(cfg_path, 'w') as f:
        f.write(CFG.format(iters=args.iters, step=int(args.iters * 0.8),
                           ann=ann, prefix=prefix, work_dir=work_dir))

    print(f'training {args.iters} iters '
          f'(dtype {args.train_dtype or "config default (float32)"}) ...',
          flush=True)
    train_argv = [cfg_path, '--device', args.device, '--max-keep-ckpts',
                  '1']
    if args.train_dtype:
        train_argv += ['--cfg-options', f'model.dtype={args.train_dtype}']
    evals, maes = {}, {}
    with npy_frames():
        trained = train_cli.main(train_argv)
        ckpt = osp.join(work_dir, f'ckpt_{args.iters}.pth')
        for label, opts in EVALS:
            # --l2cs: this json carries 3 annotation tracks per video
            # (face/eyes/head, the l2cs layout -> GT row anno_id*3); the
            # gaze360 scorer's 1-track-per-video indexing would pair videos
            # with the wrong GT
            evals[label] = test_cli.main(
                [cfg_path, ckpt, '--json', ann, '--root', prefix, '--eval',
                 'mae', '--l2cs', '--device', args.device,
                 '--out', osp.join(work, f'results_{label}.json'),
                 '--cfg-options'] + opts)
            maes[label] = float(evals[label]['metrics']['MAE-Front180'])
            print(f'{label}: MAE-Front180 {maes[label]}', flush=True)

    ref = (maes['reference_s0'] + maes['reference_s1']) / 2
    out = dict(fixed_mae=maes['fixed'], reference_mae_mean=ref,
               reference_seeds=[maes['reference_s0'], maes['reference_s1']],
               delta_deg=round(ref - maes['fixed'], 4))
    print(json.dumps(out), flush=True)
    return dict(out, train=trained, evals=evals)


if __name__ == '__main__':
    main()
