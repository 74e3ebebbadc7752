"""The eval driver's frame dedup (EvalConfig.dedup_frames) on the device,
counterpart of tools/analysis_tools/dedup_bench.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.dedup_bench
        [--clips 8 32] [--image 224] [--stride 4] [--iters 20]
        [--warmup 3] [--dtype bfloat16] [--device cuda|cpu]

`fwd` on the duplicated clip layout (K*T frames; K1 in its identity form)
against `fwd_dedup` on the chunk's unique frames (stride*(K-1)+T frames;
backbone + FPN once per frame, K1 in its frame_idx form), both from
evaluation/forward.py::make_eval_forward on the full-width model (seeded
random weights), timed as serial chains (utils/benchmarking.py). Prints
one JSON line per clip count.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--clips', type=int, nargs='+', default=[8, 32])
    ap.add_argument('--image', type=int, default=224)
    ap.add_argument('--stride', type=int, default=4)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--warmup', type=int, default=3)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def dedup_inputs(rng, k, image, stride, t, device):
    """The unique frames of k clips at `stride` and their slot map:
    (frames (U, H, W, 3), sel (k*T,), whwh_u (U, 4), imgs = frames[sel],
    whwh = whwh_u[sel]) as f32 / int32 tensors on `device`."""
    import torch
    u = stride * (k - 1) + t
    frames = torch.from_numpy(
        rng.randn(u, image, image, 3).astype(np.float32)).to(device)
    whwh_u = torch.full((u, 4), float(image), device=device)
    sel = torch.from_numpy(np.concatenate(
        [np.arange(s, s + t) for s in np.arange(k) * stride]
    ).astype(np.int32)).to(device)
    return frames, sel, whwh_u, frames[sel.long()], whwh_u[sel.long()]


def main(argv=None):
    """Returns one dict per clip count (the printed line)."""
    args = parse_args(argv)
    from ...evaluation.forward import make_eval_forward
    from ...models.mcgaze import ModelConfig
    from ...utils.benchmarking import serial_chain_time
    from ...utils.env import resolve_device

    device = resolve_device(args.device)
    cfg = ModelConfig(dtype=args.dtype)
    t = cfg.clip_length
    _model, fwd, fwd_dedup = make_eval_forward(cfg, device=device)

    rng = np.random.RandomState(0)
    rows = []
    for k in args.clips:
        frames, sel, whwh_u, imgs, whwh = dedup_inputs(
            rng, k, args.image, args.stride, t, device)

        def f_plain(eps):
            b, _s, g = fwd(imgs + eps, whwh, t)
            return ((b.sum() + g['fusion'].sum()) * 1e-12).float()

        def f_dedup(eps):
            b, _s, g = fwd_dedup(frames + eps, sel, whwh_u, t)
            return ((b.sum() + g['fusion'].sum()) * 1e-12).float()

        ms_plain = serial_chain_time(f_plain, args.iters, args.warmup,
                                     device=device) * 1e3
        ms_dedup = serial_chain_time(f_dedup, args.iters, args.warmup,
                                     device=device) * 1e3
        row = dict(
            clips=k, frames_plain=int(k * t), frames_unique=int(len(frames)),
            ms_plain=round(ms_plain, 3), ms_dedup=round(ms_dedup, 3),
            speedup=round(ms_plain / ms_dedup, 3),
            clips_per_sec_dedup=round(k / (ms_dedup / 1e3), 1))
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == '__main__':
    main()
