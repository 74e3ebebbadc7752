"""Eval-forward time by layer, counterpart of
tools/analysis_tools/step_breakdown.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.step_breakdown
        [--batch 32] [--image 224] [--iters 20] [--warmup 3]
        [--dtype bfloat16] [--device cuda|cpu]
    python -m mcgaze_tpu_torch.tools.analysis_tools.step_breakdown
        --family query [--batch 4] [--height 384 --width 640]

Gaze: the ResNet-50 backbone, backbone + FPN, and the full model at 2 and
4 stages on `--batch` clips of 7 frames (K1 at 3 RoIs a frame); the
differences split the forward into neck, query stages and RoIAlign. Query
(InstBlink): the same on 11-frame clips of the MPEblink canvas and the
full model at 2, 4 and 6 stages (K1 at 100 RoIs). Seeded random weights;
each variant timed as a serial chain (utils/benchmarking.py); one JSON
line of ms.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=32, help='clips per step')
    ap.add_argument('--image', type=int, default=224)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--warmup', type=int, default=3)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--family', choices=('gaze', 'query'), default='gaze')
    ap.add_argument('--height', type=int, default=384,
                    help='--family query canvas height')
    ap.add_argument('--width', type=int, default=640,
                    help='--family query canvas width')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def _dep(tensors):
    """A 0-d f32 dependency of the outputs for the next chain link."""
    return (sum(t.float().sum() for t in tensors) * 1e-12).float()


def _trunk_times(args, x, widths, device):
    """{'backbone', 'backbone_fpn'}: seconds per call of the plain R50 and
    R50 + FPN on x (NCHW view of NHWC frames), seeded random weights."""
    import torch

    from ...models.fpn import FPN
    from ...models.layers import init_weights
    from ...models.resnet import ResNet
    from ...utils.benchmarking import serial_chain_time

    gen = torch.Generator().manual_seed(0)
    backbone = ResNet(50)
    neck = FPN(in_channels=widths, out_channels=256)
    init_weights(backbone, gen)
    init_weights(neck, gen)
    backbone = backbone.to(device).eval()
    neck = neck.to(device).eval()

    @torch.inference_mode()
    def bb(eps):
        return _dep(backbone(x + eps.to(x.dtype)))

    @torch.inference_mode()
    def bbf(eps):
        return _dep(neck(backbone(x + eps.to(x.dtype))))

    return dict(
        backbone=serial_chain_time(bb, args.iters, args.warmup,
                                   device=device),
        backbone_fpn=serial_chain_time(bbf, args.iters, args.warmup,
                                       device=device))


def bench_query(args, device):
    """InstBlink: backbone / +FPN / full model at 2, 4 and 6 stages on the
    MPEblink clip shape (T=11, 640x360 frames on the 384x640 canvas,
    Q=100). full_Nstage - backbone_fpn is the 100-query head path
    (RoIAlign, attention, DynamicConv, towers) the gaze path runs at Q=3."""
    import torch

    from ...models.mcgaze import DTYPES
    from ...models.query_detector import (RESNET50_CHANNELS,
                                          QueryDetectorConfig,
                                          init_query_model)
    from ...utils.benchmarking import serial_chain_time

    dt = DTYPES[args.dtype]
    t = QueryDetectorConfig().clip_length
    n = args.batch * t
    h, w = args.height, args.width
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randn(n, h, w, 3).astype(np.float32)).to(
        device)
    whwh = torch.tensor([[640., 360., 640., 360.]], device=device).repeat(
        n, 1)
    results = _trunk_times(args, imgs.to(dt).permute(0, 3, 1, 2),
                           RESNET50_CHANNELS, device)
    for stages in (2, 4, 6):
        model = init_query_model(
            QueryDetectorConfig(dtype=args.dtype, num_stages=stages),
            seed=0, device=device)

        @torch.inference_mode()
        def full(eps, model=model):
            last = model(imgs + eps, whwh, clip_length=t)['stages'][-1]
            parts = [last['boxes'], last['cls_logits']]
            if 'blink_logits' in last:
                parts.append(last['blink_logits'])
            return _dep(parts)

        results[f'full_{stages}stage'] = serial_chain_time(
            full, args.iters, args.warmup, device=device)
        del model
    ms = {k: round(v * 1e3, 3) for k, v in results.items()}
    ms['fpn'] = round(ms['backbone_fpn'] - ms['backbone'], 3)
    ms['per_stage'] = round((ms['full_6stage'] - ms['full_2stage']) / 4, 3)
    ms['head_path_6stage'] = round(
        ms['full_6stage'] - ms['backbone_fpn'], 3)
    ms['clips_per_sec_6stage'] = round(
        args.batch / (ms['full_6stage'] / 1e3), 2)
    print(json.dumps(ms))
    return ms


def main(argv=None):
    """Returns the printed dict of ms."""
    args = parse_args(argv)
    from ...utils.env import resolve_device
    device = resolve_device(args.device)
    if args.family == 'query':
        args.batch = min(args.batch, 4) if args.batch == 32 else args.batch
        return bench_query(args, device)

    import torch

    from ...models.mcgaze import DTYPES, ModelConfig, init_model
    from ...models.query_detector import RESNET50_CHANNELS
    from ...utils.benchmarking import serial_chain_time

    dt = DTYPES[args.dtype]
    n = args.batch * 7
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randn(n, args.image, args.image, 3)
                            .astype(np.float32)).to(device)
    whwh = torch.full((n, 4), float(args.image), device=device)
    results = _trunk_times(args, imgs.to(dt).permute(0, 3, 1, 2),
                           RESNET50_CHANNELS, device)
    for stages in (2, 4):
        cfg = ModelConfig(dtype=args.dtype, num_stages=stages,
                          stage_loss_weights=(1.0,) * stages)
        model = init_model(cfg, seed=0, device=device)

        @torch.inference_mode()
        def full(eps, model=model):
            last = model(imgs + eps, whwh, clip_length=7)['stages'][-1]
            return _dep([last['boxes'], last['gaze']['fusion']])

        results[f'full_{stages}stage'] = serial_chain_time(
            full, args.iters, args.warmup, device=device)
        del model
    ms = {k: round(v * 1e3, 3) for k, v in results.items()}
    ms['fpn'] = round(ms['backbone_fpn'] - ms['backbone'], 3)
    ms['per_stage'] = round(
        (ms['full_4stage'] - ms['full_2stage']) / 2, 3)
    ms['head_path_4stage'] = round(
        ms['full_4stage'] - ms['backbone_fpn'], 3)
    print(json.dumps(ms))
    return ms


if __name__ == '__main__':
    main()
