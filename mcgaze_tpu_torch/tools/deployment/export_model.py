"""Serving export: the eval clip forward as a saved `torch.export`
program, counterpart of tools/deployment/export_model.py (there a
StableHLO artifact of the jitted forward; the reference's ONNX tooling,
tools/deployment/pytorch2onnx.py):

    python -m mcgaze_tpu_torch.tools.deployment.export_model <config>
        [ckpt.pth] --out model.pt2 [--batch-clips 1] [--dtype bfloat16]
        [--selftest] [--device cuda|cpu] [--cfg-options a.b=v ...]

The program maps (imgs (N, H, W, 3) f32 normalised, whwh (N, 4) f32),
N = batch_clips * clip_length, to the last stage's boxes (N, 3, 4), scores
(N, 3) and fusion, face, eyes and head gazes (N, 3 each), with the weights
inside it. `torch.export.load` reads it back once the port's operators
are registered (importing `mcgaze_tpu_torch.models.mcgaze` registers all
three): the FPN RoIAlign is the operator `torch.ops.mcgaze.roi_align_fpn`
in the program, and in the fused configuration (backbone_impl='fused',
fused_attention=True) each stride-1 bottleneck chain is
`torch.ops.mcgaze.fused_bottleneck_chain` and each stage's attention
`torch.ops.mcgaze.stqi_attention`; on the card each launches its kernel
(K1, K5, K4). --selftest loads the saved program and holds its outputs
against the eager forward at 1e-5.
--device defaults to the card and refuses without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
import time

import numpy as np
import torch
from torch import nn

SELFTEST_ATOL = 1e-5
OUTPUTS = ('boxes', 'scores', 'fusion', 'face', 'eyes', 'head')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='torch .pth (omit for seeded random weights)')
    p.add_argument('--out', required=True)
    p.add_argument('--batch-clips', type=int, default=1,
                   help='clips per forward in the exported signature')
    p.add_argument('--dtype', default=None)
    p.add_argument('--selftest', action='store_true',
                   help='load the saved program and hold it against the '
                        'eager forward')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None)
    return p.parse_args(argv)


class ClipForward(nn.Module):
    """(imgs, whwh) -> the last stage's boxes, scores and four gazes."""

    def __init__(self, model, clip_length: int):
        super().__init__()
        self.model = model
        self.clip_length = clip_length

    def forward(self, imgs, whwh):
        last = self.model(imgs, whwh, clip_length=self.clip_length)[
            'stages'][-1]
        g = last['gaze']
        return (last['boxes'], torch.sigmoid(last['cls_logits'])[..., 0],
                g['fusion'], g['face'], g['eyes'], g['head'])


def example_inputs(n, h, w, device, seed=0):
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.randn(n, h, w, 3).astype(np.float32))
    whwh = torch.tensor([[w, h, w, h]], dtype=torch.float32).repeat(n, 1)
    return imgs.to(device), whwh.to(device)


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(path, seconds, selftest_max_abs_err,
    program: the ExportedProgram, forward: the eager module exported)."""
    from ...models.mcgaze import MCGazeModel, init_model
    from ...utils.cfg_options import apply_overrides
    from ...utils.config import load_config
    from ...utils.env import resolve_device
    from ..test_gaze360_gaze import load_weights

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    model_cfg = cfg.model
    if args.dtype:
        model_cfg = dataclasses.replace(model_cfg, dtype=args.dtype)
    t = model_cfg.clip_length
    h, w = cfg.eval_cfg.canvas
    n = args.batch_clips * t

    if args.checkpoint:
        model = MCGazeModel(model_cfg)
        load_weights(model, args.checkpoint)
        model = model.to(device).eval()
    else:
        model = init_model(model_cfg, seed=0, device=device)
    # the weights are constants of the program
    model.requires_grad_(False)
    serve = ClipForward(model, t).eval()
    imgs, whwh = example_inputs(n, h, w, device)

    t0 = time.perf_counter()
    program = torch.export.export(serve, (imgs, whwh))
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    seconds = time.perf_counter() - t0
    print(f'wrote {args.out}: {osp.getsize(args.out) / 1e6:.1f} MB, '
          f'signature imgs({n},{h},{w},3) whwh({n},4) -> boxes/scores/4x '
          f'gaze, {model_cfg.dtype}, on {device}')

    err = None
    if args.selftest:
        loaded = torch.export.load(args.out).module()
        with torch.inference_mode():
            ref = serve(imgs, whwh)
            got = loaded(imgs, whwh)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(ref, got))
        if not err <= SELFTEST_ATOL:
            raise RuntimeError(f'selftest: the loaded program differs from '
                               f'the eager forward by {err} '
                               f'(atol {SELFTEST_ATOL})')
        print(f'selftest OK: the loaded program matches the eager forward '
              f'(max abs diff {err}, atol {SELFTEST_ATOL})')
    return dict(path=args.out, seconds=seconds, selftest_max_abs_err=err,
                program=program, forward=serve)


if __name__ == '__main__':
    main()
