"""The ResNet-50 backbone alone, plain against the fused bottleneck chains
(ops/fused_bottleneck.py, K5) per subset of fused stages, counterpart of
tools/analysis_tools/backbone_bench.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.backbone_bench
        [--batch 224] [--image 224] [--iters 20] [--warmup 3]
        [--dtype bfloat16] [--device cuda|cpu]

Every variant holds the same seeded random weights (models/resnet.py,
`fused_blocks` as the JAX ResNet takes it: True for every stage, or a
tuple of stage indices 0-3). Timed as serial chains
(utils/benchmarking.py); one JSON line per variant.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

VARIANTS = {
    'plain': False,
    'fused_all': True,
    'fused_123': (1, 2, 3),
    'fused_23': (2, 3),
    'fused_3': (3,),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=224,
                    help='frames per step (32 clips x 7)')
    ap.add_argument('--image', type=int, default=224)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--warmup', type=int, default=3)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns one dict per variant: the printed line and `k5_launches`,
    the K5 launches the variant's calls made (warmup included)."""
    args = parse_args(argv)
    import torch

    from ...models.layers import init_weights
    from ...models.mcgaze import DTYPES
    from ...models.resnet import ResNet
    from ...ops import fused_bottleneck
    from ...utils.benchmarking import serial_chain_time
    from ...utils.env import resolve_device

    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    rng = np.random.RandomState(0)
    # NHWC frames seen as NCHW (channels_last), as the model feeds them
    x = torch.from_numpy(rng.randn(args.batch, args.image, args.image, 3)
                         .astype(np.float32)).to(device, dtype)
    x = x.permute(0, 3, 1, 2)
    plain = ResNet(50)
    init_weights(plain, torch.Generator().manual_seed(0))
    state = plain.state_dict()
    rows = []
    for name, spec in VARIANTS.items():
        model = ResNet(50, fused_blocks=spec)
        model.load_state_dict(state)
        model = model.to(device).eval()

        @torch.inference_mode()
        def fwd(eps, model=model):
            outs = model(x + eps.to(dtype))
            return (sum(o.float().sum() for o in outs) * 1e-12).float()

        before = fused_bottleneck.launch_count
        dt = serial_chain_time(fwd, args.iters, args.warmup, device=device)
        row = {'variant': name, 'ms_per_step': round(dt * 1e3, 3),
               'frames_per_sec': round(args.batch / dt, 1)}
        print(json.dumps(row))
        rows.append(dict(row, k5_launches=fused_bottleneck.launch_count
                         - before))
        del model
    return rows


if __name__ == '__main__':
    main()
