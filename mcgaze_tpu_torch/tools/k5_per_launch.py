"""Device time of each K5 launch (csrc/fused_bottleneck.cu) at the gaze
eval shape, beside one cuDNN convolution with the same operands:

    python -m mcgaze_tpu_torch.tools.k5_per_launch [--frames 131] [--reps 10]
        [--dtype bfloat16|float32]

For every convolution of the four ResNet-50 stage chains, in launch order,
prints one JSON object: layer, cin, cout, ksize, whether the launch adds
an identity, the kernel's ms, F.conv2d's ms (channels_last in the dtype
with its bias, TF32 off in float32; no identity add or ReLU), and the
launch's floor (kernel_bounds.k5_conv_bound: its bytes over 3.35 TB/s or
its flops over the peak K5 runs the dtype at, 989 TFLOP/s in bf16, 165 in
f32's 3xTF32, whichever is larger). In float32 the kernel is handed the
weight's tf32_split, made once outside the timing. A last object holds
the sums and the card.
Activations and weights are random, from a seed; each time is the median
of `reps` launches timed with CUDA events, L2 flushed (a 256 MB write)
before each. Needs a CUDA card.
"""
import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _native
from ..ops import fused_bottleneck as fb
from .kernel_bounds import chains, k5_conv_bound, k5_convs


def median_ms(fn, flush, reps):
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--frames', type=int, default=131)
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('bfloat16', 'float32'))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('k5_per_launch: needs a CUDA card', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    lib = _native.load('fused_bottleneck')
    fn = fb._signature(lib)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, args.dtype)
    torch.backends.cudnn.allow_tf32 = False
    totals = dict(ms=0.0, cudnn_ms=0.0, floor_ms=0.0)
    for chain in chains(50, 224):
        size = chain['size']
        m = args.frames * size * size
        for cin, cout, ksize, has_idn in k5_convs(chain):
            k = ksize * ksize * cin
            x = torch.randn(m, cin, device=dev, generator=gen).to(dt)
            a = (torch.randn(k, cout, device=dev, generator=gen)
                 * k ** -0.5).to(dt)
            b = torch.randn(cout, device=dev, generator=gen) * 0.1
            idn = (torch.randn(m, cout, device=dev, generator=gen).to(dt)
                   if has_idn else None)
            out = torch.empty(m, cout, device=dev, dtype=dt)
            ka = fb.tf32_split(a) if dt == torch.float32 else a
            k_ms = median_ms(lambda: fb._conv(fn, lib, x, ka, b, idn, out,
                                              size, size, ksize, True),
                             flush, args.reps)
            weight = a.view(ksize, ksize, cin, cout).permute(3, 2, 0, 1)
            weight = weight.contiguous(memory_format=torch.channels_last)
            x4 = x.view(args.frames, size, size, cin).permute(0, 3, 1, 2)
            bias = b.to(dt)
            c_ms = median_ms(lambda: F.conv2d(x4, weight, bias,
                                              padding=ksize // 2),
                             flush, args.reps)
            floor = k5_conv_bound(m, cin, cout, ksize, has_idn,
                                  args.dtype)['bound_ms']
            totals['ms'] += k_ms
            totals['cudnn_ms'] += c_ms
            totals['floor_ms'] += floor
            print(json.dumps(dict(
                layer=chain['stage'], cin=cin, cout=cout, ksize=ksize,
                identity=has_idn, ms=k_ms, cudnn_ms=c_ms, floor_ms=floor,
                tflops=2 * m * k * cout / k_ms / 1e9)), flush=True)
            del x, a, ka, idn, out, x4, weight
    print(json.dumps(dict(totals, frames=args.frames, dtype=args.dtype,
                          device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
