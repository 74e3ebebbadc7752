"""ResNet backbone with frozen BatchNorm (torchvision layout, stride on the
3x3), counterpart of mcgaze_tpu/models/resnet.py's plain path.

Every BatchNorm normalises with its running statistics (norm_eval=True),
so it is an affine map folded from (weight, bias, running_mean,
running_var). Module and parameter names are the reference's
(`conv1`, `bn1`, `layer{s}.{i}.conv{j}`, `downsample.{0,1}`), so a
reference state dict loads as it is. Runs in whatever memory format its
input has; the model feeds it channels_last.

`fused_blocks` (True, or a tuple of 0-based stages) runs each chosen
stage's stride-1 bottlenecks through ops/fused_bottleneck.py (the CUDA
chain kernel on a card, its plain version on the CPU), with the BN folded
into the convolutions at every call: the modules, and so the state dict,
are those of the plain path. Stride-2 lead-in blocks stay plain.

`s2d_stem` computes the 7x7 stride-2 stem as a 4x4 stride-1 convolution
on the 2x2 space-to-depth input (the same products; `_s2d_stem`), from
the same `conv1.weight`. H and W must be even.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_bottleneck import fold_block_params, fused_bottleneck_chain
from .layers import Conv2d

# depth -> blocks per stage (bottleneck depths only)
RESNET_SPECS = {
    26: (1, 1, 1, 1),  # tiny variant for fast tests
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


class FrozenBatchNorm(nn.Module):
    """BN with fixed running stats: x * w + b, where w = weight /
    sqrt(var + eps) and b = bias - mean * w are folded in f32 and cast to
    the input's dtype (as the JAX FrozenBatchNorm does)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * inv
        return (x * inv.to(x.dtype).view(1, -1, 1, 1)
                + b.to(x.dtype).view(1, -1, 1, 1))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, mid: int, stride: int = 1):
        super().__init__()
        out = mid * self.expansion
        self.conv1 = Conv2d(cin, mid, 1, bias=False)
        self.bn1 = FrozenBatchNorm(mid)
        self.conv2 = Conv2d(mid, mid, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = FrozenBatchNorm(mid)
        self.conv3 = Conv2d(mid, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(cin, out, 1, stride=stride, bias=False),
                FrozenBatchNorm(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """4-stage bottleneck ResNet; returns the (C2, C3, C4, C5) pyramid
    (strides 4..32) as NCHW tensors."""

    def __init__(self, depth: int = 50, fused_blocks=False,
                 s2d_stem: bool = False):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise ValueError(f'bottleneck depth {depth} not in '
                             f'{sorted(RESNET_SPECS)}')
        self.fused_stages = (tuple(range(4)) if fused_blocks is True
                             else tuple(fused_blocks or ()))
        self.s2d_stem = s2d_stem
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin, mid = 64, 64
        for stage, n_blocks in enumerate(RESNET_SPECS[depth]):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(Bottleneck(cin, mid, stride))
                cin = mid * Bottleneck.expansion
            self.add_module(f'layer{stage + 1}', nn.Sequential(*blocks))
            mid *= 2

    def forward(self, x):
        x = _s2d_stem(x, self.conv1.weight) if self.s2d_stem \
            else self.conv1(x)
        x = F.relu(self.bn1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(4):
            layer = getattr(self, f'layer{stage + 1}')
            if stage in self.fused_stages:
                lead = [b for b in layer if b.conv2.stride != (1, 1)]
                for block in lead:
                    x = block(x)
                chain = list(layer)[len(lead):]
                if chain:
                    x = _fused_chain(x, chain)
            else:
                x = layer(x)
            outs.append(x)
        return tuple(outs)


def _fused_chain(x, blocks):
    """The stride-1 `blocks` over NCHW x through the fused chain, in x's
    dtype. The chain takes (N, H*W, C) rows: a channels_last x is already
    that in memory, and the result comes back as a channels_last NCHW
    view."""
    n, c, h, w = x.shape
    weights = [a for block in blocks
               for a in fold_block_params(block, x.dtype)]
    y = x.permute(0, 2, 3, 1).reshape(n, h * w, c).contiguous()
    y = fused_bottleneck_chain(y, weights, h, w)
    return y.view(n, h, w, -1).permute(0, 3, 1, 2)


def _s2d_stem(x, weight):
    """The stem conv (7x7, stride 2, pad 3) of NCHW x as a 4x4 stride-1
    conv on the 2x2 space-to-depth input, in x's dtype. Output pixel o
    reads padded columns 2o..2o+6; grouping them pairwise makes that
    groups o..o+3, and kernel tap (k, r) of the 4x4 conv is tap 2k+r of
    the 7x7 one zero-padded to 8x8 (tap 7 is the pad). Channel order of
    the grouped input and kernel: (row parity, column parity, channel)."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f's2d stem needs even H and W, got {h}x{w}')
    o = weight.shape[0]
    k4 = (F.pad(weight, (0, 1, 0, 1)).reshape(o, c, 4, 2, 4, 2)
          .permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4))
    xp = F.pad(x, (3, 3, 3, 3))
    hg, wg = (h + 6) // 2, (w + 6) // 2
    xg = (xp.reshape(n, c, hg, 2, wg, 2).permute(0, 3, 5, 1, 2, 4)
          .reshape(n, 4 * c, hg, wg))
    return F.conv2d(xg, k4.to(x.dtype))
