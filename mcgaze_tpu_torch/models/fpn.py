"""Feature Pyramid Network, counterpart of mcgaze_tpu/models/fpn.py (mmdet
FPN with 4 inputs and 4 outputs of 256 channels): 1x1 laterals, exact 2x
nearest top-down, 3x3 output convs. Names are the reference's
(`lateral_convs.{i}.conv`, `fpn_convs.{i}.conv`).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class _ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: holds `.conv`."""

    def __init__(self, cin, cout, k, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=padding)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            _ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)

    def forward(self, inputs):
        """NCHW inputs -> tuple of NHWC-contiguous levels, so that the
        RoIAlign kernel reads C contiguously (a channels_last result is
        already NHWC in memory; permuting it is free)."""
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode='nearest')
        return tuple(conv(x).permute(0, 2, 3, 1).contiguous()
                     for conv, x in zip(self.fpn_convs, laterals))
