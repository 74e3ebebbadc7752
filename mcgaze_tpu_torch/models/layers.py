"""Layers that compute in their input's dtype while their parameters stay
float32, the way flax's `Dense(dtype=...)`/`Conv(dtype=...)`/
`LayerNorm(dtype=...)` do in the JAX package: a bf16 model keeps f32
weights and casts them at use. State-dict keys are those of the torch
layers they extend.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# torch/mmcv LayerNorm epsilon, everywhere (mcgaze_tpu/models/heads.py)
LN_EPS = 1e-5


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax's `LayerNorm(dtype=...)`: the statistics, scale and bias in
    f32, y rounded once to the input's dtype. (torch on the card refuses
    a bf16 input with f32 parameters, so x is cast up first.)"""

    def __init__(self, features: int):
        super().__init__(features, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator):
    """In place: N(0, 1/fan_in) with fan_in = prod(shape[1:]) (torch's
    (out, in, ...) layout), flax's default kernel scale."""
    fan_in = math.prod(w.shape[1:])
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
    return w


def init_weights(module: nn.Module, generator: torch.Generator):
    """Seeded init below `module`, flax's defaults: lecun-normal for every
    parameter of 2+ dims, zero Linear/Conv2d biases. Norm layers keep
    their (ones, zeros)."""
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if p.dim() >= 2:
                lecun_normal_(p, generator)
            elif name == 'bias' and isinstance(m, (nn.Linear, nn.Conv2d)):
                nn.init.zeros_(p)
