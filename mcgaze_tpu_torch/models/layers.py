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

# torch/mmcv LayerNorm epsilon of the heads (mcgaze_tpu/models/heads.py);
# the MsgShifT backbone passes its own 1e-6 (models/msgshift.py)
LN_EPS = 1e-5


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


def blocked_linear(x, weight, bias=None, rows: int | None = None):
    """F.linear in x's dtype, the rows taken `rows` at a time (the last
    block zero-padded), one product of the same shape per block. One
    product over all rows orders its sums by the row count (on the CPU;
    a GEMM library may pick another kernel or split for another count),
    so in bf16 a clip's outputs moved with the number of clips in its
    serving bucket; a block of fixed shape sums each row the same way
    whatever shares the call. rows=None: one F.linear."""
    w, b = weight.to(x.dtype), _cast(bias, x.dtype)
    if rows is None:
        return F.linear(x, w, b)
    lead, k = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, k)
    m = x.shape[0]
    x = F.pad(x, (0, 0, 0, -m % rows))
    y = torch.cat([F.linear(blk, w, b) for blk in x.split(rows)])
    return y[:m].reshape(*lead, -1)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax's `LayerNorm(dtype=...)`: the statistics, scale and bias in
    f32, y rounded once to the input's dtype. (torch on the card refuses
    a bf16 input with f32 parameters, so x is cast up first.)"""

    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__(features, eps=eps)

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
