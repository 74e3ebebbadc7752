"""MsgShifT, the TeViT backbone, counterpart of mcgaze_tpu/models/msgshift.py:
a PVTv2 pyramid (patch sizes 7/3/3/3, strides 4/2/2/2, no absolute
position embedding, a LayerNorm after each stage, a convolutional FFN)
with `num_msg_tokens` learned messenger tokens that ride along every stage
and are rolled across the clip's frames after each encoder layer. The
messengers are the only channel between frames.

Messengers have no spatial extent, so every convolution the spatial tokens
pass through reaches them as its spatially summed kernel, a plain matmul:
the OIHW weight summed over (2, 3) (the depthwise 3x3 becomes a
per-channel scale, its (hidden, 1, 3, 3) weight summed over (1, 2, 3)).

Tokens are (N, h*w, C) in row-major (h, w) order, as the JAX package's
reshape of its NHWC maps; the convolutions see them as NCHW. LayerNorm
eps is 1e-6 here (the heads' is 1e-5); GELU is exact; attention logits and
softmax are f32. Parameter names are the reference's
(`layers.{i}.0.projection|norm`, `layers.{i}.1.{l}.{norm1, attn.attn.
in_proj_*, attn.attn.out_proj, attn.sr, attn.norm, norm2, ffn.layers.
{0,1,4}}`, `layers.{i}.2`, `msg_tokens`).

DropPath (stochastic depth) wraps both residual branches of every encoder
layer, its rate ramping linearly from 0 to `drop_path_rate` over all the
layers: one Bernoulli(keep) draw per frame and branch, kept rows scaled by
1/keep, one mask shared by a frame's spatial and messenger tokens. It is
active only in a forward given train=True, and its masks come from the
caller's torch.Generator.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear, cast_param

LN_EPS_PVT = 1e-6


def _tokens_to_nchw(x: torch.Tensor, hw) -> torch.Tensor:
    n, _, c = x.shape
    return x.transpose(1, 2).reshape(n, c, *hw)


def _nchw_to_tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def _summed(conv: nn.Conv2d, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """A convolution's spatially summed kernel as a (C_in, C_out) matrix and
    its bias, in `dtype`."""
    return (conv.weight.sum((2, 3)).t().to(dtype),
            cast_param(conv.bias, dtype))


class CrossMHA(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj, out_proj)
    on distinct query and key-value inputs: q from the first E rows of the
    in-proj, k and v from the rest."""

    def __init__(self, embed: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed, embed))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed))
        self.out_proj = Linear(embed, embed)

    def forward(self, q_in, kv_in):
        e, h = self.in_proj_weight.shape[1], self.heads
        hd = e // h
        w = self.in_proj_weight.to(q_in.dtype)
        b = self.in_proj_bias.to(q_in.dtype)
        q = F.linear(q_in, w[:e], b[:e])
        k, v = F.linear(kv_in, w[e:], b[e:]).chunk(2, dim=-1)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], h, hd).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        attn = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(
            q_in.shape[0], q_in.shape[1], e)
        return self.out_proj(out)


class PatchEmbed(nn.Module):
    """Strided convolution patch embedding and its LayerNorm; messengers go
    through the summed kernel."""

    def __init__(self, in_channels: int, embed_dim: int, patch: int,
                 stride: int, pad: int):
        super().__init__()
        self.projection = Conv2d(in_channels, embed_dim, patch,
                                 stride=stride, padding=pad)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS_PVT)

    def forward(self, x, msg):
        """x (N, C, H, W); msg (N, M, C) -> (tokens (N, h*w, E), (h, w),
        msg (N, M, E))."""
        x = self.projection(x)
        hw = tuple(x.shape[2:])
        w, b = _summed(self.projection, msg.dtype)
        msg = msg @ w + b
        return self.norm(_nchw_to_tokens(x)), hw, self.norm(msg)


class SRAttention(nn.Module):
    """Spatial-reduction attention: queries are [spatial tokens;
    messengers]; with sr_ratio > 1 the keys and values are the sr-reduced
    spatial tokens and the sr-projected messengers, LayerNormed together;
    with sr_ratio 1 they are the spatial tokens alone."""

    def __init__(self, channels: int, heads: int, sr_ratio: int):
        super().__init__()
        self.sr_ratio = sr_ratio
        self.attn = CrossMHA(channels, heads)
        if sr_ratio > 1:
            self.sr = Conv2d(channels, channels, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(channels, eps=LN_EPS_PVT)

    def forward(self, x, hw, msg):
        m = msg.shape[1]
        x_q = torch.cat([x, msg], 1)
        if self.sr_ratio > 1:
            # the JAX sr conv pads 'SAME', which is no padding only when
            # the stage's sides divide by sr_ratio
            if hw[0] % self.sr_ratio or hw[1] % self.sr_ratio:
                raise ValueError(f'stage {hw} does not divide by sr_ratio '
                                 f'{self.sr_ratio}')
            x_kv = _nchw_to_tokens(self.sr(_tokens_to_nchw(x, hw)))
            w, b = _summed(self.sr, msg.dtype)
            x_kv = self.norm(torch.cat([x_kv, msg @ w + b], 1))
        else:
            x_kv = x
        out = self.attn(x_q, x_kv)
        return out[:, :-m], out[:, -m:]


class MixFFN(nn.Module):
    """1x1 conv, 3x3 depthwise conv, GELU, 1x1 conv (`layers.{0,1,4}`);
    messengers take the summed kernels, the depthwise one as a per-channel
    scale."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            Conv2d(channels, hidden, 1),
            Conv2d(hidden, hidden, 3, padding=1, groups=hidden),
            nn.GELU(), nn.Identity(),
            Conv2d(hidden, channels, 1))

    def forward(self, x, hw, msg):
        fc1, dw, _, _, fc2 = self.layers
        y = F.gelu(dw(fc1(_tokens_to_nchw(x, hw))))
        y = _nchw_to_tokens(fc2(y))
        dtype = msg.dtype
        w1, b1 = _summed(fc1, dtype)
        w2, b2 = _summed(fc2, dtype)
        msg = msg @ w1 + b1
        msg = (msg * dw.weight.sum((1, 2, 3)).to(dtype)
               + cast_param(dw.bias, dtype))
        return y, F.gelu(msg) @ w2 + b2


def shift_msg_tokens(msg: torch.Tensor, clip_length: int,
                     strides: Tuple[int, ...]) -> torch.Tensor:
    """Roll messenger-token groups across the time axis: msg (B*T, M, C),
    M divisible by len(strides); group g rolls by strides[g] frames."""
    bt, m, c = msg.shape
    t, g = clip_length, len(strides)
    msg = msg.reshape(bt // t, t, g, m // g, c)
    rolled = [torch.roll(msg[:, :, i], s, dims=1)
              for i, s in enumerate(strides)]
    return torch.stack(rolled, dim=2).reshape(bt, m, c)


def drop_path_mask(n: int, rate: float, generator: torch.Generator,
                   dtype, device) -> torch.Tensor:
    """(n, 1, 1) per-frame DropPath mask: Bernoulli(1 - rate) rows scaled
    by 1/(1 - rate)."""
    keep = 1.0 - rate
    u = torch.rand((n, 1, 1), generator=generator, device=device)
    return (u < keep).to(dtype) / keep


class PVTEncoderLayer(nn.Module):
    """Pre-norm SR attention and MixFFN, each a residual branch over the
    spatial and messenger tokens, each under DropPath at `drop_path`."""

    def __init__(self, channels: int, heads: int, hidden: int,
                 sr_ratio: int, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(channels, eps=LN_EPS_PVT)
        self.attn = SRAttention(channels, heads, sr_ratio)
        self.norm2 = LayerNorm(channels, eps=LN_EPS_PVT)
        self.ffn = MixFFN(channels, hidden)

    def forward(self, x, hw, msg, generator: Optional[torch.Generator] = None):
        """generator: draws this layer's two DropPath masks; None (eval)
        or a zero rate leaves both branches whole."""
        drop = generator is not None and self.drop_path > 0.0
        ax, amsg = self.attn(self.norm1(x), hw, self.norm1(msg))
        if drop:
            mask = drop_path_mask(x.shape[0], self.drop_path, generator,
                                  x.dtype, x.device)
            ax, amsg = ax * mask, amsg * mask
        x, msg = x + ax, msg + amsg
        fx, fmsg = self.ffn(self.norm2(x), hw, self.norm2(msg))
        if drop:
            mask = drop_path_mask(x.shape[0], self.drop_path, generator,
                                  x.dtype, x.device)
            fx, fmsg = fx * mask, fmsg * mask
        return x + fx, msg + fmsg


class MsgShifT(nn.Module):
    """The shipped MsgShifT configuration: 4 stages of widths
    embed_dim * num_heads (64/128/320/512), returning the 4-level NCHW
    pyramid at strides 4/8/16/32 for the FPN."""

    def __init__(self, num_msg_tokens: int = 32,
                 shift_strides: Tuple[int, ...] = (1, -1, 2, -2),
                 embed_dim: int = 64,
                 num_layers: Tuple[int, ...] = (3, 4, 6, 3),
                 num_heads: Tuple[int, ...] = (1, 2, 5, 8),
                 patch_sizes: Tuple[int, ...] = (7, 3, 3, 3),
                 strides: Tuple[int, ...] = (4, 2, 2, 2),
                 paddings: Tuple[int, ...] = (3, 1, 1, 1),
                 sr_ratios: Tuple[int, ...] = (8, 4, 2, 1),
                 mlp_ratios: Tuple[int, ...] = (8, 8, 4, 4),
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.shift_strides = tuple(shift_strides)
        self.stage_channels = tuple(embed_dim * h for h in num_heads)
        self.msg_tokens = nn.Parameter(torch.zeros(1, num_msg_tokens, 3))
        total = sum(num_layers)
        stages, in_c, gl = [], 3, 0
        for i, depth in enumerate(num_layers):
            ch = self.stage_channels[i]
            blocks = []
            for _ in range(depth):
                blocks.append(PVTEncoderLayer(
                    ch, num_heads[i], mlp_ratios[i] * ch, sr_ratios[i],
                    drop_path=drop_path_rate * gl / max(total - 1, 1)))
                gl += 1
            stages.append(nn.ModuleList([
                PatchEmbed(in_c, ch, patch_sizes[i], strides[i],
                           paddings[i]),
                nn.ModuleList(blocks),
                LayerNorm(ch, eps=LN_EPS_PVT)]))
            in_c = ch
        self.layers = nn.ModuleList(stages)

    def forward(self, x, clip_length: int,
                generator: Optional[torch.Generator] = None) -> tuple:
        """x (B*T, 3, H, W), H and W multiples of 32 -> 4 NCHW levels.
        generator: DropPath's masks (training); None: no DropPath."""
        msg = cast_param(self.msg_tokens, x.dtype).expand(x.shape[0], -1, -1)
        outs = []
        for embed, blocks, norm in self.layers:
            x, hw, msg = embed(x, msg)
            depth = len(blocks)
            for lid, block in enumerate(blocks):
                x, msg = block(x, hw, msg, generator)
                # shift directions alternate per layer; the last layer of
                # an odd-depth stage does not shift
                if not (lid == depth - 1 and depth % 2 == 1):
                    strides = (self.shift_strides if lid % 2 == 0 else
                               tuple(-s for s in self.shift_strides))
                    msg = shift_msg_tokens(msg, clip_length, strides)
            x, msg = norm(x), norm(msg)
            x = _tokens_to_nchw(x, hw)
            outs.append(x)
        return tuple(outs)
