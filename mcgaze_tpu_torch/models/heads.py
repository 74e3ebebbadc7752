"""Query-interaction and gaze heads, counterpart of
mcgaze_tpu/models/heads.py.

  * STQIHead: spatial then temporal self-attention through ONE shared
    attention module and ONE shared LayerNorm, DynamicConv instance
    interaction, FFN, per-clue cls/reg towers and linear heads
    (reference gaze_stqi_head.py);
  * GazeHead: per-clue gaze towers, confidence towers on detached
    features, the learned 9 -> 3 fusion, unit-norm outputs
    (reference gaze_head.py).

With `fused_attention`, STQIHead runs steps (a)+(b) through
ops/stqi_attention.py (one kernel launch per stage on a card) on the same
parameters. With `batched_clues` (ModelConfig.batched_clue_heads), the
per-clue linear heads of STQIHead and the towers and heads of GazeHead
run as one batched product over the three clues (`_batched_towers`,
`_batched_heads`), again on the same parameters. Module names follow the
reference state dict (`attention.attn.in_proj_*`, `ffn.layers.0.0`,
`cls_fcs.{3i}`, ...), so a reference checkpoint loads as it is. LayerNorm
eps is 1e-5 everywhere.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stqi_attention import fused_stqi_attention
from .layers import LayerNorm, Linear, blocked_linear

CLUES = ('face', 'eyes', 'head')
# rows per product of STQIHead's attention in_proj and DynamicConv fc_layer
# in eval mode (layers.blocked_linear): a clip's outputs do not depend on
# the clips that share its serving bucket or eval batch. 128 rows: 6
# products for 32 clips of 7 x 3 queries, one for a lone clip. A train
# step sums its batch into one loss and keeps one product.
BLOCK_ROWS = 128


class _PackedAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj, out_proj)
    with the JAX TorchMHA's arithmetic: f32 logits divided by sqrt(d).
    block_rows: in_proj through blocked_linear in eval mode."""

    def __init__(self, embed: int, heads: int, block_rows=None):
        super().__init__()
        self.heads, self.block_rows = heads, block_rows
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed, embed))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed))
        self.out_proj = Linear(embed, embed)

    def forward(self, x):
        """x: (B, S, E) -> (B, S, E), no residual."""
        b, s, e = x.shape
        hd = e // self.heads
        qkv = blocked_linear(x, self.in_proj_weight, self.in_proj_bias,
                             None if self.training else self.block_rows)
        q, k, v = (t.reshape(b, s, self.heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(out)


def _batched_towers(x, towers):
    """x (N, Q, C); towers: Q mlp_towers of equal shape. Each layer is one
    (Q, C, C') batched product, computed in f32 from operands rounded to
    x's dtype, then a per-clue f32 LayerNorm and ReLU rounded to x's
    dtype (the JAX batched path's numerics)."""
    dtype = x.dtype
    for li in range(0, len(towers[0]), 3):
        lin, norm = [t[li] for t in towers], [t[li + 1] for t in towers]
        kern = torch.stack([m.weight for m in lin]).to(dtype).float()
        y = torch.einsum('nqc,qdc->nqd', x.float(), kern)
        y = F.layer_norm(y, y.shape[-1:], eps=norm[0].eps)
        y = (y * torch.stack([m.weight for m in norm])
             + torch.stack([m.bias for m in norm]))
        x = F.relu(y).to(dtype)
    return x


def _batched_heads(x, heads):
    """x (N, Q, C); heads: Q Linear(C, O). One (Q, C, O) batched product in
    f32 from operands rounded to x's dtype, rounded to x's dtype, plus the
    bias in x's dtype."""
    dtype = x.dtype
    kern = torch.stack([m.weight for m in heads]).to(dtype).float()
    bias = torch.stack([m.bias for m in heads]).to(dtype)
    return torch.einsum('nqc,qoc->nqo', x.float(), kern).to(dtype) + bias


class MultiheadAttention(nn.Module):
    """mmcv's residual MultiheadAttention brick: x + attn(x)."""

    def __init__(self, embed: int, heads: int, block_rows=None):
        super().__init__()
        self.attn = _PackedAttention(embed, heads, block_rows)

    def forward(self, x):
        return x + self.attn(x)


def mlp_tower(features: int, num_layers: int):
    """n x (Linear-no-bias -> LayerNorm -> ReLU); keys `{3i}` / `{3i+1}`."""
    layers = []
    for _ in range(num_layers):
        layers += [Linear(features, features, bias=False),
                   LayerNorm(features), nn.ReLU()]
    return nn.Sequential(*layers)


class DynamicConv(nn.Module):
    """Query-conditioned 1x1 conv over the RoI feature (reference
    mmdet/models/utils/transformer.py DynamicConv). block_rows: fc_layer
    through blocked_linear in eval mode."""

    def __init__(self, channels=256, feat_channels=64, roi_size=7,
                 block_rows=None):
        super().__init__()
        self.channels, self.feat_channels = channels, feat_channels
        self.block_rows = block_rows
        self.dynamic_layer = Linear(channels, 2 * channels * feat_channels)
        self.norm_in = LayerNorm(feat_channels)
        self.norm_out = LayerNorm(channels)
        self.fc_layer = Linear(roi_size * roi_size * channels, channels)
        self.fc_norm = LayerNorm(channels)

    def forward(self, query, roi):
        """query: (M, C); roi: (M, S, S, C) -> (M, C)."""
        c, f = self.channels, self.feat_channels
        m = query.shape[0]
        params = self.dynamic_layer(query)
        p_in = params[:, :c * f].reshape(m, c, f)
        p_out = params[:, c * f:].reshape(m, f, c)
        x = roi.reshape(m, -1, c)
        x = F.relu(self.norm_in(torch.bmm(x, p_in)))
        x = F.relu(self.norm_out(torch.bmm(x, p_out)))
        x = blocked_linear(x.reshape(m, -1), self.fc_layer.weight,
                           self.fc_layer.bias,
                           None if self.training else self.block_rows)
        return F.relu(self.fc_norm(x))


class _FFN(nn.Module):
    """mmcv FFN's layers (`layers.0.0`, `layers.1`), without the identity:
    the head adds it before `ffn_norm`."""

    def __init__(self, channels: int, ffn_channels: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(channels, ffn_channels), nn.ReLU()),
            Linear(ffn_channels, channels))

    def forward(self, x):
        return self.layers(x)


class STQIHead(nn.Module):
    """One refinement stage: spatio-temporal query interaction, then
    per-clue classification logits and box deltas."""

    def __init__(self, channels=256, num_heads=8, ffn_channels=2048,
                 feat_channels=64, roi_size=7, num_queries=3,
                 num_cls_fcs=1, num_reg_fcs=3, fused_attention=False,
                 batched_clues=False):
        super().__init__()
        self.fused_attention = fused_attention
        self.batched_clues = batched_clues
        self.attention = MultiheadAttention(channels, num_heads, BLOCK_ROWS)
        self.attention_norm = LayerNorm(channels)
        self.instance_interactive_conv = DynamicConv(
            channels, feat_channels, roi_size, BLOCK_ROWS)
        self.instance_interactive_conv_norm = LayerNorm(channels)
        self.ffn = _FFN(channels, ffn_channels)
        self.ffn_norm = LayerNorm(channels)
        self.cls_fcs = mlp_tower(channels, num_cls_fcs)
        self.reg_fcs = mlp_tower(channels, num_reg_fcs)
        for clue in CLUES[:num_queries]:
            self.add_module(f'{clue}_fc_cls', Linear(channels, 1))
            self.add_module(f'{clue}_fc_reg', Linear(channels, 4))

    def forward(self, roi_feat, query, clip_length: int):
        """roi_feat: (N*Q, S, S, C); query: (N, Q, C), N = B*T.
        Returns (cls_logits (N, Q, 1), deltas (N, Q, 4), obj (N, Q, C))."""
        n, nq, c = query.shape
        t = clip_length
        b = n // t
        if self.fused_attention:
            # (a) + (b) in f32 in one call, as the JAX fused head does
            attn, norm = self.attention.attn, self.attention_norm
            q = fused_stqi_attention(
                query.float().contiguous(),
                attn.in_proj_weight.float().t().contiguous(),
                attn.in_proj_bias.float(),
                attn.out_proj.weight.float().t().contiguous(),
                attn.out_proj.bias.float(), norm.weight.float(),
                norm.bias.float(), clip_length=t,
                heads=attn.heads).to(query.dtype)
        else:
            # (a) spatial: the Q clue queries of each frame attend to each
            # other
            q = self.attention_norm(self.attention(query))
            # (b) temporal, same weights and norm: each clue across T frames
            q = q.reshape(b, t, nq, c).transpose(1, 2).reshape(b * nq, t, c)
            q = self.attention_norm(self.attention(q))
            q = q.reshape(b, nq, t, c).transpose(1, 2).reshape(n, nq, c)

        # (c) DynamicConv + residual + LN
        flat_q = q.reshape(n * nq, c)
        iic = self.instance_interactive_conv(flat_q, roi_feat)
        obj = self.instance_interactive_conv_norm(flat_q + iic)
        # (d) FFN, residual, norm
        obj = self.ffn_norm(obj + self.ffn(obj))
        # (e) towers and per-clue heads
        cls_feat = self.cls_fcs(obj).reshape(n, nq, c)
        reg_feat = self.reg_fcs(obj).reshape(n, nq, c)
        clues = CLUES[:nq]
        if self.batched_clues:
            cls_logits = _batched_heads(cls_feat, [
                getattr(self, f'{clue}_fc_cls') for clue in clues])
            deltas = _batched_heads(reg_feat, [
                getattr(self, f'{clue}_fc_reg') for clue in clues])
            return cls_logits, deltas, obj.reshape(n, nq, c)
        cls_logits = torch.stack(
            [getattr(self, f'{clue}_fc_cls')(cls_feat[:, i])
             for i, clue in enumerate(clues)], dim=1)
        deltas = torch.stack(
            [getattr(self, f'{clue}_fc_reg')(reg_feat[:, i])
             for i, clue in enumerate(clues)], dim=1)
        return cls_logits, deltas, obj.reshape(n, nq, c)


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


class GazeHead(nn.Module):
    """Per-clue gaze regression and confidence-weighted fusion."""

    def __init__(self, channels=256, gaze_dim=3, batched_clues=False):
        super().__init__()
        self.batched_clues = batched_clues
        for clue in CLUES:
            self.add_module(f'gaze_{clue}_fcs', mlp_tower(channels, 2))
            self.add_module(f'gaze_{clue}_confidence', mlp_tower(channels, 2))
            self.add_module(f'fc_{clue}', Linear(channels, 3))
            self.add_module(f'fc_{clue}_confidence', Linear(channels,
                                                            gaze_dim))
        self.fc_gaze = Linear(3 * 3, 3)

    def forward(self, obj_feat):
        """obj_feat: (N, 3, C) -> dict of unit gaze vectors (N, 3)."""
        if self.batched_clues:
            def part(fmt):
                return [getattr(self, fmt.format(clue)) for clue in CLUES]

            g = _batched_towers(obj_feat, part('gaze_{}_fcs'))
            gazes = _batched_heads(g, part('fc_{}'))          # (N, 3, 3)
            # confidence towers read DETACHED features (gaze_head.py:168)
            f = _batched_towers(obj_feat.detach(), part('gaze_{}_confidence'))
            confs = _batched_heads(f, part('fc_{}_confidence'))
            # (N, Q, 3) -> (N, 9) clue-major == cat([c_i * g_i], -1)
            fusion = self.fc_gaze((confs * gazes).reshape(-1, 9))
            return dict(fusion=_unit(fusion), face=_unit(gazes[:, 0]),
                        eyes=_unit(gazes[:, 1]), head=_unit(gazes[:, 2]))
        gazes, confs = [], []
        for i, clue in enumerate(CLUES):
            g = getattr(self, f'gaze_{clue}_fcs')(obj_feat[:, i])
            gazes.append(getattr(self, f'fc_{clue}')(g))
            # confidence towers read DETACHED features (gaze_head.py:168)
            f = getattr(self, f'gaze_{clue}_confidence')(
                obj_feat[:, i].detach())
            confs.append(getattr(self, f'fc_{clue}_confidence')(f))
        fused_in = torch.cat([c * g for c, g in zip(confs, gazes)], dim=-1)
        fusion = self.fc_gaze(fused_in)
        return dict(fusion=_unit(fusion), face=_unit(gazes[0]),
                    eyes=_unit(gazes[1]), head=_unit(gazes[2]))
