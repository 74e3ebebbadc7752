"""Query-interaction and gaze heads, counterpart of
mcgaze_tpu/models/heads.py (unbatched path).

  * STQIHead: spatial then temporal self-attention through ONE shared
    attention module and ONE shared LayerNorm, DynamicConv instance
    interaction, FFN, per-clue cls/reg towers and linear heads
    (reference gaze_stqi_head.py);
  * GazeHead: per-clue gaze towers, confidence towers on detached
    features, the learned 9 -> 3 fusion, unit-norm outputs
    (reference gaze_head.py).

With `fused_attention`, STQIHead runs steps (a)+(b) through
ops/stqi_attention.py (one kernel launch per stage on a card) on the same
parameters. Module names follow the reference state dict
(`attention.attn.in_proj_*`, `ffn.layers.0.0`, `cls_fcs.{3i}`, ...), so a
reference checkpoint loads as it is. LayerNorm eps is 1e-5 everywhere.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stqi_attention import fused_stqi_attention
from .layers import LayerNorm, Linear

CLUES = ('face', 'eyes', 'head')


class _PackedAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj, out_proj)
    with the JAX TorchMHA's arithmetic: f32 logits divided by sqrt(d)."""

    def __init__(self, embed: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed, embed))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed))
        self.out_proj = Linear(embed, embed)

    def forward(self, x):
        """x: (B, S, E) -> (B, S, E), no residual."""
        b, s, e = x.shape
        hd = e // self.heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, s, self.heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(out)


class MultiheadAttention(nn.Module):
    """mmcv's residual MultiheadAttention brick: x + attn(x)."""

    def __init__(self, embed: int, heads: int):
        super().__init__()
        self.attn = _PackedAttention(embed, heads)

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
    mmdet/models/utils/transformer.py DynamicConv)."""

    def __init__(self, channels=256, feat_channels=64, roi_size=7):
        super().__init__()
        self.channels, self.feat_channels = channels, feat_channels
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
        x = self.fc_layer(x.reshape(m, -1))
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
        if batched_clues:
            raise NotImplementedError(
                'batched_clue_heads is not ported yet (ROADMAP Queue 1, '
                'item 10: opt-ins of the JAX package)')
        self.fused_attention = fused_attention
        self.attention = MultiheadAttention(channels, num_heads)
        self.attention_norm = LayerNorm(channels)
        self.instance_interactive_conv = DynamicConv(channels, feat_channels,
                                                     roi_size)
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
        if batched_clues:
            raise NotImplementedError(
                'batched_clue_heads is not ported yet (ROADMAP Queue 1, '
                'item 10: opt-ins of the JAX package)')
        for clue in CLUES:
            self.add_module(f'gaze_{clue}_fcs', mlp_tower(channels, 2))
            self.add_module(f'gaze_{clue}_confidence', mlp_tower(channels, 2))
            self.add_module(f'fc_{clue}', Linear(channels, 3))
            self.add_module(f'fc_{clue}_confidence', Linear(channels,
                                                            gaze_dim))
        self.fc_gaze = Linear(3 * 3, 3)

    def forward(self, obj_feat):
        """obj_feat: (N, 3, C) -> dict of unit gaze vectors (N, 3)."""
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
