"""Plain PyTorch layers shared by the references of the MCGaze and
InstBlink families: ResNet-50 with frozen BatchNorm, the FPN, the FPN
RoIAlign, the STQI query interaction, DynamicConv, the towers and the box
decoder.

Written from the published descriptions (mmdet's ResNet, FPN,
SingleRoIExtractor with mmcv RoIAlign(aligned=True), Sparse R-CNN's
DynamicConv, MCGaze's STQI head) and checked against the semantics the
port at commit 8553edb computes. Functional over a state dict of the
reference mmdet names; it imports nothing of the program and no kernel.

Every product of a convolution or a matrix goes through `Prec`, which
rounds both operands to the precision under test and multiplies in f32:
'float32' leaves them (the reference, run with TF32 off), 'bfloat16' and
'float8' (e4m3, one scale a tensor) are the controls one step below a
configuration's own precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
LN_EPS = 1e-5
BN_EPS = 1e-5
RESNET50_BLOCKS = (3, 4, 6, 3)
DELTA_STDS = (0.5, 0.5, 1.0, 1.0)
WH_RATIO_CLIP = 16.0 / 1000.0
FP8_MAX = 448.0


class Prec:
    """Operand rounding of every conv and matmul."""

    def __init__(self, mode: str = 'float32'):
        if mode not in ('float32', 'bfloat16', 'float8'):
            raise ValueError(f'precision {mode!r}')
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == 'float32':
            return t
        if self.mode == 'bfloat16':
            return t.to(torch.bfloat16).float()
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


# ------------------------------------------------------------ parameters

def resnet50_specs(prefix='backbone.'):
    """[(name, shape, init)] of ResNet-50 with frozen BN; init is one of
    'lecun', 'zeros', 'ones'."""
    out = []

    def bn(name, c):
        out.extend([(f'{name}.weight', (c,), 'ones'),
                    (f'{name}.bias', (c,), 'zeros'),
                    (f'{name}.running_mean', (c,), 'zeros'),
                    (f'{name}.running_var', (c,), 'ones')])

    out.append((f'{prefix}conv1.weight', (64, 3, 7, 7), 'lecun'))
    bn(f'{prefix}bn1', 64)
    cin, mid = 64, 64
    for stage, blocks in enumerate(RESNET50_BLOCKS):
        for i in range(blocks):
            p = f'{prefix}layer{stage + 1}.{i}.'
            cout = 4 * mid
            out.append((p + 'conv1.weight', (mid, cin, 1, 1), 'lecun'))
            bn(p + 'bn1', mid)
            out.append((p + 'conv2.weight', (mid, mid, 3, 3), 'lecun'))
            bn(p + 'bn2', mid)
            out.append((p + 'conv3.weight', (cout, mid, 1, 1), 'lecun'))
            bn(p + 'bn3', cout)
            if i == 0:
                out.append((p + 'downsample.0.weight', (cout, cin, 1, 1),
                            'lecun'))
                bn(p + 'downsample.1', cout)
            cin = cout
        mid *= 2
    return out


def fpn_specs(c=256, widths=(256, 512, 1024, 2048), prefix='neck.'):
    out = []
    for i, w in enumerate(widths):
        out += [(f'{prefix}lateral_convs.{i}.conv.weight', (c, w, 1, 1),
                 'lecun'),
                (f'{prefix}lateral_convs.{i}.conv.bias', (c,), 'zeros')]
    for i in range(len(widths)):
        out += [(f'{prefix}fpn_convs.{i}.conv.weight', (c, c, 3, 3), 'lecun'),
                (f'{prefix}fpn_convs.{i}.conv.bias', (c,), 'zeros')]
    return out


def linear_specs(name, cin, cout, bias=True):
    out = [(f'{name}.weight', (cout, cin), 'lecun')]
    if bias:
        out.append((f'{name}.bias', (cout,), 'zeros'))
    return out


def ln_specs(name, c):
    return [(f'{name}.weight', (c,), 'ones'), (f'{name}.bias', (c,), 'zeros')]


def tower_specs(name, c, layers):
    out = []
    for i in range(layers):
        out += linear_specs(f'{name}.{3 * i}', c, c, bias=False)
        out += ln_specs(f'{name}.{3 * i + 1}', c)
    return out


def interaction_specs(p, c, ffn, feat, roi):
    """The STQI interaction of one stage: shared attention and norm,
    DynamicConv, FFN."""
    ic = p + 'instance_interactive_conv'
    return ([(p + 'attention.attn.in_proj_weight', (3 * c, c), 'lecun'),
             (p + 'attention.attn.in_proj_bias', (3 * c,), 'zeros')]
            + linear_specs(p + 'attention.attn.out_proj', c, c)
            + ln_specs(p + 'attention_norm', c)
            + linear_specs(ic + '.dynamic_layer', c, 2 * c * feat)
            + ln_specs(ic + '.norm_in', feat) + ln_specs(ic + '.norm_out', c)
            + linear_specs(ic + '.fc_layer', roi * roi * c, c)
            + ln_specs(ic + '.fc_norm', c) + ln_specs(ic + '_norm', c)
            + linear_specs(p + 'ffn.layers.0.0', c, ffn)
            + linear_specs(p + 'ffn.layers.1', ffn, c)
            + ln_specs(p + 'ffn_norm', c))


def proposal_specs(queries, c):
    return [('rpn_head.init_proposal_bboxes.weight', (queries, 4),
             'whole_image'),
            ('rpn_head.init_proposal_features.weight', (queries, c),
             'normal')]


# --------------------------------------------------------------- backbone

def normalize_u8(imgs: torch.Tensor, whwh: torch.Tensor) -> torch.Tensor:
    """(U, H, W, 3) uint8 -> ImageNet-normalised f32, zero outside each
    frame's (w, h)."""
    mean = torch.tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, device=imgs.device)
    out = (imgs.float() - mean) / std
    h, w = imgs.shape[1:3]
    xx = torch.arange(w, device=imgs.device)[None, None, :]
    yy = torch.arange(h, device=imgs.device)[None, :, None]
    valid = (xx < whwh[:, 0, None, None]) & (yy < whwh[:, 1, None, None])
    return out * valid[..., None]


def frozen_bn(x, p, name):
    w = p[name + '.weight'] * torch.rsqrt(p[name + '.running_var'] + BN_EPS)
    b = p[name + '.bias'] - p[name + '.running_mean'] * w
    return x * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def resnet50(x, p, prec: Prec, prefix='backbone.'):
    """NCHW f32 -> (C2, C3, C4, C5); the stride sits on the 3x3."""
    x = F.relu(frozen_bn(prec.conv(x, p[prefix + 'conv1.weight'], None, 2,
                                   3), p, prefix + 'bn1'))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    outs = []
    for stage, blocks in enumerate(RESNET50_BLOCKS):
        for i in range(blocks):
            q = f'{prefix}layer{stage + 1}.{i}.'
            stride = 2 if stage > 0 and i == 0 else 1
            y = F.relu(frozen_bn(prec.conv(x, p[q + 'conv1.weight']), p,
                                 q + 'bn1'))
            y = F.relu(frozen_bn(prec.conv(y, p[q + 'conv2.weight'], None,
                                           stride, 1), p, q + 'bn2'))
            y = frozen_bn(prec.conv(y, p[q + 'conv3.weight']), p, q + 'bn3')
            idn = x
            if i == 0:
                idn = frozen_bn(prec.conv(x, p[q + 'downsample.0.weight'],
                                          None, stride), p,
                                q + 'downsample.1')
            x = F.relu(y + idn)
        outs.append(x)
    return outs


def fpn(inputs, p, prec: Prec, prefix='neck.'):
    """NCHW levels -> NHWC levels of 256 channels."""
    lat = [prec.conv(x, p[f'{prefix}lateral_convs.{i}.conv.weight'],
                     p[f'{prefix}lateral_convs.{i}.conv.bias'])
           for i, x in enumerate(inputs)]
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], scale_factor=2,
                                                mode='nearest')
    return [prec.conv(x, p[f'{prefix}fpn_convs.{i}.conv.weight'],
                      p[f'{prefix}fpn_convs.{i}.conv.bias'], 1, 1)
            .permute(0, 2, 3, 1) for i, x in enumerate(lat)]


# --------------------------------------------------------------- RoIAlign

def roi_levels(rois, levels, finest=56.0):
    """mmdet's map_roi_levels: floor(log2(sqrt(area) / finest + 1e-6))
    clipped to [0, levels - 1], as comparisons against powers of two."""
    area = ((rois[..., 2] - rois[..., 0])
            * (rois[..., 3] - rois[..., 1])).clamp_min(0.0)
    v = torch.sqrt(area) / finest + 1e-6
    lvl = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    for k in range(1, levels):
        lvl += (v >= 2.0 ** k).to(torch.int64)
    return lvl


def _samples(start, end, size, out, s):
    """Sample coordinates of RoIs on one axis (M, out*s) -> (lo, hi, frac,
    valid), mmcv's bilinear rule with the clamped far edge."""
    pos = (torch.arange(out, device=start.device, dtype=torch.float32)[:, None]
           + (torch.arange(s, device=start.device, dtype=torch.float32)
              + 0.5) / s).reshape(-1)
    v = start[:, None] + pos * ((end - start) / out)[:, None]
    valid = (v >= -1.0) & (v <= size)
    vc = v.clamp_min(0.0)
    lo = torch.floor(vc)
    edge = lo >= size - 1
    lo = lo.clamp_max(size - 1)
    hi = (lo + 1).clamp_max(size - 1)
    frac = torch.where(edge, torch.zeros_like(vc), vc - lo)
    return lo.long(), hi.long(), frac, valid


def roi_align(feats, rois, frame_idx=None, out=7, s=2,
              strides=(4, 8, 16, 32), finest=56.0, block=2048):
    """feats: L (U, H, W, C) NHWC f32; rois (N, R, 4) xyxy; frame_idx (N,)
    slot -> frame (identity when None). Returns (N, R, out, out, C): each
    RoI on its routed level, mean of s x s bilinear samples a bin, a
    sample outside [-1, size] counting 0. Gathers rows of at most `block`
    RoIs at a time."""
    n, r = rois.shape[:2]
    c = feats[0].shape[-1]
    flat = rois.reshape(-1, 4).float()
    frames = (torch.arange(n, device=rois.device) if frame_idx is None
              else frame_idx.long())
    frames = frames[:, None].expand(n, r).reshape(-1)
    lvl = roi_levels(flat, len(feats), finest)
    result = flat.new_zeros((n * r, out, out, c))
    for li, (f, stride) in enumerate(zip(feats, strides)):
        u, h, w, _ = f.shape
        table = f.reshape(u * h * w, c)
        for ids in torch.nonzero(lvl == li).flatten().split(block):
            b = flat[ids] / stride - 0.5
            ylo, yhi, fy, vy = _samples(b[:, 1], b[:, 3], h, out, s)
            xlo, xhi, fx, vx = _samples(b[:, 0], b[:, 2], w, out, s)
            base = frames[ids][:, None, None] * (h * w)
            acc = 0.0
            for yy, wy in ((ylo, 1 - fy), (yhi, fy)):
                for xx, wx in ((xlo, 1 - fx), (xhi, fx)):
                    idx = base + yy[:, :, None] * w + xx[:, None, :]
                    wt = (wy * vy)[:, :, None] * (wx * vx)[:, None, :]
                    acc = acc + table[idx.reshape(-1)].reshape(
                        *idx.shape, c) * wt[..., None]
            m = ids.numel()
            result[ids] = acc.reshape(m, out, s, out, s, c).mean((2, 4))
    return result.reshape(n, r, out, out, c)


# ------------------------------------------------------------------ heads

def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + '.weight'],
                        p[name + '.bias'], LN_EPS)


def linear(x, p, name, prec: Prec, bias=True):
    return prec.linear(x, p[name + '.weight'],
                       p[name + '.bias'] if bias else None)


def attention(x, p, name, prec: Prec, heads):
    """Residual multi-head self-attention over (B, S, E), mmcv's brick with
    torch's packed q, k, v projection."""
    b, s, e = x.shape
    hd = e // heads
    qkv = prec.linear(x, p[name + '.in_proj_weight'], p[name + '.in_proj_bias'])
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    logits = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    out = prec.matmul(torch.softmax(logits, dim=-1), v)
    out = out.transpose(1, 2).reshape(b, s, e)
    return x + linear(out, p, name + '.out_proj', prec)


def tower(x, p, name, prec: Prec, layers):
    for i in range(layers):
        x = F.relu(layer_norm(linear(x, p, f'{name}.{3 * i}', prec, False),
                              p, f'{name}.{3 * i + 1}'))
    return x


def dynamic_conv(query, roi, p, name, prec: Prec, feat):
    """Sparse R-CNN's DynamicConv: query (M, C), roi (M, S, S, C) -> (M, C)."""
    m, c = query.shape
    params = linear(query, p, name + '.dynamic_layer', prec)
    p_in = params[:, :c * feat].reshape(m, c, feat)
    p_out = params[:, c * feat:].reshape(m, feat, c)
    x = roi.reshape(m, -1, c)
    x = F.relu(layer_norm(prec.matmul(x, p_in), p, name + '.norm_in'))
    x = F.relu(layer_norm(prec.matmul(x, p_out), p, name + '.norm_out'))
    x = linear(x.reshape(m, -1), p, name + '.fc_layer', prec)
    return F.relu(layer_norm(x, p, name + '.fc_norm'))


def interaction(query, roi_feat, p, stage_prefix, prec: Prec, t, heads,
                feat):
    """One stage's query interaction over (N, Q, C) queries, N = B * T:
    attention across the Q queries of a frame, then across the T frames of
    each query (one attention and one norm), DynamicConv with residual
    and norm, FFN with residual and norm. Returns (obj (N*Q, C),
    attn_feat (N, Q, C))."""
    n, nq, c = query.shape
    b = n // t
    att, norm = stage_prefix + 'attention.attn', stage_prefix + 'attention_norm'
    q = layer_norm(attention(query, p, att, prec, heads), p, norm)
    q = q.reshape(b, t, nq, c).transpose(1, 2).reshape(b * nq, t, c)
    q = layer_norm(attention(q, p, att, prec, heads), p, norm)
    q = q.reshape(b, nq, t, c).transpose(1, 2).reshape(n, nq, c)
    flat = q.reshape(n * nq, c)
    ic = stage_prefix + 'instance_interactive_conv'
    obj = layer_norm(flat + dynamic_conv(flat, roi_feat, p, ic, prec, feat),
                     p, ic + '_norm')
    ffn = F.relu(linear(obj, p, stage_prefix + 'ffn.layers.0.0', prec))
    obj = layer_norm(obj + linear(ffn, p, stage_prefix + 'ffn.layers.1', prec),
                     p, stage_prefix + 'ffn_norm')
    return obj, q


def proposals(p, whwh):
    """The learned proposal boxes (normalised cx, cy, w, h) in each frame's
    pixels, xyxy: (N, Q, 4)."""
    cx, cy, w, h = p['rpn_head.init_proposal_bboxes.weight'].unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return xyxy[None] * whwh[:, None, :]


def delta2bbox(rois, deltas):
    """mmdet DeltaXYWHBBoxCoder.decode, means 0, stds (.5, .5, 1, 1),
    clip_border False."""
    d = deltas * torch.tensor(DELTA_STDS, device=deltas.device)
    dx, dy, dw, dh = d.unbind(-1)
    lim = abs(math.log(WH_RATIO_CLIP))
    dw, dh = dw.clamp(-lim, lim), dh.clamp(-lim, lim)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gx, gy = px + pw * dx, py + ph * dy
    gw, gh = pw * torch.exp(dw), ph * torch.exp(dh)
    return torch.stack([gx - gw / 2, gy - gh / 2, gx + gw / 2, gy + gh / 2],
                       -1)


def features(frames_u8, whwh, p, prec: Prec):
    """uint8 NHWC frames -> the FPN's four NHWC levels."""
    x = normalize_u8(frames_u8, whwh).permute(0, 3, 1, 2)
    return fpn(resnet50(x, p, prec), p, prec)
