"""The work of a forward and of a train step of the MCGaze and InstBlink
configurations, counted from their shapes: every convolution and matrix
product, 2 flops a multiply-add, by the work the inputs need and not by
what a program happens to run.

  forward   backbone and FPN once per frame the call holds (131 unique
            frames of a deduplicated 32-clip gaze batch, not its 224
            slots), the query stages once per (slot, query) token;
  train     the forward over every frame of the batch, then for each
            product a weight gradient where the weight trains and an input
            gradient where something upstream trains. The stem and layer1
            are frozen: none of their gradients counts, nor the input
            gradients of the first products that read layer1's output.
            The gaze confidence towers read detached features: their first
            input gradient does not count.

RoIAlign, normalisations, activations and the optimizer are left out, so
the count is a lower bound of the step's work. No card is used.
"""
from __future__ import annotations

RESNET50_BLOCKS = (3, 4, 6, 3)


def _out(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def backbone_products(h, w, channels=256):
    """[(macs per frame, weight trains, input needs a gradient)] of
    ResNet-50 and the FPN on an h x w frame."""
    prods = []
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    prods.append((h * w * 7 * 7 * 3 * 64, False, False))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, mid = 64, 64
    levels = []
    for stage, blocks in enumerate(RESNET50_BLOCKS):
        trains = stage > 0
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            oh, ow = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            first = stage == 1 and i == 0        # reads layer1's output
            prods.append((h * w * cin * mid, trains, trains and not first))
            prods.append((oh * ow * 9 * mid * mid, trains, trains))
            prods.append((oh * ow * mid * 4 * mid, trains, trains))
            if i == 0:
                prods.append((oh * ow * cin * 4 * mid, trains,
                              trains and not first))
            cin, h, w = 4 * mid, oh, ow
        levels.append((h, w, cin))
        mid *= 2
    for li, (lh, lw, lc) in enumerate(levels):
        prods.append((lh * lw * lc * channels, True, li > 0))
        prods.append((lh * lw * 9 * channels * channels, True, True))
    return prods


def stage_products(m, t, with_gaze):
    """[(macs per token, weight trains, input needs a gradient)] of one
    query stage, a token being one (slot, query); attention's logits and
    values are products of two activations (counted as trained: both
    operands need gradients)."""
    c, f, s = m['channels'], m['dyn_feat_channels'], m['roi_size']
    q = m['num_queries']
    prods = [(c * 3 * c, True, True), (c * 3 * c, True, True),
             (c * c, True, True), (c * c, True, True),
             (2 * q * c, True, True), (2 * t * c, True, True),
             (c * 2 * c * f, True, True),
             (2 * s * s * c * f, True, True),
             (s * s * c * c, True, True),
             (2 * c * m['ffn_channels'], True, True)]
    prods += [(c * c, True, True)] * (m['num_cls_fcs'] + m['num_reg_fcs'])
    prods += [(c * m.get('num_classes', 1), True, True), (c * 4, True, True)]
    if with_gaze:
        # per clue token: 2 gaze layers, 2 confidence layers (the first on
        # detached features), two 3-wide heads; the 9 -> 3 fusion
        prods += [(c * c, True, True)] * 3 + [(c * c, True, False)]
        prods += [(c * 3, True, True)] * 2 + [(3, True, True)]
    if m.get('with_blink'):
        prods += [(c * c, True, True)] * 2 + [(c, True, True)]
    return prods


def _flops(prods, count, train):
    total = 0
    for macs, weight, inp in prods:
        total += 2 * macs * count
        if train:
            total += 2 * macs * count * (int(weight) + int(inp))
    return total


def work_flops(m: dict, frames: int, height: int, width: int, slots: int,
               clip_length: int, train: bool = False,
               with_gaze: bool = False) -> int:
    """Flops of one call: the backbone and FPN over `frames` frames, the
    query stages (with the gaze head where `with_gaze`) over `slots` slots
    of m['num_queries'] queries."""
    back = _flops(backbone_products(height, width, m['channels']), frames,
                  train)
    tokens = slots * m['num_queries']
    heads = m['num_stages'] * _flops(
        stage_products(m, clip_length, with_gaze), tokens,
        train)
    return back + heads
