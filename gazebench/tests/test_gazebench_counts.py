"""The frozen work counts equal the port's tools/kernel_bounds.py at the
cells' shapes (as of the commit they were copied from), and the model
count's convolutions equal what torch's FlopCounterMode counts of the
reference backbone."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gazebench.counts import kernels as K
from gazebench.counts import model as M
from mcgaze_tpu_torch.tools import kernel_bounds as KB

GAZE_LEVELS = [(56, 56), (28, 28), (14, 14), (7, 7)]
INSTBLINK_LEVELS = [(96, 160), (48, 80), (24, 40), (12, 20)]
STRIDES = (4, 8, 16, 32)


def _rois(n, r, w, h, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [w * 0.8, h * 0.8], (n, r, 2))
    wh = rng.uniform(8, [w * 0.6, h * 0.6], (n, r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize('case', [
    ('gaze eval bf16', 224, 3, GAZE_LEVELS, 224, 224, 2, True, 131),
    ('gaze train f32', 224, 3, GAZE_LEVELS, 224, 224, 4, False, 224),
    ('instblink eval f32', 88, 100, INSTBLINK_LEVELS, 640, 360, 4, False,
     88)])
def test_roi_counts_match_kernel_bounds(case):
    _, n, r, levels, w, h, item, dedup, frames = case
    rois = _rois(n, r, w, h, n + r)
    fidx = (np.concatenate([np.arange(4 * i, 4 * i + 7) for i in range(32)])
            .astype(np.int32) if dedup else None)
    assert K.roi_work(rois, fidx, levels, STRIDES, 256, item) == \
        KB.roi_work(rois, fidx, levels, STRIDES, 256, item)
    assert K.roi_bwd_work(rois, fidx, levels, STRIDES, 256, item, frames) \
        == KB.roi_bwd_work(rois, fidx, levels, STRIDES, 256, item, frames)


@pytest.mark.parametrize('clips', [1, 32])
def test_k4_counts_match_kernel_bounds(clips):
    kb = KB.k4_bound(clips)
    assert K.k4_work(clips) == (kb['bytes'], kb['flops'])


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_k5_counts_match_kernel_bounds(dtype):
    for chain in KB.chains(50):
        args = (chain['cin'], chain['mid'], chain['blocks'], chain['down'])
        assert K.k5_convs(*args) == KB.k5_convs(chain)
        kb = KB.k5_bound(131, chain, dtype)
        got = K.k5_work(131 * chain['size'] ** 2, *args, K.ITEMSIZE[dtype])
        assert got == (kb['bytes'], kb['flops'], kb['launches'])


def test_backbone_count_matches_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from gazebench.reference import common as C
    from gazebench.traffic import make_weights
    specs = C.resnet50_specs() + C.fpn_specs(256)
    p = make_weights(specs, 0, 'cpu')
    x = torch.zeros(2, 3, 64, 96)
    with FlopCounterMode(display=False) as fc:
        C.fpn(C.resnet50(x, p, C.Prec()), p, C.Prec())
    want = 2 * 2 * sum(m for m, _, _ in M.backbone_products(64, 96))
    assert fc.get_total_flops() == want


def test_gaze_batch_is_about_two_teraflop():
    m = dict(channels=256, dyn_feat_channels=64, roi_size=7, num_queries=3,
             ffn_channels=2048, num_cls_fcs=1, num_reg_fcs=3, num_stages=4)
    f = M.work_flops(m, 131, 224, 224, 224, 7, with_gaze=True)
    assert 1.8e12 < f < 2.0e12
    train = M.work_flops(m, 224, 224, 224, 224, 7, train=True,
                         with_gaze=True)
    assert 2.5 < train / M.work_flops(m, 224, 224, 224, 224, 7,
                                      with_gaze=True) < 3.0
