"""The port's losses, box geometry and stage criterion against the JAX
package, on the CPU.

Same numpy inputs on both sides, f32. Elementwise losses and geometry
agree at 1e-6 relative (the same formulas, rounding apart); the stage
criterion's keys at 1e-5 relative (sums over a few hundred terms in
another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcgaze_tpu import geometry as jgeo
from mcgaze_tpu.models.mcgaze import ModelConfig as JModelConfig
from mcgaze_tpu.ops import losses as JL
from mcgaze_tpu.train import criterion as jcrit
from mcgaze_tpu.train.targets import flatten_targets as jflatten
from mcgaze_tpu_torch import geometry as pgeo
from mcgaze_tpu_torch.models.mcgaze import ModelConfig
from mcgaze_tpu_torch.ops import losses as PL
from mcgaze_tpu_torch.train import criterion as pcrit
from mcgaze_tpu_torch.train.targets import flatten_targets as pflatten
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

REL = 1e-6
REL_CRIT = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def close(got, ref, rtol, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=rtol, atol=atol)


def boxes(rng, n, scale=50.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(1, scale, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def unit(rng, n):
    g = rng.randn(n, 3).astype(np.float32)
    return g / np.linalg.norm(g, axis=1, keepdims=True)


def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    a, b = boxes(rng, 64), boxes(rng, 64)
    b[:8] = a[:8]                                       # identical boxes
    b[8:16, :2] = a[8:16, 2:] + 5                       # disjoint boxes
    b[8:16, 2:] = b[8:16, :2] + 3
    close(pgeo.giou(t(a), t(b)), jgeo.giou(j(a), j(b)), REL)
    close(pgeo.bbox2delta(t(a), t(b)), jgeo.bbox2delta(j(a), j(b)), REL)
    close(pgeo.bbox_xyxy_to_cxcywh(t(a)), jgeo.bbox_xyxy_to_cxcywh(j(a)),
          REL)
    # the encoder inverts the decoder
    d = pgeo.bbox2delta(t(a), t(b))
    close(pgeo.delta2bbox(t(a), d), b, 1e-5, atol=1e-4)


@pytest.mark.parametrize('weighted', [False, True])
def test_box_and_focal_losses_match_jax(weighted):
    rng = np.random.RandomState(1)
    n = 40
    logits = (3 * rng.randn(n)).astype(np.float32)
    tgt = (rng.rand(n) > 0.5).astype(np.float32)
    w = (rng.rand(n) > 0.3).astype(np.float32) if weighted else None
    a, b = boxes(rng, n), boxes(rng, n)
    avg = np.float32(7.0)
    close(PL.sigmoid_focal_loss(t(logits), t(tgt), None if w is None
                                else t(w), avg_factor=t(avg)),
          JL.sigmoid_focal_loss(j(logits), j(tgt), None if w is None
                                else j(w), avg_factor=j(avg)), REL)
    w4 = None if w is None else w[:, None]
    close(PL.l1_loss(t(a), t(b), None if w4 is None else t(w4), t(avg)),
          JL.l1_loss(j(a), j(b), None if w4 is None else j(w4), j(avg)),
          REL)
    close(PL.giou_loss(t(a), t(b), None if w is None else t(w), t(avg)),
          JL.giou_loss(j(a), j(b), None if w is None else j(w), j(avg)),
          REL)


@pytest.mark.parametrize('kind', sorted(JL.GAZE_LOSSES))
def test_gaze_losses_match_jax(kind):
    rng = np.random.RandomState(2)
    pred, tgt = unit(rng, 30), unit(rng, 30)
    pred[0] = tgt[0]                                    # angle 0, clipped
    w = (rng.rand(30) > 0.4).astype(np.float32)
    close(PL.GAZE_LOSSES[kind](t(pred), t(tgt), t(w)),
          JL.GAZE_LOSSES[kind](j(pred), j(tgt), j(w)), REL)
    # no positive row: 0 on both sides
    zero = np.zeros(30, np.float32)
    assert float(PL.GAZE_LOSSES[kind](t(pred), t(tgt), t(zero))) == 0.0


def test_temporal_loss_matches_jax():
    rng = np.random.RandomState(3)
    pred = unit(rng, 4 * 7).reshape(4, 7, 3)
    close(PL.temporal_gaze_loss(t(pred)), JL.temporal_gaze_loss(j(pred)),
          REL)


def test_loss_gradients_match_jax():
    """The criterion is differentiated on the card: its gradients through
    torch autograd equal jax.grad's."""
    import jax
    rng = np.random.RandomState(4)
    pred, tgt = unit(rng, 20), unit(rng, 20)
    w = (rng.rand(20) > 0.3).astype(np.float32)
    p = t(pred).requires_grad_()
    PL.arccos_gaze_loss(p, t(tgt), t(w)).backward()
    ref = jax.grad(lambda x: JL.arccos_gaze_loss(x, j(tgt), j(w)))(
        j(pred))
    close(p.grad, ref, 1e-5, atol=1e-6)
    a, b = boxes(rng, 20), boxes(rng, 20)
    p = t(a).requires_grad_()
    PL.giou_loss(p, t(b), t(w)).backward()
    ref = jax.grad(lambda x: JL.giou_loss(x, j(b), j(w)))(j(a))
    close(p.grad, ref, 1e-5, atol=1e-7)


def stage_inputs(seed, b=2, t_len=7, head_only_every=3):
    """Random stage outputs and fixed-slot targets, head-only frames
    mixed in."""
    rng = np.random.RandomState(seed)
    n = b * t_len
    gt_boxes = np.zeros((b, t_len, 3, 4), np.float32)
    valid = np.zeros((b, t_len, 3), np.float32)
    gazes = np.zeros((b, t_len, 3, 3), np.float32)
    for i in range(b):
        for k in range(t_len):
            if head_only_every and (i + k) % head_only_every == 0:
                gt_boxes[i, k, 2] = boxes(rng, 1)[0]
                valid[i, k, 2] = 1
                gazes[i, k, 2] = unit(rng, 1)[0]
            else:
                gt_boxes[i, k] = boxes(rng, 3)
                valid[i, k] = 1
                gazes[i, k] = unit(rng, 3)
    whwh = np.tile(np.array([64., 48., 64., 48.], np.float32),
                   (b, t_len, 1))
    stages = []
    for _ in range(2):
        stages.append(dict(
            cls_logits=rng.randn(n, 3, 1).astype(np.float32),
            boxes=boxes(rng, n * 3).reshape(n, 3, 4),
            gaze={k: unit(rng, n) for k in ('fusion', 'face', 'eyes',
                                            'head')}))
    return (gt_boxes, valid, gazes, whwh), stages


def _both_losses(tg_np, stages, cfg_kw):
    jcfg = JModelConfig(stage_loss_weights=(1.0, 0.5), **cfg_kw)
    pcfg = ModelConfig(stage_loss_weights=(1.0, 0.5), **cfg_kw)
    jout = dict(stages=[dict(cls_logits=j(s['cls_logits']),
                             boxes=j(s['boxes']),
                             gaze={k: j(v) for k, v in s['gaze'].items()})
                        for s in stages])
    pout = dict(stages=[dict(cls_logits=t(s['cls_logits']),
                             boxes=t(s['boxes']),
                             gaze={k: t(v) for k, v in s['gaze'].items()})
                        for s in stages])
    jl = jcrit.total_loss(jcfg, jout, jflatten(*map(j, tg_np)), 7)[1]
    pl = pcrit.total_loss(pcfg, pout, pflatten(*map(t, tg_np)), 7)[1]
    return jl, pl


@pytest.mark.parametrize('gaze_loss_type', ['arccos', 'cos', 'pinball'])
def test_total_loss_matches_jax(gaze_loss_type):
    tg_np, stages = stage_inputs(5)
    jl, pl = _both_losses(tg_np, stages,
                          dict(gaze_loss_type=gaze_loss_type))
    assert sorted(pl) == sorted(jl)
    assert len(pl) == 2 * 14 + 1
    for k in jl:
        close(pl[k], jl[k], REL_CRIT, atol=1e-6)


def test_head_only_frames_mask_face_and_eyes():
    """All frames head-only: the face/eyes box and gaze terms are exactly 0
    on both sides, the head terms and every cls term are not
    (tests/test_train_step.py::test_loss_masks_head_only_frames)."""
    tg_np, stages = stage_inputs(6, b=1, head_only_every=1)
    jl, pl = _both_losses(tg_np, stages, {})
    for s in (0, 1):
        for k in ('face_loss_bbox', 'eyes_loss_bbox', 'face_loss_iou',
                  'face_gaze_loss', 'eyes_gaze_loss'):
            assert float(pl[f'stage{s}_{k}']) == 0.0
            assert float(jl[f'stage{s}_{k}']) == 0.0
        for k in ('head_loss_bbox', 'head_gaze_loss', 'face_loss_cls'):
            assert float(pl[f'stage{s}_{k}']) > 0.0
    for k in jl:
        close(pl[k], jl[k], REL_CRIT, atol=1e-6)
