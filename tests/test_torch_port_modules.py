"""The port's backbone + FPN, STQIHead and GazeHead against the JAX modules,
on the small model's weights (tests/test_torch_port_model.py::small_pair).

Tolerance 2e-5, tight enough to catch a LayerNorm epsilon other than
1e-5: f32 on both sides, summed in another order. The pyramid is compared
relative to each level's scale (values there reach tens after ~26 conv
layers), the heads absolutely.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcgaze_tpu.models.mcgaze import MCGazeModel as JModel
from tests.test_torch_port_model import T, clip_inputs, small_pair  # noqa: F401
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

TOL = 2e-5


def test_backbone_fpn_matches_extract_features(small_pair):  # noqa: F811
    jmodel, variables, port = small_pair
    imgs, _ = clip_inputs(3, n=T)
    ref = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JModel.extract_features))(variables, jnp.asarray(imgs))
    with torch.inference_mode():
        ours = port.extract_features(torch.from_numpy(imgs))
    for lvl, (a, b) in enumerate(zip(ours, ref)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.is_contiguous()
        scale = np.abs(b).max()
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=TOL, err_msg=f'level {lvl}')


@pytest.mark.parametrize('stage', [0, 1])
def test_stqi_and_gaze_heads_match(small_pair, stage):  # noqa: F811
    jmodel, variables, port = small_pair
    rng = np.random.RandomState(4 + stage)
    n, q, c = 2 * T, 3, 256
    roi = rng.randn(n * q, 7, 7, c).astype(np.float32)
    query = rng.randn(n, q, c).astype(np.float32)

    def jheads(m, roi_feat, qry):
        cls, deltas, obj = m.bbox_head[stage](roi_feat, qry, T)
        return cls, deltas, obj, m.gaze_head[stage](obj)

    ref = jax.jit(lambda v, r, qq: jmodel.apply(v, r, qq, method=jheads))(
        variables, jnp.asarray(roi), jnp.asarray(query))
    with torch.inference_mode():
        cls, deltas, obj = port.roi_head.bbox_head[stage](
            torch.from_numpy(roi), torch.from_numpy(query), T)
        gaze = port.roi_head.gaze_head[stage](obj)
    for name, a, b in (('cls', cls, ref[0]), ('deltas', deltas, ref[1]),
                       ('obj', obj, ref[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=name)
    for k in ('fusion', 'face', 'eyes', 'head'):
        np.testing.assert_allclose(gaze[k].numpy(), np.asarray(ref[3][k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
