"""mcgaze_tpu_torch.geometry against mcgaze_tpu.geometry on the same seeded
numpy inputs. Same f32 formulas on both sides: tolerance 1e-6 relative,
plus an absolute term of a few ulp of the operands' magnitude where XLA
may fuse a multiply-add that PyTorch rounds twice (1e-4 for box
coordinates up to ~1000, 1e-5 for unit vectors and angles)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcgaze_tpu import geometry as G
from mcgaze_tpu_torch import geometry as P
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401


def _boxes(rng, n):
    xy = rng.uniform(-50, 200, (n, 2)).astype(np.float32)
    wh = rng.uniform(0.5, 300, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def test_cxcywh_to_xyxy():
    x = np.random.RandomState(0).uniform(0, 100, (5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        P.bbox_cxcywh_to_xyxy(torch.from_numpy(x)).numpy(),
        np.asarray(G.bbox_cxcywh_to_xyxy(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize('scale', [0.5, 8.0])
def test_delta2bbox_matches_and_clamps(scale):
    """scale 8 drives dw/dh far past +-|log(16/1000)|: the clamp must bite
    identically."""
    rng = np.random.RandomState(1)
    rois = _boxes(rng, 64)
    deltas = (rng.randn(64, 4) * scale).astype(np.float32)
    ours = P.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas))
    ref = np.asarray(G.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-4)


def test_yaw_pitch_roundtrip():
    rng = np.random.RandomState(2)
    yp = np.stack([rng.uniform(-3, 3, 32), rng.uniform(-1.5, 1.5, 32)],
                  -1).astype(np.float32)
    v = P.yaw_pitch_to_vector(torch.from_numpy(yp))
    np.testing.assert_allclose(
        v.numpy(), np.asarray(G.yaw_pitch_to_vector(jnp.asarray(yp))),
        atol=1e-6)
    raw = rng.randn(32, 3).astype(np.float32)
    np.testing.assert_allclose(
        P.vector_to_yaw_pitch(torch.from_numpy(raw)).numpy(),
        np.asarray(G.vector_to_yaw_pitch(jnp.asarray(raw))), atol=1e-5)
