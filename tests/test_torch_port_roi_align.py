"""FPN RoIAlign of the port against the JAX package, on the CPU.

The port's plain version (mcgaze_tpu_torch.ops.roi_align) against
roi_align_fpn_mm and against the Pallas kernel in interpret mode, in the
identity and the frame_idx form, on mixed-level boxes. Both sides compute
in f32 with the same rounding points; the contractions sum in another
order, so the tolerance is 1e-5 (features are O(1)). The CUDA kernel's
own tests are in tests/test_torch_port_kernels.py, which imports no JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcgaze_tpu.ops import roi_align as jra
from mcgaze_tpu.ops.roi_align_pallas import roi_align_fpn_pallas
from mcgaze_tpu_torch.ops import roi_align as pra
from mcgaze_tpu_torch.ops import roi_align_cuda
from tests.test_torch_port_kernels import make_pyramid, mixed_rois
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

TOL_F32 = 1e-5


def ours(feats, rois, frame_idx=None):
    t = tuple(torch.from_numpy(f) for f in feats)
    fi = None if frame_idx is None else torch.from_numpy(frame_idx)
    return pra.roi_align_fpn_mm(t, torch.from_numpy(rois), fi).numpy()


def jax_mm(feats, rois, frame_idx=None):
    if frame_idx is not None:
        feats = tuple(f[frame_idx] for f in feats)
    return np.asarray(jra.roi_align_fpn_mm(tuple(map(jnp.asarray, feats)),
                                           jnp.asarray(rois)))


def test_levels_match_jax():
    rng = np.random.RandomState(0)
    rois = np.concatenate([mixed_rois(rng, 4, (20, 60, 130, 250, 500)),
                           # exact level thresholds: sqrt(area) = 112, 224
                           np.array([[[0, 0, 112, 112], [0, 0, 224, 224],
                                      [5, 5, 5, 5], [40, 40, 0, 0],
                                      [40, 0, 0, 40]]], np.float32)])
    np.testing.assert_array_equal(
        pra.roi_levels(torch.from_numpy(rois)).numpy(),
        np.asarray(jra.roi_levels(jnp.asarray(rois))))


@pytest.mark.parametrize('seed', [0, 1])
def test_plain_matches_jax_mm(seed):
    rng = np.random.RandomState(seed)
    feats = make_pyramid(rng, 3, 16)
    rois = mixed_rois(rng, 3, (25, 90, 300, 600))
    np.testing.assert_allclose(ours(feats, rois), jax_mm(feats, rois),
                               rtol=TOL_F32, atol=TOL_F32)


def test_plain_frame_idx_matches_jax_gather():
    """frame_idx form: slots read unique frames; equals the JAX
    formulation on the duplicated pyramid (what fwd_dedup does)."""
    rng = np.random.RandomState(2)
    feats = make_pyramid(rng, 3, 8)
    fidx = np.array([0, 0, 1, 2, 2, 1, 0], np.int32)
    rois = mixed_rois(rng, len(fidx))
    np.testing.assert_allclose(ours(feats, rois, fidx),
                               jax_mm(feats, rois, fidx),
                               rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_plain_matches_pallas_interpret(with_frame_idx):
    """The TPU kernel run as the JAX tests run it on the CPU (interpret
    mode), both forms. The boxes include one inverted on x only, whose
    clipped area is 0 under both conventions (level 0)."""
    rng = np.random.RandomState(3)
    feats = make_pyramid(rng, 2, 8)
    n = 4 if with_frame_idx else 2
    rois = mixed_rois(rng, n)
    rois[0, 1] = [60.0, 10.0, 20.0, 70.0]
    fidx = (np.array([1, 0, 0, 1], np.int32) if with_frame_idx else None)
    ref = np.asarray(roi_align_fpn_pallas(
        tuple(map(jnp.asarray, feats)), jnp.asarray(rois),
        frame_idx=None if fidx is None else jnp.asarray(fidx),
        interpret=True))
    np.testing.assert_allclose(ours(feats, rois, fidx), ref,
                               rtol=TOL_F32, atol=TOL_F32)


def test_inverted_box_follows_roi_levels():
    """A box inverted on both axes has a positive signed area. The port
    (plain version and kernel alike) routes it by roi_levels, which clips
    the signed product, as roi_align_fpn_mm does; the Pallas kernel clips
    each extent and sends it to level 0 instead (a divergence inside the
    JAX package). Pinned here: the port equals roi_align_fpn_mm."""
    rng = np.random.RandomState(4)
    feats = make_pyramid(rng, 1, 8)
    rois = np.array([[[120.0, 125.0, 10.0, 5.0]]], np.float32)
    assert int(pra.roi_levels(torch.from_numpy(rois))[0, 0]) == 1
    np.testing.assert_allclose(ours(feats, rois), jax_mm(feats, rois),
                               rtol=TOL_F32, atol=TOL_F32)
    assert np.abs(ours(feats, rois)).max() > 0.1


def test_wrapper_uses_plain_version_on_cpu():
    rng = np.random.RandomState(5)
    feats = tuple(torch.from_numpy(f) for f in make_pyramid(rng, 2, 8))
    rois = torch.from_numpy(mixed_rois(rng, 2))
    before = roi_align_cuda.launch_count
    out = roi_align_cuda.roi_align_fpn(feats, rois)
    assert roi_align_cuda.launch_count == before
    torch.testing.assert_close(out, pra.roi_align_fpn_mm(feats, rois),
                               rtol=0, atol=0)


def test_cuda_path_raises_instead_of_falling_back():
    """The kernel path takes CUDA tensors only; with CPU tensors it raises
    and never computes on the CPU."""
    rng = np.random.RandomState(6)
    feats = tuple(torch.from_numpy(f) for f in make_pyramid(rng, 2, 8))
    rois = torch.from_numpy(mixed_rois(rng, 2))
    with pytest.raises(RuntimeError, match='CUDA device only'):
        roi_align_cuda.launch_roi_align_fpn(feats, rois)
    with pytest.raises(ValueError, match='several devices'):
        roi_align_cuda.roi_align_fpn(feats, rois.to('meta'))


def _plain_grad(feats, rois, g, frame_idx=None):
    """The plain version's feature gradient: autograd through
    roi_align_fpn (CPU tensors take the plain version)."""
    t = tuple(torch.from_numpy(f).requires_grad_() for f in feats)
    fi = None if frame_idx is None else torch.from_numpy(frame_idx)
    out = roi_align_cuda.roi_align_fpn(t, torch.from_numpy(rois), fi)
    out.backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in t]


@pytest.mark.parametrize('nq', [3, 20])
def test_plain_gradient_matches_jax_vjp_and_pallas_bwd(nq):
    """The backward kernel's reference (autograd of the plain version)
    against the JAX mm-formulation vjp and the TPU backward kernel in
    interpret mode, as tests/test_roi_align.py runs it: 3 RoIs (the gaze
    path) and 20 (RoI chunks with level sort in the Pallas kernel)."""
    import jax
    from mcgaze_tpu.ops.roi_align_pallas import roi_align_fpn_pallas_bwd
    rng = np.random.RandomState(7)
    feats = make_pyramid(rng, 2, 8)
    rois = mixed_rois(rng, 2, tuple(rng.choice([25, 90, 300], nq)))
    g = rng.randn(2, nq, 7, 7, 8).astype(np.float32)
    got = _plain_grad(feats, rois, g)
    jf = tuple(map(jnp.asarray, feats))
    _, vjp = jax.vjp(lambda f: jra.roi_align_fpn_mm(f, jnp.asarray(rois)),
                     jf)
    ref_mm = vjp(jnp.asarray(g))[0]
    ref_pallas = roi_align_fpn_pallas_bwd(jf, jnp.asarray(rois),
                                          jnp.asarray(g), interpret=True)
    for lvl, (a, b, c) in enumerate(zip(got, ref_mm, ref_pallas)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL_F32,
                                   atol=TOL_F32, err_msg=f'level {lvl} mm')
        np.testing.assert_allclose(a, np.asarray(c), rtol=TOL_F32,
                                   atol=TOL_F32,
                                   err_msg=f'level {lvl} pallas')
    assert any(np.abs(a).max() > 0.1 for a in got)


def test_plain_gradient_frame_idx_matches_jax_gather_vjp():
    """frame_idx form: slots scatter into their frames, as the JAX
    _gdiff_bwd (the mm transpose of gather . roi_align) does."""
    import jax
    rng = np.random.RandomState(8)
    feats = make_pyramid(rng, 3, 8)
    fidx = np.array([0, 0, 1, 2, 2, 1, 0], np.int32)
    rois = mixed_rois(rng, len(fidx))
    g = rng.randn(len(fidx), 3, 7, 7, 8).astype(np.float32)
    got = _plain_grad(feats, rois, g, fidx)
    _, vjp = jax.vjp(lambda f: jra.roi_align_fpn_mm(
        tuple(x[fidx] for x in f), jnp.asarray(rois)),
        tuple(map(jnp.asarray, feats)))
    for a, b in zip(got, vjp(jnp.asarray(g))[0]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL_F32,
                                   atol=TOL_F32)


def test_backward_launch_raises_on_cpu_tensors():
    """The backward kernel's wrapper takes CUDA tensors only and never
    computes on the CPU; nothing is counted."""
    rng = np.random.RandomState(9)
    feats = make_pyramid(rng, 2, 8)
    rois = torch.from_numpy(mixed_rois(rng, 2))
    g = torch.zeros(2, 3, 7, 7, 8)
    before = roi_align_cuda.bwd_launch_count
    with pytest.raises(RuntimeError, match='CUDA device only'):
        roi_align_cuda.launch_roi_align_fpn_bwd(
            g, rois, None, [f.shape for f in feats])
    assert roi_align_cuda.bwd_launch_count == before
