"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`; without a card each test skips (the kernels have no CPU
mode). This file imports no JAX, so it also runs on a machine that has
only PyTorch; there tests/conftest.py (which imports JAX) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

Tolerances: f32 1e-5 of the largest feature (each side rounds up to ~16
partial sums bounded by it, in another order); bf16 2e-2 of the output's
scale (the plain version rounds its weights and its intermediate to bf16,
the kernel only its output). The backward kernel (K3) is held against the
plain version's autograd gradient at the same tolerances, scaled by the
largest |gradient| in f32: its f32 atomics add a cell's terms in an order
that changes from run to run.
"""
import numpy as np
import pytest
import torch

from mcgaze_tpu_torch.ops import roi_align_cuda
from mcgaze_tpu_torch.ops.roi_align import roi_align_fpn_mm

TOL_F32 = 1e-5
TOL_BF16 = 2e-2


def make_pyramid(rng, u, c, base=32):
    """4 levels (U, H, W, C) of an image of base*4 px, strides 4..32."""
    return tuple(rng.randn(u, base * 4 // s, base * 4 // s, c).astype(
        np.float32) for s in (4, 8, 16, 32))


def mixed_rois(rng, n, sizes=(25, 90, 300), img=128):
    """Boxes that route to levels 0..2, some running off the image."""
    rois = np.zeros((n, len(sizes), 4), np.float32)
    for i in range(n):
        for r, s in enumerate(sizes):
            x1, y1 = rng.uniform(-10, img - 28, 2)
            rois[i, r] = [x1, y1, x1 + s * rng.uniform(0.5, 1.5), y1 + s]
    return rois


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


def _case(device, dtype, with_frame_idx, seed=0):
    rng = np.random.RandomState(seed)
    u = 5
    feats = make_pyramid(rng, u, 64)
    n = 9 if with_frame_idx else u
    rois = mixed_rois(rng, n, (25, 90, 300, 700))
    rois[0, 0] = [120.0, 125.0, 10.0, 5.0]          # inverted, level 1
    rois[1, 1] = [30.0, 30.0, 30.0, 30.0]           # zero area
    fidx = (rng.randint(0, u, n).astype(np.int32) if with_frame_idx
            else None)
    t = tuple(torch.from_numpy(f).to(device, dtype) for f in feats)
    r = torch.from_numpy(rois).to(device)
    fi = None if fidx is None else torch.from_numpy(fidx).to(device)
    return t, r, fi


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_roi_align_kernel_matches_plain(cuda_device, dtype, with_frame_idx):
    feats, rois, fidx = _case(cuda_device, dtype, with_frame_idx)
    before = roi_align_cuda.launch_count
    got = roi_align_cuda.roi_align_fpn(feats, rois, fidx)
    torch.cuda.synchronize()
    assert roi_align_cuda.launch_count == before + 1
    ref = roi_align_fpn_mm(feats, rois, fidx)
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= TOL_F32 * max(f.abs().max().item() for f in feats), err
    else:
        assert err <= TOL_BF16 * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_roi_align_kernel_frame_outside_pyramid_is_nan(cuda_device):
    """A slot mapped past the pyramid reads nothing: its RoIs are NaN, the
    other slots are untouched."""
    feats, rois, fidx = _case(cuda_device, torch.float32, True)
    fidx[2] = 99
    got = roi_align_cuda.roi_align_fpn(feats, rois, fidx)
    torch.cuda.synchronize()
    assert torch.isnan(got[2]).all()
    keep = torch.arange(len(fidx), device=cuda_device) != 2
    assert torch.isfinite(got[keep]).all()


@pytest.mark.cuda
def test_roi_align_kernel_refuses_what_it_does_not_take(cuda_device):
    feats, rois, fidx = _case(cuda_device, torch.float32, True)
    with pytest.raises(TypeError, match='int32'):
        roi_align_cuda.roi_align_fpn(feats, rois, fidx.long())
    with pytest.raises(TypeError, match='float32 or'):
        roi_align_cuda.roi_align_fpn(tuple(f.half() for f in feats), rois,
                                     fidx)
    with pytest.raises(ValueError, match='non-contiguous'):
        roi_align_cuda.roi_align_fpn(
            tuple(f.transpose(1, 2) for f in feats), rois, fidx)
    # a grad path outside the autograd Function is refused
    with pytest.raises(RuntimeError, match='autograd Function'):
        roi_align_cuda.launch_roi_align_fpn(
            tuple(f.requires_grad_() for f in feats), rois, fidx)


def _grads(feats, rois, fidx, g, fn):
    leaves = tuple(f.detach().clone().requires_grad_() for f in feats)
    fn(leaves, rois, fidx).backward(g)
    return [x.grad for x in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_roi_align_bwd_kernel_matches_plain_autograd(cuda_device, dtype,
                                                     with_frame_idx):
    """roi_align_fpn on CUDA tensors: K1 forward, K3 backward, once each;
    the feature gradient equals the plain version's autograd gradient."""
    feats, rois, fidx = _case(cuda_device, dtype, with_frame_idx)
    n, r = rois.shape[:2]
    g = torch.randn(n, r, 7, 7, feats[0].shape[-1], generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device).to(dtype)
    fwd, bwd = roi_align_cuda.launch_count, roi_align_cuda.bwd_launch_count
    got = _grads(feats, rois, fidx, g, roi_align_cuda.roi_align_fpn)
    torch.cuda.synchronize()
    assert roi_align_cuda.launch_count == fwd + 1
    assert roi_align_cuda.bwd_launch_count == bwd + 1
    ref = _grads(feats, rois, fidx, g, roi_align_fpn_mm)
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        scale = max(b.float().abs().max().item() for b in ref)
        tol = (TOL_F32 if dtype == torch.float32 else TOL_BF16) * scale
        assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_roi_align_bwd_kernel_is_the_adjoint(cuda_device, with_frame_idx):
    """<K1(F), G> = sum_l <F_l, K3(G)_l>, summed in f64, f32 kernels: the
    backward is the forward's transpose without any plain version."""
    feats, rois, fidx = _case(cuda_device, torch.float32, with_frame_idx)
    n, r = rois.shape[:2]
    g = torch.randn(n, r, 7, 7, feats[0].shape[-1], device=cuda_device)
    out = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx)
    grads = roi_align_cuda.launch_roi_align_fpn_bwd(
        g, rois, fidx, [f.shape for f in feats])
    lhs = (out.double() * g.double()).sum().item()
    rhs = sum((f.double() * d.double()).sum().item()
              for f, d in zip(feats, grads))
    scale = out.double().norm().item() * g.double().norm().item()
    assert abs(lhs - rhs) <= 1e-5 * scale, (lhs, rhs, scale)
