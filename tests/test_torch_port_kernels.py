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
largest |gradient| in f32 (it sums each cell's terms in another order);
two of its launches are bitwise equal, and it writes every cell, zeros
included, whatever memory it is handed.

The inverse slot map K3 reads and K4's cluster plan are plain Python and
run on the CPU as well.

K5 (fused bottleneck chain) is held against `chain_reference` at 1e-4 of
the plain output's largest value in f32 (K up to 9*256 summed in another
order through up to two blocks) and 2e-2 of it in bf16, where the
tensor cores also sum K in another order; its Function's
gradients against autograd of `chain_reference` at 1e-4 of each
gradient's largest value. K4 (fused STQI attention, f32 only) is held
against `stqi_attention_reference` at 2e-5 absolute (LN outputs are O(1)),
and the fused STQIHead against the unfused one at the model's tolerances.
"""
import numpy as np
import pytest
import torch

from mcgaze_tpu_torch.models.heads import STQIHead
from mcgaze_tpu_torch.models.layers import init_weights
from mcgaze_tpu_torch.models.resnet import Bottleneck
from mcgaze_tpu_torch.ops import fused_bottleneck, roi_align_cuda
from mcgaze_tpu_torch.ops import stqi_attention
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


def _check_k1(feats, rois, fidx):
    """K1 against the plain version at the file's tolerances; returns the
    kernel's output."""
    got = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx)
    torch.cuda.synchronize()
    ref = roi_align_fpn_mm(feats, rois, fidx)
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    if feats[0].dtype == torch.float32:
        assert err <= TOL_F32 * max(f.abs().max().item() for f in feats), err
    else:
        assert err <= TOL_BF16 * ref.float().abs().max().item(), err
    return got


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _footprint_bytes(box, img, c, itemsize, strides=(4, 8, 16, 32)):
    """Bytes of the cells a box's valid samples span on its level: rows x
    columns between the outermost corners (the whole RoI as one chunk)."""
    x1, y1, x2, y2 = box
    v = np.sqrt(max((x2 - x1) * (y2 - y1), 0.0)) / 56.0 + 1e-6
    stride = strides[int(sum(v >= 2.0 ** k for k in (1, 2, 3)))]
    spans = []
    for a1, a2, size in ((y1, y2, img // stride), (x1, x2, img // stride)):
        pos = a1 / stride - 0.5 + (np.arange(14) // 2 + (np.arange(14) % 2
                                                          + 0.5) / 2) * (
            (a2 - a1) / stride / 7)
        pos = pos[(pos >= -1) & (pos <= size)]
        lo = np.minimum(np.floor(np.maximum(pos, 0)), size - 1)
        spans.append(np.minimum(lo + 1, size - 1).max() - lo.min() + 1)
    return int(spans[0] * spans[1]) * c * itemsize


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_roi_align_kernel_footprint_beyond_a_chunk(cuda_device, dtype,
                                                  with_frame_idx):
    """RoIs whose footprint exceeds one chunk, cut into bands: an
    elongated box at level 0 (its rows span the whole level), a square box
    at the top of level 0, and boxes running off the image (negative
    corner, far edge); C = 256, 256 px. Smaller rings (smaller chunks) give
    the same bits, down to chunks so small that every RoI reads global
    memory."""
    rng = np.random.RandomState(3)
    img, u = 256, 3
    feats = tuple(torch.from_numpy(f).to(cuda_device, dtype)
                  for f in make_pyramid(rng, u, 256, base=img // 4))
    boxes = np.array([[-40.0, 100.0, 560.0, 116.0],    # 600 x 16, level 0
                      [60.0, 40.0, 170.0, 150.0],      # 110 x 110, level 0
                      [-50.0, -40.0, 60.0, 70.0],      # off the top left
                      [200.0, 180.0, 330.0, 300.0]],   # off the far edge
                     np.float32)
    n = 5 if with_frame_idx else u
    rois = torch.from_numpy(np.tile(boxes[None], (n, 1, 1))).to(cuda_device)
    fidx = (torch.from_numpy(np.array([2, 0, 1, 2, 0], np.int32)).to(
        cuda_device) if with_frame_idx else None)
    _, smem_block, side = roi_align_cuda.device_limits(cuda_device)
    ring, chunk = roi_align_cuda.ring_plan(smem_block, side)
    big = [b for b in boxes
           if _footprint_bytes(b, img, 256, feats[0].element_size()) > chunk]
    assert len(big) >= 3, 'the boxes fit a chunk: nothing is cut'
    got = _check_k1(feats, rois, fidx)
    for smaller in (ring // 3 // 128 * 128, 32768, 8192, 2048):
        other = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx,
                                                    _ring_bytes=smaller)
        assert torch.equal(_bits(got), _bits(other)), smaller


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_kernel_chunk_that_ends_at_the_ring_end(cuda_device,
                                                           dtype):
    """A chunk that ends exactly at the ring's last byte: the next one
    starts at 0 (it once started one past the ring's end, an illegal
    address). One RoI of the InstBlink learning proof's step (a 96x128
    canvas, C = 64, level 1: 21 chunks at a 16 KB ring), then every ring
    from 4 KB to 64 KB in 128-byte steps, each as the full ring gives it."""
    rng = np.random.RandomState(4)
    feats = tuple(torch.from_numpy(rng.randn(1, 96 // s, 128 // s, 64)
                                   .astype(np.float32)).to(cuda_device, dtype)
                  for s in (4, 8, 16, 32))
    rois = torch.tensor([[[-54.342873, -2.6034966, 201.47107, 61.4343]]],
                        device=cuda_device)
    got = _check_k1(feats, rois, None)
    for ring in range(4096, 65536 + 1, 128):
        other = roi_align_cuda.launch_roi_align_fpn(feats, rois,
                                                    _ring_bytes=ring)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(other)), ring


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_kernel_scalar_path(cuda_device, dtype):
    """C = 62 is a multiple of neither vector width (4 f32, 8 bf16): the
    kernel reads scalars from global memory."""
    feats, rois, fidx = _case(cuda_device, dtype, True)
    feats = tuple(f[..., :62].contiguous() for f in feats)
    _check_k1(feats, rois, fidx)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_kernel_other_grid(cuda_device, dtype):
    """out_size 5, sampling_ratio 3: the body for a sampling count other
    than the model's 2."""
    feats, rois, fidx = _case(cuda_device, dtype, True)
    got = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx, 5, 3)
    torch.cuda.synchronize()
    ref = roi_align_fpn_mm(feats, rois, fidx, 5, 3)
    assert got.shape == ref.shape == (*rois.shape[:2], 5, 5, 64)
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= TOL_F32 * max(f.abs().max().item() for f in feats), err
    else:
        assert err <= TOL_BF16 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_kernel_r100(cuda_device, dtype):
    """100 RoIs per slot over all four levels, the query family's shape."""
    rng = np.random.RandomState(4)
    feats = tuple(torch.from_numpy(f).to(cuda_device, dtype)
                  for f in make_pyramid(rng, 3, 256, base=64))
    rois = mixed_rois(rng, 3, (20, 60, 150, 400, 900) * 20, img=256)
    _check_k1(feats, torch.from_numpy(rois).to(cuda_device), None)


@pytest.mark.cuda
@pytest.mark.parametrize('frames', [44, 88])
def test_roi_align_kernel_instblink_shapes(cuda_device, frames):
    """K1 in f32, identity form, at the InstBlink path's shapes: 100 RoIs
    on each of 44 frames (a train step: 4 clips of 11) or 88 (an eval
    launch: 8 windows of 11) of a 384x640 canvas, C=256."""
    rng = np.random.RandomState(frames)
    feats = tuple(torch.from_numpy(rng.randn(
        frames, 384 // s, 640 // s, 256).astype(np.float32)).to(cuda_device)
        for s in (4, 8, 16, 32))
    size = rng.choice([24.0, 70.0, 150.0, 300.0, 640.0], (frames, 100, 1))
    xy = np.stack([rng.uniform(-60, 640, (frames, 100)),
                   rng.uniform(-40, 384, (frames, 100))], -1)
    rois = np.concatenate([xy, xy + size * rng.uniform(0.6, 1.4, (
        frames, 100, 2))], -1).astype(np.float32)
    _check_k1(feats, torch.from_numpy(rois).to(cuda_device), None)


@pytest.mark.cuda
def test_query_detector_full_width_kernel_matches_plain(cuda_device):
    """The InstBlink model at full width (R-50, C=256, 100 queries, 6
    stages) on an 11-frame u8 clip of 640x360 frames on the 384x640
    canvas, seeded random weights, f32 with TF32 off, through
    chip_smoke.query_window_check: at every stage K1 against the plain
    RoIAlign on the same inputs at 1e-5 of the largest feature, and the
    stage head fed either within 1e-3; 6 K1 launches."""
    from chip_smoke import query_window_check
    from mcgaze_tpu_torch.models.query_detector import (QueryDetectorConfig,
                                                        init_query_model)
    cfg = QueryDetectorConfig()
    model = init_query_model(cfg, seed=0, device=cuda_device)
    rng = np.random.RandomState(0)
    imgs = torch.zeros((11, 384, 640, 3), dtype=torch.uint8)
    imgs[:, :360] = torch.from_numpy(rng.randint(0, 256, (11, 360, 640, 3),
                                                 dtype=np.uint8))
    whwh = torch.tensor([[640.0, 360.0, 640.0, 360.0]]).repeat(11, 1)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = roi_align_cuda.launch_count
    try:
        rows = query_window_check(model, imgs.to(cuda_device),
                                  whwh.to(cuda_device), 11)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert len(rows) == cfg.num_stages
    assert roi_align_cuda.launch_count == before + cfg.num_stages


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_kernel_partial_last_round(cuda_device, dtype):
    """More RoIs than blocks, not a multiple: the persistent grid's last
    round leaves blocks without a RoI."""
    sms = roi_align_cuda.device_limits(cuda_device)[0]
    units = sms + sms // 2 + 1
    rng = np.random.RandomState(5)
    feats = tuple(torch.from_numpy(f).to(cuda_device, dtype)
                  for f in make_pyramid(rng, units, 64, base=16))
    rois = mixed_rois(rng, units, (25,), img=64)
    assert roi_align_cuda.persistent_grid(units, sms) == sms
    _check_k1(feats, torch.from_numpy(rois).to(cuda_device), None)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_roi_align_kernel_is_deterministic(cuda_device, dtype,
                                           with_frame_idx):
    """Each bin is one thread's sum in a fixed order: two launches give
    the same bits."""
    feats, rois, fidx = _case(cuda_device, dtype, with_frame_idx)
    a = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx)
    b = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize('smem_block, side', [
    (232448, 8432), (232448, 8992), (101376, 8432), (49152, 1000)])
def test_k1_ring_plan_matches_numpy(smem_block, side):
    """K1's ring on the CPU: the largest 128-byte multiple that fits the
    block's shared memory beside what it keeps there, and the largest
    128-byte multiple within half of it."""
    ring, chunk = roi_align_cuda.ring_plan(smem_block, side)
    sizes = np.arange(0, smem_block + 1, 128)
    assert ring == sizes[sizes + side <= smem_block].max()
    assert chunk == sizes[sizes * 2 <= ring].max()


def test_k1_ring_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match='holds no chunk'):
        roi_align_cuda.ring_plan(9216, 8992)
    with pytest.raises(ValueError, match='holds no chunk'):
        roi_align_cuda.ring_plan(8432, 8432)


def test_k1_persistent_grid_matches_numpy():
    units = np.array([1, 5, 131, 132, 133, 199, 264, 672, 4400])
    got = [roi_align_cuda.persistent_grid(int(x), 132) for x in units]
    np.testing.assert_array_equal(got, np.minimum(units, 132))


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


def test_frame_slots_matches_numpy():
    """The frame -> slots inverse K3 reads in the frame_idx form, on the
    CPU, against a numpy construction: repeated frames, a frame no slot
    maps to (3), and slots mapped outside [0, U) (-1 and 7), which no
    frame lists."""
    fidx = np.array([2, 0, 7, 2, -1, 0, 2, 4, 1], np.int32)
    u = 5
    offsets, slots = roi_align_cuda.frame_slots(torch.from_numpy(fidx), u)
    assert offsets.dtype == slots.dtype == torch.int32
    assert offsets.shape == (u + 1,) and slots.shape == fidx.shape
    offsets, slots = offsets.numpy(), slots.numpy()
    for f in range(u):
        np.testing.assert_array_equal(slots[offsets[f]:offsets[f + 1]],
                                      np.nonzero(fidx == f)[0])
    assert offsets[3] == offsets[4]
    listed = slots[offsets[0]:offsets[u]]
    assert sorted(listed) == sorted(np.nonzero((fidx >= 0) &
                                               (fidx < u))[0])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_roi_align_bwd_kernel_is_deterministic(cuda_device, dtype,
                                               with_frame_idx):
    """Each cell sums its terms in a fixed order: two launches give the
    same bits."""
    feats, rois, fidx = _case(cuda_device, dtype, with_frame_idx)
    n, r = rois.shape[:2]
    g = torch.randn(n, r, 7, 7, feats[0].shape[-1], device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(1)).to(dtype)
    shapes = [f.shape for f in feats]
    a = roi_align_cuda.launch_roi_align_fpn_bwd(g, rois, fidx, shapes)
    b = roi_align_cuda.launch_roi_align_fpn_bwd(g, rois, fidx, shapes)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert x.dtype == dtype
        assert torch.equal(x.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           y.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_frame_idx', [False, True])
def test_roi_align_bwd_kernel_writes_every_cell(cuda_device, dtype,
                                                with_frame_idx):
    """The output is one torch.empty that the kernel fills: handed a block
    the caching allocator last held NaN in (its address is checked), it is
    finite everywhere and exactly 0 on the cells no RoI touches. Those are
    the cells where the plain f32 gradient of an all-ones cotangent is 0:
    its terms are all >= 0, so nothing cancels there (a bf16 gradient of a
    random cotangent can cancel to 0 where two slots add into one frame).
    In the frame_idx form frame 4 is mapped to by no slot."""
    feats, rois, fidx = _case(cuda_device, dtype, with_frame_idx)
    if fidx is not None:
        fidx[fidx == 4] = 0
    n, r = rois.shape[:2]
    g = torch.randn(n, r, 7, 7, feats[0].shape[-1], device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(2)).to(dtype)
    shapes = [f.shape for f in feats]
    total = sum(f.numel() for f in feats)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    poison = torch.full((total,), float('nan'), dtype=dtype,
                        device=cuda_device)
    poisoned = poison.data_ptr()
    del poison
    got = roi_align_cuda.launch_roi_align_fpn_bwd(g, rois, fidx, shapes)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == poisoned
    reach = _grads(tuple(f.float() for f in feats), rois, fidx,
                   torch.ones(g.shape, device=cuda_device), roi_align_fpn_mm)
    for a, b in zip(got, reach):
        assert torch.isfinite(a).all()
        assert (a[b == 0] == 0).all() and (b >= 0).all()
    assert any((b > 0).any() for b in reach)
    if fidx is not None:
        assert all((a[4] == 0).all() for a in got)


# ------------------------------------------------------------ K5 and K4

def random_blocks(seed, cin=64, mid=64, n_blocks=2):
    """Stride-1 Bottlenecks (the first with a downsample when cin !=
    4*mid) with seeded weights and BN statistics, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    blocks = []
    for _ in range(n_blocks):
        blk = Bottleneck(cin, mid, 1)
        init_weights(blk, gen)
        with torch.no_grad():
            for name, b in blk.named_buffers():
                if name.endswith('running_mean'):
                    b.normal_(0.0, 0.1, generator=gen)
                elif name.endswith('running_var'):
                    b.uniform_(0.5, 1.5, generator=gen)
            for name, p in blk.named_parameters():
                if p.dim() == 1:
                    p.normal_(1.0 if name.endswith('weight') else 0.0, 0.1,
                              generator=gen)
        blocks.append(blk)
        cin = 4 * mid
    return blocks


def chain_case(device, dtype, frames=3, h=7, w=9, seed=0):
    """x (frames, h*w, 64) and the folded weights of two blocks (64 -> 256
    with a downsample, then 256 -> 256): 189 rows, a ragged row tile, a
    non-square frame."""
    blocks = [b.to(device) for b in random_blocks(seed)]
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        frames, h * w, 64).astype(np.float32)).to(device, dtype)
    with torch.no_grad():
        weights = [a for b in blocks
                   for a in fused_bottleneck.fold_block_params(b, dtype)]
    return blocks, x, weights, h, w


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fused_bottleneck_kernel_matches_plain(cuda_device, dtype):
    _, x, weights, h, w = chain_case(cuda_device, dtype)
    before = fused_bottleneck.launch_count
    with torch.no_grad():
        got = fused_bottleneck.fused_bottleneck_chain(x, weights, h, w)
        torch.cuda.synchronize()
        ref = fused_bottleneck.chain_reference(x, weights, h, w)
    assert fused_bottleneck.launch_count == before + 7    # 3 + 1 + 3 convs
    assert got.dtype == dtype and got.shape == ref.shape == (3, 63, 256)
    err = (got.float() - ref.float()).abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else TOL_BF16) * \
        ref.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin, mid, n_blocks, frames, h, w', [
    (64, 64, 2, 5, 5, 3),        # N=64 and 256, downsample, frames 3 px wide
    (512, 128, 2, 2, 14, 14),    # identity x on the first block, 392 rows
    (1024, 256, 1, 3, 7, 7),     # N=256 and 1024, K=2304, 147 rows
    (64, 64, 1, 40, 28, 28),     # 245 row tiles: several per block, and
])                               # the ring wraps within and across tiles
def test_fused_bottleneck_kernel_tilings(cuda_device, dtype, cin, mid,
                                         n_blocks, frames, h, w):
    """Shapes that reach the bf16 kernel's tiles: a ragged last row tile
    (every case), a 3x3 on frames narrower than a tile, N=64 and N>=256
    tiles, a chain whose first block adds x itself, Cin=64 with a
    downsample, and more row tiles than the card has SMs."""
    blocks = [b.to(cuda_device)
              for b in random_blocks(1, cin=cin, mid=mid, n_blocks=n_blocks)]
    x = torch.from_numpy(np.random.RandomState(1).randn(
        frames, h * w, cin).astype(np.float32)).to(cuda_device, dtype)
    with torch.no_grad():
        weights = [a for b in blocks
                   for a in fused_bottleneck.fold_block_params(b, dtype)]
        before = fused_bottleneck.launch_count
        got = fused_bottleneck.fused_bottleneck_chain(x, weights, h, w)
        torch.cuda.synchronize()
        ref = fused_bottleneck.chain_reference(x, weights, h, w)
    assert fused_bottleneck.launch_count == \
        before + 3 * n_blocks + int(cin != 4 * mid)
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else TOL_BF16) * \
        ref.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.cuda
def test_fused_bottleneck_function_gradient(cuda_device):
    """Kernel forward, autograd-of-the-plain-version backward: gradients of
    x and of every conv and BN parameter through the fold, f32."""
    def grads(device, fn):
        blocks, x, _, h, w = chain_case(device, torch.float32, seed=3)
        x.requires_grad_()
        weights = [a for b in blocks
                   for a in fused_bottleneck.fold_block_params(b,
                                                               torch.float32)]
        out = fn(x, weights, h, w)
        g = torch.from_numpy(np.random.RandomState(4).randn(
            *out.shape).astype(np.float32)).to(device)
        out.backward(g)
        return [x.grad] + [p.grad for b in blocks for p in b.parameters()]

    before = fused_bottleneck.launch_count
    got = grads(cuda_device, fused_bottleneck.fused_bottleneck_chain)
    torch.cuda.synchronize()
    assert fused_bottleneck.launch_count == before + 7
    ref = grads(cuda_device, fused_bottleneck.chain_reference)
    for a, b in zip(got, ref):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), err


@pytest.mark.cuda
def test_fused_bottleneck_kernel_refuses_what_it_does_not_take(cuda_device):
    _, x, weights, h, w = chain_case(cuda_device, torch.float32)
    launch = fused_bottleneck.launch_fused_bottleneck_chain
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        launch(x.half(), weights, h, w)
    with pytest.raises(TypeError, match='fold the weights'):
        launch(x.bfloat16(), weights, h, w)
    with pytest.raises(ValueError, match='non-contiguous'):
        launch(x.transpose(1, 2).contiguous().transpose(1, 2), weights, h,
               w)
    with pytest.raises(ValueError, match='needs'):
        launch(x, weights, h + 1, w)
    with pytest.raises(RuntimeError, match='autograd Function'):
        launch(x.clone().requires_grad_(), weights, h, w)
    blocks = random_blocks(0, cin=48, mid=64, n_blocks=1)
    with torch.no_grad():
        odd = [a.to(cuda_device) for a in
               fused_bottleneck.fold_block_params(blocks[0], torch.float32)]
    with pytest.raises(ValueError, match='multiples of 64'):
        launch(torch.zeros(1, h * w, 48, device=cuda_device), odd, h, w)


def attention_case(device, clips=3, t=7, q=3, c=256, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).to(device)

    query = arr(clips * t, q, c)
    weights = (arr(c, 3 * c, scale=c ** -0.5), arr(3 * c, scale=0.1),
               arr(c, c, scale=c ** -0.5), arr(c, scale=0.1),
               1.0 + arr(c, scale=0.1), arr(c, scale=0.1))
    return query, weights, t


@pytest.mark.cuda
@pytest.mark.parametrize('clips', [1, 3, 32])
def test_stqi_attention_kernel_matches_plain(cuda_device, clips):
    query, weights, t = attention_case(cuda_device, clips)
    before = stqi_attention.launch_count
    got = stqi_attention.fused_stqi_attention(query, *weights, t)
    torch.cuda.synchronize()
    assert stqi_attention.launch_count == before + 1
    ref = stqi_attention.stqi_attention_reference(query, *weights, t)
    assert (got - ref).abs().max().item() <= 2e-5
    # clips are independent: moving the others leaves clip 0 as it was
    if clips > 1:
        perm = torch.cat([query[:t], query[t:].flip(0)])
        again = stqi_attention.fused_stqi_attention(perm, *weights, t)
        assert torch.equal(again[:t], got[:t])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fused_stqi_head_matches_unfused_on_card(cuda_device, dtype):
    """The head casts its query to f32 for the kernel and back: the fused
    head equals the unfused one (2e-5 in f32; in bf16 2e-2 of the largest
    output, where the unfused head also rounds inside the attention)."""
    gen = torch.Generator().manual_seed(5)
    heads = []
    for fused in (False, True):
        head = STQIHead(fused_attention=fused)
        init_weights(head, torch.Generator().manual_seed(5))
        heads.append(head.to(cuda_device).eval())
    rng = np.random.RandomState(6)
    roi = torch.from_numpy(rng.randn(2 * 7 * 3, 7, 7, 256).astype(
        np.float32)).to(cuda_device, dtype)
    query = torch.randn(2 * 7, 3, 256, generator=gen).to(cuda_device, dtype)
    before = stqi_attention.launch_count
    with torch.no_grad():
        outs = [head(roi, query, 7) for head in heads]
    assert stqi_attention.launch_count == before + 1
    for a, b in zip(*outs):
        err = (a.float() - b.float()).abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else \
            TOL_BF16 * a.float().abs().max().item()
        assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('c, heads, cluster', [
    (96, 3, 3),       # 4 does not divide the heads: 3 CTAs of one head
    (176, 11, 1),     # no divisor up to 8 leaves <= 64 channels a CTA: one
])                    # CTA of 176 channels, the kernel's wide tile
def test_stqi_attention_kernel_other_head_counts(cuda_device, c, heads,
                                                 cluster):
    query, weights, t = attention_case(cuda_device, clips=3, c=c, seed=7)
    assert stqi_attention.cluster_plan(7 * 3, c, heads)['cluster'] == cluster
    got = stqi_attention.fused_stqi_attention(query, *weights, t,
                                              heads=heads)
    torch.cuda.synchronize()
    ref = stqi_attention.stqi_attention_reference(query, *weights, t,
                                                  heads=heads)
    assert (got - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize('tokens, c, heads, plan', [
    # the gaze shape: 4 CTAs of 2 heads, 21 tokens in 24 rows
    (21, 256, 8, dict(cluster=4, heads_per_cta=2, cols_per_cta=64, rows=24,
                      kc=16, smem_bytes=111104)),
    # the most tokens the kernel takes
    (32, 256, 8, dict(cluster=4, heads_per_cta=2, cols_per_cta=64, rows=32,
                      kc=16, smem_bytes=131584)),
    # 3 heads: 4 does not divide them, so 3 CTAs of one head
    (21, 96, 3, dict(cluster=3, heads_per_cta=1, cols_per_cta=32, rows=24,
                     kc=16, smem_bytes=49760)),
])
def test_stqi_attention_cluster_plan(tokens, c, heads, plan):
    """K4's split of a clip, on the CPU: the cluster size, each CTA's
    heads and columns, the padded rows, the ring's rows per stage and the
    shared memory of a CTA (at the gaze shape two CTAs fit an SM)."""
    got = stqi_attention.cluster_plan(tokens, c, heads)
    assert {k: got[k] for k in plan} == plan
    assert heads % got['cluster'] == 0


@pytest.mark.cuda
def test_stqi_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    query, weights, t = attention_case(cuda_device)
    launch = stqi_attention.launch_stqi_attention
    with pytest.raises(TypeError, match='float32'):
        launch(query.bfloat16(), *weights, t)
    with pytest.raises(ValueError, match='whole clips'):
        launch(query[:-1], *weights, t)
    with pytest.raises(ValueError, match='heads'):
        launch(query, *weights, t, heads=6)
    with pytest.raises(ValueError, match='non-contiguous'):
        launch(query, weights[0].t().contiguous().t(), *weights[1:], t)
    with pytest.raises(RuntimeError, match='forward-only'):
        launch(query.clone().requires_grad_(), *weights, t)
    wide, wide_weights, _ = attention_case(cuda_device, clips=1, c=512)
    with pytest.raises(ValueError, match='up to 256'):
        launch(wide, *wide_weights, t, heads=16)


@pytest.mark.cuda
@pytest.mark.parametrize('op', ['stqi_attention', 'fused_bottleneck_chain'])
def test_operators_launch_the_kernels(cuda_device, op):
    """The operators' CUDA kernels are the launch wrappers: one call adds
    the wrapper's launches to its count and equals the eager call bit for
    bit (K4 at 3 clips; K5 bf16 over two blocks, 7 convolutions)."""
    if op == 'stqi_attention':
        query, weights, t = attention_case(cuda_device)
        args, module, launches = (query, *weights, t, 8), stqi_attention, 1
        eager = stqi_attention.fused_stqi_attention(query, *weights, t)
    else:
        _, x, weights, h, w = chain_case(cuda_device, torch.bfloat16)
        args, module, launches = (x, weights, h, w), fused_bottleneck, 7
        with torch.no_grad():
            eager = fused_bottleneck.fused_bottleneck_chain(x, weights, h, w)
    before = module.launch_count
    got = getattr(torch.ops.mcgaze, op)(*args)
    torch.cuda.synchronize()
    assert module.launch_count == before + launches
    assert torch.equal(got, eager)
