"""Fused FPN RoIAlign: the hand-written CUDA kernels (csrc/roi_align_fpn.cu,
the forward; csrc/roi_align_fpn_bwd.cu, its transpose), their wrappers and
the autograd Function that joins them.

The forward replaces mcgaze_tpu/ops/roi_align_pallas.py::roi_align_fpn_pallas
in both of its forms (identity, and slot -> unique-frame through
frame_idx); the backward replaces roi_align_fpn_pallas_bwd and also covers
the frame_idx form. The sources' headers say what bounds each kernel on
the card and how its design answers that.

`roi_align_fpn` is what the model calls: tensors on the CPU go to the plain
version (ops/roi_align.py::roi_align_fpn_mm, whose gradient is autograd),
tensors on a CUDA device go to `RoIAlignFPNFunction`: the forward kernel,
and the backward kernel for the feature gradient (the rois get none, the
model detaches them). The launch wrappers raise on anything the kernels do
not take; there is no fallback from the card to the plain version.
`launch_count` and `bwd_launch_count` count the kernels' launches.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _native
from .roi_align import roi_align_fpn_mm

launch_count = 0
bwd_launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS, _MAX_OUT, _MAX_SAMPLING = 4, 16, 4


def roi_align_fpn(feats, rois: torch.Tensor,
                  frame_idx: torch.Tensor | None = None,
                  out_size: int = 7, sampling_ratio: int = 2,
                  strides=(4, 8, 16, 32),
                  finest_scale: float = 56.0) -> torch.Tensor:
    """feats: L tensors (U, H_l, W_l, C) NHWC; rois: (N, R, 4) xyxy f32;
    frame_idx: optional (N,) int32 slot -> frame map (U == N when
    omitted). Returns (N, R, out_size, out_size, C) in feats' dtype,
    differentiable in feats."""
    tensors = list(feats) + [rois] + ([] if frame_idx is None
                                      else [frame_idx])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'roi_align_fpn: inputs on several devices '
                         f'{sorted(map(str, devices))}')
    if next(iter(devices)).type == 'cpu':
        return roi_align_fpn_mm(feats, rois, frame_idx, out_size,
                                sampling_ratio, strides, finest_scale)
    return RoIAlignFPNFunction.apply(
        rois, frame_idx,
        (out_size, sampling_ratio, tuple(strides), float(finest_scale)),
        *feats)


class RoIAlignFPNFunction(torch.autograd.Function):
    """Forward: the K1 kernel. Backward: the K3 kernel, the feature
    gradient in the features' dtype (the cotangent is cast to it first, as
    the JAX _diff_bwd does); no gradient for rois or frame_idx."""

    @staticmethod
    def forward(ctx, rois, frame_idx, params, *feats):
        out = launch_roi_align_fpn(feats, rois, frame_idx, *params)
        ctx.save_for_backward(rois, frame_idx)
        ctx.params = params
        ctx.level_shapes = [tuple(f.shape) for f in feats]
        ctx.dtype = feats[0].dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        rois, frame_idx = ctx.saved_tensors
        grads = launch_roi_align_fpn_bwd(
            g.to(ctx.dtype).contiguous(), rois, frame_idx, ctx.level_shapes,
            *ctx.params)
        return (None, None, None, *grads)


def _signature(lib, name):
    fn = getattr(lib, name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p] * 4 + [i] * 8 + [f] * 4 + [i, i] + [p, p, p]
                   + [i] * 5 + [f, i, i, p])
    fn.restype = ctypes.c_int
    return fn


def _check(what, level_shapes, dtype, rois, frame_idx, out_size,
           sampling_ratio, strides, tensors):
    """Raise on what the kernels do not take. Returns (U, C, N, R)."""
    num_levels = len(level_shapes)
    if not 1 <= num_levels <= _MAX_LEVELS or len(strides) != num_levels:
        raise ValueError(f'{what}: {num_levels} levels with strides '
                         f'{strides}; it takes 1..{_MAX_LEVELS} levels, one '
                         'stride each')
    if not (1 <= out_size <= _MAX_OUT and 1 <= sampling_ratio <= _MAX_SAMPLING):
        raise ValueError(f'{what}: out_size {out_size} (max {_MAX_OUT}), '
                         f'sampling_ratio {sampling_ratio} (max '
                         f'{_MAX_SAMPLING})')
    for t in tensors + [rois] + ([] if frame_idx is None else [frame_idx]):
        if not t.is_cuda:
            raise RuntimeError(f'{what}: a {t.device} tensor given; the '
                               'kernel runs on a CUDA device only')
        if t.device != rois.device:
            raise ValueError(f'{what}: inputs on several devices')
        if not t.is_contiguous():
            raise ValueError(f'{what}: non-contiguous input '
                             f'{tuple(t.shape)} stride {t.stride()}')
    if dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {dtype}; it takes float32 or '
                        'bfloat16, the same on every level')
    if rois.dtype != torch.float32:
        raise TypeError(f'{what}: rois {rois.dtype}, needs float32')
    if any(len(s) != 4 for s in level_shapes):
        raise ValueError(f'{what}: levels must be (U, H, W, C)')
    u, c = level_shapes[0][0], level_shapes[0][3]
    if any(s[0] != u or s[3] != c for s in level_shapes):
        raise ValueError(f'{what}: levels disagree on frames or channels: '
                         f'{level_shapes}')
    if rois.dim() != 3 or rois.shape[2] != 4:
        raise ValueError(f'{what}: rois {tuple(rois.shape)}, needs (N, R, 4)')
    n, r = rois.shape[:2]
    if frame_idx is None:
        if u != n:
            raise ValueError(f'{what}: {u} frames for {n} slots and no '
                             'frame_idx')
    elif frame_idx.dtype != torch.int32 or tuple(frame_idx.shape) != (n,):
        raise TypeError(f'{what}: frame_idx {frame_idx.dtype} '
                        f'{tuple(frame_idx.shape)}, needs int32 ({n},)')
    if n * r * out_size >= 2 ** 31:
        raise ValueError(f'{what}: grid too large')
    return u, c, n, r


def _level_args(level_shapes, strides, ptrs):
    """The C interface's per-level arguments, padded to _MAX_LEVELS."""
    pad = _MAX_LEVELS - len(level_shapes)
    hw = []
    for s in level_shapes:
        hw += [s[1], s[2]]
    return (list(ptrs) + [None] * pad, hw + [0, 0] * pad,
            [float(s) for s in strides] + [1.0] * pad)


def _vec(c, itemsize, tensors):
    """16 bytes of channels per load where C and every pointer allow it."""
    per_load = 16 // itemsize
    return per_load if (c % per_load == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)) else 1


def launch_roi_align_fpn(feats, rois, frame_idx=None, out_size=7,
                         sampling_ratio=2, strides=(4, 8, 16, 32),
                         finest_scale=56.0) -> torch.Tensor:
    """The forward kernel alone: CUDA tensors only, checked, launched on
    the current stream; no synchronisation. It builds no autograd graph,
    so it refuses features that need a gradient while grad mode is on:
    that path goes through roi_align_fpn (RoIAlignFPNFunction)."""
    global launch_count
    feats = list(feats)
    what = 'roi_align_fpn kernel'
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        raise RuntimeError(f'{what}: features that need a gradient; call '
                           'roi_align_fpn, whose autograd Function runs the '
                           'backward kernel')
    dtype = feats[0].dtype
    if any(f.dtype != dtype for f in feats):
        raise TypeError(f'{what}: feats dtypes {[f.dtype for f in feats]}; '
                        'it takes float32 or bfloat16, the same on every '
                        'level')
    shapes = [tuple(f.shape) for f in feats]
    u, c, n, r = _check(what, shapes, dtype, rois, frame_idx, out_size,
                        sampling_ratio, strides, feats)

    out = torch.empty((n, r, out_size, out_size, c), dtype=dtype,
                      device=rois.device)
    vec = _vec(c, feats[0].element_size(), feats + [out])
    lib = _native.load('roi_align_fpn')
    fn = _signature(lib, 'mcg_roi_align_fpn_fwd')
    ptrs, hw, strides_f = _level_args(shapes, strides,
                                      [f.data_ptr() for f in feats])
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        err = fn(*ptrs, *hw, *strides_f, len(feats), u, rois.data_ptr(),
                 None if frame_idx is None else frame_idx.data_ptr(),
                 out.data_ptr(), n, r, c, _DTYPES[dtype], vec,
                 float(finest_scale), out_size, sampling_ratio, stream)
    _native.check(lib, err, 'roi_align_fpn kernel launch')
    launch_count += 1
    return out


def launch_roi_align_fpn_bwd(g, rois, frame_idx, level_shapes, out_size=7,
                             sampling_ratio=2, strides=(4, 8, 16, 32),
                             finest_scale=56.0) -> tuple:
    """The backward kernel alone: g (N, R, out, out, C) on a CUDA device
    in the features' dtype, level_shapes the L feature shapes (U, H, W, C).
    Returns the L feature gradients in g's dtype, launched on the current
    stream; no synchronisation.

    The terms are added with f32 atomics into one zeroed f32 buffer that
    holds every level; in f32 it is the result, in bf16 it is cast once."""
    global bwd_launch_count
    what = 'roi_align_fpn backward kernel'
    level_shapes = [tuple(int(d) for d in s) for s in level_shapes]
    u, c, n, r = _check(what, level_shapes, g.dtype, rois, frame_idx,
                        out_size, sampling_ratio, strides, [g])
    if tuple(g.shape) != (n, r, out_size, out_size, c):
        raise ValueError(f'{what}: g {tuple(g.shape)}, needs '
                         f'{(n, r, out_size, out_size, c)}')

    sizes = [s[0] * s[1] * s[2] * s[3] for s in level_shapes]
    offsets = [sum(sizes[:k]) for k in range(len(sizes))]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=g.device)
    vec = _vec(c, g.element_size(), [g])
    lib = _native.load('roi_align_fpn_bwd')
    fn = _signature(lib, 'mcg_roi_align_fpn_bwd')
    ptrs, hw, strides_f = _level_args(
        level_shapes, strides, [buf.data_ptr() + 4 * o for o in offsets])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(*ptrs, *hw, *strides_f, len(level_shapes), u,
                 rois.data_ptr(),
                 None if frame_idx is None else frame_idx.data_ptr(),
                 g.data_ptr(), n, r, c, _DTYPES[g.dtype], vec,
                 float(finest_scale), out_size, sampling_ratio, stream)
    _native.check(lib, err, 'roi_align_fpn backward kernel launch')
    out = buf.to(g.dtype)
    bwd_launch_count += 1
    return tuple(out[o:o + sz].view(shape)
                 for o, sz, shape in zip(offsets, sizes, level_shapes))
