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

The forward is also the operator `torch.ops.mcgaze.roi_align_fpn`, so a
traced program (`torch.export`, tools/deployment/export_model.py) records
it as one node: its CUDA kernel is the forward kernel, its CPU kernel the
plain version, and its fake kernel gives the output's shape.
`roi_align_fpn` goes through the operator only while a program is being
traced, and the operator has no gradient: with the backward kernel
registered as its gradient, an eager call whose features need one cost
several times the autograd Function's host time (tools/k1_host_us.py,
'roi_align_fpn, grad'; PERF.md). The backward kernel is the operator
`torch.ops.mcgaze.roi_align_fpn_bwd` (CPU kernel: ops/roi_align.py::
roi_align_fpn_mm_bwd). Inside ops/routing.py::through_operators() an eager
call takes `RoIAlignFPNFunction` on any device with both kernels reached
through their operators, so a dispatch mode sees each launch
(utils/profiling.py::cost_analysis).
"""
from __future__ import annotations

import ctypes
import struct

import torch
from torch.autograd.function import once_differentiable

from . import _native, routing
from .roi_align import roi_align_fpn_mm, roi_align_fpn_mm_bwd

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
    if torch.compiler.is_compiling():
        return torch.ops.mcgaze.roi_align_fpn(
            list(feats), rois, frame_idx, out_size, sampling_ratio,
            list(strides), float(finest_scale))
    tensors = list(feats) + [rois] + ([] if frame_idx is None
                                      else [frame_idx])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'roi_align_fpn: inputs on several devices '
                         f'{sorted(map(str, devices))}')
    if next(iter(devices)).type == 'cpu' and not routing.active():
        return roi_align_fpn_mm(feats, rois, frame_idx, out_size,
                                sampling_ratio, strides, finest_scale)
    return RoIAlignFPNFunction.apply(
        rois, frame_idx,
        (out_size, sampling_ratio, tuple(strides), float(finest_scale)),
        *feats)


def _op_cpu(feats, rois, frame_idx, out_size, sampling_ratio, strides,
            finest_scale):
    # looked up at call time, as roi_align_fpn's CPU path is, so a test
    # can wrap both at once
    return roi_align_fpn_mm(feats, rois, frame_idx, out_size, sampling_ratio,
                            strides, finest_scale)


roi_align_fpn_op = torch.library.custom_op(
    'mcgaze::roi_align_fpn', _op_cpu, mutates_args=(), device_types='cpu',
    schema='(Tensor[] feats, Tensor rois, Tensor? frame_idx, int out_size, '
           'int sampling_ratio, int[] strides, float finest_scale) -> Tensor')


@roi_align_fpn_op.register_kernel('cuda')
def _op_cuda(feats, rois, frame_idx, out_size, sampling_ratio, strides,
             finest_scale):
    # the operator has no gradient: its kernel never builds a graph
    with torch.no_grad():
        return launch_roi_align_fpn(feats, rois, frame_idx, out_size,
                                    sampling_ratio, strides, finest_scale)


@roi_align_fpn_op.register_fake
def _op_fake(feats, rois, frame_idx, out_size, sampling_ratio, strides,
             finest_scale):
    return feats[0].new_empty((rois.shape[0], rois.shape[1], out_size,
                               out_size, feats[0].shape[-1]))


def _bwd_op_cpu(g, rois, frame_idx, level_shapes, out_size, sampling_ratio,
                strides, finest_scale):
    return list(roi_align_fpn_mm_bwd(
        g, rois, frame_idx, _shapes(level_shapes), out_size, sampling_ratio,
        strides, finest_scale))


def _shapes(flat) -> list:
    """The operator's flat level shapes -> L (U, H, W, C) tuples."""
    return [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]


roi_align_fpn_bwd_op = torch.library.custom_op(
    'mcgaze::roi_align_fpn_bwd', _bwd_op_cpu, mutates_args=(),
    device_types='cpu',
    schema='(Tensor g, Tensor rois, Tensor? frame_idx, int[] level_shapes, '
           'int out_size, int sampling_ratio, int[] strides, '
           'float finest_scale) -> Tensor[]')


@roi_align_fpn_bwd_op.register_kernel('cuda')
def _bwd_op_cuda(g, rois, frame_idx, level_shapes, out_size, sampling_ratio,
                 strides, finest_scale):
    # the kernel's gradients are views of one buffer; an operator's
    # outputs may not alias each other
    return [t.clone() for t in launch_roi_align_fpn_bwd(
        g, rois, frame_idx, _shapes(level_shapes), out_size, sampling_ratio,
        strides, finest_scale)]


@roi_align_fpn_bwd_op.register_fake
def _bwd_op_fake(g, rois, frame_idx, level_shapes, out_size, sampling_ratio,
                 strides, finest_scale):
    return [g.new_empty(s) for s in _shapes(level_shapes)]


class RoIAlignFPNFunction(torch.autograd.Function):
    """Forward: the K1 kernel. Backward: the K3 kernel, the feature
    gradient in the features' dtype (the cotangent is cast to it first, as
    the JAX _diff_bwd does); no gradient for rois or frame_idx. Inside
    routing.through_operators() both kernels are reached through their
    operators (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, rois, frame_idx, params, *feats):
        ctx.routed = routing.active()
        if ctx.routed:
            out_size, sampling_ratio, strides, finest_scale = params
            out = torch.ops.mcgaze.roi_align_fpn(
                list(feats), rois, frame_idx, out_size, sampling_ratio,
                list(strides), finest_scale)
        else:
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
        g = g.to(ctx.dtype).contiguous()
        if ctx.routed:
            out_size, sampling_ratio, strides, finest_scale = ctx.params
            grads = torch.ops.mcgaze.roi_align_fpn_bwd(
                g, rois, frame_idx,
                [d for s in ctx.level_shapes for d in s], out_size,
                sampling_ratio, list(strides), finest_scale)
        else:
            grads = launch_roi_align_fpn_bwd(g, rois, frame_idx,
                                             ctx.level_shapes, *ctx.params)
        return (None, None, None, *grads)


_bound: dict = {}


def _bind(lib_name, fn_name, argtypes):
    """(library, C function) with its argtypes set once, at first load."""
    key = (lib_name, fn_name)
    bound = _bound.get(key)
    if bound is None:
        lib = _native.load(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        bound = _bound[key] = (lib, fn)
    return bound


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K3's C interface: the pyramid's 4 pointers, 8 sizes and 4 strides, levels
# and frames, rois, the two inverse-map pointers, g, 4 ints, finest_scale,
# out_size, sampling and the stream
_K3_ARGTYPES = ([_P] * 4 + [_I] * 8 + [_F] * 4 + [_I, _I] + [_P] * 4
                + [_I] * 4 + [_F, _I, _I, _P])
# K1's C interface is one pointer to its arguments packed as
# csrc/roi_align_fpn.cu::LaunchArgs (33 fields of 8 bytes), which costs a
# call a fraction of the marshalling of 33 ctypes arguments
_K1_ARGS = struct.Struct('=4Q8q4d2q4Q7qd2qQ')


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
    device = rois.device
    for t in (*tensors, rois, frame_idx):
        if t is None or (t.device == device and t.is_contiguous()):
            continue
        if not t.is_cuda:
            raise RuntimeError(f'{what}: a {t.device} tensor given; the '
                               'kernel runs on a CUDA device only')
        if t.device != device:
            raise ValueError(f'{what}: inputs on several devices')
        raise ValueError(f'{what}: non-contiguous input '
                         f'{tuple(t.shape)} stride {t.stride()}')
    if device.type != 'cuda':
        raise RuntimeError(f'{what}: a {device} tensor given; the kernel '
                           'runs on a CUDA device only')
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
    """The C interface's per-level arguments (pointers, H and W, strides),
    padded to _MAX_LEVELS with null pointers."""
    pad = _MAX_LEVELS - len(level_shapes)
    hw = []
    for s in level_shapes:
        hw += [s[1], s[2]]
    return (list(ptrs) + [0] * pad, hw + [0, 0] * pad,
            [float(s) for s in strides] + [1.0] * pad)


def _vec(c, itemsize, ptrs):
    """16 bytes of channels per load where C and every pointer allow it."""
    per_load = 16 // itemsize
    return per_load if c % per_load == 0 and not any(
        p % 16 for p in ptrs) else 1


_limits: dict = {}


def device_limits(device: torch.device) -> tuple:
    """(SMs, opt-in shared memory of a block, bytes a K1 block needs beside
    its ring) of a CUDA device, read from the CUDA runtime once."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    lim = _limits.get(index)
    if lim is None:
        lib = _native.load('roi_align_fpn')
        fn = lib.mcg_roi_align_fpn_limits
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
        vals = [ctypes.c_int() for _ in range(3)]
        _native.check(lib, fn(index, *vals), 'roi_align_fpn limits')
        lim = _limits[index] = tuple(v.value for v in vals)
    return lim


_work_buffers: dict = {}


def _work(device, stream) -> int:
    """K1's RoI counter on this stream: two int32 zeros, which every launch
    leaves at zero again (the last block out resets them), so launches on
    one stream share them and launches on two streams never do."""
    key = (device.index, stream.cuda_stream)
    buf = _work_buffers.get(key)
    if buf is None:
        with torch.cuda.stream(stream):
            buf = _work_buffers[key] = torch.zeros(2, dtype=torch.int32,
                                                   device=device)
    return buf.data_ptr()


def ring_plan(smem_block: int, side_bytes: int) -> tuple:
    """(ring bytes, the most one chunk's footprint may take) of a K1 block:
    its opt-in shared memory less what the block keeps beside the ring,
    and half of that (the kernel's rule), both rounded down to 128 bytes.
    One such block fills an SM."""
    ring = (smem_block - side_bytes) // 128 * 128
    if ring // 2 < 128:
        raise ValueError(f'roi_align_fpn kernel: a ring of {ring} bytes '
                         'holds no chunk')
    return ring, ring // 2 // 128 * 128


def persistent_grid(units: int, sms: int) -> int:
    """K1's grid: one block per SM (its ring takes the SM's shared
    memory), never more blocks than RoIs."""
    return max(1, min(units, sms))


def launch_roi_align_fpn(feats, rois, frame_idx=None, out_size=7,
                         sampling_ratio=2, strides=(4, 8, 16, 32),
                         finest_scale=56.0, *,
                         _ring_bytes: int | None = None) -> torch.Tensor:
    """The forward kernel alone: CUDA tensors only, checked, launched on
    the current stream; no synchronisation. It builds no autograd graph,
    so it refuses features that need a gradient while grad mode is on:
    that path goes through roi_align_fpn (RoIAlignFPNFunction).
    `_ring_bytes` (tests only) shrinks the block's ring below what its
    shared memory holds, which cuts RoIs into smaller chunks; the output
    does not depend on it."""
    global launch_count
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
    shapes = [f.shape for f in feats]
    u, c, n, r = _check(what, shapes, dtype, rois, frame_idx, out_size,
                        sampling_ratio, strides, feats)
    if any(s[1] * s[2] * c >= 2 ** 31 for s in shapes):
        raise ValueError(f'{what}: a level of {shapes} holds 2**31 '
                         'elements or more in one frame')

    device = rois.device
    out = torch.empty((n, r, out_size, out_size, c), dtype=dtype,
                      device=device)
    ptrs = [f.data_ptr() for f in feats]
    optr = out.data_ptr()
    vec = _vec(c, out.element_size(), (*ptrs, optr))
    lib, fn = _bind('roi_align_fpn', 'mcg_roi_align_fpn_fwd',
                    [ctypes.c_char_p])
    sms, smem_block, side_bytes = device_limits(device)
    ring = ring_plan(smem_block, side_bytes)[0]
    if _ring_bytes is not None:
        ring = min(ring, _ring_bytes)
    stream = torch.cuda.current_stream(device)
    level_ptrs, hw, strides_f = _level_args(shapes, strides, ptrs)
    args = _K1_ARGS.pack(
        *level_ptrs, *hw, *strides_f, len(shapes), u, rois.data_ptr(),
        0 if frame_idx is None else frame_idx.data_ptr(), optr,
        _work(device, stream), n, r, c, _DTYPES[dtype], vec,
        persistent_grid(n * r, sms), ring, finest_scale, out_size,
        sampling_ratio, stream.cuda_stream)
    if device.index == torch.cuda.current_device():
        err = fn(args)
    else:
        with torch.cuda.device(device):
            err = fn(args)
    _native.check(lib, err, 'roi_align_fpn kernel launch')
    launch_count += 1
    return out


def frame_slots(frame_idx: torch.Tensor, num_frames: int) -> tuple:
    """The frame -> slots inverse of a slot -> frame map, built on
    frame_idx's device without a host synchronisation (a stable sort and a
    search): (offsets (U + 1,) int32, slots (N,) int32). Frame f's slots,
    ascending, are slots[offsets[f]:offsets[f + 1]]; a slot mapped outside
    [0, U) is in no frame's range, and a frame no slot maps to has an
    empty one."""
    keys, order = torch.sort(frame_idx, stable=True)
    bounds = torch.arange(num_frames + 1, dtype=keys.dtype,
                          device=keys.device)
    offsets = torch.searchsorted(keys, bounds, out_int32=True)
    return offsets, order.to(torch.int32)


def launch_roi_align_fpn_bwd(g, rois, frame_idx, level_shapes, out_size=7,
                             sampling_ratio=2, strides=(4, 8, 16, 32),
                             finest_scale=56.0) -> tuple:
    """The backward kernel alone: g (N, R, out, out, C) on a CUDA device
    in the features' dtype, level_shapes the L feature shapes (U, H, W, C).
    Returns the L feature gradients in g's dtype, launched on the current
    stream; no synchronisation.

    The gradients are views of one `torch.empty` that the kernel fills
    cell by cell, zeros included, each cell summed in f32 in a fixed order
    and stored once: no memset, no atomics, no f32 buffer, and the same
    bits on every launch. In the frame_idx form the kernel reads each
    frame's slots through `frame_slots`."""
    global bwd_launch_count
    what = 'roi_align_fpn backward kernel'
    level_shapes = [tuple(int(d) for d in s) for s in level_shapes]
    u, c, n, r = _check(what, level_shapes, g.dtype, rois, frame_idx,
                        out_size, sampling_ratio, strides, [g])
    if tuple(g.shape) != (n, r, out_size, out_size, c):
        raise ValueError(f'{what}: g {tuple(g.shape)}, needs '
                         f'{(n, r, out_size, out_size, c)}')
    if u > 65535:
        raise ValueError(f'{what}: {u} frames; it takes at most 65535')

    sizes = [s[0] * s[1] * s[2] * s[3] for s in level_shapes]
    offsets = [sum(sizes[:k]) for k in range(len(sizes))]
    out = torch.empty(sum(sizes), dtype=g.dtype, device=g.device)
    levels = [out[o:o + sz] for o, sz in zip(offsets, sizes)]
    vec = _vec(c, g.element_size(), [t.data_ptr() for t in [g] + levels])
    inverse = (None, None) if frame_idx is None else frame_slots(frame_idx, u)
    lib, fn = _bind('roi_align_fpn_bwd', 'mcg_roi_align_fpn_bwd',
                    _K3_ARGTYPES)
    ptrs, hw, strides_f = _level_args(level_shapes, strides,
                                      [v.data_ptr() for v in levels])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(*ptrs, *hw, *strides_f, len(level_shapes), u,
                 rois.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in inverse),
                 g.data_ptr(), r, c, _DTYPES[g.dtype], vec,
                 float(finest_scale), out_size, sampling_ratio, stream)
    _native.check(lib, err, 'roi_align_fpn backward kernel launch')
    bwd_launch_count += 1
    return tuple(v.view(shape) for v, shape in zip(levels, level_shapes))
