"""Fused FPN RoIAlign forward: the hand-written CUDA kernel
(csrc/roi_align_fpn.cu) and its wrapper.

Replaces mcgaze_tpu/ops/roi_align_pallas.py::roi_align_fpn_pallas in both
of its forms (identity, and slot -> unique-frame through frame_idx). The
source's header says what bounds the kernel on the card and how its design
answers that.

`roi_align_fpn` is what the model calls: tensors on the CPU go to the plain
version (ops/roi_align.py::roi_align_fpn_mm), tensors on a CUDA device go
to the kernel through `launch_roi_align_fpn`, which raises on anything the
kernel does not take. There is no fallback from the card to the plain
version. `launch_count` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _native
from .roi_align import roi_align_fpn_mm

launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS, _MAX_OUT, _MAX_SAMPLING = 4, 16, 4


def roi_align_fpn(feats, rois: torch.Tensor,
                  frame_idx: torch.Tensor | None = None,
                  out_size: int = 7, sampling_ratio: int = 2,
                  strides=(4, 8, 16, 32),
                  finest_scale: float = 56.0) -> torch.Tensor:
    """feats: L tensors (U, H_l, W_l, C) NHWC; rois: (N, R, 4) xyxy f32;
    frame_idx: optional (N,) int32 slot -> frame map (U == N when
    omitted). Returns (N, R, out_size, out_size, C) in feats' dtype."""
    tensors = list(feats) + [rois] + ([] if frame_idx is None
                                      else [frame_idx])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'roi_align_fpn: inputs on several devices '
                         f'{sorted(map(str, devices))}')
    if next(iter(devices)).type == 'cpu':
        return roi_align_fpn_mm(feats, rois, frame_idx, out_size,
                                sampling_ratio, strides, finest_scale)
    return launch_roi_align_fpn(feats, rois, frame_idx, out_size,
                                sampling_ratio, strides, finest_scale)


def _signature(lib):
    fn = lib.mcg_roi_align_fpn_fwd
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p] * 4 + [i] * 8 + [f] * 4 + [i, i] + [p, p, p]
                   + [i] * 5 + [f, i, i, p])
    fn.restype = ctypes.c_int
    return fn


def launch_roi_align_fpn(feats, rois, frame_idx=None, out_size=7,
                         sampling_ratio=2, strides=(4, 8, 16, 32),
                         finest_scale=56.0) -> torch.Tensor:
    """The kernel alone: CUDA tensors only, checked, launched on the
    current stream; no synchronisation."""
    global launch_count
    feats = list(feats)
    num_levels = len(feats)
    if not 1 <= num_levels <= _MAX_LEVELS or len(strides) != num_levels:
        raise ValueError(f'roi_align_fpn kernel: {num_levels} levels with '
                         f'strides {strides}; it takes 1..{_MAX_LEVELS} '
                         'levels, one stride each')
    if not (1 <= out_size <= _MAX_OUT and 1 <= sampling_ratio <= _MAX_SAMPLING):
        raise ValueError(f'roi_align_fpn kernel: out_size {out_size} '
                         f'(max {_MAX_OUT}), sampling_ratio {sampling_ratio} '
                         f'(max {_MAX_SAMPLING})')
    tensors = feats + [rois] + ([] if frame_idx is None else [frame_idx])
    for t in tensors:
        if not t.is_cuda:
            raise RuntimeError(f'roi_align_fpn kernel: a {t.device} tensor '
                               'given; the kernel runs on a CUDA device only')
        if t.device != rois.device:
            raise ValueError('roi_align_fpn kernel: inputs on several devices')
        if not t.is_contiguous():
            raise ValueError(f'roi_align_fpn kernel: non-contiguous input '
                             f'{tuple(t.shape)} stride {t.stride()}')
        if t.requires_grad:
            raise NotImplementedError(
                'roi_align_fpn kernel is inference only: its backward '
                '(TPU roi_align_fpn_pallas_bwd) is ported with the training '
                'slice (ROADMAP Queue 2, K3)')
    dtype = feats[0].dtype
    if dtype not in _DTYPES or any(f.dtype != dtype for f in feats):
        raise TypeError(f'roi_align_fpn kernel: feats dtypes '
                        f'{[f.dtype for f in feats]}; it takes float32 or '
                        'bfloat16, the same on every level')
    if rois.dtype != torch.float32:
        raise TypeError(f'roi_align_fpn kernel: rois {rois.dtype}, '
                        'needs float32')
    if any(f.dim() != 4 for f in feats):
        raise ValueError('roi_align_fpn kernel: feats must be (U, H, W, C)')
    u, c = feats[0].shape[0], feats[0].shape[3]
    if any(f.shape[0] != u or f.shape[3] != c for f in feats):
        raise ValueError(f'roi_align_fpn kernel: levels disagree on frames '
                         f'or channels: {[tuple(f.shape) for f in feats]}')
    if rois.dim() != 3 or rois.shape[2] != 4:
        raise ValueError(f'roi_align_fpn kernel: rois {tuple(rois.shape)}, '
                         'needs (N, R, 4)')
    n, r = rois.shape[:2]
    if frame_idx is None:
        if u != n:
            raise ValueError(f'roi_align_fpn kernel: {u} frames for {n} '
                             'slots and no frame_idx')
    elif frame_idx.dtype != torch.int32 or tuple(frame_idx.shape) != (n,):
        raise TypeError(f'roi_align_fpn kernel: frame_idx '
                        f'{frame_idx.dtype} {tuple(frame_idx.shape)}, needs '
                        f'int32 ({n},)')
    if n * r * out_size >= 2 ** 31:
        raise ValueError('roi_align_fpn kernel: grid too large')

    out = torch.empty((n, r, out_size, out_size, c), dtype=dtype,
                      device=rois.device)
    per_load = 16 // feats[0].element_size()
    vec = per_load if (c % per_load == 0 and all(
        t.data_ptr() % 16 == 0 for t in feats + [out])) else 1

    lib = _native.load('roi_align_fpn')
    fn = _signature(lib)
    pad = _MAX_LEVELS - num_levels
    ptrs = [f.data_ptr() for f in feats] + [None] * pad
    hw = []
    for f in feats:
        hw += [f.shape[1], f.shape[2]]
    hw += [0, 0] * pad
    strides_f = [float(s) for s in strides] + [1.0] * pad
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        err = fn(*ptrs, *hw, *strides_f, num_levels, u, rois.data_ptr(),
                 None if frame_idx is None else frame_idx.data_ptr(),
                 out.data_ptr(), n, r, c, _DTYPES[dtype], vec,
                 float(finest_scale), out_size, sampling_ratio, stream)
    _native.check(lib, err, 'roi_align_fpn kernel launch')
    launch_count += 1
    return out
