"""The work of each kernel launch of a call, from the arguments of the
program's `mcgaze::` operators.

Called eagerly, the port launches its kernels bare; inside
`mcgaze_tpu_torch.ops.routing.through_operators()` each launch goes through
its torch.library operator (mcgaze::roi_align_fpn, ::roi_align_fpn_bwd,
::stqi_attention, ::fused_bottleneck_chain), where a dispatch mode sees its
inputs. `Capture` prices each launch with the frozen formulas of
counts/kernels.py; nothing of the program's own counting is read.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .counts import kernels as K

DTYPES = {torch.float32: 'float32', torch.bfloat16: 'bfloat16'}


def _roi_inputs(rois, frame_idx):
    fidx = None if frame_idx is None else \
        frame_idx.detach().cpu().numpy().astype('int32')
    return rois.detach().float().cpu().numpy(), fidx


def _k1(feats, rois, frame_idx, out_size, sampling_ratio, strides,
        finest_scale):
    dtype = DTYPES[feats[0].dtype]
    r, f = _roi_inputs(rois, frame_idx)
    nbytes, flops = K.roi_work(r, f, [tuple(x.shape[1:3]) for x in feats],
                               strides, feats[0].shape[-1], K.ITEMSIZE[dtype],
                               out_size, sampling_ratio, finest_scale)
    return [('k1', nbytes, flops, dtype)]


def _k3(g, rois, frame_idx, level_shapes, out_size, sampling_ratio, strides,
        finest_scale):
    dtype = DTYPES[g.dtype]
    shapes = [level_shapes[i:i + 4] for i in range(0, len(level_shapes), 4)]
    r, f = _roi_inputs(rois, frame_idx)
    nbytes, flops = K.roi_bwd_work(r, f, [(s[1], s[2]) for s in shapes],
                                   strides, shapes[0][3], K.ITEMSIZE[dtype],
                                   shapes[0][0], out_size, sampling_ratio,
                                   finest_scale)
    return [('k3', nbytes, flops, dtype)]


def _k4(query, wqkv, bqkv, wout, bout, ln_scale, ln_bias, clip_length,
        heads):
    n, q, c = query.shape
    nbytes, flops = K.k4_work(n // clip_length, clip_length, q, c)
    return [('k4', nbytes, flops, DTYPES[query.dtype])]


def _k5(x, weights, h, w):
    """One record per launch of the chain: its work spread evenly over its
    launches (a roofline sums them)."""
    dtype = DTYPES[x.dtype]
    has_down = len(weights) % 6 == 2
    blocks = len(weights) // 6
    cin, mid = weights[0].shape[0], weights[0].shape[1]
    nbytes, flops, launches = K.k5_work(x.shape[0] * h * w, cin, mid, blocks,
                                        has_down, K.ITEMSIZE[dtype])
    return [('k5', nbytes / launches, flops / launches, dtype)] * launches


class Capture(TorchDispatchMode):
    """Records [(kernel, bytes, flops, dtype)] a launch, in launch order,
    of the operators called inside it and through_operators()."""

    def __init__(self):
        super().__init__()
        ops = torch.ops.mcgaze
        self.work = {ops.roi_align_fpn: _k1, ops.roi_align_fpn_bwd: _k3,
                     ops.stqi_attention: _k4,
                     ops.fused_bottleneck_chain: _k5}
        self.launches = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        work = self.work.get(func.overloadpacket)
        if work is not None:
            self.launches += work(*args, **kwargs)
        return func(*args, **kwargs)


def capture(fn) -> list:
    """Run fn() once with the kernels through their operators; the
    launches' work."""
    from mcgaze_tpu_torch.ops.routing import through_operators
    with through_operators(), Capture() as cap:
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return cap.launches
