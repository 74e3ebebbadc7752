"""Least device time of K1 and K3 (csrc/roi_align_fpn{,_bwd}.cu, the ports
of mcgaze_tpu/ops/roi_align_pallas.py's forward and backward), K4
(csrc/stqi_attention.cu, the port of
mcgaze_tpu/ops/stqi_attention.py::fused_stqi_attention) and K5
(csrc/fused_bottleneck.cu, the port of
mcgaze_tpu/ops/fused_bottleneck.py::fused_bottleneck_chain) on one H100
SXM, worked out from the gaze model's shapes:

    python -m mcgaze_tpu_torch.tools.kernel_bounds

Prints one JSON object: for eval (32 clips, 131 unique frames, bf16) and
train (32 clips = 224 frames, f32) the bound of K4 per stage and of K5 per
ResNet-50 stage chain, with the launches each forward makes. chip_smoke.py
computes the bounds of the shapes it runs with the same functions, and
utils/profiling.py::cost_analysis counts the kernels' operators with them.
K1's and K3's work depends on the boxes (their level, the samples inside
the image): `roi_work` and `roi_bwd_work` count it on given inputs.

Bound = max(bytes / 3.35 TB/s, flops / peak), each input read once and
each output written once (the chain's intermediates do not count: an
ideal kernel keeps them on chip). K5's per-launch floor
(`k5_launch_floor`) is that bound taken launch by launch, as the kernel
runs: each convolution's input, output and identity through device
memory. The peak is that of the type the kernel
computes in (NVIDIA's data sheet, dense, at 700 W): K4 computes in f32
outside the tensor cores on both paths (the head casts its query to f32),
67 TFLOP/s; K5 in bf16 on the tensor cores, 989 TFLOP/s, or in f32 as
three TF32 passes on the tensor cores (3xTF32), 495 / 3 = 165 TFLOP/s of
f32 products (PEAKS['float32_3xtf32'], K5_PEAK). K5's functions take
`peak=`, a key of PEAKS: peak='float32' gives the bound of the FMA body
K5's f32 path ran on before it (67 TFLOP/s). No card is used.
"""
import json

import numpy as np

from ..models.resnet import RESNET_SPECS

HBM_BYTES_PER_S = 3.35e12
PEAKS = dict(bfloat16=989e12, float32=67e12, float32_3xtf32=495e12 / 3)
# the peak K5 runs each dtype at
K5_PEAK = dict(bfloat16='bfloat16', float32='float32_3xtf32')
ITEMSIZE = dict(bfloat16=2, float32=4)


def _axis(start, end, size, out, s):
    """Sample geometry on one axis, as the kernel computes it:
    (lo, hi, valid) of shape (..., out*s)."""
    pos = (np.arange(out, dtype=np.float32)[:, None]
           + (np.arange(s, dtype=np.float32) + 0.5) / s).reshape(-1)
    bin_ = (end - start) / np.float32(out)
    v = start[..., None] + pos * bin_[..., None]
    valid = (v >= -1.0) & (v <= size)
    lo = np.minimum(np.floor(np.maximum(v, 0.0)), size - 1).astype(np.int64)
    hi = np.minimum(lo + 1, size - 1)
    return lo, hi, valid


def roi_touch(rois, frame_idx, sizes, strides, out=7, s=2, finest=56.0):
    """(pyramid cells the routed samples touch, valid samples) of the
    RoIAlign on these inputs (numpy rois (N, R, 4), frame_idx (N,) or
    None, sizes [(H_l, W_l)]), counted as the kernels route and sample."""
    n, r = rois.shape[:2]
    fidx = np.arange(n) if frame_idx is None else frame_idx
    area = np.maximum((rois[..., 2] - rois[..., 0]) *
                      (rois[..., 3] - rois[..., 1]), 0.0)
    v = np.sqrt(area) / np.float32(finest) + np.float32(1e-6)
    lvl = sum((v >= 2.0 ** k).astype(np.int64) for k in range(1, len(sizes)))
    cells = 0
    valid_samples = 0
    for li, ((h, w), stride) in enumerate(zip(sizes, strides)):
        m = lvl == li
        if not m.any():
            continue
        b = rois[m].astype(np.float32)
        frames = np.broadcast_to(fidx[:, None], (n, r))[m]
        ylo, yhi, yv = _axis(b[:, 1] / stride - 0.5, b[:, 3] / stride - 0.5,
                             h, out, s)
        xlo, xhi, xv = _axis(b[:, 0] / stride - 0.5, b[:, 2] / stride - 0.5,
                             w, out, s)
        valid_samples += int((yv.sum(1) * xv.sum(1)).sum())
        mask = np.zeros((int(fidx.max()) + 1, h, w), bool)
        for yy in (ylo, yhi):
            for xx in (xlo, xhi):
                ok = yv[:, :, None] & xv[:, None, :]
                f3 = np.broadcast_to(frames[:, None, None], ok.shape)
                mask[f3[ok], np.broadcast_to(yy[:, :, None], ok.shape)[ok],
                     np.broadcast_to(xx[:, None, :], ok.shape)[ok]] = True
        cells += int(mask.sum())
    return cells, valid_samples


def roi_work(rois, frame_idx, sizes, strides, c, itemsize, out=7, s=2,
             finest=56.0):
    """(bytes, flops) the RoIAlign forward needs on these inputs: each
    routed pyramid cell read once, the output written once, the boxes and
    map read once; 8 flops per channel per valid (sample, corner)
    weight-multiply-add."""
    n, r = rois.shape[:2]
    cells, valid_samples = roi_touch(rois, frame_idx, sizes, strides, out,
                                     s, finest)
    nbytes = (cells * c * itemsize + n * r * out * out * c * itemsize
              + rois.nbytes + (0 if frame_idx is None else frame_idx.nbytes))
    return nbytes, valid_samples * 4 * 2 * c


def roi_bwd_work(rois, frame_idx, sizes, strides, c, itemsize, frames,
                 out=7, s=2, finest=56.0):
    """(bytes, flops) of its transpose: the dense gradient (every cell of
    `frames` pyramids) written once in its dtype, g, the boxes and the map
    read once; the same 8 flops per channel per valid (sample, corner)."""
    n, r = rois.shape[:2]
    _, valid_samples = roi_touch(rois, frame_idx, sizes, strides, out, s,
                                 finest)
    dense = frames * sum(h * w for h, w in sizes) * c * itemsize
    nbytes = (dense + n * r * out * out * c * itemsize + rois.nbytes
              + (0 if frame_idx is None else frame_idx.nbytes))
    return nbytes, valid_samples * 4 * 2 * c


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes=nbytes, flops=flops,
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def k4_bound(clips, t=7, q=3, c=256):
    """One launch per stage over (clips*T*Q, C) f32 tokens: per pass (over
    the Q clues of a frame, then the T frames of a clue) the packed qkv
    projection, the logits and values over the pass's sequence, the out
    projection, the residual and a LayerNorm."""
    tokens = clips * t * q
    flops = sum(2 * tokens * c * 3 * c + 2 * tokens * c * c
                + 4 * tokens * seq * c + 8 * tokens * c for seq in (q, t))
    weights = c * 3 * c + 3 * c + c * c + 3 * c
    nbytes = 2 * tokens * c * 4 + weights * 4
    return bound(nbytes, flops, PEAKS['float32'])


def chains(depth=50, image=224):
    """The stride-1 chain of each ResNet stage as the fused backbone runs
    it: layer1 from block 0 (with its downsample), the others after their
    stride-2 lead-in. [dict(stage, size, cin, mid, blocks, down)]."""
    out = []
    size, mid = image // 4, 64
    for stage, n_blocks in enumerate(RESNET_SPECS[depth]):
        first = 0 if stage == 0 else 1
        if n_blocks > first:
            out.append(dict(stage=stage + 1, size=size,
                            cin=64 if stage == 0 else 4 * mid, mid=mid,
                            blocks=n_blocks - first, down=stage == 0))
        size //= 2
        mid *= 2
    return out


def k5_convs(chain):
    """The chain's convolutions in launch order: (cin, cout, ksize,
    adds the identity)."""
    cin, mid = chain['cin'], chain['mid']
    cout = 4 * mid
    convs = []
    for b in range(chain['blocks']):
        convs += [(cin, mid, 1, False), (mid, mid, 3, False)]
        if b == 0 and chain['down']:
            convs.append((cin, cout, 1, False))
        convs.append((mid, cout, 1, True))
        cin = cout
    return convs


def k5_launches(chain) -> int:
    """The kernel's launches for one chain: one per convolution."""
    return len(k5_convs(chain))


def k5_bound(frames, chain, dtype, peak=None):
    """One stage chain over `frames` frames of chain['size'] squared
    pixels (k5_pixels_bound)."""
    return k5_pixels_bound(frames * chain['size'] ** 2, chain, dtype, peak)


def k5_pixels_bound(pixels, chain, dtype, peak=None):
    """One stage chain over `pixels` rows: x read once, the output written
    once, the folded weights (A's in the dtype, f32 biases) read once; 2
    flops per multiply-add of its convolutions, at PEAKS[peak] (default
    K5_PEAK[dtype])."""
    itemsize = ITEMSIZE[dtype]
    convs = k5_convs(chain)
    macs = sum(k * k * ci * co for ci, co, k, _ in convs)
    w_bytes = sum(k * k * ci * co * itemsize + co * 4
                  for ci, co, k, _ in convs)
    nbytes = pixels * (chain['cin'] + 4 * chain['mid']) * itemsize + w_bytes
    return dict(bound(nbytes, 2 * macs * pixels,
                      PEAKS[peak or K5_PEAK[dtype]]),
                launches=len(convs))


def k5_conv_bound(pixels, cin, cout, ksize, identity, dtype, peak=None):
    """One launch as the kernel runs it: its input, its folded weights and
    bias and (with `identity`) the identity read once, its output written
    once, over `pixels` rows."""
    itemsize = ITEMSIZE[dtype]
    k = ksize * ksize * cin
    nbytes = (pixels * (cin + cout * (2 if identity else 1)) * itemsize
              + k * cout * itemsize + cout * 4)
    return bound(nbytes, 2 * pixels * k * cout, PEAKS[peak or K5_PEAK[dtype]])


def k5_launch_floor(frames, chain, dtype, peak=None):
    """The least time of the chain as the kernel runs it, one launch per
    convolution (k5_conv_bound summed): y1, y2 and the identity go through
    device memory, which k5_bound leaves out."""
    pixels = frames * chain['size'] ** 2
    per_launch = [k5_conv_bound(pixels, *conv, dtype, peak)
                  for conv in k5_convs(chain)]
    return dict(floor_ms=sum(b['bound_ms'] for b in per_launch),
                bytes=sum(b['bytes'] for b in per_launch),
                flops=sum(b['flops'] for b in per_launch),
                launches=len(per_launch),
                bytes_bound_launches=sum(b['bound_by'] == 'bytes'
                                         for b in per_launch))


def path_bounds(frames, clips, dtype, stages=4, depth=50):
    """K4 and K5 of one forward: K4 per stage, K5 per chain (with its
    per-launch floor) and summed."""
    per_chain = {f"layer{ch['stage']}": dict(
        k5_bound(frames, ch, dtype),
        launch_floor_ms=k5_launch_floor(frames, ch, dtype)['floor_ms'])
        for ch in chains(depth)}
    total = dict(bound_ms=sum(v['bound_ms'] for v in per_chain.values()),
                 launch_floor_ms=sum(v['launch_floor_ms']
                                     for v in per_chain.values()),
                 flops=sum(v['flops'] for v in per_chain.values()),
                 bytes=sum(v['bytes'] for v in per_chain.values()),
                 launches=sum(v['launches'] for v in per_chain.values()))
    return dict(frames=frames, clips=clips, dtype=dtype,
                K4=dict(k4_bound(clips), launches=stages),
                K5=dict(total=total, **per_chain))


def gaze_bounds(clips=32):
    """Eval: 32 clips -> 224 slots, 131 unique frames, bf16. Train: 32
    clips = 224 frames, f32."""
    return dict(eval=path_bounds(131, clips, 'bfloat16'),
                eval_f32=path_bounds(131, clips, 'float32'),
                train=path_bounds(224, clips, 'float32'),
                K4_one_clip=k4_bound(1))


if __name__ == '__main__':
    print(json.dumps(gaze_bounds(), indent=1))
