"""The least work of the port's hand-written kernels, frozen from
mcgaze_tpu_torch/tools/kernel_bounds.py at commit 8553edb (`roi_touch`,
`roi_work`, `roi_bwd_work`, `k4_bound`, `chains`, `k5_convs`,
`k5_pixels_bound`), so that a later change to the program cannot move the
yardstick:

  K1  RoIAlign forward: each routed pyramid cell read once, the output
      written once, the boxes and map read once; 8 flops per channel per
      valid (sample, corner).
  K3  its transpose: the dense gradient written once, g, boxes and map
      read once; the same flops.
  K4  one stage's two attention passes and their LayerNorms over (tokens,
      C) f32 rows.
  K5  a stride-1 ResNet chain over its pixels: x read once, the output
      written once, the folded weights read once, 2 flops a multiply-add.

The bound of a launch is max(bytes / 3.35 TB/s, flops / peak), the peak
being the tensor-core rate of the kernel's input dtype (H100 SXM data
sheet, dense: bf16 989, TF32 495 TFLOP/s). Any implementation of the same
work, on the tensor cores or off them, takes at least that long, so a
kernel's share of it cannot pass 100%. No card is used.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = dict(bfloat16=989e12, float32=495e12)
ITEMSIZE = dict(bfloat16=2, float32=4)


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """Seconds of the least time of `nbytes` and `flops` on one H100."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def _axis(start, end, size, out, s):
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
    RoIAlign on numpy rois (N, R, 4), frame_idx (N,) or None and level
    sizes [(H_l, W_l)]."""
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
    """(bytes, flops) of the RoIAlign forward on these inputs."""
    n, r = rois.shape[:2]
    cells, valid_samples = roi_touch(rois, frame_idx, sizes, strides, out,
                                     s, finest)
    nbytes = (cells * c * itemsize + n * r * out * out * c * itemsize
              + rois.nbytes + (0 if frame_idx is None else frame_idx.nbytes))
    return nbytes, valid_samples * 4 * 2 * c


def roi_bwd_work(rois, frame_idx, sizes, strides, c, itemsize, frames,
                 out=7, s=2, finest=56.0):
    """(bytes, flops) of its transpose over `frames` pyramids."""
    n, r = rois.shape[:2]
    _, valid_samples = roi_touch(rois, frame_idx, sizes, strides, out, s,
                                 finest)
    dense = frames * sum(h * w for h, w in sizes) * c * itemsize
    nbytes = (dense + n * r * out * out * c * itemsize + rois.nbytes
              + (0 if frame_idx is None else frame_idx.nbytes))
    return nbytes, valid_samples * 4 * 2 * c


def k4_work(clips, t=7, q=3, c=256):
    """(bytes, flops) of one K4 launch over clips * t * q f32 tokens."""
    tokens = clips * t * q
    flops = sum(2 * tokens * c * 3 * c + 2 * tokens * c * c
                + 4 * tokens * seq * c + 8 * tokens * c for seq in (q, t))
    weights = c * 3 * c + 3 * c + c * c + 3 * c
    return 2 * tokens * c * 4 + weights * 4, flops


def k5_convs(cin, mid, blocks, down):
    """A stride-1 chain's convolutions in launch order: (cin, cout, ksize,
    adds the identity)."""
    cout = 4 * mid
    convs = []
    for b in range(blocks):
        convs += [(cin, mid, 1, False), (mid, mid, 3, False)]
        if b == 0 and down:
            convs.append((cin, cout, 1, False))
        convs.append((mid, cout, 1, True))
        cin = cout
    return convs


def k5_work(pixels, cin, mid, blocks, down, itemsize):
    """(bytes, flops, launches) of one chain over `pixels` rows."""
    convs = k5_convs(cin, mid, blocks, down)
    macs = sum(k * k * ci * co for ci, co, k, _ in convs)
    w_bytes = sum(k * k * ci * co * itemsize + co * 4
                  for ci, co, k, _ in convs)
    nbytes = pixels * (cin + 4 * mid) * itemsize + w_bytes
    return nbytes, 2 * macs * pixels, len(convs)
