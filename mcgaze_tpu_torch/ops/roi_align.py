"""FPN RoIAlign in plain PyTorch: the reference formulation of the CUDA
kernel (ops/roi_align_cuda.py) and the path a CPU tensor takes.

Counterpart of mcgaze_tpu/ops/roi_align.py (roi_levels, roi_align_fpn_mm),
with the optional slot -> frame map of the fused kernel. Semantics are
mmcv RoIAlign(aligned=True) with SingleRoIExtractor level routing:
  * level: floor(log2(sqrt(area) / finest_scale + 1e-6)) clipped to
    [0, L-1], as power-of-two comparisons on the clipped signed area;
  * coords: x / stride - 0.5, bin = (x2' - x1') / out_size;
  * samples: sampling_ratio^2 per bin at (j + (k + 0.5) / s) * bin, a
    sample is valid iff its coordinate is in [-1, size];
  * bilinear corners clamped with the degenerate-edge rule (lo = floor,
    hi = lo + 1 capped at size - 1, weight 0 on hi once lo >= size - 1).

The bilinear weights are separable, so each level is two contractions
Ay (7, H) . F (H, W, C) . Ax^T (W, 7), with the intermediate rounded to the
feature dtype between them, as the JAX formulation does.
"""
from __future__ import annotations

import torch


def roi_levels(rois: torch.Tensor, num_levels: int = 4,
               finest_scale: float = 56.0) -> torch.Tensor:
    """(..., 4) absolute xyxy boxes -> (...,) int64 FPN level."""
    area = ((rois[..., 2] - rois[..., 0]) *
            (rois[..., 3] - rois[..., 1])).clamp_min(0.0)
    v = torch.sqrt(area) / finest_scale + 1e-6
    lvl = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    for level in range(1, num_levels):
        lvl += (v >= 2.0 ** level).to(torch.int64)
    return lvl


def _axis_weights(coord: torch.Tensor, size: int,
                  sampling_ratio: int) -> torch.Tensor:
    """coord (N, R, out*s) sample positions on one axis -> (N, R, out,
    size) bilinear rows with the mean over the s sub-samples folded in."""
    valid = (coord >= -1.0) & (coord <= size)
    vc = coord.clamp_min(0.0)
    lo = torch.floor(vc)
    degenerate = lo >= size - 1
    lo = lo.clamp_max(size - 1)
    hi = (lo + 1.0).clamp_max(size - 1)
    frac = torch.where(degenerate, torch.zeros_like(vc), vc - lo)
    iota = torch.arange(size, dtype=torch.float32, device=coord.device)
    w = ((iota == lo[..., None]) * (1.0 - frac)[..., None] +
         (iota == hi[..., None]) * frac[..., None])
    w = w * valid[..., None]
    n, r, k = coord.shape
    return w.reshape(n, r, k // sampling_ratio, sampling_ratio,
                     size).mean(3)


def _level_weights(rois_f, stride, h_l, w_l, out_size, s, dtype):
    """The separable bilinear rows of every RoI on one level, rounded to
    the feature dtype: (Ay (N, R, out, H), Ax (N, R, out, W))."""
    pos = (torch.arange(out_size, dtype=torch.float32,
                        device=rois_f.device)[:, None]
           + (torch.arange(s, dtype=torch.float32,
                           device=rois_f.device)[None, :] + 0.5) / s
           ).reshape(-1)
    x1 = rois_f[..., 0] / stride - 0.5
    y1 = rois_f[..., 1] / stride - 0.5
    x2 = rois_f[..., 2] / stride - 0.5
    y2 = rois_f[..., 3] / stride - 0.5
    ys = y1[..., None] + pos * ((y2 - y1) / out_size)[..., None]
    xs = x1[..., None] + pos * ((x2 - x1) / out_size)[..., None]
    return (_axis_weights(ys, h_l, s).to(dtype),
            _axis_weights(xs, w_l, s).to(dtype))


def roi_align_fpn_mm(feats, rois: torch.Tensor,
                     frame_idx: torch.Tensor | None = None,
                     out_size: int = 7, sampling_ratio: int = 2,
                     strides=(4, 8, 16, 32),
                     finest_scale: float = 56.0) -> torch.Tensor:
    """feats: L tensors (U, H_l, W_l, C), NHWC; rois: (N, R, 4) xyxy f32;
    frame_idx: optional (N,) slot -> frame map (U == N and the identity
    when omitted). Returns (N, R, out_size, out_size, C) in feats' dtype.

    Every level is computed for every RoI and the routed one is selected,
    as in the JAX formulation; this is the plain version, not a fast one.
    """
    dtype = feats[0].dtype
    lvl = roi_levels(rois, len(feats), finest_scale)
    rois_f = rois.to(torch.float32)
    out = None
    for li, stride in enumerate(strides):
        f = feats[li] if frame_idx is None else feats[li][frame_idx.long()]
        h_l, w_l = f.shape[1:3]
        ay, ax = _level_weights(rois_f, stride, h_l, w_l, out_size,
                                sampling_ratio, dtype)
        tmp = torch.einsum('nrih,nhwc->nriwc', ay.float(),
                           f.float()).to(dtype)
        out_l = torch.einsum('nriwc,nrjw->nrijc', tmp.float(), ax.float())
        routed = (lvl == li)[..., None, None, None]
        out = out_l if out is None else torch.where(routed, out_l, out)
        del tmp, out_l
    return out.to(dtype)


def roi_align_fpn_mm_bwd(g: torch.Tensor, rois: torch.Tensor,
                         frame_idx: torch.Tensor | None, level_shapes,
                         out_size: int = 7, sampling_ratio: int = 2,
                         strides=(4, 8, 16, 32),
                         finest_scale: float = 56.0) -> tuple:
    """The transpose of roi_align_fpn_mm in the features, written out (a
    custom operator's kernel runs without autograd): g (N, R, out, out, C)
    -> one gradient (U, H_l, W_l, C) per level of `level_shapes`, summed in
    f32 and returned in g's dtype. The plain version of the backward
    kernel (roi_align_cuda.launch_roi_align_fpn_bwd)."""
    dtype = g.dtype
    lvl = roi_levels(rois, len(level_shapes), finest_scale)
    rois_f = rois.to(torch.float32)
    grads = []
    for li, (shape, stride) in enumerate(zip(level_shapes, strides)):
        u, h_l, w_l, c = (int(d) for d in shape)
        ay, ax = _level_weights(rois_f, stride, h_l, w_l, out_size,
                                sampling_ratio, dtype)
        gl = g.float() * (lvl == li)[..., None, None, None]
        tmp = torch.einsum('nrijc,nrjw->nriwc', gl, ax.float())
        per_slot = torch.einsum('nrih,nriwc->nhwc', ay.float(), tmp)
        if frame_idx is None:
            grad = per_slot
        else:
            grad = per_slot.new_zeros((u, h_l, w_l, c)).index_add_(
                0, frame_idx.long(), per_slot)
        grads.append(grad.to(dtype))
    return tuple(grads)
