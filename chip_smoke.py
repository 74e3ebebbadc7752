#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcgaze_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  env     the card (nvidia-smi name and power limit), torch and CUDA versions
  build   nvcc builds every kernel of mcgaze_tpu_torch/csrc, one process
          per source, all started together
  kernel  the FPN RoIAlign kernel against its plain PyTorch version on the
          card: f32 and bf16, identity and frame_idx forms, at the gaze
          eval shape (224 px, 32 clips: 131 unique frames, 224 slots, 3
          RoIs, C=256) with boxes that mix levels, run off the image, and
          include an inverted and a zero-area box; and R=100 at 384x640.
          Max abs error against the stated tolerance, kernel and plain ms
          (CUDA events, L2 flushed before each launch), the bound and the
          kernel's share of it
  kernel_bwd  the RoIAlign backward kernel (K3) against the plain
          version's autograd gradient, and the adjoint identity
          <K1(F), G> = sum_l <F_l, K3(G)_l> in f64 sums at G = K1(F),
          relative to |K1(F)|^2: f32 and bf16,
          identity and frame_idx forms, at the gaze training shape (224
          frames at 224 px, 3 RoIs, C=256) and R=100 at 384x640; in every
          case two launches bitwise equal, a launch handed NaN-filled
          memory finite with the cells no RoI reaches exactly 0, and its
          peak extra device memory at most 1.1x its output; error and
          tolerance, kernel and plain ms, the bound
  slice   the full-width model (R50, C=256, FFN 2048, 4 stages, 224 px,
          seeded random weights) through VideoGazeEvaluator.run_video on a
          fabricated 60-frame u8 video, in f32 and bf16, with the kernel
          launch counter reset before and read after; finite results, unit
          gazes; fwd_dedup == fwd and kernel == plain RoIAlign end to end
          with TF32 off; then fwd_dedup timed at 32 clips in bf16
  profile torch.profiler over the timed forward: device time by kernel
          (K1 must be listed); K1's device time per launch beside the
          bound of the launches the forward makes (their inputs recorded
          in one forward), counted only where the profiler recorded every
          launch and the time is not below the bound
  train   the shipped gaze360 config (R50, 4 stages, 32 clips = 224 frames
          at 224 px, f32, its OptimConfig), seeded random weights and
          synthetic batches, through mcgaze_tpu_torch.tools.train.main for
          3 steps with both launch counters reset before and read after
          (4 K1 and 4 K3 launches per step); finite losses, frozen stem and
          layer1, moving layer2 and heads; one step at 2 clips with the
          kernels against roi_impl='mm' (f32, TF32 off): every log key
          and gradient; then ms per step (median of 6, card defaults),
          clips/s and peak memory
  train_profile  torch.profiler over a train step: device time by kernel,
          idle share, K1 and K3 ms per step
  kernel_k4  the fused STQI attention kernel (K4) against its plain
          version at the eval shape (32 clips x 7 frames x 3 clues, C=256,
          8 heads, f32), at one clip, and at 3 heads of 32 channels: error
          and tolerance, kernel and plain ms, the bound, the cluster size
          and CTA count; permuting the other clips leaves clip 0 as it
          was
  kernel_k5  the fused bottleneck chain kernel (K5) against its plain
          version for each ResNet-50 stage chain at the eval shape (131
          frames at 224 px), bf16 and f32, on the full-width seeded model's
          folded weights and the activations its plain backbone feeds each
          chain: error and tolerance, kernel, plain and plain-Bottleneck
          ms, the bound, the per-launch floor, TFLOP/s and share of the
          peak, and the library's ms (one cuDNN F.conv2d per convolution,
          summed); and the autograd Function's gradients of x and of
          every conv and BN parameter against autograd of the plain version
  slice_fused  ModelConfig(backbone_impl='fused', fused_attention=True) at
          full width through VideoGazeEvaluator.run_video, f32 and bf16,
          with the K1, K3, K4 and K5 counters reset before and read after
          (4 K1, 4 K4 and 40 K5 launches per forward, no K3); finite
          results, unit gazes; one chunk in f32 with TF32 off against the
          plain model on the same weights and fwd_dedup == fwd; the same
          chunk in bf16, fused and plain, each against the plain f32
          forward (the fused error within twice the plain one plus
          TOL_E2E); then fwd_dedup timed at 32 clips in bf16
  profile_fused  torch.profiler over that forward: idle share, K1, K4 and
          K5 ms per forward (a kernel the profiler does not list fails)
  train_fused  one train step at 2 clips with backbone_impl='fused', f32,
          TF32 off, against the plain backbone: every log key; K5 launches
          in the forwards, its backward recomputes the plain version; the
          fused backbone's f32 gradients against the plain float64 ones,
          within twice cuDNN's own f32 error plus TOL_E2E
Then the `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.

Exits with code 2 and prints nothing on stdout without a CUDA card.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = os.path.join(ROOT, 'configs', 'multiclue_gaze',
                            'multiclue_gaze_r50_gaze360.py')
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
# kernel vs plain, f32: each side rounds up to ~16 partial sums bounded by
# the largest feature it reads, so the tolerance scales with max|feats|
TOL_F32_REL = 1e-5
TOL_BF16_REL = 2e-2            # bf16: the plain version rounds its weights
#                                and intermediate to bf16, the kernel does not
# K3 against the plain version's autograd gradient: the same two
# tolerances, scaled by the largest |gradient|; in f32 the kernel adds a
# cell's terms in another (fixed) order, in bf16 the plain gradient rounds
# its intermediate to bf16 and the kernel only its output.
# The adjoint identity at G = K1(F): |<K1(F), K1(F)> - <F, K3(K1(F))>|
# relative to |K1(F)|^2, which a K3 that returned zeros reads as 1 and one
# that lost 1 term in 1e3 as ~1e-3. Sound kernels read f32 rounding, or in
# bf16 the unbiased 2^-9 rounding of each output element, which averages
# out over the ~1e7 elements.
TOL_ADJ_F32 = 1e-5
TOL_ADJ_BF16 = 1e-4
# end to end, f32, TF32 off: the model parity tolerance. It also bounds
# fwd_dedup against fwd: cuDNN picks other conv algorithms for 35 and 56
# frames, so the pyramids differ in their last bits, which four stages grow
TOL_E2E = 1e-3
# K4 against its plain version, f32: absolute, as LN outputs are O(1)
TOL_K4 = 2e-5
# K5 against its plain version, f32: relative to max|plain| (K up to 2,304
# summed in another order through up to 5 blocks); bf16 uses TOL_BF16_REL
TOL_K5_F32_REL = 1e-4


def emit(phase, **kw):
    print(json.dumps({'phase': phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def nvidia_smi():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

class Timer:
    """Median device ms of fn over reps, with the L2 cache flushed (a 256 MB
    write) before each launch, as the main path finds it cold."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps=20):
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# ------------------------------------------------------- roi align inputs

def gaze_sel(k=32, t=7, stride=4):
    """The dedup slot -> frame map of k consecutive clips."""
    return np.concatenate([np.arange(i * stride, i * stride + t)
                           for i in range(k)]).astype(np.int32)


def make_pyramid(rng, u, img_hw, c, device, dtype):
    return tuple(torch.from_numpy(rng.randn(u, img_hw[0] // s, img_hw[1] // s,
                                            c).astype(np.float32))
                 .to(device, dtype) for s in (4, 8, 16, 32))


def make_rois(rng, n, r, img_hw):
    """Boxes over all four levels, some running off the image, one
    inverted on both axes (routes by its positive area) and one of zero
    area."""
    h, w = img_hw
    size = rng.choice([24.0, 70.0, 150.0, 300.0, 640.0], (n, r, 1))
    wh = size * rng.uniform(0.6, 1.4, (n, r, 2))
    xy = np.stack([rng.uniform(-0.2 * w, w, (n, r)),
                   rng.uniform(-0.2 * h, h, (n, r))], -1)
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0, 0] = [120.0, 125.0, 10.0, 5.0]
    rois[n - 1, r - 1] = [30.0, 30.0, 30.0, 30.0]
    return rois


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
    RoIAlign on these inputs, counted as the kernels route and sample."""
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


def bound(nbytes, flops, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or F32_FLOPS) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ------------------------------------------------------------------ phases

def phase_kernel(device, timer):
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.ops.roi_align import roi_align_fpn_mm

    rng = np.random.RandomState(0)
    sel = gaze_sel()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for form in ('identity', 'frame_idx'):
            u = len(sel) if form == 'identity' else int(sel.max()) + 1
            cases.append(dict(shape='gaze_eval', img=(224, 224), u=u,
                              n=len(sel), r=3, dtype=dtype,
                              fidx=sel if form == 'frame_idx' else None))
    cases.append(dict(shape='query_r100', img=(384, 640), u=44, n=44, r=100,
                      dtype=torch.bfloat16, fidx=None))
    results = []
    for cs in cases:
        feats = make_pyramid(rng, cs['u'], cs['img'], 256, device,
                             cs['dtype'])
        rois_np = make_rois(rng, cs['n'], cs['r'], cs['img'])
        rois = torch.from_numpy(rois_np).to(device)
        fidx = (None if cs['fidx'] is None
                else torch.from_numpy(cs['fidx']).to(device))
        got = roi_align_cuda.roi_align_fpn(feats, rois, fidx)
        torch.cuda.synchronize()
        ref = roi_align_fpn_mm(feats, rois, fidx)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (TOL_F32_REL * max(1.0, max(f.float().abs().max().item()
                                          for f in feats))
               if cs['dtype'] == torch.float32
               else TOL_BF16_REL * max(1.0, scale))
        check(bool(torch.isfinite(got).all()), f'non-finite kernel output '
              f'{cs["shape"]}')
        check(err <= tol, f'kernel disagrees with plain: {cs["shape"]} '
              f'{cs["dtype"]} form={"frame_idx" if fidx is not None else "identity"} '
              f'err {err} > tol {tol}')
        del ref
        k_ms = timer.ms(lambda: roi_align_cuda.roi_align_fpn(feats, rois,
                                                             fidx))
        p_ms = timer.ms(lambda: roi_align_fpn_mm(feats, rois, fidx), reps=5)
        sizes = [tuple(f.shape[1:3]) for f in feats]
        nbytes, flops = roi_work(rois_np, cs['fidx'], sizes, (4, 8, 16, 32),
                                 256, feats[0].element_size())
        b_ms, b_by = bound(nbytes, flops)
        results.append(dict(
            shape=cs['shape'], dtype=str(cs['dtype']).replace('torch.', ''),
            form='frame_idx' if fidx is not None else 'identity',
            u=cs['u'], n=cs['n'], r=cs['r'], max_abs_err=err, tol=tol,
            out_scale=scale, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, bound_share=b_ms / k_ms, bytes=nbytes,
            flops=flops, library_ms=None))
        del feats, got
        torch.cuda.empty_cache()
    emit('kernel', cases=results)
    return results


def phase_kernel_bwd(device, timer):
    """K3 against the plain version's autograd gradient at a random
    cotangent G, and the adjoint identity <K1(F), G> = sum_l <F_l, K3(G)_l>
    in f64 sums at G = K1(F); two launches bitwise equal; handed memory
    the allocator last filled with NaN, every cell finite and the cells no
    RoI reaches exactly 0; the launch's peak extra device memory at most
    1.1x its output."""
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.ops.roi_align import roi_align_fpn_mm

    rng = np.random.RandomState(2)
    sel = gaze_sel()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for form in ('identity', 'frame_idx'):
            u = len(sel) if form == 'identity' else int(sel.max()) + 1
            cases.append(dict(shape='gaze_train', img=(224, 224), u=u,
                              n=len(sel), r=3, dtype=dtype,
                              fidx=sel if form == 'frame_idx' else None))
        cases.append(dict(shape='query_r100', img=(384, 640), u=44, n=44,
                          r=100, dtype=dtype, fidx=None))
    results = []
    for cs in cases:
        dtype = cs['dtype']
        form = 'frame_idx' if cs['fidx'] is not None else 'identity'
        what = f'{cs["shape"]} {dtype} form={form}'
        feats = make_pyramid(rng, cs['u'], cs['img'], 256, device, dtype)
        rois_np = make_rois(rng, cs['n'], cs['r'], cs['img'])
        rois = torch.from_numpy(rois_np).to(device)
        fidx = (None if cs['fidx'] is None
                else torch.from_numpy(cs['fidx']).to(device))
        shapes = [tuple(f.shape) for f in feats]
        g = torch.from_numpy(rng.randn(cs['n'], cs['r'], 7, 7, 256).astype(
            np.float32)).to(device, dtype)
        out_bytes = sum(f.numel() for f in feats) * feats[0].element_size()
        # the cells no RoI reaches: where the plain f32 gradient of an
        # all-ones cotangent (terms >= 0, nothing cancels) is 0
        leaves32 = tuple(f.detach().float().requires_grad_() for f in feats)
        reach = torch.autograd.grad(roi_align_fpn_mm(leaves32, rois, fidx),
                                    leaves32, torch.ones(g.shape,
                                                         device=device))
        untouched = [b == 0 for b in reach]
        del leaves32, reach
        torch.cuda.synchronize()
        torch.cuda.empty_cache()   # the poisoned block is then the only one
        poison = torch.full((out_bytes // feats[0].element_size(),),
                            float('nan'), dtype=dtype, device=device)
        poisoned = poison.data_ptr()
        del poison
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = roi_align_cuda.launch_roi_align_fpn_bwd(g, rois, fidx, shapes)
        torch.cuda.synchronize()
        check(got[0].data_ptr() == poisoned, f'K3 {what}: the output is not '
              'in the NaN-filled block, the coverage check tests nothing')
        extra = torch.cuda.max_memory_allocated() - before
        check(extra <= 1.1 * out_bytes, f'K3 {what}: {extra} bytes of '
              f'device memory for a {out_bytes}-byte output')
        check(all(bool(torch.isfinite(x).all()) for x in got),
              f'non-finite K3 output {what} (a cell left unwritten)')
        check(all(bool((x[m] == 0).all()) for x, m in zip(got, untouched)),
              f'K3 {what}: a cell no RoI reaches is not 0')
        n_untouched = sum(int(m.sum()) for m in untouched)
        del untouched
        again = roi_align_cuda.launch_roi_align_fpn_bwd(g, rois, fidx,
                                                        shapes)
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        check(all(torch.equal(a.view(bits), b.view(bits))
                  for a, b in zip(got, again)),
              f'K3 {what}: two launches differ')
        del again
        leaves = tuple(f.detach().requires_grad_() for f in feats)
        ref_out = roi_align_fpn_mm(leaves, rois, fidx)
        ref = torch.autograd.grad(ref_out, leaves, g, retain_graph=True)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, ref))
        scale = max(b.float().abs().max().item() for b in ref)
        tol = (TOL_F32_REL if dtype == torch.float32 else TOL_BF16_REL) * scale
        check(err <= tol, f'K3 disagrees with plain autograd: {what} '
              f'err {err} > tol {tol}')
        fwd = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx)
        back = roi_align_cuda.launch_roi_align_fpn_bwd(fwd, rois, fidx,
                                                       shapes)
        lhs = fwd.double().square().sum().item()
        rhs = sum((f.double() * d.double()).sum().item()
                  for f, d in zip(feats, back))
        adj = abs(lhs - rhs) / lhs
        adj_tol = TOL_ADJ_F32 if dtype == torch.float32 else TOL_ADJ_BF16
        check(adj <= adj_tol, f'K3 is not the adjoint of K1: {what}: '
              f'{adj} > {adj_tol}')
        del fwd, back, got
        k_ms = timer.ms(lambda: roi_align_cuda.launch_roi_align_fpn_bwd(
            g, rois, fidx, shapes))
        p_ms = timer.ms(lambda: torch.autograd.grad(
            ref_out, leaves, g, retain_graph=True), reps=5)
        nbytes, flops = roi_bwd_work(
            rois_np, cs['fidx'], [s[1:3] for s in shapes], (4, 8, 16, 32),
            256, feats[0].element_size(), cs['u'])
        b_ms, b_by = bound(nbytes, flops)
        results.append(dict(
            shape=cs['shape'], dtype=str(dtype).replace('torch.', ''),
            form=form, u=cs['u'], n=cs['n'], r=cs['r'], max_abs_err=err,
            tol=tol, grad_scale=scale, adjoint_rel_err=adj,
            adjoint_tol=adj_tol, bitwise_repeat=True,
            nan_prefilled_cells_untouched=n_untouched,
            peak_extra_bytes=extra, out_bytes=out_bytes, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            flops=flops, library_ms=None))
        del feats, leaves, ref_out, ref, g
        torch.cuda.empty_cache()
    emit('kernel_bwd', cases=results)
    return results


def phase_slice(device, timer):
    from mcgaze_tpu_torch import EvalConfig, ModelConfig, VideoGazeEvaluator
    from mcgaze_tpu_torch.evaluation.forward import (bind_forward,
                                                     make_eval_forward)
    from mcgaze_tpu_torch.evaluation.driver import clip_slices
    from mcgaze_tpu_torch.ops import roi_align_cuda

    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, (224, 224, 3), np.uint8)
              for _ in range(60)]
    ecfg = EvalConfig(crop_ratio=None, clip_batch=8, dedup_frames=True)
    n_clips = len(clip_slices(60, ecfg.clip_length, ecfg.stride))
    n_forwards = -(-n_clips // ecfg.clip_batch)

    built = {}
    for dt in ('float32', 'bfloat16'):
        cfg = ModelConfig(dtype=dt)
        model, fwd, fwd_dedup = make_eval_forward(cfg, seed=0,
                                                  device=device)
        built[dt] = (model, fwd, fwd_dedup,
                     bind_forward(fwd, device, fwd_dedup))

    # the main path: launch counts from zero, read right after
    roi_align_cuda.launch_count = 0
    roi_align_cuda.bwd_launch_count = 0
    t0 = time.perf_counter()
    res = {dt: VideoGazeEvaluator(built[dt][3], ecfg).run_video(frames, 0)
           for dt in built}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = roi_align_cuda.launch_count
    cfg = built['float32'][0].cfg
    expected = 2 * n_forwards * cfg.num_stages
    check(launches == expected, f'RoIAlign kernel launched {launches} '
          f'times on the main path, expected {expected} (4 per forward)')
    check(roi_align_cuda.bwd_launch_count == 0, 'the eval path launched '
          'the backward kernel')
    for dt, r in res.items():
        check(len(r['fusion_gazes']) == 60, f'{dt}: '
              f'{len(r["fusion_gazes"])} frames in the result')
        vals = [r['fusion_gazes']] + [
            r[f'{c}_{k}'] for c in ('face', 'eyes', 'head')
            for k in ('gazes', 'score')] + [
            b for c in ('face', 'eyes', 'head') for b in r[f'{c}_bboxes']
            if b is not None]
        check(all(np.isfinite(np.asarray(v, np.float64)).all()
                  for v in vals), f'{dt}: non-finite results')

    # one chunk of the video, f32, TF32 off: dedup == plain clips, and the
    # kernel == the plain RoIAlign end to end
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, fwd, fwd_dedup, _ = built['float32']
    sel = gaze_sel(k=8)
    u8 = torch.from_numpy(np.stack(frames[:int(sel.max()) + 1])).to(device)
    whwh = torch.full((u8.shape[0], 4), 224.0, device=device)
    sel_t = torch.from_numpy(sel).to(device)
    a = fwd_dedup(u8, sel_t, whwh, 7)
    b = fwd(u8[sel_t.long()], whwh[sel_t.long()], 7)
    model.cfg = dataclasses.replace(cfg, roi_impl='mm')
    p = fwd_dedup(u8, sel_t, whwh, 7)
    model.cfg = cfg
    torch.backends.cudnn.allow_tf32 = True

    def err(x, y):
        """Boxes relative to their largest coordinate (x1 = cx - w/2 of a
        box thousands of px wide cancels), scores and gazes absolute."""
        box = ((x[0] - y[0]).abs().max() / y[0].abs().max().clamp_min(1.0))
        return max(box.item(), (x[1] - y[1]).abs().max().item(),
                   *((x[2][k] - y[2][k]).abs().max().item() for k in y[2]))

    dedup_err, plain_err = err(a, b), err(a, p)
    norms = torch.stack([a[2][k].norm(dim=-1) for k in a[2]])
    check((norms - 1).abs().max().item() < 1e-4, 'f32 gazes not unit norm')
    check(dedup_err <= TOL_E2E, f'fwd_dedup != fwd: {dedup_err}')
    check(plain_err <= TOL_E2E, f'kernel vs plain RoIAlign end to end: '
          f'{plain_err}')

    # timing: fwd_dedup at 32 clips, bf16
    model16, _, fwd_dedup16, _ = built['bfloat16']
    sel = gaze_sel(k=32)
    u8 = torch.from_numpy(rng.randint(0, 256, (int(sel.max()) + 1, 224, 224,
                                               3), np.uint8)).to(device)
    whwh = torch.full((u8.shape[0], 4), 224.0, device=device)
    sel_t = torch.from_numpy(sel).to(device)
    out16 = fwd_dedup16(u8, sel_t, whwh, 7)
    norms16 = torch.stack([out16[2][k].norm(dim=-1) for k in out16[2]])
    check(all(bool(torch.isfinite(t).all())
              for t in (out16[0], out16[1], *out16[2].values())),
          'bf16 non-finite')
    check((norms16 - 1).abs().max().item() < 2e-2, 'bf16 gazes not unit')
    def step():
        return fwd_dedup16(u8, sel_t, whwh, 7)

    fwd_ms = timer.ms(step, reps=10)
    emit('slice', frames=60, clips=n_clips, forwards_per_video=n_forwards,
         roi_launches=launches, roi_launches_expected=expected,
         main_path_seconds=main_s, fwd_dedup_vs_fwd_err=dedup_err,
         kernel_vs_plain_e2e_err=plain_err, tol_e2e=TOL_E2E,
         bf16_k32_fwd_ms=fwd_ms,
         bf16_k32_clips_per_s=32 / (fwd_ms / 1e3),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    from mcgaze_tpu_torch.evaluation.forward import device_normalize
    with torch.inference_mode():
        norm = device_normalize(u8, whwh)
        feats = model16.extract_features(norm)
        whwh_s = whwh[sel_t.long()]
    layers = dict(
        backbone_fpn=lambda: model16.extract_features(norm),
        heads=lambda: model16.run_heads(feats, whwh_s, 7, sel_t))
    return launches, step, layers


def phase_train(device):
    """The shipped gaze360 config at full width through the train CLI's
    main(): K1 and K3 four times per step each; finite losses; frozen
    stem and layer1, moving layer2 and heads; one reduced step with the
    kernels against roi_impl='mm' (f32, TF32 off); then ms per step at 32
    clips with the card's defaults, and one profiled step."""
    import copy
    import shutil

    from mcgaze_tpu_torch.models.mcgaze import init_model
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.tools.train import main as train_main
    from mcgaze_tpu_torch.tools.train import synthetic_batches
    from mcgaze_tpu_torch.train import loop
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    cfg = load_config(TRAIN_CONFIG)
    work_dir = os.path.join(ROOT, 'work_dirs', 'chip_smoke_train')
    shutil.rmtree(work_dir, ignore_errors=True)
    steps = 3

    # the main path: counts from zero, read right after
    roi_align_cuda.launch_count = 0
    roi_align_cuda.bwd_launch_count = 0
    t0 = time.perf_counter()
    out = train_main([TRAIN_CONFIG, '--synthetic', '--device', 'cuda',
                      '--max-iters', str(steps), '--work-dir', work_dir,
                      '--log-interval', '1'])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(k1=roi_align_cuda.launch_count,
                    k3=roi_align_cuda.bwd_launch_count)
    per_step = cfg.model.num_stages
    check(launches == dict(k1=per_step * steps, k3=per_step * steps),
          f'train path launched {launches}, expected {per_step} of K1 and '
          f'of K3 per step over {steps} steps')
    hist = out['history']
    check(len(hist) == steps and all(
        np.isfinite([h['loss'], h['grad_norm']]).all() for h in hist),
        f'train losses not finite: {[(h["loss"], h["grad_norm"]) for h in hist]}')
    state = out['state']
    init = init_model(cfg.model, seed=0, device='cpu').state_dict()
    now = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    frozen = [k for k in now if loop.param_group(k) == 'frozen'
              and 'running_' not in k]
    check(all(torch.equal(now[k], init[k]) for k in frozen),
          'a frozen parameter (stem, layer1) moved')
    for k in ('backbone.layer2.0.conv1.weight',
              'roi_head.bbox_head.0.ffn.layers.0.0.weight'):
        check(not torch.equal(now[k], init[k]), f'{k} did not move')
    del init, now
    shutil.rmtree(work_dir, ignore_errors=True)

    # kernels vs the plain RoIAlign, one step at 2 clips, f32, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = apply_overrides(cfg, ['data_train.batch_size=2'])
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(synthetic_batches(small, seed=1)).items()}
    base = init_model(cfg.model, seed=0, device=device)
    sides = {}
    for impl in ('auto', 'mm'):
        model = copy.deepcopy(base)
        model.cfg = dataclasses.replace(cfg.model, roi_impl=impl)
        st = loop.create_train_state(model.cfg, cfg.optim, model=model)
        loss, _ = loop.loss_fn(model.cfg, model, batch)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in
                 model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        logs = loop.make_train_step(model.cfg, cfg.optim)(st, batch)
        sides[impl] = (logs, grads)
        del st, model
    (lk, gk), (lm, gm) = sides['auto'], sides['mm']
    log_err = max(abs(lk[k].item() - lm[k].item())
                  / max(abs(lm[k].item()), 1e-12) for k in lm)
    check(sorted(gk) == sorted(gm), 'gradients of different parameters')
    grad_err = max((gk[n] - gm[n]).abs().max().item()
                   / max(gm[n].abs().max().item(), 1e-30) for n in gm)
    torch.backends.cudnn.allow_tf32 = True
    check(log_err <= TOL_E2E, f'train step, kernels vs plain: a log key '
          f'differs by {log_err} relative')
    check(grad_err <= TOL_E2E, f'train step, kernels vs plain: a gradient '
          f'differs by {grad_err} of its largest value')
    del sides, base, gk, gm, batch

    # time: full batch, the card's defaults (TF32 convolutions)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(synthetic_batches(cfg, seed=2)).items()}
    step_fn = loop.make_train_step(cfg.model, cfg.optim)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    step_ms = float(np.median(walls[1:]))
    clips = cfg.data_train.batch_size
    emit('train', config=os.path.relpath(TRAIN_CONFIG, ROOT),
         clips_per_step=clips, frames_per_step=clips * cfg.model.clip_length,
         steps=steps, main_path_seconds=main_s, launches=launches,
         losses=[h['loss'] for h in hist],
         grad_norms=[h['grad_norm'] for h in hist],
         main_path_step_seconds=[h['time'] for h in hist],
         kernel_vs_plain_log_rel_err=log_err,
         kernel_vs_plain_grad_err=grad_err,
         tol_e2e=TOL_E2E,
         step_ms=step_ms, step_ms_all=walls, clips_per_s=clips / step_ms * 1e3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         precision='float32, cuDNN TF32 on (card default), matmul TF32 off')
    return launches, lambda: step_fn(state, batch), step_ms


def profile_rows(fn, reps):
    """torch.profiler over reps calls of fn: [(device ms per call, kernel
    name, launches per call, launches recorded in all)] by kernel name,
    largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # a range named on the host (Optimizer.step#AdamW.step) is also listed
    # as device time spanning its kernels: count kernels only
    host = {ev.key for ev in events
            if getattr(ev, 'device_type', None) == DeviceType.CPU}
    rows = [(ev.self_device_time_total / (1e3 * reps), ev.key,
             ev.count // reps, ev.count)
            for ev in events
            if getattr(ev, 'device_type', None) == DeviceType.CUDA
            and ev.self_device_time_total > 0 and ev.key not in host]
    rows.sort(reverse=True)
    return rows


def phase_train_profile(step, step_ms):
    """Where a full-batch train step's time goes: device time by kernel,
    the idle share against the step's wall clock, K1 and K3 per step."""
    rows = profile_rows(step, 2)
    busy = sum(r[0] for r in rows)
    k1 = sum(r[0] for r in rows if 'roi_align_fpn_kernel' in r[1])
    k3 = sum(r[0] for r in rows if 'roi_align_fpn_bwd_kernel' in r[1])
    emit('train_profile', wall_ms_per_step=step_ms,
         kernel_ms_per_step=busy if rows else 'not measured',
         k1_ms_per_step=k1 if rows else 'not measured',
         k3_ms_per_step=k3 if rows else 'not measured',
         k1_k3_share=(k1 + k3) / step_ms if rows else 'not measured',
         kernels_per_step=sum(r[2] for r in rows),
         idle_share=(1 - busy / step_ms) if rows else 'not measured',
         top=[dict(ms=round(ms, 4), calls=c, name=k[:80])
              for ms, k, c, _ in rows[:15]])


def k1_launch_bounds(step):
    """The bound (ms) of each K1 launch one call of step makes: its inputs
    recorded on the way in (the wrapper is looked up at call time), the
    launch run as it is."""
    from mcgaze_tpu_torch.ops import roi_align_cuda
    launch = roi_align_cuda.launch_roi_align_fpn
    bounds = []

    def recorded(feats, rois, frame_idx=None, *args, **kw):
        fidx = None if frame_idx is None else frame_idx.cpu().numpy()
        nbytes, flops = roi_work(
            rois.detach().cpu().numpy(), fidx,
            [tuple(f.shape[1:3]) for f in feats], (4, 8, 16, 32),
            feats[0].shape[-1], feats[0].element_size())
        bounds.append(bound(nbytes, flops)[0])
        return launch(feats, rois, frame_idx, *args, **kw)

    roi_align_cuda.launch_roi_align_fpn = recorded
    try:
        with torch.inference_mode():
            step()
    finally:
        roi_align_cuda.launch_roi_align_fpn = launch
    torch.cuda.synchronize()
    return bounds


def phase_profile(step, layers, timer, phase='profile',
                  kernels=(('roi_align', 'roi_align_fpn'),), k1_bounds=None):
    """Where the K=32 bf16 forward's time goes: host wall clock per
    forward, device time of the layers (CUDA events), and device time by
    kernel from torch.profiler; idle share = 1 - kernel time / wall.
    `kernels`: (key, name substring) pairs reported as <key>_ms_per_forward,
    each a kernel the path launches: one the profiler lists under no such
    name, or at 0 ms, fails the phase. With `k1_bounds` (the bound of each
    K1 launch of one forward), K1's device time per launch beside their
    mean, counted only where the profiler recorded as many K1 launches as
    were made and the time is not below the bound (a profiler that drops
    events reads low)."""
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls[1:]))
    with torch.inference_mode():
        layer_ms = {k: timer.ms(fn, reps=5) for k, fn in layers.items()}
    from mcgaze_tpu_torch.ops import roi_align_cuda
    reps = 3
    made = roi_align_cuda.launch_count
    rows = profile_rows(step, reps)
    made = roi_align_cuda.launch_count - made
    busy = sum(r[0] for r in rows)
    per_kernel = {f'{key}_ms_per_forward':
                  sum(r[0] for r in rows if sub in r[1])
                  for key, sub in kernels}
    k1 = {}
    if k1_bounds is not None:
        k1_rows = [r for r in rows if 'roi_align_fpn_kernel' in r[1]]
        recorded = sum(r[3] for r in k1_rows)
        per_launch = (sum(r[0] for r in k1_rows) * reps / recorded
                      if recorded else 0.0)
        bound_ms = float(np.mean(k1_bounds))
        counted = recorded == made and per_launch >= bound_ms
        k1 = dict(k1_launches_made=made, k1_launches_recorded=recorded,
                  k1_bound_ms_per_launch=bound_ms,
                  k1_device_ms_per_launch=(per_launch if counted
                                           else 'not measured'),
                  k1_profiler_ms_per_launch=per_launch)
    emit(phase, wall_ms_per_forward=wall_ms, layer_ms=layer_ms,
         kernel_ms_per_forward=busy, **per_kernel, **k1,
         kernels_per_forward=sum(r[2] for r in rows),
         idle_share=1 - busy / wall_ms,
         top=[dict(ms=round(ms, 4), calls=c, name=k[:80])
              for ms, k, c, _ in rows[:12]])
    for (key, sub), ms in zip(kernels, per_kernel.values()):
        check(ms > 0, f'{phase}: the profiler lists no device time under '
              f'"{sub}" ({key}), a kernel the path launches')


# ------------------------------------------------------------- K4 and K5

def phase_kernel_k4(device, timer):
    """K4 against stqi_attention_reference on the card, f32: the eval shape
    (32 clips), one clip, and 3 heads of 32 channels (a cluster of 3);
    clip 0 unchanged when the others move; the cluster plan."""
    from mcgaze_tpu_torch.ops import stqi_attention
    from mcgaze_tpu_torch.tools.kernel_bounds import k4_bound

    rng = np.random.RandomState(4)
    t, q = 7, 3

    def arr(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.randn(*shape)).astype(
            np.float32)).to(device)

    def weights(c):
        return (arr(c, 3 * c, scale=c ** -0.5), arr(3 * c, scale=0.1),
                arr(c, c, scale=c ** -0.5), arr(c, scale=0.1),
                arr(c, scale=0.1, shift=1.0), arr(c, scale=0.1))

    gaze = weights(256)
    results = []
    for shape, clips, c, heads, w in (('gaze_eval', 32, 256, 8, gaze),
                                      ('one_clip', 1, 256, 8, gaze),
                                      ('three_heads', 32, 96, 3,
                                       weights(96))):
        query = arr(clips * t, q, c)
        got = stqi_attention.launch_stqi_attention(query, *w, t, heads)
        torch.cuda.synchronize()
        ref = stqi_attention.stqi_attention_reference(query, *w, t, heads)
        err = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()), f'K4 non-finite, {shape}')
        check(err <= TOL_K4, f'K4 disagrees with plain, {shape}: '
              f'{err} > {TOL_K4}')
        if clips > 1:
            perm = torch.cat([query[:t], query[t:].flip(0)])
            again = stqi_attention.launch_stqi_attention(perm, *w, t, heads)
            check(torch.equal(again[:t], got[:t]), f'K4 {shape}: clip 0 '
                  'moved with the other clips')
        plan = stqi_attention.cluster_plan(t * q, c, heads)
        check(plan['cluster'] >= 2, f'K4 {shape}: a cluster of '
              f'{plan["cluster"]}')
        k_ms = timer.ms(lambda: stqi_attention.launch_stqi_attention(
            query, *w, t, heads))
        p_ms = timer.ms(lambda: stqi_attention.stqi_attention_reference(
            query, *w, t, heads), reps=10)
        b = k4_bound(clips, t, q, c)
        results.append(dict(
            shape=shape, dtype='float32', form=f'{clips} clips, {heads} heads',
            clips=clips, c=c, heads=heads, cluster=plan['cluster'],
            ctas=clips * plan['cluster'], smem_bytes=plan['smem_bytes'],
            max_abs_err=err, tol=TOL_K4, ms=k_ms, plain_ms=p_ms,
            bound_ms=b['bound_ms'], bound_by=b['bound_by'], bytes=b['bytes'],
            flops=b['flops'], library_ms=None))
    emit('kernel_k4', cases=results)
    return results


def chain_feeds(backbone, imgs):
    """The input of each stage's stride-1 chain and its blocks, fed
    through the plain backbone: [(x NCHW channels_last, blocks)]."""
    import torch.nn.functional as F
    x = F.relu(backbone.bn1(backbone.conv1(imgs)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    feeds = []
    for stage in range(4):
        layer = list(getattr(backbone, f'layer{stage + 1}'))
        lead = [b for b in layer if b.conv2.stride != (1, 1)]
        for b in lead:
            x = b(x)
        feeds.append((x, layer[len(lead):]))
        for b in layer[len(lead):]:
            x = b(x)
    return feeds


def library_convs(xin, blocks, weights, h, w):
    """The chain's convolutions as cuDNN calls, the library's yardstick
    for K5: (input, weight, bias) of one F.conv2d per convolution in launch
    order, on NCHW channels_last views of the same activations, with the
    folded weights and their bias in the dtype. The inputs of each
    convolution come from running the chain with those calls."""
    import torch.nn.functional as F
    from mcgaze_tpu_torch.ops.fused_bottleneck import split_blocks

    def conv_args(a, b, ksize):
        cout = a.shape[1]
        wt = a.view(ksize, ksize, -1, cout).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return wt, b.reshape(-1).to(a.dtype)

    n = xin.shape[0]
    x = xin.view(n, h, w, -1).permute(0, 3, 1, 2)
    calls = []
    for a1, b1, a2, b2, a3, b3, ad, bd in split_blocks(weights):
        c1, c2, c3 = (conv_args(a1, b1, 1), conv_args(a2, b2, 3),
                      conv_args(a3, b3, 1))
        y1 = torch.relu(F.conv2d(x, *c1))
        y2 = torch.relu(F.conv2d(y1, *c2, padding=1))
        calls += [(x, *c1, 0), (y1, *c2, 1)]
        idn = x
        if ad is not None:
            cd = conv_args(ad, bd, 1)
            calls.append((x, *cd, 0))
            idn = F.conv2d(x, *cd)
        calls.append((y2, *c3, 0))
        x = torch.relu(F.conv2d(y2, *c3) + idn)
    return calls


def phase_kernel_k5(device, timer, frames=131):
    """K5 against chain_reference for each ResNet-50 stage chain at the
    eval shape (131 frames at 224 px), bf16 and f32, on the full-width
    seeded model's folded weights and the activations its plain backbone
    feeds each chain; kernel, plain and plain-Bottleneck ms, the bound and
    the per-launch floor, and the library's time: one cuDNN F.conv2d per
    convolution with the folded weight and bias, summed over the chain
    (without the residual add and the ReLUs, which K5 also computes: the
    library's best case). Then the autograd Function's gradients at a
    small shape."""
    import torch.nn.functional as F
    from mcgaze_tpu_torch.models.mcgaze import ModelConfig, init_model
    from mcgaze_tpu_torch.ops import fused_bottleneck as fb
    from mcgaze_tpu_torch.tools.kernel_bounds import (PEAKS, chains,
                                                      k5_bound,
                                                      k5_launch_floor)

    model = init_model(ModelConfig(backbone_impl='fused'), seed=0,
                       device=device)
    specs = chains(50, 224)
    rng = np.random.RandomState(5)
    imgs = torch.from_numpy(rng.randn(frames, 224, 224, 3).astype(
        np.float32)).to(device).permute(0, 3, 1, 2)
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace('torch.', '')
        with torch.inference_mode():
            feeds = chain_feeds(model.backbone, imgs.to(dtype))
        for spec, (x, blocks) in zip(specs, feeds):
            n, c, h, w = x.shape
            with torch.inference_mode():
                xin = x.permute(0, 2, 3, 1).reshape(n, h * w, c).contiguous()
                weights = [a for b in blocks
                           for a in fb.fold_block_params(b, dtype)]
                got = fb.launch_fused_bottleneck_chain(xin, weights, h, w)
                torch.cuda.synchronize()
                ref = fb.chain_reference(xin, weights, h, w)
            scale = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            tol = (TOL_K5_F32_REL if dtype == torch.float32
                   else TOL_BF16_REL) * scale
            check(bool(torch.isfinite(got).all()),
                  f'K5 non-finite, layer{spec["stage"]} {name}')
            check(err <= tol, f'K5 disagrees with plain: layer'
                  f'{spec["stage"]} {name} err {err} > tol {tol}')
            del got, ref
            reps = 10 if dtype == torch.bfloat16 else 4

            def plain_blocks():
                y = x
                for b in blocks:
                    y = b(y)
                return y

            with torch.inference_mode():
                k_ms = timer.ms(lambda: fb.launch_fused_bottleneck_chain(
                    xin, weights, h, w), reps=reps)
                p_ms = timer.ms(lambda: fb.chain_reference(xin, weights, h,
                                                           w), reps=3)
                torch.backends.cudnn.allow_tf32 = True   # the card default
                blocks_ms = timer.ms(plain_blocks, reps=reps)
                torch.backends.cudnn.allow_tf32 = False  # as K5's f32
                calls = library_convs(xin, blocks, weights, h, w)
                lib_ms = timer.ms(lambda: [
                    F.conv2d(xc, wt, bias, padding=pad)
                    for xc, wt, bias, pad in calls], reps=reps)
                del calls
            b = k5_bound(frames, spec, name)
            fl = k5_launch_floor(frames, spec, name)
            results.append(dict(
                shape=f'layer{spec["stage"]}', dtype=name,
                form=f'{frames}x{h}x{w} {spec["cin"]}->{4 * spec["mid"]}',
                blocks=spec['blocks'], launches=b['launches'],
                max_abs_err=err, tol=tol, out_scale=scale, ms=k_ms,
                plain_ms=p_ms, plain_blocks_ms=blocks_ms,
                bound_ms=b['bound_ms'], bound_by=b['bound_by'],
                bytes=b['bytes'], flops=b['flops'],
                launch_floor_ms=fl['floor_ms'], launch_floor_bytes=fl['bytes'],
                tflops=b['flops'] / k_ms / 1e9,
                peak_share=b['flops'] * 1e3 / k_ms / PEAKS[name],
                library_ms=lib_ms,
                library='F.conv2d (cuDNN) with bias, one per convolution, '
                        'no residual add or ReLU; f32 with TF32 off'))
            del xin, weights
        del feeds
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True

    # the Function: kernel forward, autograd of chain_reference backward;
    # gradients of x and of every conv and BN parameter of layer1's chain
    # through the fold, f32, at 2 frames of 12x10
    blocks = list(model.backbone.layer1)
    g = torch.from_numpy(rng.randn(2, 120, 256).astype(np.float32)).to(device)
    x0 = torch.from_numpy(np.maximum(rng.randn(2, 120, 64), 0).astype(
        np.float32)).to(device)

    def grads(fn):
        x = x0.clone().requires_grad_()
        weights = [a for b in blocks
                   for a in fb.fold_block_params(b, torch.float32)]
        fn(x, weights, 12, 10).backward(g)
        out = [x.grad] + [p.grad.clone() for b in blocks
                          for p in b.parameters()]
        model.zero_grad(set_to_none=True)
        return out

    before = fb.launch_count
    got = grads(fb.fused_bottleneck_chain)
    check(fb.launch_count == before + 10, 'K5 Function did not launch the '
          'kernel 10 times for layer1')
    ref = grads(fb.chain_reference)
    grad_err = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                     1e-30)
                   for a, b in zip(got, ref))
    check(grad_err <= TOL_K5_F32_REL, f'K5 Function gradient vs autograd '
          f'of the plain version: {grad_err} > {TOL_K5_F32_REL}')
    emit('kernel_k5', cases=results, grad_rel_err=grad_err,
         grad_tol=TOL_K5_F32_REL, grad_tensors=len(ref))
    del model, imgs
    torch.cuda.empty_cache()
    return results, grad_err


def fused_counters():
    from mcgaze_tpu_torch.ops import (fused_bottleneck, roi_align_cuda,
                                      stqi_attention)
    return dict(k1=roi_align_cuda.launch_count,
                k3=roi_align_cuda.bwd_launch_count,
                k4=stqi_attention.launch_count,
                k5=fused_bottleneck.launch_count)


def reset_counters():
    from mcgaze_tpu_torch.ops import (fused_bottleneck, roi_align_cuda,
                                      stqi_attention)
    roi_align_cuda.launch_count = 0
    roi_align_cuda.bwd_launch_count = 0
    stqi_attention.launch_count = 0
    fused_bottleneck.launch_count = 0


def phase_slice_fused(device, timer):
    """The fused configuration at full width through run_video, f32 and
    bf16, counters from zero; one chunk in f32 with TF32 off against the
    plain model on the same weights; then fwd_dedup at 32 clips in bf16."""
    from mcgaze_tpu_torch import EvalConfig, ModelConfig, VideoGazeEvaluator
    from mcgaze_tpu_torch.evaluation.driver import clip_slices
    from mcgaze_tpu_torch.evaluation.forward import (bind_forward,
                                                     make_eval_forward)
    from mcgaze_tpu_torch.tools.kernel_bounds import chains, k5_launches

    rng = np.random.RandomState(11)
    frames = [rng.randint(0, 256, (224, 224, 3), np.uint8)
              for _ in range(60)]
    ecfg = EvalConfig(crop_ratio=None, clip_batch=8, dedup_frames=True)
    n_clips = len(clip_slices(60, ecfg.clip_length, ecfg.stride))
    n_forwards = -(-n_clips // ecfg.clip_batch)

    built = {}
    for dt in ('float32', 'bfloat16'):
        cfg = ModelConfig(dtype=dt, backbone_impl='fused',
                          fused_attention=True)
        model, fwd, fwd_dedup = make_eval_forward(cfg, seed=0,
                                                  device=device)
        built[dt] = (model, fwd, fwd_dedup,
                     bind_forward(fwd, device, fwd_dedup))

    # the main path: launch counts from zero, read right after
    reset_counters()
    t0 = time.perf_counter()
    res = {dt: VideoGazeEvaluator(built[dt][3], ecfg).run_video(frames, 0)
           for dt in built}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fused_counters()
    cfg = built['float32'][0].cfg
    k5_per_forward = sum(k5_launches(ch) for ch in chains(cfg.backbone_depth))
    forwards = 2 * n_forwards
    expected = dict(k1=forwards * cfg.num_stages, k3=0,
                    k4=forwards * cfg.num_stages,
                    k5=forwards * k5_per_forward)
    check(launches == expected, f'fused main path launched {launches}, '
          f'expected {expected}')
    for dt, r in res.items():
        check(len(r['fusion_gazes']) == 60, f'{dt}: '
              f'{len(r["fusion_gazes"])} frames in the result')
        vals = [r['fusion_gazes']] + [
            r[f'{c}_{k}'] for c in ('face', 'eyes', 'head')
            for k in ('gazes', 'score')] + [
            b for c in ('face', 'eyes', 'head') for b in r[f'{c}_bboxes']
            if b is not None]
        check(all(np.isfinite(np.asarray(v, np.float64)).all()
                  for v in vals), f'fused {dt}: non-finite results')

    # one chunk, f32, TF32 off: fused == plain model on the same weights,
    # and fused fwd_dedup == fused fwd
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, fwd, fwd_dedup, _ = built['float32']
    _, _, plain_dedup = make_eval_forward(ModelConfig(dtype='float32'),
                                          seed=0, device=device)
    sel = gaze_sel(k=8)
    u8 = torch.from_numpy(np.stack(frames[:int(sel.max()) + 1])).to(device)
    whwh = torch.full((u8.shape[0], 4), 224.0, device=device)
    sel_t = torch.from_numpy(sel).to(device)
    a = fwd_dedup(u8, sel_t, whwh, 7)
    b = fwd(u8[sel_t.long()], whwh[sel_t.long()], 7)
    p = plain_dedup(u8, sel_t, whwh, 7)
    del plain_dedup
    torch.backends.cudnn.allow_tf32 = True

    def err(x, y):
        box = ((x[0] - y[0]).abs().max() / y[0].abs().max().clamp_min(1.0))
        return max(box.item(), (x[1] - y[1]).abs().max().item(),
                   *((x[2][k] - y[2][k]).abs().max().item() for k in y[2]))

    dedup_err, plain_err = err(a, b), err(a, p)
    norms = torch.stack([a[2][k].norm(dim=-1) for k in a[2]])
    check((norms - 1).abs().max().item() < 1e-4, 'fused f32 gazes not unit')
    check(dedup_err <= TOL_E2E, f'fused fwd_dedup != fwd: {dedup_err}')
    check(plain_err <= TOL_E2E, f'fused vs plain model end to end: '
          f'{plain_err}')

    # the same chunk in bf16, where K5 runs its tensor-core body: the fused
    # and the plain bf16 forwards, each against the plain f32 forward p. The
    # fused error may be at most twice the plain one plus TOL_E2E, in box
    # error relative to the largest coordinate and in gaze angle (degrees)
    _, _, plain_dedup16 = make_eval_forward(ModelConfig(dtype='bfloat16'),
                                            seed=0, device=device)

    def bf16_err(x):
        box = ((x[0].float() - p[0]).abs().max()
               / p[0].abs().max().clamp_min(1.0)).item()
        deg = 0.0
        for k in p[2]:
            g, r = x[2][k].float(), p[2][k]
            cos = (g * r).sum(-1) / (g.norm(dim=-1) * r.norm(dim=-1))
            deg = max(deg, torch.rad2deg(torch.acos(cos.clamp(-1.0, 1.0)))
                      .max().item())
        return box, deg

    fused16_err = bf16_err(built['bfloat16'][2](u8, sel_t, whwh, 7))
    plain16_err = bf16_err(plain_dedup16(u8, sel_t, whwh, 7))
    del plain_dedup16
    for what, f_err, p_err in zip(('box', 'gaze degrees'), fused16_err,
                                  plain16_err):
        check(f_err <= 2 * p_err + TOL_E2E, f'fused bf16 forward: {what} '
              f'error {f_err} against the plain f32 forward, above twice '
              f'the plain bf16 forward\'s {p_err} plus {TOL_E2E}')

    # timing: fwd_dedup at 32 clips, bf16
    model16, _, fwd_dedup16, _ = built['bfloat16']
    del built, model, fwd, fwd_dedup
    torch.cuda.empty_cache()
    sel = gaze_sel(k=32)
    u8 = torch.from_numpy(rng.randint(0, 256, (int(sel.max()) + 1, 224, 224,
                                               3), np.uint8)).to(device)
    whwh = torch.full((u8.shape[0], 4), 224.0, device=device)
    sel_t = torch.from_numpy(sel).to(device)
    out16 = fwd_dedup16(u8, sel_t, whwh, 7)
    norms16 = torch.stack([out16[2][k].norm(dim=-1) for k in out16[2]])
    check(all(bool(torch.isfinite(t).all())
              for t in (out16[0], out16[1], *out16[2].values())),
          'fused bf16 non-finite')
    check((norms16 - 1).abs().max().item() < 2e-2, 'fused bf16 gazes not '
          'unit')

    def step():
        return fwd_dedup16(u8, sel_t, whwh, 7)

    torch.cuda.reset_peak_memory_stats()
    fwd_ms = timer.ms(step, reps=10)
    emit('slice_fused', frames=60, clips=n_clips,
         forwards_per_video=n_forwards, launches=launches,
         launches_expected=expected, k5_launches_per_forward=k5_per_forward,
         main_path_seconds=main_s, fwd_dedup_vs_fwd_err=dedup_err,
         fused_vs_plain_e2e_err=plain_err, tol_e2e=TOL_E2E,
         bf16_vs_f32_plain=dict(
             fused_box_err=fused16_err[0], fused_gaze_deg=fused16_err[1],
             plain_box_err=plain16_err[0], plain_gaze_deg=plain16_err[1]),
         bf16_k32_fwd_ms=fwd_ms, bf16_k32_clips_per_s=32 / (fwd_ms / 1e3),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    from mcgaze_tpu_torch.evaluation.forward import device_normalize
    with torch.inference_mode():
        norm = device_normalize(u8, whwh)
        feats = model16.extract_features(norm)
        whwh_s = whwh[sel_t.long()]
    layers = dict(
        backbone_fpn=lambda: model16.extract_features(norm),
        heads=lambda: model16.run_heads(feats, whwh_s, 7, sel_t))
    return launches, step, layers


def backbone_grads(impl, dtype, frames, cotangents, device):
    """Gradients of every backbone parameter and of the input for fixed
    cotangents on the four outputs, in f64."""
    from mcgaze_tpu_torch.models.mcgaze import ModelConfig, init_model
    model = init_model(ModelConfig(backbone_impl=impl), seed=0, device=device)
    net = model.backbone.to(dtype)
    x = frames.to(dtype).clone().requires_grad_()
    torch.autograd.backward(net(x), [c.to(dtype) for c in cotangents])
    grads = {n: p.grad.double() for n, p in net.named_parameters()}
    grads['input'] = x.grad.double()
    return grads


def phase_train_fused(device):
    """One train step at 2 clips of the shipped config with
    backbone_impl='fused' (fused_attention off: K4 is forward-only), f32,
    TF32 off, against the plain backbone on the same weights: every log
    key at TOL_E2E. K5 launches in the forwards; its backward recomputes
    the plain version.

    The gradients: for fixed cotangents on the four backbone outputs of 14
    frames at 224 px, the fused backbone's f32 gradient of every parameter
    and of the input is held against the plain backbone's float64 gradient
    (each tensor relative to its largest value): its worst error must stay
    within twice cuDNN's own f32 error on the same gradients, plus
    TOL_E2E. A direct f32 comparison cannot hold: at these random weights
    the f32 and f64 plain gradients differ by ~3% of a tensor's largest
    value (ReLU kinks flip under rounding; measured on an H100), and the
    step's head gradients move as much. The step's gradient differences
    are printed, unchecked."""
    from mcgaze_tpu_torch.models.mcgaze import init_model
    from mcgaze_tpu_torch.tools.kernel_bounds import chains, k5_launches
    from mcgaze_tpu_torch.tools.train import synthetic_batches
    from mcgaze_tpu_torch.train import loop
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    cfg = apply_overrides(load_config(TRAIN_CONFIG),
                          ['data_train.batch_size=2'])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(synthetic_batches(cfg, seed=3)).items()}
    sides = {}
    for impl in ('fused', 'plain'):
        # the same seed gives both backbones the same weights
        model = init_model(dataclasses.replace(cfg.model, backbone_impl=impl),
                           seed=0, device=device)
        st = loop.create_train_state(model.cfg, cfg.optim, model=model)
        if impl == 'fused':
            reset_counters()
        loss, _ = loop.loss_fn(model.cfg, model, batch)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in
                 model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        logs = loop.make_train_step(model.cfg, cfg.optim)(st, batch)
        if impl == 'fused':
            torch.cuda.synchronize()
            launches = fused_counters()
        sides[impl] = (logs, grads)
        del st, model
    (lf, gf), (lp, gp) = sides['fused'], sides['plain']
    log_err = max(abs(lf[k].item() - lp[k].item())
                  / max(abs(lp[k].item()), 1e-12) for k in lp)
    check(sorted(gf) == sorted(gp), 'fused and plain backbones give '
          'gradients of different parameters')
    step_norm_err = max((gf[n] - gp[n]).norm().item()
                        / max(gp[n].norm().item(), 1e-30) for n in gp)
    step_max_err = max((gf[n] - gp[n]).abs().max().item()
                       / max(gp[n].abs().max().item(), 1e-30) for n in gp)
    del sides, batch

    rng = np.random.RandomState(6)
    frames = torch.from_numpy(rng.randn(14, 3, 224, 224).astype(
        np.float32)).to(device).to(memory_format=torch.channels_last)
    shapes = [(14, c, s, s) for c, s in ((256, 56), (512, 28), (1024, 14),
                                         (2048, 7))]
    cotangents = [torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(
        device) for sh in shapes]
    truth = backbone_grads('plain', torch.float64, frames, cotangents, device)

    def err(grads):
        return max((grads[n] - truth[n]).abs().max().item()
                   / max(truth[n].abs().max().item(), 1e-300) for n in truth)

    fused_err = err(backbone_grads('fused', torch.float32, frames,
                                   cotangents, device))
    cudnn_err = err(backbone_grads('plain', torch.float32, frames,
                                   cotangents, device))
    torch.backends.cudnn.allow_tf32 = True
    per_forward = sum(k5_launches(ch)
                      for ch in chains(cfg.model.backbone_depth))
    emit('train_fused', clips=2, launches=launches,
         fused_vs_plain_log_rel_err=log_err, tol_e2e=TOL_E2E,
         step_grad_norm_err=step_norm_err, step_grad_max_err=step_max_err,
         backbone_grad_err_vs_f64=fused_err,
         cudnn_f32_grad_err_vs_f64=cudnn_err,
         backbone_grad_tol=2 * cudnn_err + TOL_E2E, grad_tensors=len(gp),
         backbone_grad_tensors=len(truth), precision='float32, TF32 off')
    check(launches['k5'] == 2 * per_forward and launches['k4'] == 0,
          f'fused train step launched {launches}, expected {per_forward} K5 '
          'per forward over 2 forwards and no K4')
    check(log_err <= TOL_E2E, f'train step, fused vs plain backbone: a log '
          f'key differs by {log_err} relative')
    check(fused_err <= 2 * cudnn_err + TOL_E2E, f'fused backbone gradient '
          f'vs float64: {fused_err}, cuDNN f32: {cudnn_err}')
    del truth
    torch.cuda.empty_cache()
    return launches

def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this test '
              'needs a CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mcgaze_tpu_torch.ops import _native

    device = torch.device('cuda')
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit('env', nvidia_smi=smi, device=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    report = _native.build_all()
    emit('build', seconds=time.perf_counter() - t0,
         kernels={k: dict(seconds=v['seconds'],
                          ptxas=[ln.strip() for ln in v['log'].splitlines()
                                 if 'registers' in ln or 'spill' in ln][:8])
                  for k, v in report.items()})

    timer = Timer(device)
    cases = phase_kernel(device, timer)
    bwd_cases = phase_kernel_bwd(device, timer)
    k4_cases = phase_kernel_k4(device, timer)
    k5_cases, _ = phase_kernel_k5(device, timer)
    del timer
    torch.cuda.empty_cache()
    eval_launches, step, layers = phase_slice(device, Timer(device))
    phase_profile(step, layers, Timer(device),
                  k1_bounds=k1_launch_bounds(step))
    del step, layers
    torch.cuda.empty_cache()
    fused_launches, step, layers = phase_slice_fused(device, Timer(device))
    phase_profile(step, layers, Timer(device), phase='profile_fused',
                  kernels=(('roi_align', 'roi_align_fpn'),
                           ('k4', 'stqi_attention_kernel'),
                           ('k5', 'conv_gemm')))
    del step, layers
    torch.cuda.empty_cache()
    train_launches, train_step, train_ms = phase_train(device)
    phase_train_profile(train_step, train_ms)
    del train_step
    torch.cuda.empty_cache()
    train_fused_launches = phase_train_fused(device)

    # each kernel beside the case of the path that runs it: K1 at the eval
    # shape (bf16, frame_idx), K3 at the training shape (f32, identity), K4
    # at the eval shape (f32, 32 clips), K5 summed over the four stage
    # chains at the eval shape in bf16
    k1 = next(c for c in cases if c['shape'] == 'gaze_eval'
              and c['dtype'] == 'bfloat16' and c['form'] == 'frame_idx')
    k3 = next(c for c in bwd_cases if c['shape'] == 'gaze_train'
              and c['dtype'] == 'float32' and c['form'] == 'identity')
    k4 = next(c for c in k4_cases if c['shape'] == 'gaze_eval')
    k5_bf16 = [c for c in k5_cases if c['dtype'] == 'bfloat16']
    worst = max(k5_bf16, key=lambda c: c['max_abs_err'] / c['tol'])
    k5 = dict(shape='resnet50 chains layer1-4', dtype='bfloat16',
              form='131 frames at 224 px, summed',
              max_abs_err=worst['max_abs_err'], tol=worst['tol'],
              **{k: sum(c[k] for c in k5_bf16)
                 for k in ('ms', 'plain_ms', 'plain_blocks_ms', 'bound_ms',
                           'launch_floor_ms', 'library_ms')},
              bound_by=('operations' if all(c['bound_by'] == 'operations'
                                            for c in k5_bf16) else 'bytes'))

    def line(name, source, replaces, launches, case):
        extra = {k: case[k] for k in ('plain_blocks_ms', 'launch_floor_ms')
                 if k in case}
        return dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=case['max_abs_err'], tolerance=case['tol'],
            case=f"{case['shape']} {case['dtype']} {case['form']}",
            ms=case['ms'], plain_ms=case['plain_ms'],
            bound_ms=case['bound_ms'], bound_by=case['bound_by'],
            library_ms=case['library_ms'], **extra)

    print(json.dumps({'kernels': [
        line('roi_align_fpn', 'mcgaze_tpu_torch/csrc/roi_align_fpn.cu',
             'mcgaze_tpu/ops/roi_align_pallas.py:424',
             dict(eval=eval_launches, eval_fused=fused_launches['k1'],
                  train=train_launches['k1']), k1),
        line('roi_align_fpn_bwd',
             'mcgaze_tpu_torch/csrc/roi_align_fpn_bwd.cu',
             'mcgaze_tpu/ops/roi_align_pallas.py:772',
             dict(train=train_launches['k3']), k3),
        line('fused_stqi_attention',
             'mcgaze_tpu_torch/csrc/stqi_attention.cu',
             'mcgaze_tpu/ops/stqi_attention.py:110',
             dict(eval_fused=fused_launches['k4']), k4),
        line('fused_bottleneck_chain',
             'mcgaze_tpu_torch/csrc/fused_bottleneck.cu',
             'mcgaze_tpu/ops/fused_bottleneck.py:125',
             dict(eval_fused=fused_launches['k5'],
                  train_fused=train_fused_launches['k5']), k5)]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
