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
          (CUDA events, L2 flushed before each launch), the bound
  kernel_bwd  the RoIAlign backward kernel (K3) against the plain
          version's autograd gradient, and the adjoint identity
          <K1(F), G> = sum_l <F_l, K3(G)_l> in f64 sums at G = K1(F),
          relative to |K1(F)|^2: f32 and bf16,
          identity and frame_idx forms, at the gaze training shape (224
          frames at 224 px, 3 RoIs, C=256) and R=100 at 384x640; error and
          tolerance, kernel and plain ms, the bound
  slice   the full-width model (R50, C=256, FFN 2048, 4 stages, 224 px,
          seeded random weights) through VideoGazeEvaluator.run_video on a
          fabricated 60-frame u8 video, in f32 and bf16, with the kernel
          launch counter reset before and read after; finite results, unit
          gazes; fwd_dedup == fwd and kernel == plain RoIAlign end to end
          with TF32 off; then fwd_dedup timed at 32 clips in bf16
  profile torch.profiler over the timed forward: device time by kernel
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
# tolerances, scaled by the largest |gradient|; in f32 the atomics add a
# cell's terms in an order that changes from run to run, in bf16 the plain
# gradient rounds its intermediate to bf16 and the kernel only its output.
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
    """Median device ms of fn over reps, with the L2 cache flushed (a
    256 MB write) before each launch, as the main path finds it cold."""

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
    """(bytes, flops, scatter bytes) of its transpose: the dense gradient
    (every cell of `frames` pyramids) written once in its dtype, g, the
    boxes and the map read once; the same 8 flops per channel per valid
    (sample, corner). Scatter bytes, apart from the bound: a read and a
    write of each touched cell, which an accumulating scatter adds over a
    gather form that writes each cell once."""
    n, r = rois.shape[:2]
    cells, valid_samples = roi_touch(rois, frame_idx, sizes, strides, out,
                                     s, finest)
    dense = frames * sum(h * w for h, w in sizes) * c * itemsize
    nbytes = (dense + n * r * out * out * c * itemsize + rois.nbytes
              + (0 if frame_idx is None else frame_idx.nbytes))
    return nbytes, valid_samples * 4 * 2 * c, 2 * cells * c * itemsize


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
            bound_by=b_by, bytes=nbytes, flops=flops, library_ms=None))
        del feats, got
        torch.cuda.empty_cache()
    emit('kernel', cases=results)
    return results


def phase_kernel_bwd(device, timer):
    """K3 against the plain version's autograd gradient at a random
    cotangent G, and the adjoint identity <K1(F), G> = sum_l <F_l, K3(G)_l>
    in f64 sums at G = K1(F)."""
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
        feats = make_pyramid(rng, cs['u'], cs['img'], 256, device, dtype)
        rois_np = make_rois(rng, cs['n'], cs['r'], cs['img'])
        rois = torch.from_numpy(rois_np).to(device)
        fidx = (None if cs['fidx'] is None
                else torch.from_numpy(cs['fidx']).to(device))
        shapes = [tuple(f.shape) for f in feats]
        g = torch.from_numpy(rng.randn(cs['n'], cs['r'], 7, 7, 256).astype(
            np.float32)).to(device, dtype)
        got = roi_align_cuda.launch_roi_align_fpn_bwd(g, rois, fidx, shapes)
        torch.cuda.synchronize()
        leaves = tuple(f.detach().requires_grad_() for f in feats)
        ref_out = roi_align_fpn_mm(leaves, rois, fidx)
        ref = torch.autograd.grad(ref_out, leaves, g, retain_graph=True)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, ref))
        scale = max(b.float().abs().max().item() for b in ref)
        tol = (TOL_F32_REL if dtype == torch.float32 else TOL_BF16_REL) * scale
        check(all(bool(torch.isfinite(x).all()) for x in got),
              f'non-finite K3 output {cs["shape"]}')
        check(err <= tol, f'K3 disagrees with plain autograd: {cs["shape"]} '
              f'{dtype} form={"frame_idx" if fidx is not None else "identity"}'
              f' err {err} > tol {tol}')
        fwd = roi_align_cuda.launch_roi_align_fpn(feats, rois, fidx)
        back = roi_align_cuda.launch_roi_align_fpn_bwd(fwd, rois, fidx,
                                                       shapes)
        lhs = fwd.double().square().sum().item()
        rhs = sum((f.double() * d.double()).sum().item()
                  for f, d in zip(feats, back))
        adj = abs(lhs - rhs) / lhs
        adj_tol = TOL_ADJ_F32 if dtype == torch.float32 else TOL_ADJ_BF16
        check(adj <= adj_tol, f'K3 is not the adjoint of K1: {cs["shape"]} '
              f'{dtype}: {adj} > {adj_tol}')
        del fwd, back, got
        k_ms = timer.ms(lambda: roi_align_cuda.launch_roi_align_fpn_bwd(
            g, rois, fidx, shapes))
        p_ms = timer.ms(lambda: torch.autograd.grad(
            ref_out, leaves, g, retain_graph=True), reps=5)
        nbytes, flops, scatter = roi_bwd_work(
            rois_np, cs['fidx'], [s[1:3] for s in shapes], (4, 8, 16, 32),
            256, feats[0].element_size(), cs['u'])
        b_ms, b_by = bound(nbytes, flops)
        results.append(dict(
            shape=cs['shape'], dtype=str(dtype).replace('torch.', ''),
            form='frame_idx' if fidx is not None else 'identity',
            u=cs['u'], n=cs['n'], r=cs['r'], max_abs_err=err, tol=tol,
            grad_scale=scale, adjoint_rel_err=adj, adjoint_tol=adj_tol,
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            bytes=nbytes, flops=flops, scatter_bytes=scatter,
            scatter_bound_ms=bound(nbytes + scatter, flops)[0],
            library_ms=None))
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
    name, launches per call)] by kernel name, largest first."""
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
             ev.count // reps)
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
              for ms, k, c in rows[:15]])


def phase_profile(step, layers, timer):
    """Where the K=32 bf16 forward's time goes: host wall clock per
    forward, device time of the layers (CUDA events), and device time by
    kernel from torch.profiler; idle share = 1 - kernel time / wall."""
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
    rows = profile_rows(step, 3)
    busy = sum(r[0] for r in rows)
    roi = sum(r[0] for r in rows if 'roi_align_fpn' in r[1])
    emit('profile', wall_ms_per_forward=wall_ms, layer_ms=layer_ms,
         kernel_ms_per_forward=busy if rows else 'not measured',
         roi_align_ms_per_forward=roi if rows else 'not measured',
         kernels_per_forward=sum(r[2] for r in rows),
         idle_share=(1 - busy / wall_ms) if rows else 'not measured',
         top=[dict(ms=round(ms, 4), calls=c, name=k[:80])
              for ms, k, c in rows[:12]])


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
    del timer
    torch.cuda.empty_cache()
    eval_launches, step, layers = phase_slice(device, Timer(device))
    phase_profile(step, layers, Timer(device))
    del step, layers
    torch.cuda.empty_cache()
    train_launches, train_step, train_ms = phase_train(device)
    phase_train_profile(train_step, train_ms)

    # each kernel beside the case of the path that runs it: K1 at the eval
    # shape (bf16, frame_idx), K3 at the training shape (f32, identity)
    k1 = next(c for c in cases if c['shape'] == 'gaze_eval'
              and c['dtype'] == 'bfloat16' and c['form'] == 'frame_idx')
    k3 = next(c for c in bwd_cases if c['shape'] == 'gaze_train'
              and c['dtype'] == 'float32' and c['form'] == 'identity')

    def line(name, source, replaces, launches, case):
        return dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=case['max_abs_err'], tolerance=case['tol'],
            case=f"{case['shape']} {case['dtype']} {case['form']}",
            ms=case['ms'], plain_ms=case['plain_ms'],
            bound_ms=case['bound_ms'], bound_by=case['bound_by'],
            library_ms=None)

    print(json.dumps({'kernels': [
        line('roi_align_fpn', 'mcgaze_tpu_torch/csrc/roi_align_fpn.cu',
             'mcgaze_tpu/ops/roi_align_pallas.py:424',
             dict(eval=eval_launches, train=train_launches['k1']), k1),
        line('roi_align_fpn_bwd',
             'mcgaze_tpu_torch/csrc/roi_align_fpn_bwd.cu',
             'mcgaze_tpu/ops/roi_align_pallas.py:772',
             dict(train=train_launches['k3']), k3)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
