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
  slice   the full-width model (R50, C=256, FFN 2048, 4 stages, 224 px,
          seeded random weights) through VideoGazeEvaluator.run_video on a
          fabricated 60-frame u8 video, in f32 and bf16, with the kernel
          launch counter reset before and read after; finite results, unit
          gazes; fwd_dedup == fwd and kernel == plain RoIAlign end to end
          with TF32 off; then fwd_dedup timed at 32 clips in bf16
  profile torch.profiler over the timed forward: device time by kernel
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
# kernel vs plain, f32: each side rounds up to ~16 partial sums bounded by
# the largest feature it reads, so the tolerance scales with max|feats|
TOL_F32_REL = 1e-5
TOL_BF16_REL = 2e-2            # bf16: the plain version rounds its weights
#                                and intermediate to bf16, the kernel does not
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


def roi_work(rois, frame_idx, sizes, strides, c, itemsize, out=7, s=2,
             finest=56.0):
    """(bytes, flops) the RoIAlign needs on these inputs: each routed
    pyramid cell read once, the output written once, the boxes and map
    read once; 8 flops per channel per valid (sample, corner)
    weight-multiply-add."""
    n, r = rois.shape[:2]
    fidx = np.arange(n) if frame_idx is None else frame_idx
    area = np.maximum((rois[..., 2] - rois[..., 0]) *
                      (rois[..., 3] - rois[..., 1]), 0.0)
    v = np.sqrt(area) / np.float32(finest) + np.float32(1e-6)
    lvl = sum((v >= 2.0 ** k).astype(np.int64) for k in range(1, len(sizes)))
    touched = {}
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
        touched[li] = int(mask.sum())
    cells = sum(touched.values())
    nbytes = (cells * c * itemsize + n * r * out * out * c * itemsize
              + rois.nbytes + (0 if frame_idx is None else frame_idx.nbytes))
    flops = valid_samples * 4 * 2 * c
    return nbytes, flops


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
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


def phase_profile(step, layers, timer):
    """Where the K=32 bf16 forward's time goes: host wall clock per
    forward, device time of the layers (CUDA events), and device time by
    kernel from torch.profiler; idle share = 1 - kernel time / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total / 3e3, ev.key, ev.count // 3)
            for ev in prof.key_averages()
            if getattr(ev, 'device_type', None) == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
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
    launches, step, layers = phase_slice(device, timer)
    phase_profile(step, layers, timer)

    main_case = next(c for c in cases if c['shape'] == 'gaze_eval'
                     and c['dtype'] == 'bfloat16' and c['form'] == 'frame_idx')
    print(json.dumps({'kernels': [dict(
        name='roi_align_fpn', route='cuda',
        source='mcgaze_tpu_torch/csrc/roi_align_fpn.cu',
        replaces='mcgaze_tpu/ops/roi_align_pallas.py:424',
        launches=launches, max_abs_err=main_case['max_abs_err'],
        tolerance=main_case['tol'], ms=main_case['ms'],
        plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
        bound_by=main_case['bound_by'], library_ms=None)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
