#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcgaze_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  env     the card (nvidia-smi name and power limit), torch and CUDA versions
  build   nvcc builds every kernel of mcgaze_tpu_torch/csrc, one process
          per source, all started together; the kernel and kernel_bwd
          phases run once K1's and K3's libraries are built, and the line
          comes when the whole build is done
  kernel  the FPN RoIAlign kernel against its plain PyTorch version on the
          card: f32 and bf16, identity and frame_idx forms, at the gaze
          eval shape (224 px, 32 clips: 131 unique frames, 224 slots, 3
          RoIs, C=256) with boxes that mix levels, run off the image, and
          include an inverted and a zero-area box; R=100 at 384x640 (bf16,
          44 frames; and the InstBlink path's f32 identity shapes, 44 and
          88 frames of 100 RoIs: a train step and an eval launch); the
          l2cs eval shape (448 px, 32 clips, bf16, frame_idx form); and
          the shapes the serving and demo paths give it at 224 px: the
          micro-batcher's 1- and 8-clip buckets (bf16, identity form),
          the first chunk of a 33-frame request (bf16) and of the demo's
          20-frame track (f32), both frame_idx form.
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
          frames at 224 px), bf16 and f32 (3xTF32 on the tensor cores),
          on the full-width seeded model's folded weights and the
          activations its plain backbone feeds each chain: error and
          tolerance (f32: both sides also against the chain in float64),
          kernel, plain and plain-Bottleneck ms, the bound (f32 at 3xTF32's
          165 TFLOP/s, and at the 67 of the FMA body it replaced), the
          per-launch floor, TFLOP/s and share of the peak, the f32 weight
          split's ms, and the library's ms (one cuDNN F.conv2d per
          convolution, summed); and the autograd Function's gradients of
          x and of every conv and BN parameter against autograd of the
          plain version
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
          within twice cuDNN's own f32 error plus TOL_E2E; then the fused
          f32 step at the shipped 32 clips (one warm step, two timed),
          beside the plain train phase's step, reported
  cli     the eval entry points on the train phase's ckpt_3.pth, on two
          fabricated videos (60 and 33 frames) decoded by a .npy stand-in
          for _decode_video (the machine has no OpenCV, which cv2 and the
          native loader need): test_gaze360_gaze.main (gaze360 config,
          full width, bf16, 32 clips per forward, 224 px, no crop) and
          test.main --eval mae --l2cs (l2cs config, f32, 448 px), each with
          the launch counters reset before and read after (4 K1 per
          forward, no K3); results parse, one entry per frame, finite, unit
          gazes on frames one clip covers; both scorer CLIs on the gaze360
          results, the first also with --device; the device scorer within
          1e-3 deg of numpy, exact frame counts; one 448 px chunk in f32,
          TF32 off, through the kernel against roi_impl='mm' within
          TOL_E2E; frames/s of each CLI run
  serve   the serving stack on the train phase's ckpt_3.pth (gaze360
          config, full width, bf16, 224 px, no crop, max_batch 8):
          package_model -> resolve_package -> the serve CLI's processor;
          warmup timed per bucket; make_server in a thread on a free
          localhost port; /ping, /models, 404, 400; then the served
          traffic with the counters reset before and read after (K1
          exactly 4 launches per forward: identity form from the batcher,
          frame_idx form from the video path): a raw-image request equal
          to process_body in process at 1e-4, a lone and a concurrent
          round of 8 7-frame JSON requests, an 8 s closed-loop window of 8
          clients (every response finite with unit gazes, the batcher
          fusing more than one clip; latency percentiles over all its
          requests, requests/s over the window), two 33-frame requests
          equal to run_video. In f32 with TF32 off: a concurrent round,
          each response against its lone response with roi_impl='mm', and
          an 8-clip bucket through the batcher against the same bucket
          through the plain version, within TOL_E2E. Request images are
          .npy bytes decoded by a stand-in for decode_image_bytes (no
          OpenCV on this machine)
  export  export_model.main --selftest at one clip (EXPORT_DTYPE) on the
          same checkpoint; the saved program loaded back launches K1 once
          per stage (the mcgaze::roi_align_fpn operator's CUDA kernel);
          the fused configuration refuses to export
  demo    HeadDetector at YOLOv5m's width (640 px, seeded random weights)
          on 8 fabricated 640x480 frames: boxes finite, in the frame, at
          most max_det; ms per batch of 8, the NMS's kernels per batch;
          then gaze_demo's gaze step (read_labels -> group_segments ->
          square_crop -> run_video) on fabricated labels with 224 px
          crops, 4 K1 launches per forward, unit fused gazes
  instblink_train  the InstBlink R-50 config at full width (4 clips x 11
          frames on the 384x640 canvas, 100 queries, 6 stages, f32, cuDNN
          TF32 on) through train_instblink.main --synthetic for 3 steps,
          counters reset before and read after (6 K1 and 6 K3 launches per
          step); finite losses; ms per step (median of 4 after a warm
          step), the host ms of the matching solves per step, peak memory;
          one profiled step: idle share, K1 and K3 ms per step. Writes the
          ckpt_3.pth the next phase reads
  instblink_eval  test_instblink.main --eval on that checkpoint over two
          fabricated MPEblink-form videos (40 and 23 frames of 640x360, two
          face tracks with blink events) decoded by a .npy stand-in (no
          OpenCV on this machine), counters reset before and read after (6
          K1 per forward, 8 windows of 11 frames a forward, no K3); tracks
          finite, one box per frame, blink probabilities in [0, 1];
          frames/s and the track and blink AP (random weights: they show
          the scorer ran); one window in f32, TF32 off, stage by stage
          (query_window_check): K1 against the plain RoIAlign on each
          stage's inputs at TOL_F32_REL, the stage head fed either at
          TOL_E2E, and the composed roi_impl='mm' forward's error per stage
          reported
  tevit_kernel, tevit_train, tevit_eval  K1 and K3 at TeViT's shapes, and
          the two instblink phases above with the TeViT config
  ddp     the gaze train CLI and tools.test under an NCCL group of one
          process against the same runs without it (phase_ddp)
  tp      tensor parallelism, the 'model' mesh axis, at full width, f32,
          TF32 off: the gaze train step at --mesh 1,2 in two processes
          against --mesh 1,1, across two cards under NCCL (the train CLI)
          where two are visible, else sharing the one card over gloo (the
          library step); 4 K1 and 4 K3 a step in each process, the first
          loss and grad_norm and the gathered parameters within the JAX
          package's 1x2 bounds, the replicated parameters bit for bit
          equal on both ranks, the seeded model gathered from its slices
          bit for bit the one-process model and tools.test's results on
          it those of the 1,1 one, tools.test on the trained tp
          checkpoint finite (its distance reported); ms per step at both
          meshes, labelled with the form, and each process's peak memory
          (phase_tp)
  tools   the port's measurement tools through their main(argv), full
          width, few iterations: collect_env (the card, the built
          kernels), benchmark (synthetic; --e2e on the fused
          configuration: K1, K4, K5), dedup_bench (and fwd_dedup against
          fwd at TOL_E2E, f32, TF32 off), backbone_bench (K5 in each fused
          subset's stages only), step_breakdown (gaze and InstBlink),
          get_flops (plain and fused forwards within 1%, the train step;
          a launch outside a counted operator fails), train_bench (step
          and --e2e), serve_bench (engine), the train CLI's --profile-dir
          (a trace naming K1 and K3), analyze_logs and roi_kernel_check
          (K1 and K3 through both routes at its two shapes); each tool's
          launch counts equal to what its arguments make it launch, every
          number it prints finite; the readings beside the card
          (phase_tools)
  learning  the learning proofs at the JAX tools' counts, f32, TF32 off:
          tools.analysis_tools.crop_sensitivity (gaze: 1500 steps on 20
          fabricated videos, scored with the fixed and the reference crop)
          and, side by side in a process of its own (both are host-bound),
          tools.analysis_tools.instblink_burnin (600 steps, scored at its
          first and last checkpoint), through the port's train and eval
          CLIs on .npy frames (npy_frames: no OpenCV on this machine); the
          counters reset before and read after each CLI run: K1 and K3 once
          per stage on every train step, K1 once per stage on every eval
          forward; finite metrics inside the band a model that learned
          clears (phase_learning); seconds of each tool, ms per step
  tp_learned  the model axis on learned weights: the gaze proof's last
          checkpoint trained 2 more steps through the train CLI's
          --resume-from at --mesh 1,1 and at --mesh 1,2 (two processes,
          tp's form), 2 K1 and 2 K3 a step in each; tools.test on the two
          checkpoints within TP_LEARNED_TOL (1e-3) of each other, no box on
          one side only; the parameters against the JAX 1x2 bounds
          reported (phase_tp_learned, at the end of learning)
Then the `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.

Exits with code 2 and prints nothing on stdout without a CUDA card.
"""
import collections
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
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


# readings a later phase sizes itself by (the train phase's peak memory)
READINGS = {}
T_START = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({'phase': phase, **kw,
                      'script_s': time.perf_counter() - T_START}),
          flush=True)


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


def video_sel(frames, clip_batch=8, t=7, stride=4):
    """The slot -> frame map of the first chunk VideoGazeEvaluator sends
    a video of `frames` frames to the forward's .dedup: its clips padded
    to a power of two (at most clip_batch) by repeating the last one,
    over a window of stride * (k_pad - 1) + t frames. Returns (map,
    window)."""
    from mcgaze_tpu_torch.evaluation.driver import clip_slices
    starts = [s[0] for s in clip_slices(frames, t, stride)][:clip_batch]
    k_pad = min(clip_batch, 1 << (len(starts) - 1).bit_length())
    starts += [starts[-1]] * (k_pad - len(starts))
    return (np.concatenate([np.arange(s - starts[0], s - starts[0] + t)
                            for s in starts]).astype(np.int32),
            stride * (k_pad - 1) + t)


def device_normal(rng, shape, device, dtype):
    """N(0, 1) values of `shape` drawn on `device` from a seed taken
    off the numpy stream: a host draw of a 384x640 pyramid for 88 frames
    (460M values) takes tens of seconds of the script's time limit."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng.randint(2 ** 31)))
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def make_pyramid(rng, u, img_hw, c, device, dtype):
    return tuple(device_normal(rng, (u, img_hw[0] // s, img_hw[1] // s, c),
                               device, dtype) for s in (4, 8, 16, 32))


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


def bound(nbytes, flops, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or F32_FLOPS) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def e2e_err(x, y):
    """Forward outputs (boxes, scores, gazes) against a reference's: boxes
    relative to their largest coordinate (x1 = cx - w/2 of a box thousands
    of px wide cancels), scores and gazes absolute."""
    box = ((x[0] - y[0]).abs().max() / y[0].abs().max().clamp_min(1.0))
    return max(box.item(), (x[1] - y[1]).abs().max().item(),
               *((x[2][k] - y[2][k]).abs().max().item() for k in y[2]))


def box_deg_err(boxes, gazes, ref_boxes, ref_gazes):
    """(box error relative to the reference's largest coordinate, largest
    angle in degrees between a gaze and its reference), for a bf16 forward
    against an f32 one."""
    box = ((boxes.float() - ref_boxes.float()).abs().max()
           / ref_boxes.float().abs().max().clamp_min(1.0)).item()
    deg = 0.0
    for g, r in zip(gazes, ref_gazes):
        g, r = g.float(), r.float()
        cos = (g * r).sum(-1) / (g.norm(dim=-1) * r.norm(dim=-1))
        deg = max(deg, torch.rad2deg(torch.acos(cos.clamp(-1.0, 1.0)))
                  .max().item())
    return box, deg


# ------------------------------------------------------------------ phases

def default_k1_cases():
    """K1's cases on the paths before TeViT: the gaze eval shapes, R=100
    bf16, the InstBlink train and eval shapes, l2cs at 448 px, the
    serving and demo shapes."""
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
    # the InstBlink path's shapes, f32 identity form: a train step's 4
    # clips of 11 frames and an eval launch's 8 windows of 11
    for shape, frames in (('instblink_train', 44), ('instblink_eval', 88)):
        cases.append(dict(shape=shape, img=(384, 640), u=frames, n=frames,
                          r=100, dtype=torch.float32, fidx=None))
    # the l2cs eval setting: 448 px, no crop (level 0 is 112x112)
    cases.append(dict(shape='l2cs_eval', img=(448, 448),
                      u=int(sel.max()) + 1, n=len(sel), r=3,
                      dtype=torch.bfloat16, fidx=sel))
    # the serving and demo shapes at 224 px: the micro-batcher's identity
    # form at its smallest and largest bucket (1 and 8 clips, bf16; the
    # exported program runs the first), and the frame_idx form of the
    # first chunk of a 33-frame request (bf16) and of the demo's 20-frame
    # person track (f32)
    for clips in (1, 8):
        cases.append(dict(shape=f'serve_clips{clips}', img=(224, 224),
                          u=7 * clips, n=7 * clips, r=3,
                          dtype=torch.bfloat16, fidx=None))
    for shape, frames, dtype in (('serve_video', 33, torch.bfloat16),
                                 ('demo_video', 20, torch.float32)):
        vsel, window = video_sel(frames)
        cases.append(dict(shape=shape, img=(224, 224), u=window,
                          n=len(vsel), r=3,
                          dtype=dtype, fidx=vsel))
    return cases


def phase_kernel(device, timer, cases=None, phase='kernel', seed=0):
    """K1 against the plain RoIAlign, its ms, plain ms and bound, at each
    case (default: default_k1_cases)."""
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.ops.roi_align import roi_align_fpn_mm
    from mcgaze_tpu_torch.tools.kernel_bounds import roi_work

    rng = np.random.RandomState(seed)
    if cases is None:
        cases = default_k1_cases()
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
    emit(phase, cases=results)
    return results


def phase_kernel_bwd(device, timer, cases=None, phase='kernel_bwd',
                     seed=2):
    """At each case (default: the gaze train shapes and R=100), K3 against the plain version's autograd gradient at a random
    cotangent G, and the adjoint identity <K1(F), G> = sum_l <F_l, K3(G)_l>
    in f64 sums at G = K1(F); two launches bitwise equal; handed memory
    the allocator last filled with NaN, every cell finite and the cells no
    RoI reaches exactly 0; the launch's peak extra device memory at most
    1.1x its output."""
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.ops.roi_align import roi_align_fpn_mm
    from mcgaze_tpu_torch.tools.kernel_bounds import roi_bwd_work

    rng = np.random.RandomState(seed)
    sel = gaze_sel()
    if cases is None:
        cases = []
        for dtype in (torch.float32, torch.bfloat16):
            for form in ('identity', 'frame_idx'):
                u = len(sel) if form == 'identity' else int(sel.max()) + 1
                cases.append(dict(shape='gaze_train', img=(224, 224), u=u,
                                  n=len(sel), r=3, dtype=dtype,
                                  fidx=sel if form == 'frame_idx' else None))
            cases.append(dict(shape='query_r100', img=(384, 640), u=44,
                              n=44, r=100, dtype=dtype, fidx=None))
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
        g = device_normal(rng, (cs['n'], cs['r'], 7, 7, 256), device,
                          dtype)
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
    emit(phase, cases=results)
    return results


def phase_tevit_kernel(device, timer):
    """K1 and K3 at the TeViT shapes of the 384x640 canvas's pyramid, f32
    identity form, 100 RoIs a frame: K1 at a train step's 4 clips x 5
    frames (20) and an eval launch's 8 windows x 5 (40), K3 at 20; each
    against its plain version at the kernel phases' tolerances, with ms,
    plain ms and bound (phase_kernel, phase_kernel_bwd)."""
    shapes = (('tevit_train', 20), ('tevit_eval', 40))
    k1 = phase_kernel(device, timer, [
        dict(shape=shape, img=(384, 640), u=frames, n=frames, r=100,
             dtype=torch.float32, fidx=None) for shape, frames in shapes],
        phase='tevit_kernel', seed=10)
    k3 = phase_kernel_bwd(device, timer, [
        dict(shape='tevit_train', img=(384, 640), u=20, n=20, r=100,
             dtype=torch.float32, fidx=None)],
        phase='tevit_kernel_bwd', seed=12)
    return k1, k3


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

    dedup_err, plain_err = e2e_err(a, b), e2e_err(a, p)
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
    READINGS['train_peak_bytes'] = torch.cuda.max_memory_allocated()
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
    # the checkpoint stays for the cli phase, which removes work_dir
    return launches, lambda: step_fn(state, batch), step_ms, out['checkpoint']


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
    from mcgaze_tpu_torch.tools.kernel_bounds import roi_work
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

def host_us(fn, calls=200, reps=5):
    """Host microseconds per call of fn: `calls` calls queued back to back
    (the device keeps up or the queue absorbs them), then one sync,
    median of `reps`; and the median of 30 calls each synchronised."""
    fn()
    torch.cuda.synchronize()
    queued, synced = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queued.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    for _ in range(30):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e6)
    return dict(queued=float(np.median(queued)),
                synced=float(np.median(synced)),
                synced_iqr=float(np.subtract(*np.percentile(synced,
                                                            [75, 25]))))


def phase_kernel_k4(device, timer):
    """K4 against stqi_attention_reference on the card, f32: the eval shape
    (32 clips), one clip, and 3 heads of 32 channels (a cluster of 3);
    clip 0 unchanged when the others move; the cluster plan. At the two
    8-head shapes, the host us per call of the bare launch and of the
    eager mcgaze::stqi_attention operator (host_us)."""
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
        dispatch = {}
        if heads == 8:
            # host cost of the eager operator against the bare launch
            dispatch = dict(
                launch=host_us(lambda: stqi_attention.launch_stqi_attention(
                    query, *w, t, heads)),
                operator=host_us(lambda: torch.ops.mcgaze.stqi_attention(
                    query, *w, t, heads)))
        results.append(dict(dispatch_us=dispatch,
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
    from mcgaze_tpu_torch.tools.kernel_bounds import (K5_PEAK, PEAKS,
                                                      chains, k5_bound,
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
            f64 = {}
            if dtype == torch.float32:
                # both f32 sides against the chain in float64, relative
                # to max|plain|: the kernel's 3xTF32 beside the plain
                # version's f32 products (reported)
                with torch.inference_mode():
                    exact = fb.chain_reference(
                        xin.double(), [t.double() for t in weights], h, w)
                f64 = dict(kernel_vs_f64=(got.double() - exact).abs().max()
                           .item() / scale,
                           plain_vs_f64=(ref.double() - exact).abs().max()
                           .item() / scale)
                del exact
            del got, ref
            reps = 10

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
                # f32: the share of k_ms that splits the weights (tf32_split,
                # plain torch on every call)
                split_ms = timer.ms(lambda: [
                    fb.tf32_split(a) for a in weights[::2]],
                    reps=reps) if dtype == torch.float32 else None
            b = k5_bound(frames, spec, name)
            fl = k5_launch_floor(frames, spec, name)
            fma = (k5_bound(frames, spec, name, peak='float32')
                   if dtype == torch.float32 else None)
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
                peak=K5_PEAK[name],
                peak_share=b['flops'] * 1e3 / k_ms / PEAKS[K5_PEAK[name]],
                bound_fma_ms=fma and fma['bound_ms'], split_ms=split_ms,
                **f64, library_ms=lib_ms,
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

    dedup_err, plain_err = e2e_err(a, b), e2e_err(a, p)
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
        return box_deg_err(x[0], [x[2][k] for k in p[2]], p[0],
                           [p[2][k] for k in p[2]])

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


def phase_train_fused(device, plain_step_ms=None):
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
    are printed, unchecked.

    Then the fused f32 step at the shipped batch (32 clips), card
    defaults: one warm step and two timed (host clock ending in a sync),
    its K5 launches and peak memory, reported beside the plain train
    phase's step (`plain_step_ms`), unchecked."""
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

    # the fused f32 step at the shipped batch, card defaults
    from mcgaze_tpu_torch.ops import fused_bottleneck
    full = load_config(TRAIN_CONFIG)
    model = init_model(dataclasses.replace(full.model, backbone_impl='fused'),
                       seed=0, device=device)
    st = loop.create_train_state(model.cfg, full.optim, model=model)
    step_fn = loop.make_train_step(model.cfg, full.optim)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(synthetic_batches(full, seed=4)).items()}
    torch.cuda.reset_peak_memory_stats()
    before = fused_bottleneck.launch_count
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = step_fn(st, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    k5_timed = fused_bottleneck.launch_count - before
    check(np.isfinite(float(logs['loss'])), 'fused f32 step at the shipped '
          'batch: the loss is not finite')
    emit('train_fused_step', clips=full.data_train.batch_size,
         step_ms=float(np.median(walls[1:])), step_ms_all=walls,
         plain_step_ms=plain_step_ms, k5_launches=k5_timed,
         k5_per_step=per_forward,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         note='fused backbone (K5 3xTF32 forward, autograd of '
              'chain_reference backward), f32, card defaults (cuDNN TF32 '
              'on); one warm step, the median of two timed; plain_step_ms '
              'is the train phase\'s median of 6', card=nvidia_smi())
    del st, model, batch, step_fn
    torch.cuda.empty_cache()
    return launches


NPY_DECODE = 'npy stand-in (no OpenCV on this machine)'


def npy_decode(self, paths, video_id):
    """VideoGazeEvaluator._decode_video for frames stored as .npy at the
    eval scale: the card's machine has no OpenCV, so neither cv2 nor the
    native loader (which links it) can decode there. The frames go through
    the driver's own u8 preprocessing, as the native u8 path's do."""
    from mcgaze_tpu_torch.evaluation.driver import (crop_ratios,
                                                    preprocess_frames_u8)
    frames = [np.load(p) for p in paths]
    imgs, whwh, sfs = preprocess_frames_u8(
        frames, self.cfg, crop_ratios(self.cfg, len(frames), video_id))
    self.decoder = NPY_DECODE
    return imgs, whwh, sfs, len(frames)


def write_cli_dataset(root, lengths=(60, 33), seed=7):
    """Two fabricated videos as .npy frames at 224 and at 448 px, and the
    annotation JSONs of both layouts (gaze360: one gaze row per video;
    l2cs: three). Returns {layout: (json path, frames root)}."""
    rng = np.random.RandomState(seed)
    videos, rows, rows3 = [], [], []
    for vid, n in enumerate(lengths, 1):
        names = [f'{vid:03d}/{f:05d}.npy' for f in range(n)]
        videos.append(dict(id=vid, width=224, height=224, length=n,
                           file_names=names))
        tracks = []
        for _ in range(3):
            g = rng.randn(n, 3)
            g[:, 2] = -np.abs(g[:, 2])
            tracks.append((g / np.linalg.norm(g, axis=1,
                                              keepdims=True)).tolist())
        rows.append(dict(video_id=vid, gaze=tracks[0]))
        rows3.extend(dict(video_id=vid, gaze=t) for t in tracks)
    out = {}
    for layout, size, annotations in (('gaze360', 224, rows),
                                      ('l2cs', 448, rows3)):
        frames = os.path.join(root, f'frames_{size}')
        for v in videos:
            os.makedirs(os.path.join(frames, f'{v["id"]:03d}'))
            for name in v['file_names']:
                np.save(os.path.join(frames, name),
                        rng.randint(0, 256, (size, size, 3), np.uint8))
        ann = os.path.join(root, f'test_{layout}.json')
        with open(ann, 'w') as f:
            json.dump(dict(videos=[dict(v, width=size, height=size)
                                   for v in videos],
                           annotations=annotations), f)
        out[layout] = (ann, frames + '/')
    return out


def check_results(path, lengths, dtype, clip_len=7, stride=4):
    """A results file: parses, one entry per frame, finite; fusion and clue
    gazes unit vectors on the frames one clip covers (stitching averages
    the others), none longer than unit. Returns the largest |norm - 1|."""
    from mcgaze_tpu_torch.evaluation.driver import clip_slices
    with open(path) as f:
        results = json.load(f)
    check(len(results) == len(lengths), f'{path}: {len(results)} videos')
    tol = 2e-2 if dtype == 'bfloat16' else 1e-4
    worst = 0.0
    for r, n in zip(results, lengths):
        covered = np.zeros(n, int)
        for start, length, _ in clip_slices(n, clip_len, stride):
            covered[start:start + length] += 1
        for key in ('fusion_gazes', 'face_gazes', 'eyes_gazes',
                    'head_gazes', 'face_score', 'eyes_score', 'head_score',
                    'face_bboxes', 'eyes_bboxes', 'head_bboxes'):
            check(len(r[key]) == n, f'{path}: {key} has {len(r[key])} '
                  f'entries for {n} frames')
        vals = [r[k] for k in r if k.endswith(('_gazes', '_score'))] + [
            b for k in r if k.endswith('_bboxes') for b in r[k]
            if b is not None]
        check(all(np.isfinite(np.asarray(v, np.float64)).all()
                  for v in vals), f'{path}: non-finite results')
        for k in ('fusion_gazes', 'face_gazes', 'eyes_gazes', 'head_gazes'):
            norms = np.linalg.norm(np.asarray(r[k], np.float64), axis=1)
            check((norms <= 1 + tol).all(), f'{path}: {k} longer than unit')
            one = np.abs(norms[covered == 1] - 1)
            worst = max(worst, float(one.max()))
            check(worst <= tol, f'{path}: {k} not unit ({worst})')
    return results, worst


def phase_cli(device, checkpoint):
    """The eval entry points at full width, as a user runs them, on the
    train phase's ckpt_3.pth: test_gaze360_gaze.main (gaze360 config,
    bf16, 32 clips per forward, 224 px, no crop) and test.main --eval mae
    --l2cs (l2cs config, f32, 448 px), on two fabricated videos decoded by
    the .npy stand-in; then both scorer CLIs on the gaze360 results, the
    first also with --device. K1 launched 4 times per forward of each run,
    K3 never; results parse, finite, one entry per frame, unit gazes; one
    448 px chunk in f32 (TF32 off) through the kernel against
    roi_impl='mm'; the device scorer within 1e-3 deg of numpy with exact
    frame counts."""
    import io
    import shutil

    from mcgaze_tpu_torch.evaluation.driver import (VideoGazeEvaluator,
                                                    clip_slices)
    from mcgaze_tpu_torch.evaluation.forward import make_eval_forward
    from mcgaze_tpu_torch.evaluation.mae import gaze_error
    from mcgaze_tpu_torch.evaluation.mae_device import gaze_error_device
    from mcgaze_tpu_torch.models.mcgaze import MCGazeModel
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.tools import (calculate_mae_gaze360,
                                        calculate_mae_l2cs)
    from mcgaze_tpu_torch.tools import test as test_cli
    from mcgaze_tpu_torch.tools import test_gaze360_gaze as gaze_cli
    from mcgaze_tpu_torch.utils.config import load_config

    l2cs_config = os.path.join(ROOT, 'configs', 'multiclue_gaze',
                               'multiclue_gaze_r50_l2cs.py')
    root = os.path.join(ROOT, 'work_dirs', 'chip_smoke_cli')
    shutil.rmtree(root, ignore_errors=True)
    lengths = (60, 33)
    data = write_cli_dataset(root, lengths)

    def forwards(clip_batch):
        return sum(-(-len(clip_slices(n, 7, 4)) // clip_batch)
                   for n in lengths)

    runs = {}
    decode = VideoGazeEvaluator._decode_video
    VideoGazeEvaluator._decode_video = npy_decode
    try:
        for name, main, (ann, frames), argv, clip_batch, dtype in (
                ('eval_cli', gaze_cli.main, data['gaze360'],
                 [TRAIN_CONFIG, checkpoint, '--out-dir',
                  os.path.join(root, 'results'), '--dtype', 'bfloat16',
                  '--clip-batch', '32', '--cfg-options',
                  'eval_cfg.crop_ratio=None'], 32, 'bfloat16'),
                ('eval_cli_l2cs', test_cli.main, data['l2cs'],
                 [l2cs_config, checkpoint, '--eval', 'mae', '--l2cs',
                  '--out', os.path.join(root, 'results_l2cs.json')], 8,
                 'float32')):
            roi_align_cuda.launch_count = 0
            roi_align_cuda.bwd_launch_count = 0
            out = main(argv + ['--json', ann, '--root', frames])
            torch.cuda.synchronize()
            launches = dict(k1=roi_align_cuda.launch_count,
                            k3=roi_align_cuda.bwd_launch_count)
            expected = 4 * forwards(clip_batch)
            check(launches == dict(k1=expected, k3=0), f'{name} launched '
                  f'{launches}, expected {expected} K1 (4 per forward) and '
                  'no K3')
            check(out['evaluator'].decoder == NPY_DECODE,
                  f'{name} decoded with {out["evaluator"].decoder}')
            path = out.get('path') or argv[argv.index('--out') + 1]
            results, norm_err = check_results(path, lengths, dtype)
            frames_n = sum(lengths)
            runs[name] = dict(
                config=os.path.relpath(argv[0], ROOT), dtype=dtype,
                clip_batch=clip_batch, forwards=forwards(clip_batch),
                launches=launches, frames=frames_n, seconds=out['seconds'],
                frames_per_s=frames_n / out['seconds'],
                gaze_norm_err=norm_err, metrics=out.get('metrics'),
                results=path, annotations=ann)
    finally:
        VideoGazeEvaluator._decode_video = decode

    # the scorer CLIs on the gaze360 results: plain, on the card, l2cs
    scorer_lines = {}
    gaze_res = runs['eval_cli']['results']
    for key, main, argv in (
            ('gaze360', calculate_mae_gaze360.main,
             ['--evalfile', gaze_res, '--anno', data['gaze360'][0]]),
            ('gaze360_device', calculate_mae_gaze360.main,
             ['--evalfile', gaze_res, '--anno', data['gaze360'][0],
              '--device']),
            ('l2cs', calculate_mae_l2cs.main,
             ['--evalfile', gaze_res, '--anno', data['l2cs'][0]])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        scorer_lines[key] = buf.getvalue().splitlines()
        check(len(scorer_lines[key]) == 3, f'scorer {key} printed '
              f'{scorer_lines[key]}')

    # the device scorer against numpy, every bucket, both layouts
    with open(gaze_res) as f:
        results = json.load(f)
    scorer_err = 0.0
    for layout, smooth, l2cs in (('gaze360', True, False),
                                 ('gaze360', False, False),
                                 ('l2cs', True, True)):
        with open(data[layout][0]) as f:
            anno = json.load(f)
        a = gaze_error(results, anno, smooth=smooth, l2cs=l2cs)
        b = gaze_error_device(results, anno, smooth=smooth, l2cs=l2cs,
                              device=device)
        check(a['frames'] == b['frames'] == sum(lengths),
              f'device scorer frames {b["frames"]} != {a["frames"]}')
        scorer_err = max(scorer_err, *(abs(a[k] - b[k]) for k in
                                       ('mae360', 'front90', 'front20')))
    check(scorer_err <= 1e-3, f'device scorer vs numpy: {scorer_err} deg')

    # one 448 px chunk of the l2cs video, f32, TF32 off: the kernel against
    # the plain RoIAlign end to end, on the checkpoint's weights
    cfg = load_config(l2cs_config)
    model = MCGazeModel(cfg.model)
    gaze_cli.load_weights(model, checkpoint)
    model = model.to(device).eval()
    _, _, fwd_dedup = make_eval_forward(cfg.model, device=device,
                                        model=model)
    sel = gaze_sel(k=8)
    with open(data['l2cs'][0]) as f:
        video = json.load(f)['videos'][0]
    u8 = torch.from_numpy(np.stack([
        np.load(os.path.join(data['l2cs'][1], name))
        for name in video['file_names'][:int(sel.max()) + 1]])).to(device)
    whwh = torch.full((u8.shape[0], 4), 448.0, device=device)
    sel_t = torch.from_numpy(sel).to(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    a = fwd_dedup(u8, sel_t, whwh, 7)
    model.cfg = dataclasses.replace(cfg.model, roi_impl='mm')
    p = fwd_dedup(u8, sel_t, whwh, 7)
    torch.backends.cudnn.allow_tf32 = True
    chunk_err = e2e_err(a, p)
    check(chunk_err <= TOL_E2E, f'448 px chunk, kernel vs plain RoIAlign '
          f'end to end: {chunk_err}')
    del model, a, p, u8
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(os.path.dirname(checkpoint), ignore_errors=True)

    emit('cli', decode=NPY_DECODE,
         checkpoint=f'train phase {os.path.basename(checkpoint)}',
         videos=list(lengths),
         runs={k: {kk: vv for kk, vv in v.items()
                   if kk not in ('results', 'annotations')}
               for k, v in runs.items()},
         scorer_lines=scorer_lines, device_scorer_max_err_deg=scorer_err,
         l2cs_chunk_kernel_vs_plain_e2e_err=chunk_err, tol_e2e=TOL_E2E,
         card=nvidia_smi())
    return {k: v['launches']['k1'] for k, v in runs.items()}


# ------------------------------------------- serving, export and the demo

SERVE_DECODE = 'npy stand-in for decode_image_bytes (no OpenCV on this machine)'
TOL_BF16 = 2e-2   # the slice phase's bf16 tolerance, on O(1) outputs


def post(port, path, body=None, ctype=None, method='POST'):
    """(status, parsed JSON, seconds) of one localhost request."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=body, method=method,
        headers={'Content-Type': ctype} if ctype else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, data = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, data = e.code, e.read()
    return status, json.loads(data), time.perf_counter() - t0


def entries_err(a: list, b: list) -> dict:
    """Two handler-style entry lists (every clue present): the largest
    bbox error relative to b's largest coordinate, score and gaze errors
    absolute."""
    check([e['class_name'] for e in a] == [e['class_name'] for e in b],
          f'entries {[e["class_name"] for e in a]} vs '
          f'{[e["class_name"] for e in b]}')
    err = dict(bbox=0.0, score=0.0, gaze=0.0)
    for x, y in zip(a, b):
        if 'bbox' in y:
            scale = max(float(np.abs(y['bbox']).max()), 1.0)
            err['bbox'] = max(err['bbox'], float(np.abs(np.subtract(
                x['bbox'], y['bbox'])).max()) / scale)
            err['score'] = max(err['score'], abs(x['score'] - y['score']))
        err['gaze'] = max(err['gaze'], float(np.abs(np.subtract(
            x['gaze'], y['gaze'])).max()))
    return err


def check_entries(entries: list, tol: float):
    """Finite boxes and scores, gazes unit within tol."""
    for e in entries:
        vals = [e['gaze']] + [e[k] for k in ('bbox', 'score') if k in e]
        check(all(np.isfinite(np.asarray(v, np.float64)).all()
                  for v in vals), f'non-finite entry {e}')
        norm = float(np.linalg.norm(e['gaze']))
        check(abs(norm - 1) <= tol, f'{e["class_name"]} gaze norm {norm}')


def serve_in_thread(proc):
    """make_server(proc) on a free localhost port, served from a thread.
    Returns (server, port, thread)."""
    import threading

    from mcgaze_tpu_torch.evaluation import serving
    server = serving.make_server(proc, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1], thread


def stop_server(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(30)


def concurrent_round(port, bodies, seconds=None):
    """One client thread per body, started together, each posting its
    body once, or back to back (closed loop) until `seconds` have passed
    since the start (its last request starts before then). Returns (per
    client [(status, response, seconds)], wall seconds from the start
    until the last response)."""
    import threading
    results = [[] for _ in bodies]
    barrier = threading.Barrier(len(bodies))

    def client(i):
        barrier.wait()
        while not results[i] or time.perf_counter() < end:
            results[i].append(post(port, '/predictions/mcgaze', bodies[i],
                                   'application/json'))

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(len(bodies))]
    t0 = time.perf_counter()
    end = t0 + (seconds or 0.0)
    for th in ths:
        th.start()
    for th in ths:
        th.join(600)
        check(not th.is_alive(), 'a client thread hung')
    wall = time.perf_counter() - t0
    check(all(results), 'a client got no response')
    for res in results:
        for status, resp, _ in res:
            check(status == 200, f'concurrent: {status} {resp}')
    return results, wall


def clip_err(resp, ref, tol):
    """A clip response against a reference one: {bbox, score, gaze}
    largest errors; every entry finite with unit gazes (within tol)."""
    check(len(resp['frames']) == len(ref['frames']), 'frames in a reply')
    err = dict(bbox=0.0, score=0.0, gaze=0.0)
    for a, b in zip(resp['frames'], ref['frames']):
        check_entries(a, tol)
        for k, v in entries_err(a, b).items():
            err[k] = max(err[k], v)
    return err


SERVE_WINDOW_S = 8.0    # the closed-loop window the serving rate is read on


def phase_serve(device, checkpoint, opts=(), dtype='bfloat16',
                window_s=SERVE_WINDOW_S):
    """The serving stack at full width (shipped gaze360 config: R50, C=256,
    FFN 2048, 4 stages, `dtype`, 224 px, no crop, max_batch 8) on the
    train phase's ckpt_3.pth: package_model -> resolve_package -> the
    serve CLI's processor; warmup, timed per bucket; make_server in a
    thread on a free localhost port. /ping, /models, 404, 400. The served
    traffic, with the counters reset before and read after (K1 exactly 4
    launches per forward): one raw-image request, equal to process_body
    in process at 1e-4; one lone 7-frame JSON request per client; one
    round of 8 concurrent clients; then a closed-loop window of
    `window_s` seconds, 8 client threads posting 7-frame JSON requests
    back to back (latency percentiles over all its requests, requests/s
    over the window), the batcher fusing more than one clip, every
    response finite with unit gazes; two 33-frame requests, each equal to
    VideoGazeEvaluator.run_video on the same frames. Then, on float32
    processors of the same package with TF32 off (where the batch
    composition moves outputs by rounding only): one round of 8
    concurrent requests, each against its lone response on a processor
    whose RoIAlign is the plain version (roi_impl='mm'), and one 8-clip
    bucket through the batcher against the same bucket through the plain
    version's batcher, each within TOL_E2E. Request images are .npy
    bytes decoded by the stand-in for decode_image_bytes
    (tools/analysis_tools/npy_frames.py::npy_request_images)."""
    import base64
    import shutil

    from mcgaze_tpu_torch.evaluation import serving
    from mcgaze_tpu_torch.evaluation.driver import (VideoGazeEvaluator,
                                                    clip_slices)
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.tools.analysis_tools import npy_frames
    from mcgaze_tpu_torch.tools.analysis_tools.npy_frames import npy_bytes
    from mcgaze_tpu_torch.tools.deployment import (package_model, serve,
                                                   test_server)

    root = os.path.join(ROOT, 'work_dirs', 'chip_smoke_serve')
    shutil.rmtree(root, ignore_errors=True)
    pkg = package_model.main([TRAIN_CONFIG, checkpoint, '--output-folder',
                              root, '--model-name', 'mcgaze'])
    check(serving.resolve_package(pkg)[2] == 'mcgaze', 'package name')

    def processor(dt, *extra):
        return serve.build_processor(serve.parse_args(
            [pkg, '--dtype', dt, '--max-batch', '8', '--score-thr', '0.0',
             '--device', str(device), '--cfg-options',
             'eval_cfg.crop_ratio=None', *opts, *extra]))

    request_images = npy_frames.npy_request_images()
    request_images.__enter__()
    proc = processor(dtype)
    h, w = proc.eval_cfg.canvas
    rng = np.random.RandomState(11)

    def frames(n):
        return [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(n)]

    def json_body(fr):
        return json.dumps({'frames': [base64.b64encode(npy_bytes(f)).decode()
                                      for f in fr]}).encode()

    clients = 8
    bodies = [json_body(frames(7)) for _ in range(clients)]
    octet = 'application/octet-stream'
    proc32 = proc_mm = None
    try:
        t0 = time.perf_counter()
        warm = proc.warmup()
        warm_s = time.perf_counter() - t0
        warm_batches = len(proc.batcher.batch_sizes)
        server, port, thread = serve_in_thread(proc)
        try:
            check(post(port, '/ping', method='GET')[:2] ==
                  (200, {'status': 'Healthy'}), '/ping')
            status, models, _ = post(port, '/models', method='GET')
            check(status == 200 and models['models'][0]['modelName'] ==
                  'mcgaze', f'/models: {status} {models}')
            check(post(port, '/nope', method='GET')[0] == 404, 'GET 404')
            raw = npy_bytes(frames(1)[0])
            check(post(port, '/predictions/other', raw, octet)[0] == 404,
                  'POST 404')
            status, data, _ = post(port, '/predictions/mcgaze', b'garbage',
                                   octet)
            check(status == 400 and 'error' in data, f'400: {status}')

            # the main path: counts from zero, read right after
            reset_counters()
            status, lone_raw, first_s = post(port, '/predictions/mcgaze',
                                             raw, octet)
            check(status == 200, f'raw request: {status} {lone_raw}')
            lone_posts = [post(port, '/predictions/mcgaze', b,
                               'application/json') for b in bodies]
            check(all(p[0] == 200 for p in lone_posts), 'lone clips')
            concurrent_round(port, bodies)
            batches = len(proc.batcher.batch_sizes)
            results, window_wall = concurrent_round(port, bodies,
                                                    seconds=window_s)
            burst = proc.batcher.batch_sizes[batches:]
            long_body = json_body(frames(33))
            long_posts = [post(port, '/predictions/mcgaze', long_body,
                               'application/json') for _ in range(2)]
            torch.cuda.synchronize()
            launches = roi_align_cuda.launch_count
            check(all(p[0] == 200 for p in long_posts), 'long requests')
            chunks = -(-len(clip_slices(33, proc.eval_cfg.clip_length,
                                        proc.eval_cfg.stride))
                       // proc.eval_cfg.clip_batch)
            forwards = (len(proc.batcher.batch_sizes) - warm_batches +
                        len(long_posts) * chunks)
            check(launches == 4 * forwards, f'serve: K1 launched '
                  f'{launches} times, expected {4 * forwards} (4 per '
                  f'forward, {forwards} forwards)')
            check(roi_align_cuda.bwd_launch_count == 0, 'serve launched K3')
        finally:
            stop_server(server, thread)
        local = proc.process_body(raw, octet)
        raw_err = test_server.assert_same(local, lone_raw, 1e-4)
        check_entries(lone_raw, TOL_BF16)
        check(max(burst) > 1, f'the batcher never fused clips: {burst}')
        for res in results:
            for _, resp, _ in res:
                check(len(resp['frames']) == 7, 'frames in a reply')
                for entries in resp['frames']:
                    check_entries(entries, TOL_BF16)
        lat_ms = np.asarray([sec for res in results
                             for _, _, sec in res]) * 1e3
        long_frames = [np.load(io.BytesIO(base64.b64decode(f)))
                       for f in json.loads(long_body)['frames']]
        ref = VideoGazeEvaluator(proc.evaluator.forward,
                                 proc.eval_cfg).run_video(long_frames, 0)
        long_err = 0.0
        for long_resp in (p[1] for p in long_posts):
            for key in ref:
                if key.endswith(('_gazes', '_score')):
                    long_err = max(long_err, float(np.abs(
                        np.subtract(long_resp[key], ref[key])).max()))
                elif key.endswith('_bboxes'):
                    check([b is None for b in long_resp[key]] ==
                          [b is None for b in ref[key]], f'{key} None')
                    pairs = [(a, b) for a, b in zip(long_resp[key], ref[key])
                             if b is not None]
                    if pairs:
                        long_err = max(long_err, float(np.abs(np.subtract(
                            *zip(*pairs))).max()))
        check(long_err <= 1e-5, f'long requests vs run_video: {long_err}')

        # float32, TF32 off: the served responses and one 8-clip bucket
        # against the plain RoIAlign's on the same package
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            proc32 = processor('float32')
            proc_mm = processor('float32', 'model.roi_impl=mm')
            lone_mm = [proc_mm.process_body(b, 'application/json')
                       for b in bodies]
            reset_counters()
            server, port, thread = serve_in_thread(proc32)
            try:
                results32, _ = concurrent_round(port, bodies)
            finally:
                stop_server(server, thread)
            burst32 = list(proc32.batcher.batch_sizes)
            clips = [proc32._preprocess(serving.parse_request_body(
                b, 'application/json')) for b in bodies]
            imgs = np.concatenate([c[0] for c in clips])
            whwh = np.concatenate([c[1] for c in clips])
            bucket = proc32.batcher.run_bucket(imgs, whwh)
            torch.cuda.synchronize()
            launches32 = roi_align_cuda.launch_count
            bucket_mm = proc_mm.batcher.run_bucket(imgs, whwh)
        finally:
            torch.backends.cudnn.allow_tf32 = True
        forwards32 = len(proc32.batcher.batch_sizes)
        check(launches32 == 4 * forwards32, f'serve f32: K1 launched '
              f'{launches32} times, expected {4 * forwards32}')
        check(max(burst32) > 1, f'f32: the batcher never fused: {burst32}')
        served_mm_err = dict(bbox=0.0, score=0.0, gaze=0.0)
        for res, ref_mm in zip(results32, lone_mm):
            for _, resp, _ in res:
                for k, v in clip_err(resp, ref_mm, 1e-4).items():
                    served_mm_err[k] = max(served_mm_err[k], v)
        bucket_mm_err = dict(
            bbox=float(np.abs(bucket[0] - bucket_mm[0]).max() /
                       max(np.abs(bucket_mm[0]).max(), 1.0)),
            score=float(np.abs(bucket[1] - bucket_mm[1]).max()),
            gaze=max(float(np.abs(bucket[2][n] - bucket_mm[2][n]).max())
                     for n in bucket_mm[2]))
        for what, err in (('concurrent responses vs lone plain-RoIAlign '
                           'ones', served_mm_err),
                          ('8-clip bucket vs the plain RoIAlign',
                           bucket_mm_err)):
            check(max(err.values()) <= TOL_E2E, f'serve f32, TF32 off: '
                  f'{what}: {err} (tolerance {TOL_E2E})')
    finally:
        for p in (proc, proc32, proc_mm):
            if p is not None:
                p.close()
        request_images.__exit__(None, None, None)
        shutil.rmtree(root, ignore_errors=True)
    del proc, proc32, proc_mm
    torch.cuda.empty_cache()
    emit('serve', decode=SERVE_DECODE, checkpoint='train phase ckpt_3.pth',
         config=f'gaze360, R50 full width, {dtype}, 224 px, no crop',
         max_batch=8, warmup_s=warm_s, warmup_s_by_bucket=warm,
         first_request_ms=first_s * 1e3, raw_vs_local_err=raw_err,
         lone_clip_ms=[p[2] * 1e3 for p in lone_posts],
         window_s=window_s, window_clients=clients,
         window_requests=len(lat_ms), window_wall_s=window_wall,
         window_requests_per_s=len(lat_ms) / window_wall,
         window_p50_ms=float(np.percentile(lat_ms, 50)),
         window_p90_ms=float(np.percentile(lat_ms, 90)),
         window_p99_ms=float(np.percentile(lat_ms, 99)),
         window_max_ms=float(lat_ms.max()),
         window_batch_sizes=dict(sorted(collections.Counter(burst)
                                        .items())),
         long_request_ms=[p[2] * 1e3 for p in long_posts],
         long_vs_run_video_err=long_err, forwards=forwards,
         k1_launches=launches,
         f32_tf32_off_concurrent_vs_lone_mm_err=served_mm_err,
         f32_tf32_off_bucket8_vs_mm_err=bucket_mm_err,
         f32_batch_sizes=burst32, f32_k1_launches=launches32,
         tol_e2e=TOL_E2E, card=nvidia_smi())
    return launches


EXPORT_DTYPE = 'bfloat16'
FUSED_OPTS = ('model.backbone_impl=fused', 'model.fused_attention=True')


def export_err(x, y):
    """Exported outputs (boxes, scores, 4 gazes) against a reference's:
    boxes relative to their largest coordinate, the rest absolute."""
    box = ((x[0].float() - y[0].float()).abs().max()
           / y[0].float().abs().max().clamp_min(1.0)).item()
    return max(box, *((a.float() - b.float()).abs().max().item()
                      for a, b in zip(x[1:], y[1:])))


def f32_forward(cfg, checkpoint, device):
    """The plain configuration's eager ClipForward in f32 on the weights
    of `checkpoint`, frozen, as export_model builds its forward."""
    from mcgaze_tpu_torch.models.mcgaze import MCGazeModel
    from mcgaze_tpu_torch.tools.deployment.export_model import ClipForward
    from mcgaze_tpu_torch.tools.test_gaze360_gaze import load_weights

    model = MCGazeModel(dataclasses.replace(cfg.model, dtype='float32'))
    load_weights(model, checkpoint)
    model = model.to(device).eval().requires_grad_(False)
    return ClipForward(model, cfg.model.clip_length).eval()


def phase_export(device, checkpoint, opts=()):
    """export_model.main --selftest at --batch-clips 1 on the train
    phase's ckpt_3.pth (full width, 224 px): the plain and the fused
    configuration in EXPORT_DTYPE, and the fused one again in f32. Each
    saved program, loaded back, runs once with the counters from zero: the
    plain one launches K1 once per stage; each fused one K1 and K4 once
    per stage and K5 as often as one eager fused forward does. Outputs
    finite with unit gazes; each fused program against its eager forward
    at the selftest tolerance; the f32 fused program (TF32 off) against
    the plain configuration's f32 forward on the same weights at TOL_E2E.
    The bf16 programs' errors against that forward are printed, not held:
    in bf16 the kernels' and the batch's rounding move this model's
    random-weight outputs by O(1). Host ms per call of each loaded program
    and its eager forward (median of 5, synchronised)."""
    import shutil

    from mcgaze_tpu_torch.tools.deployment import export_model
    from mcgaze_tpu_torch.tools.kernel_bounds import chains, k5_launches
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    cfg = apply_overrides(load_config(TRAIN_CONFIG), opts)
    root = os.path.join(ROOT, 'work_dirs', 'chip_smoke_export')
    shutil.rmtree(root, ignore_errors=True)
    n_stages = cfg.model.num_stages
    h, w = cfg.eval_cfg.canvas
    imgs, whwh = export_model.example_inputs(cfg.model.clip_length, h, w,
                                             device, seed=1)

    def ms(fn):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(imgs, whwh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    def export(name, extra, dtype):
        out = os.path.join(root, f'{name}.pt2')
        res = export_model.main(
            [TRAIN_CONFIG, checkpoint, '--out', out, '--batch-clips', '1',
             '--dtype', dtype, '--device', str(device), '--selftest']
            + (['--cfg-options', *extra, *opts] if extra or opts else []))
        return dict(mb=os.path.getsize(out) / 1e6,
                    selftest_err=res['selftest_max_abs_err'],
                    loaded=torch.export.load(out).module(),
                    eager=res['forward'])

    def run(fn):
        reset_counters()
        outs = fn(imgs, whwh)
        torch.cuda.synchronize()
        return outs, fused_counters()

    results = {}
    for name, extra, dtype in (('plain', (), EXPORT_DTYPE),
                               ('fused', FUSED_OPTS, EXPORT_DTYPE),
                               ('fused_f32', FUSED_OPTS, 'float32')):
        # the f32 program runs with TF32 off, as the plain f32 forward
        # it is held against
        torch.backends.cudnn.allow_tf32 = dtype != 'float32'
        torch.backends.cuda.matmul.allow_tf32 = False
        ex = export(name, extra, dtype)
        with torch.inference_mode():
            eager_outs, eager_launches = run(ex['eager'])
            outs, launches = run(ex['loaded'])
            loaded_ms, eager_ms = ms(ex['loaded']), ms(ex['eager'])
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f'export {name}: non-finite outputs')
        norms = torch.stack([o.float().norm(dim=-1) for o in outs[2:]])
        tol = TOL_BF16 if dtype == 'bfloat16' else 1e-4
        check((norms - 1).abs().max().item() <= tol,
              f'export {name}: gazes not unit')
        results[name] = dict(
            ex, dtype=dtype, outs=outs, launches=launches,
            eager_launches=eager_launches, loaded_ms=loaded_ms,
            eager_ms=eager_ms, vs_eager_err=export_err(outs, eager_outs))
    torch.backends.cudnn.allow_tf32 = True

    plain, fused = results['plain'], results['fused']
    check(plain['launches']['k1'] == n_stages, f'export: the loaded plain '
          f'program launched K1 {plain["launches"]["k1"]} times, expected '
          f'{n_stages} (one per stage)')
    k5_expected = sum(k5_launches(ch) for ch in chains(cfg.model.backbone_depth))
    check(fused['eager_launches']['k5'] == k5_expected, f'export: the eager '
          f'fused forward launched K5 {fused["eager_launches"]["k5"]} times, '
          f'expected {k5_expected}')
    expected = dict(k1=n_stages, k3=0, k4=n_stages, k5=k5_expected)
    for name in ('fused', 'fused_f32'):
        r = results[name]
        check(r['launches'] == expected, f'export: the loaded {name} '
              f'program launched {r["launches"]}, expected {expected}')
        check(r['vs_eager_err'] <= export_model.SELFTEST_ATOL,
              f'export: the loaded {name} program differs from its eager '
              f'forward by {r["vs_eager_err"]} '
              f'(atol {export_model.SELFTEST_ATOL})')
    # the plain configuration's f32 forward on the same weights, TF32 off
    ref = f32_forward(cfg, checkpoint, device)
    with torch.inference_mode():
        torch.backends.cudnn.allow_tf32 = False
        p = ref(imgs, whwh)
        torch.backends.cudnn.allow_tf32 = True
    del ref
    fused_f32_vs_plain = export_err(results['fused_f32']['outs'], p)
    check(fused_f32_vs_plain <= TOL_E2E, f'export: the f32 fused program '
          f'differs from the plain f32 forward by {fused_f32_vs_plain} '
          f'(tolerance {TOL_E2E})')
    # printed only: the bf16 programs against the plain f32 forward, in
    # box error and gaze degrees
    vs_f32 = {name: box_deg_err(results[name]['outs'][0],
                                results[name]['outs'][2:], p[0], p[2:])
              for name in ('plain', 'fused')}
    fused_vs_plain = export_err(fused['outs'], plain['outs'])
    summary = {name: {k: r[k] for k in ('dtype', 'mb', 'selftest_err',
                                        'launches',
                                        'eager_launches', 'loaded_ms',
                                        'eager_ms', 'vs_eager_err')}
               for name, r in results.items()}
    del results, plain, fused
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    emit('export', dtype=EXPORT_DTYPE, batch_clips=1, **summary,
         selftest_atol=export_model.SELFTEST_ATOL,
         vs_plain_f32=dict(
             fused_box_err=vs_f32['fused'][0],
             fused_gaze_deg=vs_f32['fused'][1],
             plain_box_err=vs_f32['plain'][0],
             plain_gaze_deg=vs_f32['plain'][1]),
         fused_vs_plain_bf16_err=fused_vs_plain,
         fused_f32_vs_plain_f32_err=fused_f32_vs_plain, tol_e2e=TOL_E2E,
         card=nvidia_smi())
    return {name: r['launches'] for name, r in summary.items()}


def phase_demo(device, opts=()):
    """The demo at full width with seeded random weights (and a head
    bias): HeadDetector at YOLOv5m's width (depth 0.67, width 0.75, 640
    px, conf_thres 0.01) on 8 fabricated 640x480 u8 frames (no resize):
    heads in every frame, boxes finite, inside the frame, at most max_det;
    ms per batch of 8 (host clock, synchronised, median of 5) and the
    NMS's kernels per batch (torch.profiler). Then gaze_demo's gaze
    step on labels the phase writes itself (the random detector finds no
    real heads): read_labels -> group_segments -> square_crop ->
    run_video, two persons over 20 frames whose square crops are 224 px
    (no resize), through the l2cs config at 224 px and seeded random
    weights; K1 launched 4 times per forward; fused gazes unit on frames
    one clip covers."""
    import shutil

    from mcgaze_tpu_torch.demo import gaze_demo
    from mcgaze_tpu_torch.evaluation.driver import (VideoGazeEvaluator,
                                                    clip_slices)
    from mcgaze_tpu_torch.models import yolov5
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.tools.test_gaze360_gaze import build_forward
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    # random weights score every box near 0.25, persons above heads: a low
    # threshold gives the NMS candidates to suppress, and a head bias makes
    # heads the class it keeps, so the boxes checked below are not none
    ycfg = yolov5.YoloConfig()
    model = yolov5.init_yolo(ycfg, seed=0, device=device)
    with torch.no_grad():
        for conv in model.model[24].m:
            conv.bias.view(len(ycfg.anchors[0]), -1)[:, 6] += 1.0
    detector = yolov5.HeadDetector(model, conf_thres=0.01)
    rng = np.random.RandomState(12)
    frames = [rng.randint(0, 256, (480, 640, 3), np.uint8)
              for _ in range(20)]
    batch = frames[:8]
    dets = detector(batch)
    torch.cuda.synchronize()
    check(min(len(d) for d in dets) > 0, 'demo: no heads in a frame')
    for d in dets:
        check(np.isfinite(d).all(), 'demo: non-finite detections')
        check(len(d) <= detector.max_det, f'demo: {len(d)} detections')
        check(((d[:, [0, 2]] >= 0) & (d[:, [0, 2]] <= 640)).all() and
              ((d[:, [1, 3]] >= 0) & (d[:, [1, 3]] <= 480)).all(),
              'demo: boxes outside the frame')
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detector(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    det_ms = float(np.median(times[1:]))
    canvases = torch.from_numpy(np.stack([f[..., ::-1] for f in batch]))
    canvases = torch.nn.functional.pad(canvases.to(device), (0, 0, 0, 0, 80,
                                                             80), value=114)
    with torch.inference_mode():
        preds = yolov5.decode_predictions(
            ycfg, detector.model(canvases.float() / 255.0))
        rows = profile_rows(lambda: yolov5.postprocess(
            ycfg, preds, detector.conf_thres), 1)
    nms_kernels = sum(r[2] for r in rows if 'Memcpy' not in r[1]
                      and 'Memset' not in r[1])
    nms_copies = sum(r[2] for r in rows if 'Memcpy' in r[1])
    del preds, canvases, detector, model
    torch.cuda.empty_cache()

    # the gaze step on fabricated labels: two persons, boxes of side 140,
    # so square_crop cuts 2 * int(0.8 * 140) = 224 px
    work = os.path.join(ROOT, 'work_dirs', 'chip_smoke_demo')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    for i in range(len(frames)):
        with open(os.path.join(work, f'{i}.txt'), 'w') as f:
            for cx in (200 + i, 440 - i):
                f.write(f'1 {cx - 70} 170 {cx + 70} 310\n')
    segments = gaze_demo.group_segments(
        [gaze_demo.read_labels(os.path.join(work, f'{i}.txt'))
         for i in range(len(frames))])
    shutil.rmtree(work, ignore_errors=True)
    check(len(segments) == 1 and len(segments[0]['persons']) == 2,
          f'demo: segments {segments}')
    crop_shapes = {gaze_demo.square_crop(frames[fid], box).shape
                   for person in segments[0]['persons']
                   for fid, box in zip(segments[0]['frame_id'], person)}
    check(crop_shapes == {(224, 224, 3)}, f'demo: crops {crop_shapes}')
    cfg = apply_overrides(load_config(os.path.join(
        ROOT, 'configs', 'multiclue_gaze', 'multiclue_gaze_r50_l2cs.py')),
        ['eval_cfg.scale=224,224', 'eval_cfg.canvas=224,224', *opts])
    evaluator = VideoGazeEvaluator(build_forward(cfg, None, device=device),
                                   cfg.eval_cfg)
    ecfg = cfg.eval_cfg
    slices = clip_slices(len(frames), ecfg.clip_length, ecfg.stride)
    forwards = 2 * -(-len(slices) // ecfg.clip_batch)
    reset_counters()
    t0 = time.perf_counter()
    gaze_demo.segment_gazes(evaluator, frames, segments)
    torch.cuda.synchronize()
    gaze_s = time.perf_counter() - t0
    launches = roi_align_cuda.launch_count
    check(launches == 4 * forwards, f'demo: K1 launched {launches} times, '
          f'expected {4 * forwards} (4 per forward)')
    covered = np.zeros(len(frames), int)
    for start, length, _ in slices:
        covered[start:start + length] += 1
    norm_err = 0.0
    for g in segments[0]['gazes']:
        check(g.shape == (len(frames), 3) and np.isfinite(g).all(),
              f'demo: gazes {g.shape}')
        norm_err = max(norm_err, float(np.abs(np.linalg.norm(
            g[covered == 1], axis=1) - 1).max()))
    check(norm_err <= 1e-4, f'demo: fused gazes not unit ({norm_err})')
    del evaluator
    torch.cuda.empty_cache()
    emit('demo', detector='YOLOv5m (depth 0.67, width 0.75), 640 px, '
         'seeded random weights with a head bias, f32, conf_thres 0.01',
         frames=len(batch),
         detections=[len(d) for d in dets], detector_ms_per_batch_of_8=det_ms,
         nms_kernels_per_batch=nms_kernels, nms_copies_per_batch=nms_copies,
         labels='fabricated: the random detector finds no real heads',
         gaze='l2cs config at 224 px, seeded random weights, f32, '
              '2 persons x 20 frames, 224 px crops',
         gaze_forwards=forwards, k1_launches=launches, gaze_seconds=gaze_s,
         fused_gaze_norm_err=norm_err, card=nvidia_smi())
    return launches


# ------------------------------------------------ the InstBlink detector

INSTBLINK_CONFIG = os.path.join(ROOT, 'configs', 'instblink',
                                'instblink_r50_mpeblink.py')
TEVIT_CONFIG = os.path.join(ROOT, 'configs', 'tevit',
                            'tevit_msgshift_youtubevis.py')
INSTBLINK_DECODE = 'npy stand-in for _decode_video (no OpenCV on this machine)'


def query_window_check(model, imgs, whwh, t):
    """A QueryDetector window through K1 against roi_impl='mm', stage by
    stage. One forward through K1 records each stage's RoIAlign inputs and
    head inputs; per stage, the plain RoIAlign on the same inputs is held
    against K1 within TOL_F32_REL of the largest |feature| (the kernel
    phase's f32 tolerance), and the stage head fed the plain features and
    the same query against the head fed K1's within TOL_E2E (cls_logits and
    obj absolute, decoded boxes relative to their largest coordinate). A
    forward with roi_impl='mm' throughout is compared too, and its error
    per stage reported, not held: six stages of random weights amplify a
    1e-6 difference about tenfold a stage (boxes reach 1e5 px), so the
    composed outputs measure that amplification, not the kernel. Returns
    the per-stage numbers; raises on a failed check."""
    from mcgaze_tpu_torch.evaluation.forward import device_normalize
    from mcgaze_tpu_torch.geometry import delta2bbox
    from mcgaze_tpu_torch.models import query_detector as qd
    from mcgaze_tpu_torch.ops.roi_align import roi_align_fpn_mm

    kernel = qd.roi_align_fpn
    aligns, heads = [], []

    def both(feats, rois, frame_idx, *args):
        out = kernel(feats, rois, frame_idx, *args)
        aligns.append((rois, out, roi_align_fpn_mm(feats, rois, frame_idx,
                                                   *args),
                       max(f.abs().max().item() for f in feats)))
        return out

    hooks = [h.register_forward_hook(
        lambda m, args, out: heads.append((m, args, out)))
        for h in model.roi_head.bbox_head]
    qd.roi_align_fpn = both
    cfg = model.cfg
    try:
        with torch.inference_mode():
            x = device_normalize(imgs, whwh)
            got = model(x, whwh, t)['stages']
            qd.roi_align_fpn = kernel
            for h in hooks:
                h.remove()
            model.cfg = dataclasses.replace(cfg, roi_impl='mm')
            plain = model(x, whwh, t)['stages']
            model.cfg = cfg
            rows = []
            for (rois, k, p, fmax), (head, (roi_feat, query, tt),
                                     (cls, deltas, obj, _)) in zip(aligns,
                                                                   heads):
                cls_p, deltas_p, obj_p, _ = head(p.reshape(roi_feat.shape),
                                                 query, tt)
                bk = delta2bbox(rois, deltas.float())
                bp = delta2bbox(rois, deltas_p.float())
                rows.append(dict(
                    k1_err=(k - p).abs().max().item(),
                    k1_tol=TOL_F32_REL * max(1.0, fmax),
                    head_cls_err=(cls - cls_p).abs().max().item(),
                    head_obj_err=(obj - obj_p).abs().max().item(),
                    head_box_rel_err=(bk - bp).abs().max().item()
                    / max(bp.abs().max().item(), 1.0),
                    roi_extent_px=[rois.min().item(), rois.max().item()]))
            for row, g, p in zip(rows, got, plain):
                row['composed_cls_err'] = (g['cls_logits'] - p['cls_logits']
                                           ).abs().max().item()
                row['composed_box_rel_err'] = (
                    (g['boxes'] - p['boxes']).abs().max()
                    / p['boxes'].abs().max().clamp_min(1.0)).item()
    finally:
        qd.roi_align_fpn = kernel
        model.cfg = cfg
        for h in hooks:
            h.remove()
    check(len(rows) == cfg.num_stages, f'{len(rows)} stages recorded')
    for s, row in enumerate(rows):
        check(row['k1_err'] <= row['k1_tol'], f'window stage {s}: K1 vs the '
              f'plain RoIAlign on the same inputs {row["k1_err"]} > '
              f'{row["k1_tol"]}')
        head_err = max(row['head_cls_err'], row['head_obj_err'],
                       row['head_box_rel_err'])
        check(head_err <= TOL_E2E, f'window stage {s}: the head fed K1 vs '
              f'fed the plain RoIAlign {head_err} > {TOL_E2E}')
    return rows


def phase_instblink_train(device, opts=(), steps=3, config=INSTBLINK_CONFIG,
                          phase='instblink_train'):
    """A query-detector config at full width (InstBlink R-50: 4 clips x 11
    frames; TeViT MsgShifT (`config=TEVIT_CONFIG`): 4 clips x 5 frames with
    DropPath at its 0.1 ceiling; both on the 384x640 canvas, 100 queries, 6
    stages, f32, cuDNN TF32 on and matmul TF32 off, the card's defaults)
    through train_instblink's main() with --synthetic for `steps` steps,
    both launch counters reset before and read after: 6 K1 and 6 K3
    launches per step; finite losses. Then ms per step (median of 4 after
    one warm step), the host ms of the matching solves per step, peak
    memory, and one profiled step: device idle share, K1 and K3 ms per
    step. `opts`: config overrides (a CPU rehearsal passes a tiny model).
    Returns (launches, ckpt_<steps>.pth)."""
    import shutil

    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.tools import train_instblink
    from mcgaze_tpu_torch.train.query_loop import (make_query_train_step,
                                                   uses_droppath)
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.query_config import load_query_config

    cfg = apply_overrides(load_query_config(config), list(opts))
    if cfg.model.backbone == 'msgshift':
        check(uses_droppath(cfg.model), f'{phase}: DropPath is off '
              f'(msg_drop_path_rate={cfg.model.msg_drop_path_rate})')
    work_dir = os.path.join(ROOT, 'work_dirs', f'chip_smoke_{phase}')
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    # the main path: counts from zero, read right after
    roi_align_cuda.launch_count = 0
    roi_align_cuda.bwd_launch_count = 0
    t0 = time.perf_counter()
    out = train_instblink.main(
        [config, '--synthetic', '--device', str(device),
         '--max-iters', str(steps), '--work-dir', work_dir,
         '--log-interval', '1'] + (['--cfg-options', *opts] if opts else []))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(k1=roi_align_cuda.launch_count,
                    k3=roi_align_cuda.bwd_launch_count)
    per_step = cfg.model.num_stages
    check(launches == dict(k1=per_step * steps, k3=per_step * steps),
          f'{phase} path launched {launches}, expected {per_step} '
          f'of K1 and of K3 per step over {steps} steps')
    hist = out['history']
    check(len(hist) == steps and all(
        np.isfinite([v for k, v in h.items() if k.startswith(
            ('stage', 'loss', 'grad_norm'))]).all() for h in hist),
        f'{phase} losses not finite: '
        f'{[(h["loss"], h["grad_norm"]) for h in hist]}')

    # time: a fresh full batch, the card's defaults
    state = out['state']
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(
        train_instblink.synthetic_batches(cfg, seed=2)).items()}
    step_fn = make_query_train_step(cfg.model, cfg.optim)
    torch.cuda.reset_peak_memory_stats()
    walls, match_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logs = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        match_ms.append(float(logs['match_ms']))
    step_ms = float(np.median(walls[1:]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = profile_rows(lambda: step_fn(state, batch), 1)
    busy = sum(r[0] for r in rows)
    k1 = sum(r[0] for r in rows if 'roi_align_fpn_kernel' in r[1])
    k3 = sum(r[0] for r in rows if 'roi_align_fpn_bwd_kernel' in r[1])
    clips, t = cfg.data_train.batch_size, cfg.model.clip_length
    emit(phase, config=os.path.relpath(config, ROOT),
         backbone=cfg.model.backbone,
         drop_path_rate=(cfg.model.msg_drop_path_rate
                         if uses_droppath(cfg.model) else 0.0),
         clips_per_step=clips, frames_per_step=clips * t,
         canvas=list(cfg.data_train.canvas),
         queries=cfg.model.num_queries, stages=cfg.model.num_stages,
         steps=steps, main_path_seconds=main_s, launches=launches,
         losses=[h['loss'] for h in hist],
         grad_norms=[h['grad_norm'] for h in hist],
         main_path_step_seconds=[h['time'] for h in hist],
         step_ms=step_ms, step_ms_all=walls,
         clips_per_s=clips / step_ms * 1e3,
         match_host_ms_per_step=float(np.median(match_ms[1:])),
         match_host_ms_all=match_ms, peak_mem_gb=peak_gb,
         kernel_ms_per_step=busy if rows else 'not measured',
         idle_share=(1 - busy / step_ms) if rows else 'not measured',
         k1_ms_per_step=k1 if rows else 'not measured',
         k3_ms_per_step=k3 if rows else 'not measured',
         kernels_per_step=sum(r[2] for r in rows),
         top=[dict(ms=round(ms, 4), calls=c, name=k[:80])
              for ms, k, c, _ in rows[:12]],
         precision='float32, cuDNN TF32 on (card default), matmul TF32 off',
         card=nvidia_smi())
    del state, batch, step_fn, out
    torch.cuda.empty_cache()
    return launches, os.path.join(work_dir, f'ckpt_{steps}.pth')


def write_instblink_dataset(root, lengths=(40, 23), hw=(360, 640), seed=11,
                            blinks=True, num_classes=1):
    """Two videos as .npy frames of hw, two tracks each (the second absent
    in frame 0); MPEblink form (blinks=True): one face category, two blink
    events a track; YouTubeVIS form (blinks=False): num_classes categories,
    the tracks of two of them, no blinks. Writes the COCO-VID annotation
    file. Returns (ann path, frames root)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    frames_root = os.path.join(root, 'frames')
    videos, anns = [], []
    for vid, n in enumerate(lengths, 1):
        names = [f'{vid:03d}/{f:05d}.npy' for f in range(n)]
        os.makedirs(os.path.join(frames_root, f'{vid:03d}'))
        for name in names:
            np.save(os.path.join(frames_root, name),
                    rng.randint(0, 256, (h, w, 3), np.uint8))
        videos.append(dict(id=vid, height=h, width=w, length=n,
                           file_names=names))
        for inst in range(2):
            events = [[3, 5], [n - 9, n - 7]]
            binary = [int(any(s <= f <= e for s, e in events))
                      for f in range(n)]
            x0, y0 = w * (0.15 + 0.45 * inst), h * 0.25
            boxes = [None if inst == 1 and f == 0 else
                     [x0 + f, y0 + 0.5 * f, w * 0.2, h * 0.35]
                     for f in range(n)]
            ann = dict(id=len(anns) + 1, video_id=vid, bboxes=boxes)
            if blinks:
                ann.update(category_id=1, blinks_binary=binary,
                           blinks=events)
            else:
                ann['category_id'] = 1 + (vid + 3 * inst) % num_classes
            anns.append(ann)
    categories = ([dict(id=1, name='person_face')] if blinks else
                  [dict(id=c, name=f'ytvis_{c}')
                   for c in range(1, num_classes + 1)])
    ann = os.path.join(root, 'test.json')
    with open(ann, 'w') as f:
        json.dump(dict(videos=videos, annotations=anns,
                       categories=categories), f)
    return ann, frames_root + '/'


def npy_decode_instblink(self, paths):
    """InstBlinkVideoEvaluator._decode_video for .npy frames already at the
    exact-warp size (the warp is then the identity): u8 frames padded to
    the canvas, as the native loader's u8 path gives them. The card's
    machine has no OpenCV, which cv2 and the native loader need."""
    from mcgaze_tpu_torch.data import transforms as T
    dc = self.data_cfg
    frames = [np.load(p) for p in paths]
    check(all(fr.shape[:2] == (min(dc.scale), max(dc.scale))
              for fr in frames), 'instblink frames not at the warp size')
    h, w = frames[0].shape[:2]
    self.decoder = INSTBLINK_DECODE
    return (np.stack([T.pad_to_canvas(fr, dc.canvas) for fr in frames]),
            np.tile(np.asarray([[w, h, w, h]], np.float32),
                    (len(frames), 1)),
            np.ones((len(frames), 4), np.float32))


def phase_instblink_eval(device, checkpoint, opts=(), config=INSTBLINK_CONFIG,
                         phase='instblink_eval', lengths=(40, 23)):
    """A query-detector eval CLI at full width (config as in
    phase_instblink_train, f32, the card's defaults) with --eval on the
    train phase's checkpoint, over two fabricated videos of 40 and 23
    frames of 640x360 decoded by npy_decode_instblink: MPEblink form for
    InstBlink (two face tracks with blink events), YouTubeVIS form for
    TeViT (40 categories, no blinks). The launch counters reset before and
    read after: 6 K1 launches per forward (8 windows of the clip length
    per launch), no K3; every track finite with one box entry per frame,
    blink probabilities in [0, 1] where the model has a blink head and no
    blink field where it has none; frames/s, and the AP lines (random
    weights: they only show that the scorer ran; no blink line without
    blinks). Then one window, f32 with TF32 off, through
    query_window_check. Returns K1's launches."""
    import shutil

    from mcgaze_tpu_torch.evaluation.instblink_driver import (
        InstBlinkVideoEvaluator, clip_windows)
    from mcgaze_tpu_torch.models.query_detector import QueryDetector
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.tools import test_instblink
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.convert import clean_reference_query_state_dict
    from mcgaze_tpu_torch.utils.query_config import load_query_config

    root = os.path.join(ROOT, 'work_dirs', f'chip_smoke_{phase}')
    shutil.rmtree(root, ignore_errors=True)
    base = apply_overrides(load_query_config(config), list(opts))
    blinks = base.model.with_blink
    ann, frames_root = write_instblink_dataset(
        root, lengths, blinks=blinks, num_classes=base.model.num_classes)
    data_opts = [f'data_test.ann_file={ann}',
                 f'data_test.img_prefix={frames_root}', *opts]
    cfg = apply_overrides(load_query_config(config), data_opts)
    ec = cfg.eval_cfg
    t = min(ec.clip_length, min(lengths))
    forwards = sum(-(-len(clip_windows(n, t, t - ec.overlap))
                     // ec.clip_batch) for n in lengths)
    out_json = os.path.join(root, 'results.json')

    decode = InstBlinkVideoEvaluator._decode_video
    InstBlinkVideoEvaluator._decode_video = npy_decode_instblink
    buf = io.StringIO()
    try:
        roi_align_cuda.launch_count = 0
        roi_align_cuda.bwd_launch_count = 0
        with contextlib.redirect_stdout(buf):
            out = test_instblink.main(
                [config, checkpoint, '--out', out_json, '--eval',
                 '--device', str(device), '--cfg-options', *data_opts])
        torch.cuda.synchronize()
        launches = dict(k1=roi_align_cuda.launch_count,
                        k3=roi_align_cuda.bwd_launch_count)
    finally:
        InstBlinkVideoEvaluator._decode_video = decode
    per_forward = cfg.model.num_stages
    check(launches == dict(k1=per_forward * forwards, k3=0),
          f'{phase} launched {launches}, expected {per_forward} K1 '
          f'per forward over {forwards} forwards and no K3')
    check(out['evaluator'].decoder == INSTBLINK_DECODE,
          f'{phase} decoded with {out["evaluator"].decoder}')
    with open(out_json) as f:
        results = json.load(f)
    check(len(results) == len(lengths) * ec.max_per_img,
          f'{len(results)} tracks for {len(lengths)} videos')
    for r in results:
        n = lengths[r['video_id'] - 1]
        boxes = [b for b in r['bboxes'] if b is not None]
        check(len(r['bboxes']) == n and len(boxes) == n,
              f'track of video {r["video_id"]}: {len(r["bboxes"])} boxes '
              f'for {n} frames')
        check(np.isfinite(np.asarray(boxes, np.float64)).all()
              and np.isfinite(r['score']), f'non-finite {phase} track')
        check(1 <= r['category_id'] <= cfg.model.num_classes,
              f'{phase}: category {r["category_id"]}')
        if blinks:
            p = np.asarray(r['blink_scores'])
            check(len(p) == n and ((p >= 0) & (p <= 1)).all(),
                  'blink probabilities: not one per frame in [0, 1]')
        else:
            check(not any(k.startswith('blink') for k in r),
                  f'{phase}: a blink field in a track of a model without '
                  f'a blink head: {sorted(r)}')
    ap_lines = [ln for ln in buf.getvalue().splitlines()
                if 'track mAP' in ln or 'blink action' in ln]
    check(len(ap_lines) == (2 if blinks else 1)
          and ('blink action' in ap_lines[-1]) == blinks,
          f'{phase} scorer printed {ap_lines}')

    # one window of video 1, f32, TF32 off: K1 against the plain RoIAlign
    ckpt = torch.load(checkpoint, map_location='cpu', weights_only=False)
    model = QueryDetector(cfg.model)
    model.load_state_dict(clean_reference_query_state_dict(
        ckpt['state_dict']), strict=True)
    model = model.to(device).eval()
    with open(ann) as f:
        video = json.load(f)['videos'][0]
    imgs, whwh, _ = npy_decode_instblink(
        InstBlinkVideoEvaluator(None, ec, data_cfg=cfg.data_test),
        [os.path.join(frames_root, n) for n in video['file_names'][:t]])
    imgs = torch.from_numpy(imgs).to(device)
    whwh = torch.from_numpy(whwh).to(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        window = query_window_check(model, imgs, whwh, t)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    del model, imgs
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(os.path.dirname(checkpoint), ignore_errors=True)
    frames = sum(lengths)
    emit(phase, config=os.path.relpath(config, ROOT),
         backbone=cfg.model.backbone, decode=INSTBLINK_DECODE,
         videos=list(lengths),
         frame_hw=[video['height'], video['width']],
         canvas=list(cfg.data_test.canvas), clip_length=t,
         overlap=ec.overlap, clip_batch=ec.clip_batch, forwards=forwards,
         launches=launches, tracks=len(results), seconds=out['seconds'],
         frames_per_s=frames / out['seconds'], metrics=out['metrics'],
         ap_lines=ap_lines,
         metrics_note='random weights: the AP only shows the scorer ran',
         window=window, tol_e2e=TOL_E2E, tol_f32_rel=TOL_F32_REL,
         checkpoint=f'{phase.replace("eval", "train")} phase '
                    f'{os.path.basename(checkpoint)}',
         card=nvidia_smi())
    return launches['k1']


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def phase_ddp(device, steps=2, opts=(), lengths=(60, 33)):
    """Data parallel on the card under an NCCL process group of one
    process (torchrun's environment, world size 1), f32 with TF32 off:
    the gaze train CLI with --mesh 1,1 against the same CLI without a
    group, on the same seed and synthetic batches: the model under
    DistributedDataParallel on the NCCL backend, 4 K1 and 4 K3 a step,
    the first loss equal within 1e-6 relative, every parameter after the
    steps within 1e-5 of the tensor's largest |value|. NCCL's allreduce,
    broadcast and allgather (17 MiB) on the card. Then tools.test under
    the group and without it, on the non-DDP run's checkpoint and two
    fabricated videos (.npy stand-in decoder): 4 K1 a forward and the same
    results. Then ms per step of both models in turns, the card's
    defaults. The group is left and the environment restored at the end.
    `opts`: config overrides (a CPU rehearsal, on gloo, passes a tiny
    model). Returns the launches of the runs under the group."""
    import shutil

    import torch.distributed as dist

    from mcgaze_tpu_torch.evaluation.driver import (VideoGazeEvaluator,
                                                    clip_slices)
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.parallel import distributed as D
    from mcgaze_tpu_torch.tools import test as test_cli
    from mcgaze_tpu_torch.tools.train import main as train_main
    from mcgaze_tpu_torch.tools.train import synthetic_batches
    from mcgaze_tpu_torch.train.loop import make_train_step
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    stages = apply_overrides(load_config(TRAIN_CONFIG),
                             list(opts)).model.num_stages
    root = os.path.join(ROOT, 'work_dirs', 'chip_smoke_ddp')
    shutil.rmtree(root, ignore_errors=True)
    ann, frames = write_cli_dataset(root, lengths)['gaze360']
    check(not D._active(), 'a process group is up before the ddp phase')
    launch_env = dict(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()),
                      WORLD_SIZE='1', RANK='0', LOCAL_RANK='0')
    saved_env = {k: os.environ.get(k) for k in launch_env}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's default backward algorithms add with atomics, so two runs of
    # one step differ in their last bits; Adam's first steps turn such
    # bits of a near-zero gradient into whole updates
    torch.backends.cudnn.deterministic = True
    decode = VideoGazeEvaluator._decode_video
    VideoGazeEvaluator._decode_video = npy_decode

    def counts():
        return dict(k1=roi_align_cuda.launch_count,
                    k3=roi_align_cuda.bwd_launch_count)

    def train(tag, extra):
        return train_main([TRAIN_CONFIG, '--synthetic', '--device',
                           str(device), '--max-iters', str(steps),
                           '--work-dir', os.path.join(root, tag),
                           '--log-interval', '1'] + extra
                          + (['--cfg-options', *opts] if opts else []))

    def test(tag, ckpt):
        path = os.path.join(root, f'results_{tag}.json')
        out = test_cli.main([TRAIN_CONFIG, ckpt, '--json', ann, '--root',
                             frames, '--out', path, '--device', str(device),
                             '--cfg-options', 'eval_cfg.crop_ratio=None',
                             *opts])
        torch.cuda.synchronize()
        with open(path) as f:
            return out, json.load(f)

    try:
        plain = train('plain', [])
        plain_results = test('plain', plain['checkpoint'])[1]
        os.environ.update(launch_env)
        roi_align_cuda.launch_count = 0
        roi_align_cuda.bwd_launch_count = 0
        t0 = time.perf_counter()
        ddp = train('ddp', ['--mesh', '1,1'])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = counts()
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
        check(D._active() and dist.get_backend() == backend
              and D.process_count() == 1, f'no {backend} group of one '
              'process')
        check(isinstance(ddp['state'].ddp,
                         torch.nn.parallel.DistributedDataParallel),
              'the train step did not run under DistributedDataParallel')
        check(train_launches == dict(k1=stages * steps, k3=stages * steps),
              f'ddp train launched {train_launches}, expected {stages} K1 '
              f'and {stages} K3 per step')
        loss_p, loss_d = plain['history'][0]['loss'], ddp['history'][0]['loss']
        loss_rel = abs(loss_d - loss_p) / abs(loss_p)
        check(loss_rel <= 1e-6, f'ddp first loss {loss_d} vs {loss_p}')
        sp = plain['state'].model.state_dict()
        sd = ddp['state'].model.state_dict()
        param_err, worst = max(
            ((sd[k].float() - v.float()).abs().max().item()
             / max(v.float().abs().max().item(), 1e-12), k)
            for k, v in sp.items())
        check(param_err <= 1e-5, f'ddp parameters after {steps} steps: '
              f'{worst} {param_err} > 1e-5')

        # the collectives the multi-process paths use, on the card
        x = torch.arange(6, dtype=torch.float32, device=device)
        dist.all_reduce(x)
        seed = torch.tensor([1234], dtype=torch.int64, device=device)
        dist.broadcast(seed, src=0)
        big = torch.full((17 << 20,), 7, dtype=torch.uint8, device=device)
        gathered = [torch.empty_like(big)]
        dist.all_gather(gathered, big)
        torch.cuda.synchronize()
        check(x.tolist() == list(range(6)) and int(seed) == 1234
              and torch.equal(gathered[0], big), 'NCCL collectives')

        roi_align_cuda.launch_count = 0
        out, ddp_results = test('ddp', plain['checkpoint'])
        test_launches = counts()['k1']
        fwds = sum(-(-len(clip_slices(n, 7, 4)) // 8) for n in lengths)
        check(test_launches == stages * fwds, f'ddp test launched '
              f'{test_launches} K1, expected {stages} per forward over '
              f'{fwds}')
        check(ddp_results == plain_results, 'tools.test under the group '
              'wrote other results than without it')

        # ms per step, plain and under DDP in turns, on one fresh batch
        # with the card's defaults (TF32 convolutions, cuDNN's own choice)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        cfg = apply_overrides(load_config(TRAIN_CONFIG), list(opts))
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(
            synthetic_batches(cfg, seed=2)).items()}
        step_fn = make_train_step(cfg.model, cfg.optim)
        walls = dict(plain=[], ddp=[])
        # two rounds of turns: the script's 1200 s limit
        for name in ('plain', 'ddp', 'ddp', 'plain') * 2:
            st = (plain if name == 'plain' else ddp)['state']
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step_fn(st, batch)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t1) * 1e3)
        step_ms = {k: float(np.median(v[1:])) for k, v in walls.items()}
    finally:
        VideoGazeEvaluator._decode_video = decode
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        D.shutdown_distributed()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit('ddp', backend=backend, world_size=1, steps=steps,
         config=os.path.relpath(TRAIN_CONFIG, ROOT),
         train_launches=train_launches, test_launches=test_launches,
         first_loss=[loss_p, loss_d], first_loss_rel_err=loss_rel,
         param_max_rel_err=param_err, param_worst=worst,
         ddp_train_seconds=train_s,
         step_seconds=[h['time'] for h in ddp['history']],
         plain_step_seconds=[h['time'] for h in plain['history']],
         test_seconds=out['seconds'], results_equal=True,
         step_ms=step_ms, step_ms_all=walls,
         step_ms_note='plain and DDP steps in turns on one batch, median '
                      'of 3 after the first, TF32 convolutions',
         clips_per_step=cfg.data_train.batch_size,
         precision='float32, TF32 off, cuDNN deterministic',
         card=nvidia_smi())
    del plain, ddp, batch, step_fn
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return dict(train=train_launches, test=test_launches)


# ------------------------------------------------------ tensor parallel

# the JAX package's 1x2 bounds (tests/test_train_step.py): the first loss,
# grad_norm, and every parameter after its one step at rtol 2e-4, atol
# 3e-6, "~3 update magnitudes" of that step's lr (1e-6: Adam's first
# update is lr * sign(g), and a gradient at rounding level may take
# either sign). After step k the atol is the same three updates at the lr
# the k steps applied: 3 x sum(lr_t), 3e-6 after the first step of the
# shipped schedule (lr 1e-6), 9e-6 after its second (2e-6 more).
TP_LOSS_REL, TP_GRAD_NORM_REL = 2e-5, 2e-4
TP_PARAM_RTOL, TP_PARAM_ATOL_UPDATES = 2e-4, 3.0


def tp_form(device):
    """Which form the tp phase takes here: two processes under NCCL, one
    card each, where two cards are visible; two processes sharing the one
    card over gloo with CUDA tensors (NCCL refuses two ranks on one card);
    on the CPU (a rehearsal), two gloo processes."""
    if device.type != 'cuda':
        return 'gloo_cpu'
    return 'nccl_two_cards' if torch.cuda.device_count() >= 2 \
        else 'gloo_one_card'


def replicated_digest(model_sd):
    """sha256 over the bytes of every tensor TP_RULES leave whole."""
    import hashlib

    from mcgaze_tpu_torch.parallel.mesh import tp_rule
    h = hashlib.sha256()
    for k in sorted(model_sd):
        if tp_rule(k) is None:
            h.update(k.encode())
            h.update(model_sd[k].detach().cpu().contiguous().numpy()
                     .tobytes())
    return h.hexdigest()


def tp_run(form, n_model, work_dir, steps, clips, opts=(), rank=0,
           coordinator=None):
    """One process of the tp phase (n_model 2) or the --mesh 1,1 run it is
    held against (n_model 1, no process group), f32 with TF32 off and
    cuDNN deterministic, seed 0, synthetic batches of `clips` clips.
    nccl_two_cards: the gaze train CLI's main() with --mesh 1,n_model
    (torchrun's environment, set by the caller); gloo_one_card and
    gloo_cpu: the library step, create_train_state(mesh=) ->
    make_train_step, under a gloo group joined here (the CLI would pick
    NCCL on the card), and the checkpoint the CLI writes. The K1 and K3
    counters are read over the steps; then ms per step over 4 more steps
    on a fresh batch with the card's defaults, and the peak memory.
    Returns (and under a group, rank r writes work_dir/rank<r>.json) the
    logs per step, launches, the replicated tensors' digest, the timings
    and the checkpoint of the seeded model (ckpt_0) and of each step (its
    train file at the last)."""
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.parallel import distributed as D
    from mcgaze_tpu_torch.tools import train as train_cli
    from mcgaze_tpu_torch.train.loop import (create_train_state,
                                             make_train_step)
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.checkpoint import save_checkpoint
    from mcgaze_tpu_torch.utils.config import load_config

    device = torch.device('cpu' if form == 'gloo_cpu' else 'cuda')
    cuda = device.type == 'cuda'
    opts = ('checkpoint_interval=1', *opts)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    opts = [f'data_train.batch_size={clips}', *opts]
    cfg = apply_overrides(load_config(TRAIN_CONFIG), opts)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    roi_align_cuda.launch_count = 0
    roi_align_cuda.bwd_launch_count = 0
    try:
        if form == 'nccl_two_cards':
            out = train_cli.main([
                TRAIN_CONFIG, '--synthetic', '--device', 'cuda', '--mesh',
                f'1,{n_model}', '--max-iters', str(steps), '--work-dir',
                work_dir, '--log-interval', '1', '--cfg-options', *opts])
            state, history = out['state'], out['history']
            device = next(state.model.parameters()).device
        else:
            from mcgaze_tpu_torch.parallel.mesh import make_mesh
            if n_model > 1:
                D.init_distributed('cpu', coordinator_address=coordinator,
                                   num_processes=n_model, process_id=rank)
            mesh = make_mesh(1, n_model)
            state = create_train_state(cfg.model, cfg.optim, seed=0,
                                       device=device, mesh=mesh)
            step_fn = make_train_step(cfg.model, cfg.optim)
            stream = train_cli.synthetic_batches(cfg, D.data_index())
            history = []
            for step in range(1, steps + 1):
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in next(stream).items()}
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                logs = step_fn(state, batch)
                history.append(dict({k: float(v) for k, v in logs.items()},
                                    time=time.perf_counter() - t0))
                # a checkpoint a step, as the CLI at checkpoint_interval=1:
                # every rank gathers (collectives), rank 0 writes
                model_sd = train_cli.model_state_dict(state)
                train_sd = (train_cli.train_state_dict(state)
                            if step == steps else None)
                if D.process_index() == 0:
                    save_checkpoint(work_dir, step, model_sd,
                                    train_state=train_sd)
                del model_sd, train_sd
        if cuda:
            torch.cuda.synchronize()
        launches = dict(k1=roi_align_cuda.launch_count,
                        k3=roi_align_cuda.bwd_launch_count)
        digest = replicated_digest(state.model.state_dict())
        # ckpt_0: the seeded model in this mesh's layout, gathered and
        # written as the steps' checkpoints are (a collective)
        start = create_train_state(cfg.model, cfg.optim, seed=0,
                                   device=device, mesh=state.mesh)
        model_sd = train_cli.model_state_dict(start)
        if D.process_index() == 0:
            save_checkpoint(work_dir, 0, model_sd)
        del start, model_sd
        # ms per step with the card's defaults, on one fresh batch
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(
            train_cli.synthetic_batches(cfg, seed=2)).items()}
        step_fn = make_train_step(cfg.model, cfg.optim)
        walls = []
        for _ in range(4):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, batch)
            if cuda:
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        result = dict(
            rank=D.process_index(), world=D.process_count(), form=form,
            mesh=f'1,{n_model}', launches=launches,
            losses=[h['loss'] for h in history],
            grad_norms=[h['grad_norm'] for h in history],
            step_seconds=[h['time'] for h in history],
            digest=digest, step_ms=float(np.median(walls[1:])),
            step_ms_all=walls,
            peak_mem_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                         if cuda else None),
            checkpoints=[os.path.join(work_dir, f'ckpt_{t}.pth')
                         for t in range(steps + 1)])
        if D.process_count() > 1:
            with open(os.path.join(work_dir,
                                   f'rank{D.process_index()}.json'),
                      'w') as f:
                json.dump(result, f)
        return result
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        if n_model > 1:
            D.shutdown_distributed()


def tp_processes(form, fn, args, timeout=600):
    """Two processes of `fn` (a function of this module, by name) called
    as fn(form, 2, *args, rank=r, coordinator=...), each a fresh
    interpreter, started together; fails unless both exit 0 (a rank that
    fails takes the other down at once, which would otherwise wait in a
    collective). args[0] is the work directory, where rank r writes
    rank<r>.json and its log. Returns their results in rank order."""
    work_dir = args[0]
    port = free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT)
        if form == 'nccl_two_cards':
            env.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                       WORLD_SIZE='2', RANK=str(rank), LOCAL_RANK=str(rank))
        code = ('import sys, json; sys.path.insert(0, sys.argv[1]); '
                'import chip_smoke as cs; getattr(cs, sys.argv[2])('
                'sys.argv[3], 2, *json.loads(sys.argv[4]), '
                'rank=int(sys.argv[5]), coordinator=sys.argv[6])')
        logs.append(open(os.path.join(work_dir, f'rank{rank}.log'), 'w+'))
        procs.append(subprocess.Popen(
            [sys.executable, '-c', code, ROOT, fn, form,
             json.dumps(list(args)), str(rank), f'127.0.0.1:{port}'],
            cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    # the rank that failed first, before one killed here
    for rank in sorted(range(2), key=lambda r: procs[r].returncode < 0):
        check(procs[rank].returncode == 0, f'tp rank {rank} ({form}) '
              f'exited {procs[rank].returncode}:\n{texts[rank][-5000:]}')
    results = []
    for rank in range(2):
        with open(os.path.join(work_dir, f'rank{rank}.json')) as f:
            results.append(json.load(f))
    return results


def results_err(a: list, b: list) -> dict:
    """Two results files' entries (one dict a video): `err`, the largest
    gaze or score difference, absolute, and box difference relative to
    the reference's largest coordinate, over the frames where both hold a
    box; `box_presence_differs`, the frames where one side's box score
    crossed the person threshold and the other's did not."""
    check(len(a) == len(b), f'{len(a)} videos against {len(b)}')
    err, presence = 0.0, 0
    for x, y in zip(a, b):
        check(sorted(x) == sorted(y), 'results keys differ')
        for k in y:
            if k.endswith(('_gazes', '_score')):
                err = max(err, float(np.abs(np.subtract(
                    np.asarray(x[k], np.float64),
                    np.asarray(y[k], np.float64))).max()))
            elif k.endswith('_bboxes'):
                both = [(u, v) for u, v in zip(x[k], y[k])
                        if u is not None and v is not None]
                presence += sum((u is None) != (v is None)
                                for u, v in zip(x[k], y[k]))
                if both:
                    xs, ys = np.asarray(both, np.float64).transpose(1, 0, 2)
                    err = max(err, float(np.abs(xs - ys).max()
                                         / max(np.abs(ys).max(), 1.0)))
    return dict(err=err, box_presence_differs=presence)


def phase_tp(device, steps=2, clips=None, opts=(), lengths=(33, 19)):
    """Tensor parallelism (the 'model' mesh axis, parallel/
    tensor_parallel.py) at full width, f32 with TF32 off and cuDNN
    deterministic: the gaze train step at --mesh 1,2 in two processes
    against the --mesh 1,1 run on the same seed and synthetic batches, in
    the form the machine allows (tp_form; printed): across two cards, the
    train CLI under NCCL; on one card, two processes sharing it over gloo
    through the library step. Checks: 4 K1 and 4 K3 per step in each
    process; the first loss within TP_LOSS_REL and grad_norm within
    TP_GRAD_NORM_REL of the 1,1 run, and the two ranks' logs equal; each
    step's checkpoint, full-shaped parameters gathered over the model
    group, within the 1x2 bounds of the 1,1 run's (TP_PARAM_RTOL, and
    TP_PARAM_ATOL_UPDATES x the lr the steps applied); the replicated
    parameters bit for bit equal on the two ranks; the seeded model
    gathered from its slices (ckpt_0) bit for bit the one-process model,
    and tools.test on it (f32, TF32 off; two fabricated .npy videos) the
    same results as on the 1,1 one; tools.test on the trained tp
    checkpoint finite, its distance from the 1,1 one's results reported
    with how the two checkpoints' weights differ (a random-weight model
    a rounding-level update away need not give the same results: the
    learned-weight comparison is phase_tp_learned's); 4 K1 a forward.
    Then ms per
    step at both meshes and each process's peak memory. `clips` per step:
    32 where two processes of the train phase's peak fit on the card
    (one card) or on each card, else 16. `opts` shrinks it for a CPU
    rehearsal. Returns the launches of the tp processes and of tools.test
    on the tp checkpoint."""
    import shutil

    from mcgaze_tpu_torch.evaluation.driver import (VideoGazeEvaluator,
                                                    clip_slices)
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.parallel import distributed as D
    from mcgaze_tpu_torch.tools import test as test_cli
    from mcgaze_tpu_torch.train.loop import step_warmup_schedule
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    form = tp_form(device)
    check(not D._active(), 'a process group is up before the tp phase')
    cfg = apply_overrides(load_config(TRAIN_CONFIG), list(opts))
    mcfg = cfg.model
    stages = mcfg.num_stages
    peak = READINGS.get('train_peak_bytes')
    if clips is None:
        total = torch.cuda.get_device_properties(device).total_memory
        share = 2 if form == 'gloo_one_card' else 1
        clips = 32 if peak is None or share * peak <= 0.85 * total else 16
    root = os.path.join(ROOT, 'work_dirs', 'chip_smoke_tp')
    shutil.rmtree(root, ignore_errors=True)
    ref_dir, tp_dir = os.path.join(root, 'mesh11'), os.path.join(root, 'tp')
    os.makedirs(ref_dir)
    os.makedirs(tp_dir)
    ann, frames = write_cli_dataset(root, lengths)['gaze360']
    decode = VideoGazeEvaluator._decode_video
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    try:
        ref = tp_run(form, 1, ref_dir, steps, clips, opts)
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = tp_processes(form, 'tp_run',
                             [tp_dir, steps, clips, list(opts)])
        tp_s = time.perf_counter() - t0
        r0, r1 = ranks
        want = dict(k1=stages * steps, k3=stages * steps)
        if device.type == 'cuda':
            for r in ranks:
                check(r['launches'] == want, f'tp rank {r["rank"]} '
                      f'launched {r["launches"]}, expected {stages} K1 and '
                      f'{stages} K3 per step')
            check(ref['launches'] == want, f'tp 1,1 run launched '
                  f'{ref["launches"]}')
        check(r0['world'] == r1['world'] == 2 and ref['world'] == 1,
              'tp: process groups of the wrong size')
        check((r0['losses'], r0['grad_norms']) == (r1['losses'],
                                                    r1['grad_norms']),
              'tp: the two ranks logged other losses or grad norms')
        check(r0['digest'] == r1['digest'], 'tp: the replicated parameters '
              'differ between the two ranks')
        finite = np.isfinite(r0['losses'] + r0['grad_norms']).all()
        loss_rel = abs(r0['losses'][0] - ref['losses'][0]) / abs(
            ref['losses'][0])
        gn_rel = abs(r0['grad_norms'][0] - ref['grad_norms'][0]) / abs(
            ref['grad_norms'][0])
        check(finite and loss_rel <= TP_LOSS_REL, f'tp first loss '
              f'{r0["losses"][0]} vs {ref["losses"][0]} ({loss_rel})')
        check(gn_rel <= TP_GRAD_NORM_REL, f'tp first grad_norm '
              f'{r0["grad_norms"][0]} vs {ref["grad_norms"][0]} ({gn_rel})')

        # each step's checkpoint: full-shaped, within the 1x2 bounds
        sched = step_warmup_schedule(cfg.optim)
        params = []
        for t, (mine, theirs) in enumerate(zip(r0['checkpoints'],
                                               ref['checkpoints'])):
            got = torch.load(mine, map_location='cpu',
                             weights_only=True)['state_dict']
            want_sd = torch.load(theirs, map_location='cpu',
                                 weights_only=True)['state_dict']
            check({k: tuple(v.shape) for k, v in got.items()} ==
                  {k: tuple(v.shape) for k, v in want_sd.items()},
                  f'tp ckpt_{t}: other tensors or shapes than the 1,1 one')
            if t == 0:
                # the seeded model gathered from its slices: bit for bit
                check(all(torch.equal(got[k], v)
                          for k, v in want_sd.items()),
                      'tp ckpt_0: the gathered seeded model differs from '
                      'the one-process model')
                continue
            atol = TP_PARAM_ATOL_UPDATES * sum(sched(i) for i in range(t))
            ratio, worst = max(
                (((got[k].double() - v.double()).abs()
                  / (atol + TP_PARAM_RTOL * v.double().abs()))
                 .max().item(), k) for k, v in want_sd.items())
            i = int(((got[worst].double() - want_sd[worst].double()).abs()
                     / (atol + TP_PARAM_RTOL
                        * want_sd[worst].double().abs())).argmax())
            params.append(dict(step=t, atol=atol, rtol=TP_PARAM_RTOL,
                               bound_ratio=ratio, worst=worst,
                               worst_element=[
                                   float(want_sd[worst].flatten()[i]),
                                   float(got[worst].flatten()[i])]))
            print(json.dumps(dict(tp_params=params[-1])), file=sys.stderr,
                  flush=True)
            check(ratio <= 1.0, f'tp parameters after step {t}: {worst} '
                  f'at {ratio} x (atol {atol} + rtol {TP_PARAM_RTOL})')
        train_file = torch.load(r0['checkpoints'][-1][:-4] + '_train.pth',
                                map_location='cpu', weights_only=True)
        moment_shapes = {tuple(st['exp_avg'].shape)
                         for st in train_file['optimizer']['state'].values()}
        check({(mcfg.ffn_channels, mcfg.channels),
               (mcfg.channels, mcfg.roi_size ** 2 * mcfg.channels)}
              <= moment_shapes, 'tp train file: the split tensors\' AdamW '
              'moments are not full-shaped')
        del got, want_sd, train_file

        # tools.test reads the tp checkpoints back: the seeded model's to
        # the 1,1 one's results exactly; the trained one's to finite
        # results, its distance from the 1,1 one's reported (two
        # random-weight models a rounding-level update apart need not
        # agree: PERF.md; phase_tp_learned checks it on learned weights)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        VideoGazeEvaluator._decode_video = npy_decode
        results = {}
        for tag, ckpt in (('mesh11_0', ref['checkpoints'][0]),
                          ('tp_0', r0['checkpoints'][0]),
                          ('mesh11', ref['checkpoints'][-1]),
                          ('tp', r0['checkpoints'][-1])):
            path = os.path.join(root, f'results_{tag}.json')
            roi_align_cuda.launch_count = 0
            test_cli.main([TRAIN_CONFIG, ckpt, '--json', ann, '--root',
                           frames, '--out', path, '--device', str(device),
                           '--dtype', 'float32', '--cfg-options',
                           'eval_cfg.crop_ratio=None', *opts])
            if device.type == 'cuda':
                torch.cuda.synchronize()
            test_launches = roi_align_cuda.launch_count
            results[tag] = check_results(path, lengths, 'float32')[0]
        fwds = sum(-(-len(clip_slices(n, 7, 4)) // 8) for n in lengths)
        if device.type == 'cuda':
            check(test_launches == stages * fwds, f'tp test launched '
                  f'{test_launches} K1, expected {stages} per forward over '
                  f'{fwds}')
        check(results['tp_0'] == results['mesh11_0'], 'tools.test on the '
              'tp ckpt_0 wrote other results than on the 1,1 one')
        test_err = results_err(results['tp'], results['mesh11'])
        # how the tp checkpoint's weights differ from the 1,1 one's
        base = torch.load(ref['checkpoints'][-1], map_location='cpu',
                          weights_only=True)['state_dict']
        tp_sd = torch.load(r0['checkpoints'][-1], map_location='cpu',
                           weights_only=True)['state_dict']
        diffs = torch.cat([(tp_sd[k] - v).abs().flatten() for k, v in
                           base.items()
                           if v.is_floating_point() and 'running_' not in k])
        weight_diff = dict(elements=diffs.numel(),
                           share_differing=float((diffs > 0).double().mean()),
                           share_over_1e_6=float((diffs > 1e-6).double()
                                                 .mean()),
                           max=float(diffs.max()))
        del tp_sd, diffs, base
    finally:
        VideoGazeEvaluator._decode_video = decode
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(k1=r0['launches']['k1'] + r1['launches']['k1'],
                    k3=r0['launches']['k3'] + r1['launches']['k3'])
    emit('tp', form=form, mesh='1,2', processes=2, steps=steps,
         clips_per_step=clips,
         clips_rule='32 clips where two processes of the train phase\'s '
                    'peak fit (per card), else 16',
         train_peak_gb=None if peak is None else peak / 1e9,
         config=os.path.relpath(TRAIN_CONFIG, ROOT),
         launches_per_process=[r0['launches'], r1['launches']],
         launches_mesh11=ref['launches'], test_launches=test_launches,
         first_loss=[ref['losses'][0], r0['losses'][0]],
         first_loss_rel_err=loss_rel, loss_bound=TP_LOSS_REL,
         first_grad_norm=[ref['grad_norms'][0], r0['grad_norms'][0]],
         first_grad_norm_rel_err=gn_rel, grad_norm_bound=TP_GRAD_NORM_REL,
         losses={'1,1': ref['losses'], '1,2': r0['losses']},
         grad_norms={'1,1': ref['grad_norms'], '1,2': r0['grad_norms']},
         params=params,
         replicated_equal=True, ckpt0_bitwise=True,
         test_ckpt0_results_equal=True, test_err_after_steps=test_err,
         weight_diff_after_steps=weight_diff,
         step_ms={'1,1': ref['step_ms'], '1,2': [r0['step_ms'],
                                                 r1['step_ms']]},
         step_ms_all={'1,1': ref['step_ms_all'],
                      '1,2': [r0['step_ms_all'], r1['step_ms_all']]},
         step_ms_note=f'{form}: median of 3 after one warm step on one '
                      'fresh batch, TF32 convolutions; the 1,2 processes '
                      'ran together' + (' on one shared card, so their '
                                        'times are no measure of tensor '
                                        'parallelism'
                                        if form == 'gloo_one_card' else ''),
         peak_mem_gb={'1,1': ref['peak_mem_gb'],
                      '1,2': [r0['peak_mem_gb'], r1['peak_mem_gb']]},
         tp_processes_seconds=tp_s, seconds=time.perf_counter() - t_phase,
         precision='float32, TF32 off, cuDNN deterministic',
         card=nvidia_smi())
    return dict(train=launches, test=test_launches)


TP_LEARNED_TOL = 1e-3     # tools.test on the two learned checkpoints


@contextlib.contextmanager
def exact_f32():
    """TF32 off for convolutions and matmuls and cuDNN deterministic
    inside; the flags as they were on exit."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def tp_learned_run(form, n_model, work_dir, cfg_path, ckpt, max_iters,
                   rank=0, coordinator=None):
    """One process of phase_tp_learned (n_model 2) or the --mesh 1,1 run
    it is held against (n_model 1, no process group): the gaze train
    CLI's main() resumed from `ckpt` (its _train.pth: optimizer and step)
    to `max_iters` at --mesh 1,n_model, seed 0, f32 with TF32 off and
    cuDNN deterministic, on the learning proof's .npy frames
    (npy_frames). gloo_one_card and gloo_cpu join a gloo group here first
    (the CLI would ask NCCL for it, which refuses two ranks on one card);
    nccl_two_cards reads torchrun's environment, set by the caller.
    Returns (and under a group, rank r writes work_dir/rank<r>.json) the
    logs per step, the K1/K3 launches and the checkpoint written."""
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.parallel import distributed as D
    from mcgaze_tpu_torch.tools import train as train_cli
    from mcgaze_tpu_torch.tools.analysis_tools.npy_frames import npy_frames

    device = 'cpu' if form == 'gloo_cpu' else 'cuda'
    roi_align_cuda.launch_count = 0
    roi_align_cuda.bwd_launch_count = 0
    try:
        if n_model > 1 and form != 'nccl_two_cards':
            D.init_distributed('cpu', coordinator_address=coordinator,
                               num_processes=n_model, process_id=rank)
        with exact_f32(), npy_frames():
            out = train_cli.main([
                cfg_path, '--device', device, '--mesh', f'1,{n_model}',
                '--resume-from', ckpt, '--max-iters', str(max_iters),
                '--work-dir', work_dir, '--log-interval', '1', '--seed',
                '0'])
        if device == 'cuda':
            torch.cuda.synchronize()
        result = dict(
            rank=D.process_index(), world=D.process_count(), form=form,
            mesh=f'1,{n_model}',
            launches=dict(k1=roi_align_cuda.launch_count,
                          k3=roi_align_cuda.bwd_launch_count),
            losses=[h['loss'] for h in out['history']],
            grad_norms=[h['grad_norm'] for h in out['history']],
            checkpoint=os.path.join(work_dir, f'ckpt_{max_iters}.pth'))
        if D.process_count() > 1:
            with open(os.path.join(work_dir,
                                   f'rank{D.process_index()}.json'),
                      'w') as f:
                json.dump(result, f)
        return result
    finally:
        if n_model > 1:
            D.shutdown_distributed()


def phase_tp_learned(device, work):
    """The model axis on learned weights: the gaze learning proof's last
    checkpoint (`work`: crop_sensitivity's --work, R26, 2 stages, 64 px,
    1,500 steps) trained 2 more steps through the train CLI's
    --resume-from at --mesh 1,1 (this process) and at --mesh 1,2 (two
    processes in tp_form's form: NCCL across two cards where visible,
    else gloo sharing the one card), f32, TF32 off, cuDNN deterministic.
    Checked: 2 K1 and 2 K3 a step in every process (one per stage), the
    two ranks' logs equal and finite, and tools.test (f32, TF32 off, the
    fixed crop) on the two checkpoints within TP_LEARNED_TOL of each other
    (gazes and scores absolute, boxes relative to the largest coordinate)
    with no box on one side only. Reported: the first loss and grad_norm
    against 1,1's, and the parameters against the JAX package's 1x2
    bounds (TP_PARAM_RTOL, TP_PARAM_ATOL_UPDATES x the lr the steps
    applied), as phase_tp holds them. Returns the launches of the tp
    processes and of tools.test on the tp checkpoint."""
    import re
    import shutil

    from mcgaze_tpu_torch.evaluation.driver import clip_slices
    from mcgaze_tpu_torch.ops import roi_align_cuda
    from mcgaze_tpu_torch.tools import test as test_cli
    from mcgaze_tpu_torch.tools.analysis_tools.npy_frames import npy_frames
    from mcgaze_tpu_torch.train.loop import step_warmup_schedule
    from mcgaze_tpu_torch.utils.checkpoint import find_latest_checkpoint
    from mcgaze_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    steps = 2
    form = tp_form(device)
    cfg_path = os.path.join(work, 'cfg.py')
    cfg = load_config(cfg_path)
    stages = cfg.model.num_stages
    ckpt = find_latest_checkpoint(os.path.join(work, 'train'))
    check(ckpt is not None, f'tp_learned: no checkpoint under {work}')
    start = int(re.search(r'ckpt_(\d+)\.pth$', ckpt).group(1))
    end = start + steps
    root = os.path.join(work, 'tp_learned')
    shutil.rmtree(root, ignore_errors=True)
    ref_dir, tp_dir = os.path.join(root, 'mesh11'), os.path.join(root, 'tp')
    os.makedirs(ref_dir)
    os.makedirs(tp_dir)
    try:
        ref = tp_learned_run(form, 1, ref_dir, cfg_path, ckpt, end)
        t0 = time.perf_counter()
        r0, r1 = tp_processes(form, 'tp_learned_run',
                              [tp_dir, cfg_path, ckpt, end])
        tp_s = time.perf_counter() - t0
        want = dict(k1=stages * steps, k3=stages * steps)
        if device.type == 'cuda':
            for r in (ref, r0, r1):
                check(r['launches'] == want, f'tp_learned {r["mesh"]} rank '
                      f'{r["rank"]} launched {r["launches"]}, expected '
                      f'{want}')
        check(r0['world'] == r1['world'] == 2 and ref['world'] == 1,
              'tp_learned: process groups of the wrong size')
        check((r0['losses'], r0['grad_norms']) == (r1['losses'],
                                                    r1['grad_norms']),
              'tp_learned: the two ranks logged other losses or grad norms')
        check(len(r0['losses']) == steps and np.isfinite(
            r0['losses'] + r0['grad_norms'] + ref['losses']).all(),
              f'tp_learned: losses {r0["losses"]}, 1,1 {ref["losses"]}')
        loss_rel = abs(r0['losses'][0] - ref['losses'][0]) / abs(
            ref['losses'][0])
        gn_rel = abs(r0['grad_norms'][0] - ref['grad_norms'][0]) / abs(
            ref['grad_norms'][0])

        # the parameters against the JAX 1x2 bounds, reported
        sched = step_warmup_schedule(cfg.optim)
        atol = TP_PARAM_ATOL_UPDATES * sum(sched(i) for i in range(start,
                                                                   end))
        got = torch.load(r0['checkpoint'], map_location='cpu',
                         weights_only=True)['state_dict']
        want_sd = torch.load(ref['checkpoint'], map_location='cpu',
                             weights_only=True)['state_dict']
        check(sorted(got) == sorted(want_sd), 'tp_learned: the checkpoints '
              'hold other tensors')
        ratio, worst = max(
            (((got[k].double() - v.double()).abs()
              / (atol + TP_PARAM_RTOL * v.double().abs())).max().item(), k)
            for k, v in want_sd.items() if v.is_floating_point())
        diffs = torch.cat([(got[k] - v).abs().flatten()
                           for k, v in want_sd.items()
                           if v.is_floating_point()
                           and 'running_' not in k])
        weight_diff = dict(elements=diffs.numel(),
                           share_differing=float((diffs > 0).double().mean()),
                           max=float(diffs.max()))
        del got, want_sd, diffs

        # tools.test on both checkpoints, the learning proof's data
        with open(os.path.join(work, 'anno.json')) as f:
            lengths = [v['length'] for v in json.load(f)['videos']]
        results = {}
        for tag, path in (('mesh11', ref['checkpoint']),
                          ('tp', r0['checkpoint'])):
            out = os.path.join(root, f'results_{tag}.json')
            roi_align_cuda.launch_count = 0
            with exact_f32(), npy_frames():
                ran = test_cli.main([
                    cfg_path, path, '--json',
                    os.path.join(work, 'anno.json'), '--root',
                    os.path.join(work, 'frames/'), '--out', out,
                    '--device', str(device), '--dtype', 'float32',
                    '--cfg-options', 'eval_cfg.crop_mode=fixed'])
            if device.type == 'cuda':
                torch.cuda.synchronize()
            test_launches = roi_align_cuda.launch_count
            results[tag] = check_results(out, lengths, 'float32')[0]
        ev = ran['evaluator'].cfg
        fwds = sum(-(-len(clip_slices(n, ev.clip_length, ev.stride))
                     // ev.clip_batch) for n in lengths)
        if device.type == 'cuda':
            check(test_launches == stages * fwds, f'tp_learned test '
                  f'launched {test_launches} K1, expected {stages} per '
                  f'forward over {fwds}')
        test_err = results_err(results['tp'], results['mesh11'])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit('tp_learned', form=form, mesh='1,2', processes=2,
         resumed_from=os.path.basename(ckpt), steps=steps,
         config='crop_sensitivity (R26, 2 stages, 64 px, 8 clips a step)',
         launches_per_process=[r0['launches'], r1['launches']],
         launches_mesh11=ref['launches'], test_launches=test_launches,
         losses={'1,1': ref['losses'], '1,2': r0['losses']},
         grad_norms={'1,1': ref['grad_norms'], '1,2': r0['grad_norms']},
         first_loss_rel_err=loss_rel, first_grad_norm_rel_err=gn_rel,
         params=dict(atol=atol, rtol=TP_PARAM_RTOL, bound_ratio=ratio,
                     worst=worst, checked=False),
         weight_diff=weight_diff, test_err=test_err,
         test_tol=TP_LEARNED_TOL, tp_processes_seconds=tp_s,
         seconds=time.perf_counter() - t_phase,
         precision='float32, TF32 off, cuDNN deterministic',
         card=nvidia_smi())
    check(test_err['err'] <= TP_LEARNED_TOL
          and test_err['box_presence_differs'] == 0,
          f'tp_learned: tools.test on the --mesh 1,2 checkpoint is '
          f'{test_err} from the 1,1 one\'s (tol {TP_LEARNED_TOL})')
    return dict(train=dict(k1=r0['launches']['k1'] + r1['launches']['k1'],
                           k3=r0['launches']['k3'] + r1['launches']['k3']),
                test=test_launches)


# ------------------------------------------------------------- learning

# the JAX tools' counts (tools/analysis_tools/*.py), as the proofs' own
# defaults give them
# ------------------------------------------------------------- the tools

TOOLS_BUDGET_S = 150.0     # the phase's share of the script's time limit


def json_lines(text):
    """Every stdout line that is a JSON object, parsed."""
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith('{')]


def all_finite(obj):
    """Every number in a parsed line is finite."""
    if isinstance(obj, dict):
        return all(all_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(all_finite(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return bool(np.isfinite(obj))
    return True


def numbers_in(text):
    """The numbers of a tool's text lines, as floats."""
    import re
    return [float(x) for x in re.findall(r'-?\d+\.\d+|-?\d+', text)]


def phase_tools(device, opts=(), image=224, clips=32, query_hw=(384, 640),
                frames=24, rehearse=False):
    """The port's measurement tools in this process, each through its
    main(argv) on the card, at full width (the shipped gaze360 config, its
    fused configuration, InstBlink R-50; seeded random weights) and few
    iterations: collect_env; benchmark synthetic (bf16, `clips` clips a
    forward) and --e2e on two fabricated .npy videos of `frames` frames
    with the fused configuration (K1, K4, K5); dedup_bench at 8 and 32
    clips; backbone_bench (plain and the fused subsets, `clips` x 7
    frames); step_breakdown, gaze and InstBlink (`query_hw`); get_flops,
    plain and fused eval, plain --train; train_bench, the f32 step and
    --e2e over fabricated .npy frames; serve_bench engine mode (bf16,
    concurrency 1 and 4); the train CLI with --profile-dir for 6 steps,
    then analyze_logs on its log; roi_kernel_check (K1 and K3 against the
    plain version on both routes, every case inside its --tol). For each,
    the launch counters reset
    before and read after, equal to what its arguments make it launch;
    every number it prints finite. Besides: fwd_dedup against fwd on
    dedup_bench's inputs at TOL_E2E (f32, TF32 off); each fused subset
    launching K5 in its stages only; the fused forward's flops within 1%
    of the plain one's; a trace that names K1 and K3. `opts` and the
    sizes shrink it for a CPU rehearsal. Returns the launches by tool."""
    import shutil

    from mcgaze_tpu_torch.evaluation.driver import clip_slices
    from mcgaze_tpu_torch.evaluation.forward import make_eval_forward
    from mcgaze_tpu_torch.models.mcgaze import ModelConfig
    from mcgaze_tpu_torch.tools import kernel_bounds
    from mcgaze_tpu_torch.tools import train as train_cli
    from mcgaze_tpu_torch.tools.analysis_tools import (
        analyze_logs, backbone_bench, benchmark, dedup_bench, get_flops,
        roi_kernel_check, serve_bench, step_breakdown, train_bench)
    from mcgaze_tpu_torch.utils import collect_env
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    dev = str(device)
    cfg_opts = ['--cfg-options', *opts] if opts else []
    cfg = apply_overrides(load_config(TRAIN_CONFIG), list(opts) or None)
    stages = cfg.model.num_stages
    k5_forward = sum(kernel_bounds.k5_launches(ch)
                     for ch in kernel_bounds.chains(cfg.model.backbone_depth))
    root = os.path.join(ROOT, 'work_dirs', 'chip_smoke_tools')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    runs, seconds, readings = {}, {}, {}

    def run(name, main, argv, expected):
        """main(argv) with the counters from 0, checked against `expected`
        (None: the caller checks them); its return and stdout."""
        buf = io.StringIO()
        reset_counters()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                ret = main(argv)
            if device.type == 'cuda':
                torch.cuda.synchronize()
        except BaseException:
            print(buf.getvalue()[-4000:], file=sys.stderr)
            raise
        seconds[name] = time.perf_counter() - t0
        got = fused_counters()
        if expected is not None:
            want = dict(dict(k1=0, k3=0, k4=0, k5=0), **expected)
            check(got == want, f'tools {name}: launched {got}, its '
                  f'arguments make it launch {want}')
        runs[name] = got
        text = buf.getvalue()
        check(all(all_finite(x) for x in json_lines(text)) and
              all(np.isfinite(numbers_in(text))),
              f'tools {name}: a number it printed is not finite:\n'
              f'{text[-2000:]}')
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        return ret, text

    try:
        # environment
        info, _ = run('collect_env', lambda argv: collect_env.collect_env(),
                      [], {})
        readings['collect_env'] = {k: info[k] for k in (
            'torch', 'torch cuda', 'cudnn', 'cv2', 'scipy', 'triton', 'nvcc',
            'devices', 'native_loader', 'cuda_kernels')}
        if not rehearse:
            check(info['cuda'] == 'available' and
                  torch.cuda.get_device_name(0) in info['devices'],
                  f'collect_env: {info}')
            check(info['cuda_kernels'].endswith('not built: none'),
                  f'collect_env kernels: {info["cuda_kernels"]}')

        # benchmark: synthetic, then --e2e on the fused configuration
        iters = 3
        ret, _ = run('benchmark', benchmark.main, [
            TRAIN_CONFIG, '--synthetic', '--dtype', 'bfloat16', '--batch',
            str(clips), '--iters', str(iters), '--warmup', '1', '--device',
            dev, *cfg_opts], dict(k1=stages * (iters + 1)))
        readings['benchmark'] = dict(clips_per_s=ret['clips_per_s'],
                                     ms_per_forward=ret['ms'])
        e2e_batch = 8
        n_fwd = -(-len(clip_slices(frames, 7, 4)) // e2e_batch)
        passes = 2 + 1                  # two timed videos and one warm
        ret, _ = run('benchmark_e2e_fused', benchmark.main, [
            TRAIN_CONFIG, '--e2e', '--e2e-videos', '2', '--e2e-frames',
            str(frames), '--batch', str(e2e_batch), '--dtype', 'bfloat16',
            '--json', os.path.join(root, 'absent.json'), '--device', dev,
            '--cfg-options', *opts, *FUSED_OPTS],
            dict(k1=stages * n_fwd * passes, k4=stages * n_fwd * passes,
                 k5=k5_forward * n_fwd * passes))
        readings['benchmark_e2e_fused'] = dict(
            frames_per_s=ret['frames_per_s'], decoder=ret['decoder'],
            phases_s=ret['phases'])

        # dedup_bench, and fwd_dedup against fwd on its inputs
        counts = (8, clips)
        rows, _ = run('dedup_bench', dedup_bench.main, [
            '--clips', *map(str, counts), '--image', str(image), '--iters',
            str(iters), '--warmup', '1', '--device', dev],
            dict(k1=4 * (iters + 1) * 2 * len(counts)))
        readings['dedup_bench'] = [{k: r[k] for k in (
            'clips', 'ms_plain', 'ms_dedup', 'speedup')} for r in rows]
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        try:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            _, fwd, fwd_dedup = make_eval_forward(
                ModelConfig(dtype='float32'), device=device)
            fr, sel, whwh_u, imgs, whwh = dedup_bench.dedup_inputs(
                np.random.RandomState(0), 8, image, 4, 7, device)
            dedup_err = e2e_err(fwd_dedup(fr, sel, whwh_u, 7),
                                fwd(imgs, whwh, 7))
            del fwd, fwd_dedup, fr, imgs
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        check(dedup_err <= TOL_E2E, f'dedup_bench: fwd_dedup vs fwd '
              f'{dedup_err} > {TOL_E2E} (f32, TF32 off)')

        # backbone_bench: K5 in each subset's stages only
        chains = kernel_bounds.chains(50)

        def subset_k5(spec):
            stages_in = range(4) if spec is True else (spec or ())
            return sum(kernel_bounds.k5_launches(chains[s])
                       for s in stages_in)

        calls = iters + 1
        rows, _ = run('backbone_bench', backbone_bench.main, [
            '--batch', str(clips * 7), '--image', str(image), '--iters',
            str(iters), '--warmup', '1', '--device', dev],
            dict(k5=calls * sum(subset_k5(v)
                                for v in backbone_bench.VARIANTS.values())))
        for r in rows:
            want = calls * subset_k5(backbone_bench.VARIANTS[r['variant']])
            check(r['k5_launches'] == want, f'backbone_bench {r["variant"]}:'
                  f' {r["k5_launches"]} K5 launches, its stages make {want}')
        readings['backbone_bench'] = {r['variant']: r['ms_per_step']
                                      for r in rows}

        # step_breakdown, gaze and InstBlink
        sb_iters = 2
        ms, _ = run('step_breakdown', step_breakdown.main, [
            '--batch', str(clips), '--image', str(image), '--iters',
            str(sb_iters), '--warmup', '1', '--device', dev],
            dict(k1=(2 + 4) * (sb_iters + 1)))
        readings['step_breakdown'] = ms
        ms, _ = run('step_breakdown_query', step_breakdown.main, [
            '--family', 'query', '--batch', '4', '--height',
            str(query_hw[0]), '--width', str(query_hw[1]), '--iters',
            str(sb_iters), '--warmup', '1', '--device', dev],
            dict(k1=(2 + 4 + 6) * (sb_iters + 1)))
        readings['step_breakdown_query'] = ms

        # get_flops: plain and fused forwards, the plain train step
        flops = {}
        for name, argv, want in (
                ('get_flops', [*cfg_opts], dict(k1=stages)),
                ('get_flops_fused', ['--cfg-options', *opts, *FUSED_OPTS],
                 dict(k1=stages, k4=stages, k5=k5_forward)),
                ('get_flops_train', ['--train', *cfg_opts],
                 dict(k1=stages, k3=stages))):
            argv = [TRAIN_CONFIG, '--device', dev, *argv]
            ca, _ = run(name, get_flops.main, argv, want)
            flops[name] = ca['flops']
            readings[name] = dict(flops=ca['flops'],
                                  operator_bytes=ca['operator bytes accessed'],
                                  operator_calls=ca['operator calls'])
        rel = abs(flops['get_flops_fused'] - flops['get_flops']) / \
            flops['get_flops']
        check(rel <= 0.01, f'get_flops: fused forward {flops["get_flops_fused"]}'
              f' flops against plain {flops["get_flops"]} ({rel:.4f} > 1%)')
        readings['get_flops_fused']['rel_to_plain'] = rel

        # train_bench: the eager step, then the input path
        tb_iters = 2
        rows, _ = run('train_bench', train_bench.main, [
            '--batch', str(clips), '--image', str(image), '--iters',
            str(tb_iters), '--warmup', '1', '--dtypes', 'float32',
            '--device', dev],
            dict(k1=4 * (tb_iters + 1), k3=4 * (tb_iters + 1)))
        readings['train_bench'] = rows
        e2e_iters = 3
        rows, _ = run('train_bench_e2e', train_bench.main, [
            '--e2e', '--videos', '2', '--frames', str(frames), '--batch',
            '4', '--image', str(image), '--iters', str(e2e_iters),
            '--warmup', '1', '--roofline-iters', '2', '--dtypes', 'float32',
            '--device', dev],
            dict(k1=4 * (e2e_iters + 1), k3=4 * (e2e_iters + 1)))
        readings['train_bench_e2e'] = rows

        # serve_bench: warmup runs 4 buckets and 4 video chunks
        levels = (1, 4)
        out, _ = run('serve_bench', serve_bench.main, [
            '--image', str(image), '--dtype', 'bfloat16', '--requests', '8',
            '--concurrency', *map(str, levels), '--max-batch', '8',
            '--device', dev], None)
        # each level: one lone request, then the batcher's launches
        forwards = 4 + 4 + sum(1 + r['launches'] for r in out['results'])
        check(runs['serve_bench'] == dict(k1=4 * forwards, k3=0, k4=0, k5=0),
              f'serve_bench: launched {runs["serve_bench"]}, its '
              f'{forwards} forwards make {4 * forwards} K1')
        readings['serve_bench'] = out

        # the train CLI with --profile-dir, then analyze_logs on its log
        prof = os.path.join(root, 'prof')
        work = os.path.join(root, 'train')
        steps = 6          # traces iterations 3-5
        ret, text = run('train_profile_dir', train_cli.main, [
            TRAIN_CONFIG, '--synthetic', '--device', dev, '--max-iters',
            str(steps), '--work-dir', work, '--profile-dir', prof,
            *cfg_opts], dict(k1=stages * steps, k3=stages * steps))
        check(f'profiler trace -> {prof}' in text, 'train --profile-dir: '
              'no trace line')
        traces = os.listdir(prof)
        check(len(traces) == 1, f'train --profile-dir: {traces}')
        with open(os.path.join(prof, traces[0])) as f:
            trace_text = f.read()
        names = ('roi_align_fpn_kernel', 'roi_align_fpn_bwd_kernel')
        if not rehearse:
            check(all(n in trace_text for n in names),
                  f'train --profile-dir: the trace names '
                  f'{[n for n in names if n in trace_text]} of {names}')
        readings['train_profile_dir'] = dict(
            trace_mb=len(trace_text) / 2 ** 20,
            names={n: trace_text.count(n) for n in names},
            ms_per_step=float(np.median([h['time'] for h in
                                         ret['history'][1:]])) * 1e3)
        del trace_text
        _, text = run('analyze_logs', analyze_logs.main, [
            'cal_train_time', os.path.join(work, 'train_log.jsonl')], {})
        check('avg iter time' in text, f'analyze_logs: {text}')

        # roi_kernel_check: K1 and K3 against the plain version, each
        # route one forward and its backward a shape
        n_cases = 2 * len(roi_kernel_check.SHAPES)
        ret, text = run('roi_kernel_check', roi_kernel_check.main,
                        ['--device', dev], dict(k1=n_cases, k3=n_cases))
        lines = json_lines(text)
        check(ret == 0 and len(lines) == 2 * n_cases and
              all(x['ok'] for x in lines),
              f'roi_kernel_check failed:\n{text[-3000:]}')
        readings['roi_kernel_check'] = lines
    finally:
        shutil.rmtree(root, ignore_errors=True)

    phase_s = time.perf_counter() - t_phase
    launches = {k: sum(r[k] for r in runs.values())
                for k in ('k1', 'k3', 'k4', 'k5')}
    emit('tools', readings=readings, launches_by_tool=runs,
         launches=launches, seconds_by_tool=seconds, seconds=phase_s,
         budget_s=TOOLS_BUDGET_S,
         dedup_err_f32=dedup_err, card=nvidia_smi())
    return launches


GAZE_PROOF = ('--iters', '1500', '--videos', '20', '--frames', '24')
INSTBLINK_PROOF = ('--iters', '600', '--train-videos', '20',
                   '--test-videos', '6')
# the band a model that learned clears: about twice the JAX package's
# error and 0.85x / 0.55x its APs (its tools' readings, taken on a TPU:
# MAE-Front180 1.247 deg fixed crop, 1.41 / 1.33 reference crop; track mAP
# 0.9252, blink action AP 0.5333); random weights score tens of degrees
# and APs near 0. The InstBlink half is reported only (phase_learning)
BAND_FIXED_MAE = 2.5
BAND_REFERENCE_MAE = 3.0
BAND_TRACK_MAP = 0.80
BAND_BLINK_AP = 0.30


def learning_tool(name, args, work, device):
    """One learning proof in this process, f32 with TF32 off: `name`
    'gaze' (crop_sensitivity.main) or 'instblink' (instblink_burnin.main)
    on its fabricated dataset under `work`, the port's train and eval
    CLIs' mains wrapped to count the K1/K3/K4/K5 launches of each run
    (counters reset before, read after). Returns (the tool's result, its
    seconds, the runs in order: dict(cli, launches, and for a train run
    its per-step history, for an eval run its seconds and the driver's
    clip_length, stride, overlap and clip_batch)), all but the gaze
    tool's result JSON-able. Its stdout goes to work + '.log'."""
    from mcgaze_tpu_torch.tools import test as test_cli
    from mcgaze_tpu_torch.tools import test_instblink, train_instblink
    from mcgaze_tpu_torch.tools import train as train_cli
    from mcgaze_tpu_torch.tools.analysis_tools import (crop_sensitivity,
                                                       instblink_burnin)

    clis = ((train_cli, test_cli) if name == 'gaze'
            else (train_instblink, test_instblink))
    mains = {cli: cli.main for cli in clis}
    runs = []

    def counted(cli):
        def run(argv):
            reset_counters()
            out = mains[cli](argv)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            rec = dict(cli=cli.__name__.rsplit('.', 1)[1],
                       launches=fused_counters())
            if 'history' in out:
                rec['history'] = out['history']
            else:
                cfg = out['evaluator'].cfg
                rec.update(seconds=out['seconds'], **{
                    k: getattr(cfg, k) for k in ('clip_length', 'stride',
                                                 'overlap', 'clip_batch')
                    if hasattr(cfg, k)})
            runs.append(rec)
            return out
        return run

    os.makedirs(os.path.dirname(work), exist_ok=True)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for cli in clis:
            cli.main = counted(cli)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with open(work + '.log', 'w') as log, \
                contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            if name == 'gaze':
                result = crop_sensitivity.main(
                    [*args, '--work', work, '--device', str(device)])
            else:
                result = instblink_burnin.main(
                    [*args, '--root', work, '--device', str(device)])
            return result, time.perf_counter() - t0, runs
    except BaseException:
        with open(work + '.log') as log:
            print(log.read()[-6000:], file=sys.stderr)
        raise
    finally:
        for cli in clis:
            cli.main = mains[cli]
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def learning_tool_process(name, args, work, device):
    """learning_tool in a process of its own (the tools are host-bound,
    so two run side by side on the card's host); writes its JSON-able
    part to work + '.json'."""
    result, seconds, runs = learning_tool(name, args, work,
                                          torch.device(device))
    with open(work + '.json', 'w') as f:
        json.dump(dict(checkpoints={str(k): v for k, v in
                                    result['checkpoints'].items()},
                       evals=len(result['evals']), seconds=seconds,
                       runs=runs), f)


def phase_learning(device, gaze_args=GAZE_PROOF,
                   instblink_args=INSTBLINK_PROOF, bands=True):
    """The learning proofs on the card, f32 with TF32 off: the gaze tool
    (crop_sensitivity.main: R26, 2 stages, 64 px, 8 clips a step, trained
    then scored with the fixed crop and the reference crop at seeds 0 and
    1) in this process and, side by side in a process of its own, the
    InstBlink tool (instblink_burnin.main: R-50, 3 stages, 20 queries, 4
    clips x 5 frames on 96x128, scored at its first and last checkpoint),
    each on its fabricated .npy dataset through the port's train and eval
    CLIs (learning_tool). The launch counters reset before and read after
    each CLI run: K1 and K3 once per stage on every train step (launches
    = stages x steps), K1 once per stage on every eval forward and no K3
    there, no K4 or K5. Every metric finite; each tool's loss over its
    last 50 steps below its first 50. With `bands`, the gaze fixed-crop
    MAE-Front180 at most BAND_FIXED_MAE and each reference seed at most
    BAND_REFERENCE_MAE. The InstBlink band (track mAP >= BAND_TRACK_MAP,
    blink action AP >= BAND_BLINK_AP at the last checkpoint) is reported,
    not checked: no run of the port on the card and no f32 run of the JAX
    package's own tool clears its blink half (ROADMAP Queue 3). Seconds
    of each tool, ms per train step (median after the first 10 steps).
    Then phase_tp_learned on the gaze tool's last checkpoint. A CPU
    rehearsal passes small counts and bands=False. Returns the launches
    of all runs (the proofs' K1 and K3; phase_tp_learned's under
    'tp_learned')."""
    import shutil

    from mcgaze_tpu_torch.evaluation.driver import clip_slices
    from mcgaze_tpu_torch.evaluation.instblink_driver import clip_windows
    from mcgaze_tpu_torch.utils.config import load_config
    from mcgaze_tpu_torch.utils.query_config import load_query_config

    root = os.path.join(ROOT, 'work_dirs', 'chip_smoke_learning')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ib_work = os.path.join(root, 'instblink')
    code = ('import sys, json; sys.path.insert(0, sys.argv[1]); '
            'import chip_smoke as cs; cs.learning_tool_process('
            "'instblink', json.loads(sys.argv[2]), sys.argv[3], "
            'sys.argv[4])')
    with open(os.path.join(root, 'instblink_process.log'), 'w+') as plog:
        proc = subprocess.Popen(
            [sys.executable, '-c', code, ROOT,
             json.dumps(list(instblink_args)), ib_work, str(device)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=plog,
            stderr=subprocess.STDOUT)
        try:
            gaze, gaze_s, runs = learning_tool(
                'gaze', gaze_args, os.path.join(root, 'gaze'), device)
            proc.wait(timeout=1200)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        plog.seek(0)
        check(proc.returncode == 0, f'learning: the InstBlink tool exited '
              f'{proc.returncode}:\n{plog.read()[-5000:]}')
    with open(ib_work + '.json') as f:
        blink = json.load(f)
    runs += blink['runs']
    seconds = dict(gaze=gaze_s, instblink=blink['seconds'])

    gaze_stages = load_config(os.path.join(
        root, 'gaze', 'cfg.py')).model.num_stages
    ib_stages = load_query_config(os.path.join(
        root, 'instblink', 'burnin_cfg.py')).model.num_stages

    def lengths(ann):
        with open(ann) as f:
            return [v['length'] for v in json.load(f)['videos']]
    gaze_lengths = lengths(os.path.join(root, 'gaze', 'anno.json'))
    ib_lengths = lengths(os.path.join(root, 'instblink', 'test.json'))
    check([r['cli'] for r in runs] == ['train', 'test', 'test', 'test',
                                       'train_instblink']
          + ['test_instblink'] * blink['evals'],
          f'learning ran {[r["cli"] for r in runs]}')
    summary = []
    for r in runs:
        k = r['launches']
        if r['cli'].startswith('train'):
            stages = gaze_stages if r['cli'] == 'train' else ib_stages
            history = r['history']
            steps = len(history)
            expected = dict(k1=stages * steps, k3=stages * steps, k4=0,
                            k5=0)
            what = f'{stages} K1 and {stages} K3 on every one of {steps} steps'
            losses = [h['loss'] for h in history]
            check(np.isfinite(losses).all(), f'{r["cli"]}: a loss is not '
                  'finite')
            window = max(1, min(50, steps // 2))
            check(np.mean(losses[-window:]) < np.mean(losses[:window]),
                  f'{r["cli"]}: the loss did not fall: first '
                  f'{np.mean(losses[:window])}, last '
                  f'{np.mean(losses[-window:])}')
            times = [h['time'] for h in history][10:] or \
                [h['time'] for h in history]
            extra = dict(steps=steps, loss_every_100=losses[::100],
                         last_loss=losses[-1],
                         ms_per_step=float(np.median(times)) * 1e3)
            if 'match_ms' in history[0]:
                extra['match_ms'] = float(np.median(
                    [h['match_ms'] for h in history]))
        else:
            if r['cli'] == 'test':
                forwards = sum(
                    -(-len(clip_slices(n, r['clip_length'], r['stride']))
                      // r['clip_batch']) for n in gaze_lengths)
                stages = gaze_stages
            else:
                forwards = sum(
                    -(-len(clip_windows(n, min(r['clip_length'], n),
                                        min(r['clip_length'], n)
                                        - r['overlap'])) // r['clip_batch'])
                    for n in ib_lengths)
                stages = ib_stages
            expected = dict(k1=stages * forwards, k3=0, k4=0, k5=0)
            what = f'{stages} K1 on every one of {forwards} forwards'
            extra = dict(forwards=forwards, seconds=r['seconds'])
        if device.type == 'cuda':
            check(k == expected, f'learning {r["cli"]} launched {k}, '
                  f'expected {what}, no K3 in eval, no K4 or K5')
        summary.append(dict(cli=r['cli'], launches=k, **extra))

    maes = [gaze['fixed_mae'], *gaze['reference_seeds']]
    aps = [v for s in blink['checkpoints'].values() for v in s.values()]
    check(np.isfinite(maes + [gaze['delta_deg']]).all(),
          f'learning: gaze MAEs not finite: {gaze}')
    check(np.isfinite(aps).all() and len(blink['checkpoints']) >= 1,
          f'learning: InstBlink APs not finite: {blink["checkpoints"]}')
    launches = dict(k1=sum(r['launches']['k1'] for r in runs),
                    k3=sum(r['launches']['k3'] for r in runs))
    last = blink['checkpoints'][max(blink['checkpoints'], key=int)]
    emit('learning', gaze={k: gaze[k] for k in (
             'fixed_mae', 'reference_mae_mean', 'reference_seeds',
             'delta_deg')},
         gaze_args=list(gaze_args),
         instblink=blink['checkpoints'],
         instblink_args=list(instblink_args), runs=summary,
         seconds=seconds, launches=launches,
         gaze_band=dict(fixed_mae=BAND_FIXED_MAE,
                        reference_mae=BAND_REFERENCE_MAE, checked=bands),
         instblink_band=dict(
             track_mAP=BAND_TRACK_MAP, blink_ap=BAND_BLINK_AP,
             cleared=bool(last['track_mAP'] >= BAND_TRACK_MAP
                          and last['blink_ap'] >= BAND_BLINK_AP),
             checked=False),
         precision='float32, TF32 off', card=nvidia_smi())
    if bands:
        check(gaze['fixed_mae'] <= BAND_FIXED_MAE,
              f'learning: gaze fixed-crop MAE-Front180 '
              f'{gaze["fixed_mae"]} > {BAND_FIXED_MAE}')
        check(max(gaze['reference_seeds']) <= BAND_REFERENCE_MAE,
              f'learning: gaze reference-crop MAE-Front180 '
              f'{gaze["reference_seeds"]} > {BAND_REFERENCE_MAE}')
    launches['tp_learned'] = phase_tp_learned(device,
                                              os.path.join(root, 'gaze'))
    del runs, gaze, blink
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
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

    # one nvcc a source, all started together; the K1 and K3 phases start
    # as soon as those two libraries are built, K4's once all are (a
    # thread reads the other builds' output meanwhile)
    t0 = time.perf_counter()
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {n: _native._start(n) for n in _native.SOURCES
              if not _native.library_path(n).exists()}
    built, errors = {}, []

    def finish(names):
        for n in names:
            log = _native._finish(n, *builds[n]) if n in builds else ''
            built[n] = dict(seconds=time.perf_counter() - t0, ptxas=[
                ln.strip() for ln in log.splitlines()
                if 'registers' in ln or 'spill' in ln][:8])

    def finish_rest():
        try:
            finish(('fused_bottleneck', 'stqi_attention'))
        except BaseException as e:         # raised in the main thread
            errors.append(e)

    rest = threading.Thread(target=finish_rest, daemon=True)
    try:
        finish(('roi_align_fpn', 'roi_align_fpn_bwd'))
        ready_s = time.perf_counter() - t0
        rest.start()
        timer = Timer(device)
        cases = phase_kernel(device, timer)
        bwd_cases = phase_kernel_bwd(device, timer)
        rest.join()
        if errors:
            raise errors[0]
    finally:
        for proc, tmp, _ in builds.values():
            if proc.poll() is None:        # only after a failure
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    emit('build', seconds=time.perf_counter() - t0,
         roi_align_ready_seconds=ready_s, kernels=built)
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
    train_launches, train_step, train_ms, ckpt = phase_train(device)
    phase_train_profile(train_step, train_ms)
    del train_step
    torch.cuda.empty_cache()
    train_fused_launches = phase_train_fused(device, train_ms)
    serve_launches = phase_serve(device, ckpt)
    export_launches = phase_export(device, ckpt)
    cli_launches = phase_cli(device, ckpt)
    demo_launches = phase_demo(device)
    ib_train_launches, ib_ckpt = phase_instblink_train(device)
    ib_eval_launches = phase_instblink_eval(device, ib_ckpt)
    tevit_k1, tevit_k3 = phase_tevit_kernel(device, Timer(device))
    torch.cuda.empty_cache()
    tv_train_launches, tv_ckpt = phase_instblink_train(
        device, config=TEVIT_CONFIG, phase='tevit_train')
    tv_eval_launches = phase_instblink_eval(
        device, tv_ckpt, config=TEVIT_CONFIG, phase='tevit_eval')
    ddp_launches = phase_ddp(device)
    tp_launches = phase_tp(device)
    tools_launches = phase_tools(device)
    learning_launches = phase_learning(device)

    # each kernel beside the case of the path that runs it: K1 at the eval
    # shape (bf16, frame_idx), K3 at the training shape (f32, identity), K4
    # at the eval shape (f32, 32 clips), K5 summed over the four stage
    # chains at the eval shape in bf16, its f32 case (fused training and
    # the f32 export) beside it
    k1 = next(c for c in cases if c['shape'] == 'gaze_eval'
              and c['dtype'] == 'bfloat16' and c['form'] == 'frame_idx')
    k3 = next(c for c in bwd_cases if c['shape'] == 'gaze_train'
              and c['dtype'] == 'float32' and c['form'] == 'identity')
    k4 = next(c for c in k4_cases if c['shape'] == 'gaze_eval')
    def k5_summed(dtype, more=()):
        rows = [c for c in k5_cases if c['dtype'] == dtype]
        worst = max(rows, key=lambda c: c['max_abs_err'] / c['tol'])
        return dict(shape='resnet50 chains layer1-4', dtype=dtype,
                    form='131 frames at 224 px, summed',
                    max_abs_err=worst['max_abs_err'], tol=worst['tol'],
                    **{k: sum(c[k] for c in rows)
                       for k in ('ms', 'plain_ms', 'plain_blocks_ms',
                                 'bound_ms', 'launch_floor_ms', 'library_ms',
                                 *more)},
                    bound_by=('operations' if all(
                        c['bound_by'] == 'operations' for c in rows)
                        else 'bytes'))

    k5 = k5_summed('bfloat16')
    k5_f32 = k5_summed('float32', ('bound_fma_ms', 'split_ms'))
    k5_f32['kernel_vs_f64'] = max(c['kernel_vs_f64'] for c in k5_cases
                                  if c['dtype'] == 'float32')

    def tevit_cases(cases):
        return dict(tevit_cases=[
            {k: c[k] for k in ('shape', 'dtype', 'form', 'n', 'r',
                               'max_abs_err', 'tol', 'ms', 'plain_ms',
                               'bound_ms', 'bound_by')} for c in cases])

    def line(name, source, replaces, launches, case, more=None):
        extra = {k: case[k] for k in ('plain_blocks_ms', 'launch_floor_ms')
                 if k in case}
        extra.update(more or {})
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
                  train=train_launches['k1'], **cli_launches,
                  serve=serve_launches, export=export_launches['plain']['k1'],
                  export_fused=export_launches['fused']['k1'],
                  export_fused_f32=export_launches['fused_f32']['k1'],
                  demo=demo_launches, instblink_eval=ib_eval_launches,
                  instblink_train=ib_train_launches['k1'],
                  tevit_train=tv_train_launches['k1'],
                  tevit_eval=tv_eval_launches,
                  ddp_train=ddp_launches['train']['k1'],
                  ddp_test=ddp_launches['test'],
                  tp_train=tp_launches['train']['k1'],
                  tp_test=tp_launches['test'],
                  tools=tools_launches['k1'],
                  learning=learning_launches['k1'],
                  tp_learned_train=learning_launches['tp_learned']['train'][
                      'k1'],
                  tp_learned_test=learning_launches['tp_learned']['test']),
             k1,
             tevit_cases(tevit_k1)),
        line('roi_align_fpn_bwd',
             'mcgaze_tpu_torch/csrc/roi_align_fpn_bwd.cu',
             'mcgaze_tpu/ops/roi_align_pallas.py:772',
             dict(train=train_launches['k3'],
                  instblink_train=ib_train_launches['k3'],
                  tevit_train=tv_train_launches['k3'],
                  ddp_train=ddp_launches['train']['k3'],
                  tp_train=tp_launches['train']['k3'],
                  tools=tools_launches['k3'],
                  learning=learning_launches['k3'],
                  tp_learned_train=learning_launches['tp_learned']['train'][
                      'k3']), k3,
             tevit_cases(tevit_k3)),
        line('fused_stqi_attention',
             'mcgaze_tpu_torch/csrc/stqi_attention.cu',
             'mcgaze_tpu/ops/stqi_attention.py:110',
             dict(eval_fused=fused_launches['k4'],
                  export_fused=export_launches['fused']['k4'],
                  export_fused_f32=export_launches['fused_f32']['k4'],
                  tools=tools_launches['k4']), k4),
        line('fused_bottleneck_chain',
             'mcgaze_tpu_torch/csrc/fused_bottleneck.cu',
             'mcgaze_tpu/ops/fused_bottleneck.py:125',
             dict(eval_fused=fused_launches['k5'],
                  train_fused=train_fused_launches['k5'],
                  export_fused=export_launches['fused']['k5'],
                  export_fused_f32=export_launches['fused_f32']['k5'],
                  tools=tools_launches['k5']),
             k5, dict(float32={k: k5_f32[k] for k in (
                 'max_abs_err', 'tol', 'ms', 'plain_ms', 'library_ms',
                 'plain_blocks_ms', 'bound_ms', 'bound_by',
                 'launch_floor_ms', 'bound_fma_ms', 'split_ms',
                 'kernel_vs_f64')},
                 float32_route='3xTF32 on wgmma (conv_gemm_tf32x3), '
                               'bound at 495 / 3 TFLOP/s; bound_fma_ms at '
                               'the FMA body\'s 67'))]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
