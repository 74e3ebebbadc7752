"""Host time of one call of K1's wrapper (the FPN RoIAlign forward,
`ops/roi_align_cuda.py::launch_roi_align_fpn`): the checks, the output's
allocation, the argument marshalling and the launch; and of
`roi_align_fpn`, the entry the model calls, which adds what stands in
front of the launch (the operator `mcgaze::roi_align_fpn`'s dispatch and
gradient registration; in checkouts before the operator, an autograd
Function), as the eager forward pays them on every call. On one CUDA
card, at the gaze eval shape (bf16, frame_idx form: 224 slots of 3 RoIs
on 131 frames at 224 px, C=256) and the train shape (f32, identity form,
224 frames), the latter also with features that need a gradient, as a
train step calls it. From the root of a checkout:

    python -m mcgaze_tpu_torch.tools.k1_host_us

It imports `mcgaze_tpu_torch` from the path, so
`cd OTHER && PYTHONPATH=. python /path/to/this/mcgaze_tpu_torch/tools/k1_host_us.py`
times another checkout's wrapper (say, the parent commit unpacked with
`git archive`). Prints one JSON object: per case and entry the median and
mean microseconds of `reps` calls, each timed alone on the host's clock.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch


def inputs(device, dtype, frames, slots, frame_map, img=224, c=256, r=3):
    rng = np.random.RandomState(0)
    feats = tuple(torch.from_numpy(rng.randn(frames, img // s, img // s, c)
                                   .astype(np.float32)).to(device, dtype)
                  for s in (4, 8, 16, 32))
    ctr = rng.uniform(40, img - 40, (slots, r, 2))
    half = rng.uniform(16, 60, (slots, r, 1))
    rois = torch.from_numpy(np.concatenate([ctr - half, ctr + half], -1)
                            .astype(np.float32)).to(device)
    fidx = (None if frame_map is None else
            torch.from_numpy(frame_map.astype(np.int32)).to(device))
    return feats, rois, fidx


def host_us(fn, reps):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times)), float(np.mean(times))


def main(reps=200):
    if not torch.cuda.is_available():
        print('k1_host_us: needs a CUDA card', file=sys.stderr)
        return 2
    from mcgaze_tpu_torch.ops import _native, roi_align_cuda
    _native.build_all(('roi_align_fpn',))
    device = torch.device('cuda')
    eval_map = np.concatenate([np.arange(4 * i, 4 * i + 7)
                               for i in range(32)])
    cases = dict(eval_bf16_frame_idx=(torch.bfloat16, 131, 224, eval_map),
                 train_f32_identity=(torch.float32, 224, 224, None))
    out = []
    for name, (dtype, frames, slots, frame_map) in cases.items():
        feats, rois, fidx = inputs(device, dtype, frames, slots, frame_map)
        for entry in ('launch_roi_align_fpn', 'roi_align_fpn'):
            fn = getattr(roi_align_cuda, entry)
            with torch.inference_mode():
                med, mean = host_us(lambda: fn(feats, rois, fidx), reps)
            out.append(dict(case=name, entry=entry, host_us_median=med,
                            host_us_mean=mean, reps=reps))
        if fidx is None:
            for f in feats:
                f.requires_grad_()
            med, mean = host_us(
                lambda: roi_align_cuda.roi_align_fpn(feats, rois), reps)
            out.append(dict(case=name, entry='roi_align_fpn, grad',
                            host_us_median=med, host_us_mean=mean,
                            reps=reps))
        del feats, rois, fidx
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    print(json.dumps(dict(package=roi_align_cuda.__file__, cases=out,
                          device=smi)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
