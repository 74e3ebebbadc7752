"""torch.profiler listing of one K3 launch (the FPN RoIAlign backward,
`ops/roi_align_cuda.py::launch_roi_align_fpn_bwd`) at the gaze training
shape: 224 frames at 224 px, 3 RoIs a frame, C=256, identity form, f32 and
bf16, on one CUDA card. It lists every device kernel the launch runs (a
fill, the kernel itself, a cast) with its device time per recorded launch,
so a launch's time splits into its parts. From the root of a checkout:

    python -m mcgaze_tpu_torch.tools.profile_k3

It imports `mcgaze_tpu_torch` and `chip_smoke` (the input builders) from
the path, so `PYTHONPATH=OTHER_CHECKOUT python .../profile_k3.py` lists
another checkout's K3. Prints one JSON object.
"""
import json
import sys

import numpy as np
import torch


def listing(fn, reps=5):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {ev.key for ev in events
            if getattr(ev, 'device_type', None) == DeviceType.CPU}
    # per recorded launch: the profiler may drop some of the reps
    rows = [dict(name=ev.key[:100], recorded=ev.count,
                 ms=ev.self_device_time_total / (1e3 * ev.count))
            for ev in events
            if getattr(ev, 'device_type', None) == DeviceType.CUDA
            and ev.count and ev.self_device_time_total > 0
            and ev.key not in host]
    return sorted(rows, key=lambda r: -r['ms'])


def main():
    if not torch.cuda.is_available():
        print('profile_k3: needs a CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mcgaze_tpu_torch.ops import roi_align_cuda

    device = torch.device('cuda')
    rng = np.random.RandomState(2)
    sel = cs.gaze_sel()
    out = dict(package=roi_align_cuda.__file__, device=cs.nvidia_smi(),
               cases=[])
    for dtype in (torch.float32, torch.bfloat16):
        feats = cs.make_pyramid(rng, len(sel), (224, 224), 256, device, dtype)
        shapes = [tuple(f.shape) for f in feats]
        rois = torch.from_numpy(cs.make_rois(rng, len(sel), 3,
                                             (224, 224))).to(device)
        g = torch.from_numpy(rng.randn(len(sel), 3, 7, 7, 256).astype(
            np.float32)).to(device, dtype)
        del feats
        rows = listing(lambda: roi_align_cuda.launch_roi_align_fpn_bwd(
            g, rois, None, shapes))
        out['cases'].append(dict(dtype=str(dtype).replace('torch.', ''),
                                 total_ms=sum(r['ms'] for r in rows),
                                 kernels=rows))
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
