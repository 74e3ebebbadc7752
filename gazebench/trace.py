"""The traced window and what is read from it.

`profile(run)` traces the same calls in two passes. run(ranges) makes
the calls and ends with a device sync; with ranges=True it marks the
harness's phases ('gazebench.*', record_function on the host).

The first pass records CUDA activity alone, so the profiler adds no work
to each operator on the host; CUPTI's own cost a launch still slows a
host-bound call (by 20-50% on an H100 host), so the metrics take the
card's work a call from it and the time a call from the measured window:

  window_s       the host's clock from the first call to the sync after
                 the last
  busy_s         the union of the intervals in which a kernel, copy or
                 memset ran on the card (never a sum: kernels on two
                 streams that overlap count once)
  kernel_s       {kernel name: [seconds of each recorded launch]}
  calls          the number of traced calls
  call_s         window_s over calls, to set beside the measured window's
                 time a call

The second pass also records the host's operators and ranges, which slows
the host, and serves the breakdown alone:

  gaps           {harness range the host was in: idle seconds}: every
                 interval with nothing on the card, named by the innermost
                 harness range covering its middle. Host tracing lengthens
                 them, so they name where the host was and are read from
                 no metric.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
RANGE_PREFIX = 'gazebench.'


def merge(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(device_ops, window_s: float) -> dict:
    """device_ops [(start_s, end_s, name)] of a window of window_s seconds
    on the host's clock -> window_s, busy_s, kernel_s (module docstring)."""
    if not device_ops:
        raise RuntimeError('the traced window recorded no device operation')
    kernel_s = defaultdict(list)
    for s, e, name in device_ops:
        kernel_s[name].append(e - s)
    return dict(window_s=window_s,
                busy_s=sum(e - s for s, e in merge(
                    (s, e) for s, e, _ in device_ops)),
                kernel_s=dict(kernel_s))


def gaps(device_ops, ranges) -> dict:
    """{harness range: idle seconds} from the device operations and the
    harness ranges [(start_s, end_s, name)] on one clock, between the first
    range's start and the last operation's or range's end."""
    if not device_ops:
        raise RuntimeError('the traced window recorded no device operation')
    start = min(s for s, _, _ in ranges) if ranges else \
        min(s for s, _, _ in device_ops)
    end = max([e for _, e, _ in device_ops] + [e for _, e, _ in ranges])
    spans = merge((max(s, start), e) for s, e, _ in device_ops if e > start)
    out = defaultdict(float)
    edges = [start] + [x for iv in spans for x in iv] + [end]
    by_start = sorted(ranges)
    starts = [r[0] for r in by_start]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        inner, name = None, 'outside'
        for r in by_start[:bisect.bisect_right(starts, mid)]:
            if r[0] <= mid <= r[1] and (inner is None
                                        or r[1] - r[0] < inner):
                inner, name = r[1] - r[0], r[2][len(RANGE_PREFIX):]
        out[name] += g1 - g0
    return dict(out)


def profile(run) -> dict:
    """Trace run(ranges) in two passes (module docstring); run returns the
    number of calls it made."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with _profiler([ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls = run(False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    rec = busy(_events(prof)[0], t1 - t0)
    rec.update(calls=calls, call_s=rec['window_s'] / calls)
    with _profiler([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(True)
        torch.cuda.synchronize()
    rec['gaps'] = gaps(*_events(prof))
    return rec


def _profiler(activities):
    from torch.profiler import profile as torch_profile
    return torch_profile(activities=activities)


def _events(prof):
    """([(start_s, end_s, name)] of the device operations, [...] of the
    harness ranges) of a finished profile."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = {ev.name() for ev in events if ev.device_type() != DeviceType.CUDA}
    device_ops, ranges = [], []
    for ev in events:
        name = ev.name()
        span = (ev.start_ns() * 1e-9,
                (ev.start_ns() + ev.duration_ns()) * 1e-9, name)
        if ev.device_type() == DeviceType.CUDA:
            if _device_op(ev, host):
                device_ops.append(span)
        elif name.startswith(RANGE_PREFIX):
            ranges.append(span)
    return device_ops, ranges


def _device_op(ev, host_names) -> bool:
    """A kernel, copy or memset, and not a host range the trace mirrors on
    the device's timeline (a record_function, an optimizer step): by the
    event's activity type where torch gives it, else by its name."""
    if hasattr(ev, 'activity_type'):
        return ev.activity_type() in DEVICE_ACTIVITIES
    if hasattr(ev, 'is_user_annotation') and ev.is_user_annotation():
        return False
    return ev.name() not in host_names


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time (first pass) and the
    harness ranges the host was in over the longest idle stretches (second
    pass), in seconds."""
    trace = rec['trace']
    ops = sorted(((name[:160], sum(secs))
                  for name, secs in trace['kernel_s'].items()),
                 key=lambda kv: -kv[1])[:10]
    idle = sorted(trace['gaps'].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[list(x) for x in ops],
                idle_gaps=[list(x) for x in idle])
