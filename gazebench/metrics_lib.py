"""The arithmetic the per-layer metrics share. A run's record:

  mode             'eval' or 'train'
  window           window.run's dict of the measured window
  flops_per_call   counts/model.py's work of one batch or step
  peak_flops       the configuration's peak for its mfu
  trace            trace.profile's record of the traced window (--trace 1)
  launches         [(kernel, bytes, flops, dtype)] of each launch of the
                   traced calls, from capture.py

A reader returns None where its layer did no work in the run, never 0.
"""
from __future__ import annotations

import statistics

from .counts.kernels import bound_s


def host_ms(rec: dict, mode: str):
    if rec['mode'] != mode:
        return None
    return 1e3 * statistics.median(rec['window']['host_s'])


def mfu(rec: dict, mode: str):
    if rec['mode'] != mode:
        return None
    win = rec['window']
    return 100.0 * (rec['flops_per_call'] * win['calls'] / win['seconds']
                    / rec['peak_flops'])


def kernel_seconds(rec: dict, fragment: str) -> list:
    """Every recorded launch of the kernels whose name holds `fragment`."""
    trace = rec.get('trace') or {}
    return [s for name, secs in trace.get('kernel_s', {}).items()
            if fragment in name for s in secs]


def roofline(rec: dict, mode: str, fragment: str, kernel: str):
    """A kernel's share of its roofline, %: its mean bound a launch (the
    frozen counts fed with the captured arguments of the traced calls) over
    its mean device time a recorded launch (the profiler may drop a few
    launches, so means and not sums). None where the traced window did
    not launch it."""
    if rec['mode'] != mode:
        return None
    times = kernel_seconds(rec, fragment)
    work = [w for w in rec.get('launches', []) if w[0] == kernel]
    if not times or not work:
        return None
    bound = sum(bound_s(b, f, d) for _, b, f, d in work) / len(work)
    return 100.0 * bound / (sum(times) / len(times))


def idle(rec: dict, mode: str):
    """1 - the card's busy time a call (the union of busy intervals of
    the traced calls over their number) / the measured window's time a
    call, %. Tracing slows the host, so the traced calls' own pace is not
    the window's; the card's work a call is the same at either pace."""
    trace = rec.get('trace')
    if rec['mode'] != mode or not trace:
        return None
    win = rec['window']
    return 100.0 * (1.0 - (trace['busy_s'] / trace['calls'])
                    / (win['seconds'] / win['calls']))
