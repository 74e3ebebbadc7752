"""The program's own spans and counters over a few calls of a cell, and
the per-layer numbers read from them.

The port marks its layers with spans and counts its weight casts
(mcgaze_tpu_torch/utils/profiling.py: span, count, recording, drain; the
names are `mcgaze.<layer>`). `program(entry, first, n)` runs calls
first .. first + n - 1 of a set-up entry in two more passes, each with the
recorder on, and returns their record:

  host     pass (a): the recorder alone, no profiler, so the calls run at
           the pace of an untraced window but for the recorder's own cost.
           spans [{'name', 'start_ns', 'end_ns', 'parent', 'call'}] and
           counts {call: {counter: total}} as drain() gives them;
           host_s, the harness's time inside each entry call (as the
           measured window's `host_s`)
  device   pass (b): the recorder and the profiler's CUDA activity alone
           (as trace.py's first pass). spans and host_s as above; ops
           [[start_ns, end_ns, span]] of every kernel, copy and memset, each
           put down to the innermost program span that was open on the
           host when the runtime call that launched it was made (the
           profiler's correlation id links the two; span -1: no program
           span was open, -2: no runtime call was recorded for it); idle
           {span name or 'outside': seconds}: every stretch with nothing
           on the card, named by the innermost program span open at its
           middle
  calls    n

Program spans and device operations lie on one clock: the recorder stamps
time.time_ns(), the clock of the profiler's events. A span's times include
its children's. The readers below return None where their span did no work
in the run (never 0), and the median over the calls otherwise.

`python3 -m gazebench.spans --workload <cell> --seed <n> [--seconds s]`
(on a card) sets the cell up, runs an untraced window of s seconds with
the recorder off, then the two passes, and prints one JSON object: every
reading of READERS, each span's host and device milliseconds a call, the
idle seconds a call by span, the coverage checks (`summary`), the cost
(median ms inside the entry call: the window's, pass (a)'s, pass (b)'s,
and the recorder off against on in alternating rounds of the same calls;
and the recorder's own: us a span and a count, off and on, times the
spans and counts of a call) and the cell's check.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from .trace import DEVICE_ACTIVITIES, merge

RUNTIME_ACTIVITIES = ('cuda_runtime', 'cuda_driver')
OUTSIDE, UNLINKED = -1, -2
PREFIX = 'mcgaze.'


# ------------------------------------------------------------------ passes

def _calls(entry, first: int, n: int) -> list:
    from . import window
    return window.run(entry, 0.0, first, count=n)['host_s']


def host_pass(entry, first: int, n: int) -> dict:
    """Pass (a): n calls with the recorder on, no profiler."""
    from mcgaze_tpu_torch.utils import profiling
    profiling.drain()
    with profiling.recording():
        host_s = _calls(entry, first, n)
    rec = profiling.drain()
    rec['host_s'] = host_s
    return rec


def device_pass(entry, first: int, n: int) -> dict:
    """Pass (b): n calls with the recorder on under the profiler's CUDA
    activity alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcgaze_tpu_torch.utils import profiling
    profiling.drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording():
            host_s = _calls(entry, first, n)
        torch.cuda.synchronize()
    rec = profiling.drain()
    rec['host_s'] = host_s
    ops, launches = _device_events(prof)
    rec.update(attribute(rec['spans'], ops, launches))
    return rec


def program(entry, first: int, n: int) -> dict:
    """{'host': pass (a), 'device': pass (b), 'calls': n} (module
    docstring)."""
    return dict(host=host_pass(entry, first, n),
                device=device_pass(entry, first, n), calls=n)


def _device_events(prof):
    """([(start_ns, end_ns, correlation)] of the device operations,
    {correlation: start_ns} of the runtime and driver calls) of a finished
    profile."""
    ops, launches = [], {}
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind in DEVICE_ACTIVITIES:
            corr = ev.correlation_id() or ev.linked_correlation_id()
            ops.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        corr))
        elif kind in RUNTIME_ACTIVITIES:
            launches[ev.correlation_id()] = ev.start_ns()
    if not ops:
        raise RuntimeError('the program pass recorded no device operation')
    return ops, launches


def _kind(ev) -> str:
    """The event's activity type where torch gives it; else (torch 2.11)
    'kernel' for a device event that is no mirrored host range, and
    'cuda_runtime' for a host event named as a runtime or driver call
    (cuda*, cu*)."""
    if hasattr(ev, 'activity_type'):
        return ev.activity_type()
    from torch.autograd import DeviceType
    if ev.device_type() == DeviceType.CUDA:
        return 'gpu_user_annotation' if ev.is_user_annotation() else 'kernel'
    return 'cuda_runtime' if ev.name().startswith('cu') else 'cpu_op'


# ------------------------------------------------------------ attribution

def innermost(spans: list) -> tuple:
    """(starts, labels): host time cut where a span opens or closes, each
    piece labelled by the innermost span open over it (its index in
    `spans`, or OUTSIDE); the piece holding time t is
    labels[bisect_right(starts, t) - 1]."""
    marks = []
    for i, s in enumerate(spans):
        marks.append((s['start_ns'], 1, i))
        marks.append((s['end_ns'], 0, -i))
    marks.sort()
    starts, labels, open_ = [], [], []
    for t, kind, i in marks:
        if kind:
            open_.append(i)
        else:
            open_.remove(-i)
        label = open_[-1] if open_ else OUTSIDE
        if starts and starts[-1] == t:
            labels[-1] = label
        else:
            starts.append(t)
            labels.append(label)
    return starts, labels


def label_at(timeline: tuple, t) -> int:
    starts, labels = timeline
    k = bisect.bisect_right(starts, t) - 1
    return OUTSIDE if k < 0 else labels[k]


def attribute(spans: list, ops: list, launches: dict) -> dict:
    """{'ops': [[start_ns, end_ns, span]], 'idle': {name: seconds}} from
    the device operations [(start_ns, end_ns, correlation)], the runtime
    calls {correlation: start_ns} and the program's spans."""
    timeline = innermost(spans)
    out = []
    for s, e, corr in sorted(ops):
        t = launches.get(corr)
        out.append([s, e, UNLINKED if t is None else label_at(timeline, t)])
    return dict(ops=out, idle=idle(spans, out, timeline))


def idle(spans: list, ops: list, timeline: tuple | None = None) -> dict:
    """{span name (without 'mcgaze.') or 'outside': seconds} with nothing
    on the card, from the first root span's start to the last root's or
    operation's end, each stretch named by the innermost span open on the
    host at its middle."""
    timeline = timeline or innermost(spans)
    roots = [s for s in spans if s['parent'] is None]
    if not roots:
        return {}
    start = min(s['start_ns'] for s in roots)
    end = max([s['end_ns'] for s in roots] + [e for _, e, _ in ops])
    busy = merge((max(s, start), e) for s, e, _ in ops if e > start)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    out = defaultdict(float)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            out[_short(spans, label_at(timeline, (g0 + g1) / 2))] += \
                (g1 - g0) * 1e-9
    return dict(out)


def _short(spans: list, label: int) -> str:
    if label < 0:
        return 'outside'
    name = spans[label]['name']
    return name[len(PREFIX):] if name.startswith(PREFIX) else name


def _chains(spans: list) -> list:
    """Each span's name and its ancestors' names, innermost first."""
    out = []
    for s in spans:
        p = s['parent']
        out.append((s['name'],) + (out[p] if p is not None else ()))
    return out


def _roots(spans: list) -> list:
    """The index of each span's root."""
    out = []
    for i, s in enumerate(spans):
        out.append(i if s['parent'] is None else out[s['parent']])
    return out


# ---------------------------------------------------------------- readings

def host_ms_by_call(part: dict, names) -> list:
    """ms a call inside the spans named `names` (their host times summed),
    for each call where one of them opened."""
    names = {PREFIX + n for n in names}
    per = defaultdict(float)
    for s in part['spans']:
        if s['name'] in names:
            per[s['call']] += (s['end_ns'] - s['start_ns']) * 1e-6
    return list(per.values())


def device_ms_by_call(part: dict, names) -> list:
    """ms a call of the union of the device intervals of the operations
    launched inside the spans named `names` (or inside their children),
    for each call that launched one."""
    names = {PREFIX + n for n in names}
    spans = part['spans']
    chains, roots = _chains(spans), _roots(spans)
    per = defaultdict(list)
    for s, e, label in part['ops']:
        if label >= 0 and names.intersection(chains[label]):
            per[roots[label]].append((s, e))
    return [1e-6 * sum(e - s for s, e in merge(iv)) for iv in per.values()]


def ops_by_call(part: dict) -> list:
    """Device operations launched inside each root span."""
    roots = _roots(part['spans'])
    per = defaultdict(int)
    for _, _, label in part['ops']:
        if label >= 0:
            per[roots[label]] += 1
    return list(per.values())


def counter_by_call(part: dict, name: str) -> list:
    """Counter `name` of each call that counted something."""
    calls = {s['call'] for s in part['spans'] if s['parent'] is None}
    return [c[name] for call, c in part['counts'].items()
            if call in calls and c.get(name)]


def _median(values):
    return statistics.median(values) if values else None


def _part(rec: dict, mode: str, which: str):
    prog = rec.get('program')
    if rec.get('mode') != mode or not prog:
        return None
    return prog[which]


def host_ms(rec: dict, mode: str, *names):
    part = _part(rec, mode, 'host')
    return None if part is None else _median(host_ms_by_call(part, names))


def device_ms(rec: dict, mode: str, *names):
    part = _part(rec, mode, 'device')
    return None if part is None else _median(device_ms_by_call(part, names))


def device_ops(rec: dict, mode: str):
    part = _part(rec, mode, 'device')
    return None if part is None else _median(ops_by_call(part))


def counter_mb(rec: dict, mode: str, name: str):
    part = _part(rec, mode, 'host')
    if part is None:
        return None
    v = _median(counter_by_call(part, name))
    return None if v is None else v / 1e6


# {metric: (unit, read(rec))}: the per-layer metrics the two passes give
READERS = {
    'handover_host_ms.eval': ('ms', lambda r: host_ms(r, 'eval',
                                                      'handover')),
    'backbone_host_ms.eval': ('ms', lambda r: host_ms(r, 'eval', 'backbone',
                                                      'fpn')),
    'heads_host_ms.eval': ('ms', lambda r: host_ms(r, 'eval', 'heads')),
    'backbone_device_ms.eval': ('ms', lambda r: device_ms(
        r, 'eval', 'backbone', 'fpn')),
    'heads_device_ms.eval': ('ms', lambda r: device_ms(r, 'eval', 'heads')),
    'launches_per_batch.eval': ('launches', lambda r: device_ops(r, 'eval')),
    'weight_cast_mb.eval': ('MB', lambda r: counter_mb(
        r, 'eval', 'weight_cast_bytes')),
    'forward_host_ms.train': ('ms', lambda r: host_ms(r, 'train',
                                                      'train.forward')),
    'backward_host_ms.train': ('ms', lambda r: host_ms(r, 'train',
                                                       'train.backward')),
    'update_host_ms.train': ('ms', lambda r: host_ms(r, 'train',
                                                     'train.update')),
    'forward_device_ms.train': ('ms', lambda r: device_ms(
        r, 'train', 'train.forward')),
    'backward_device_ms.train': ('ms', lambda r: device_ms(
        r, 'train', 'train.backward')),
    'update_device_ms.train': ('ms', lambda r: device_ms(
        r, 'train', 'train.update')),
    'launches_per_step.train': ('launches', lambda r: device_ops(r,
                                                                'train')),
}


def read_all(rec: dict) -> dict:
    """{metric: {'value', 'unit'}} of every reader that found work."""
    out = {}
    for name, (unit, read) in READERS.items():
        value = read(rec)
        if value is not None:
            out[name] = dict(value=value, unit=unit)
    return out


def summary(prog: dict) -> dict:
    """What the two passes cover, each the worst call's:
      child_share   the direct children's host time over their root's
                    (pass (a))
      device_share  the union of the operations launched inside program
                    spans over the union of every operation launched
                    between the call's root opening and the next root
                    opening (pass (b))
      idle_named    the idle time inside a program span over all idle
                    time (pass (b), every call together)
      unlinked      device operations with no recorded runtime call"""
    host, dev = prog['host'], prog['device']
    spans = host['spans']
    child = defaultdict(float)
    for s in spans:
        if s['parent'] is not None and spans[s['parent']]['parent'] is None:
            child[s['parent']] += s['end_ns'] - s['start_ns']
    shares = [child[i] / (s['end_ns'] - s['start_ns'])
              for i, s in enumerate(spans) if s['parent'] is None]
    dspans = dev['spans']
    root_starts = sorted(s['start_ns'] for s in dspans if s['parent'] is None)
    roots = _roots(dspans)
    every, named = defaultdict(list), defaultdict(list)
    for s, e, label in dev['ops']:
        if label >= 0:
            named[roots[label]].append((s, e))
    for s, e, label in dev['ops']:
        k = bisect.bisect_right(root_starts, s) - 1
        if label >= 0:
            every[dspans[roots[label]]['start_ns']].append((s, e))
        elif k >= 0:
            every[root_starts[k]].append((s, e))
    dev_shares = []
    for i, ivs in named.items():
        tot = sum(e - s for s, e in merge(every[dspans[i]['start_ns']]))
        dev_shares.append(sum(e - s for s, e in merge(ivs)) / tot)
    idle_total = sum(dev['idle'].values())
    return dict(
        child_share=min(shares) if shares else None,
        device_share=min(dev_shares) if dev_shares else None,
        idle_named=(1.0 - dev['idle'].get('outside', 0.0) / idle_total
                    if idle_total else None),
        unlinked=sum(1 for _, _, lab in dev['ops'] if lab == UNLINKED),
        ops=len(dev['ops']))


def by_span(prog: dict) -> dict:
    """{span name: [host ms a call (pass (a)), device ms a call (pass
    (b))]}, medians over the calls where the span opened."""
    names = sorted({s['name'][len(PREFIX):] for s in prog['host']['spans']})
    return {n: [_median(host_ms_by_call(prog['host'], [n])),
                _median(device_ms_by_call(prog['device'], [n]))]
            for n in names}


def counters(part: dict) -> dict:
    """{counter: median total a call} of every counter a call moved
    (weight_cast_bytes, the kernels' launch_count.k1 ...)."""
    calls = {s['call'] for s in part['spans'] if s['parent'] is None}
    names = {k for call in calls for k in part['counts'].get(call, {})}
    return {k: _median([part['counts'].get(call, {}).get(k, 0)
                        for call in calls]) for k in sorted(names)}


# --------------------------------------------------------------------- CLI

def recorder_cost(entry, first: int, n: int, rounds: int = 3) -> dict:
    """Median ms inside the entry call of `rounds` x n calls with the
    recorder off and, alternating with them, on (no profiler)."""
    from mcgaze_tpu_torch.utils import profiling
    off, on = [], []
    for _ in range(rounds):
        off += _calls(entry, first, n)
        with profiling.recording():
            on += _calls(entry, first, n)
        profiling.drain()
    off_ms, on_ms = 1e3 * statistics.median(off), 1e3 * statistics.median(on)
    return dict(off_ms=off_ms, on_ms=on_ms, ms=on_ms - off_ms,
                percent=100 * (on_ms / off_ms - 1))


def recorder_us(reps: int = 20000) -> dict:
    """us one span (opened and closed) and one count cost: with the
    recorder off, and on for a span inside a root, a root span (it reads
    the kernels' launch counters) and a count of a tensor's bytes."""
    import time

    import torch

    from mcgaze_tpu_torch.utils import profiling as P
    x = torch.empty(4)

    def per(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t0) / reps

    def one_span():
        with P.span('mcgaze.x'):
            pass

    def one_count():
        P.count(P.WEIGHT_CAST_BYTES, x)

    out = dict(span_off=per(one_span), count_off=per(one_count))
    with P.recording():
        out['root_on'] = per(one_span)
        with P.span('mcgaze.x'):
            out['span_on'] = per(one_span)
            out['count_on'] = per(one_count)
    P.drain()
    return out


def sites_a_call(entry, first: int) -> dict:
    """Spans and counts one call opens and makes (counts tallied where
    the model's layers call the recorder)."""
    from mcgaze_tpu_torch.models import layers
    counted = [0]

    def tally(name, n):
        counted[0] += 1
        count(name, n)
    count = layers.count
    layers.count = tally
    try:
        part = host_pass(entry, first, 1)
    finally:
        layers.count = count
    return dict(spans=len(part['spans']), counts=counted[0],
                roots=sum(1 for s in part['spans'] if s['parent'] is None))


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time

    from . import run, spec, window
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, default=10.0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()

    start = time.perf_counter()
    cell = spec.load_cell(args.workload)
    entry = spec.entry_class(cell['workload']['entry'])(cell, args.seed,
                                                        'cuda')
    entry.setup()
    setup_s = time.perf_counter() - start
    win = window.run(entry, args.seconds)
    first = win['first'] + win['calls']
    n = cell['traffic']['trace_calls']
    rec = dict(mode=entry.mode, window=win, program=program(entry, first, n))
    paired = recorder_cost(entry, first, n)
    us, sites = recorder_us(), sites_a_call(entry, first)
    entry.free()
    correct, checks = entry.check(win)
    prog = rec['program']

    def ms(host_s):
        return 1e3 * statistics.median(host_s)
    window_ms = ms(win['host_s'])
    idle_a_call = {k: v / n for k, v in sorted(
        prog['device']['idle'].items(), key=lambda kv: -kv[1])}
    print('gazebench.spans: idle s a call by program span '
          + json.dumps(idle_a_call), file=sys.stderr)
    out = dict(workload=args.workload, seed=args.seed, correct=bool(correct),
               setup_s=setup_s, metrics=read_all(rec),
               by_span=by_span(prog), idle_s_a_call=idle_a_call,
               counters=counters(prog['host']),
               summary=summary(prog),
               cost=dict(window_ms=window_ms,
                         pass_a_ms=ms(prog['host']['host_s']),
                         pass_b_ms=ms(prog['device']['host_s']),
                         paired=paired, us=us, sites=sites,
                         on_ms=1e-3 * (
                             sites['roots'] * us['root_on']
                             + (sites['spans'] - sites['roots'])
                             * us['span_on'] + sites['counts']
                             * us['count_on']),
                         off_ms=1e-3 * (sites['spans'] * us['span_off']
                                        + sites['counts']
                                        * us['count_off'])),
               window_calls=win['calls'], checks=checks)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
