"""Profiling utilities, counterpart of mcgaze_tpu/utils/profiling.py:

  * profile_time: a wall-clock context manager that waits for the card
    when the block's outputs are CUDA tensors, so a time covers the device
    work and not only its enqueue;
  * trace: torch.profiler over a block (CPU and CUDA activities), written
    as a Chrome trace into a directory;
  * cost_analysis: the FLOPs of one call, from
    torch.utils.flop_counter.FlopCounterMode, with the port's kernels
    counted through their operators (below);
  * IterTimer: per-iteration time and data time (mmcv IterTimerHook);
  * span, count, recording, drain: the program's own spans and counters
    (below), which trace also writes into its Chrome trace.

Spans and counters. The program marks its layers with `span(name)` (a
context manager) and counts work with `count(name, n)`. Both are off
unless a `recording()` block is open: then span returns one shared no-op
context and count returns, each after one test of a module flag, with
nothing allocated, synchronised or handed to the torch profiler. Inside
`recording()` every span is kept as (name, start_ns, end_ns, parent,
call): a span opened with no span open on its thread is a root and
starts a call, and every span inside it carries that call's id. Each
counter is a total a call (the call of the innermost open span; None
outside every root), and each call also holds the kernels' launch
counters' deltas over its root (`launch_counts()`, as
'launch_count.k1' ...). `drain()` returns the record and empties it.
Timestamps are time.time_ns(), the Unix-epoch nanoseconds that the torch
profiler stamps its events with, so a span and the operators and device
activity of a profiled block lie on one timeline.

The spans of the main paths (names `mcgaze.<layer>`): `eval` (root:
`evaluation/forward.py`'s bound `dedup` and `batched` forwards),
`handover` (their host-to-device copies), `backbone` (with
`device_normalize` inside it on the eval paths) and `fpn`
(`extract_features`), `heads` and a child `heads.stage<i>` a query stage
(`run_heads`), `select` (the last stage's outputs, the top-k tracks);
`train` (root: `train/loop.py::make_train_step`) with `train.forward`,
`train.backward` and `train.update`. The one counter is
`weight_cast_bytes`: the bytes of f32 parameters converted to another
dtype at use (`models/layers.py`, the heads' stacked clue weights); a
same-dtype `.to()` copies nothing and counts nothing.

The kernels are called through ctypes outside the dispatcher, where no
dispatch mode sees them. cost_analysis runs the call inside
ops/routing.py::through_operators(), which sends each kernel through its
torch.library operator (mcgaze::roi_align_fpn, ::roi_align_fpn_bwd,
::stqi_attention, ::fused_bottleneck_chain; on the CPU their kernels are
the plain versions), and registers a flop formula for each, counted as
tools/kernel_bounds.py counts the kernel's work on these inputs. It checks
the kernels' launch counters around the call and raises if a kernel
launched more often than the counted operators launch it: it never
returns an undercount. Bytes moved are reported for the operators alone
('operator bytes accessed'), as kernel_bounds counts them; the rest of
the program's traffic is not estimated ('bytes not counted' says what).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Callable

import torch


def _sync(x) -> None:
    """Wait for the card if x holds a CUDA tensor (a tensor, or a list,
    tuple or dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


@contextlib.contextmanager
def profile_time(name: str, stream=None, end_stream=None, sync: Any = None,
                 log: bool = True):
    """Time a block; if `sync` (or box['sync'], set inside the block)
    holds CUDA tensors, the card is synchronised before the clock stops.
    stream/end_stream are accepted, as the JAX function accepts them, and
    ignored: the synchronisation waits for every stream of the device."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        _sync(sync if sync is not None else box.get('sync'))
        dt = time.perf_counter() - t0
        box['elapsed'] = dt
        if log:
            print(f'{name}: {dt * 1e3:.2f} ms')


# ------------------------------------------------------ spans and counters

WEIGHT_CAST_BYTES = 'weight_cast_bytes'

_on = False                      # the one flag every span and count tests
_local = threading.local()       # .stack: the open spans of this thread
_lock = threading.Lock()         # guards what follows while recording
_spans = []                      # [name, start_ns, end_ns, parent, call]
_counts = defaultdict(int)       # (call, name) -> total
_call_ids = itertools.count()
_clock = time.time_ns            # the torch profiler's clock


class _Off:
    """The shared context of a span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('name', 'index', 'launches')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        # a root reads the launch counters: their deltas count every launch
        # of the process while it is open, other threads' too
        self.launches = None if stack else launch_counts()
        with _lock:
            if stack:
                parent = stack[-1]
                call = _spans[parent][4]
            else:
                parent, call = None, next(_call_ids)
            self.index = len(_spans)
            rec = [self.name, 0, 0, parent, call]
            _spans.append(rec)
        stack.append(self.index)
        rec[1] = _clock()
        return None

    def __exit__(self, *exc):
        end = _clock()
        rec = _spans[self.index]
        rec[2] = end
        _local.stack.pop()
        if self.launches is not None:
            moved = {k: n - self.launches[k]
                     for k, n in launch_counts().items()}
            with _lock:
                for k, n in moved.items():
                    _counts[(rec[4], 'launch_count.' + k)] += n
        return False


def span(name: str, index: int | None = None):
    """A context that records the block as span `name` (`name` followed
    by `index`, where given) inside recording(); outside it, one shared
    context that does nothing."""
    if not _on:
        return _OFF
    return _Span(name if index is None else f'{name}{index}')


def count(name: str, n) -> None:
    """Add n (a number, or a tensor: its bytes) to counter `name` of the
    current call inside recording(); outside it, nothing."""
    if not _on:
        return
    if isinstance(n, torch.Tensor):
        n = n.numel() * n.element_size()
    stack = getattr(_local, 'stack', None)
    with _lock:
        call = _spans[stack[-1]][4] if stack else None
        _counts[(call, name)] += n


@contextlib.contextmanager
def recording():
    """Spans and counters on for the block (and back as they were after
    it); what they record stays until drain()."""
    global _on
    before = _on
    _on = True
    try:
        yield
    finally:
        _on = before


def drain() -> dict:
    """{'spans': [{'name', 'start_ns', 'end_ns', 'parent', 'call'}] in the
    order they opened (parent: the index of the enclosing span, None for a
    root), 'counts': {call: {counter: total}}}, and the recorder emptied.
    Raises RuntimeError while a span is still open."""
    with _lock:
        if any(rec[2] == 0 for rec in _spans):
            raise RuntimeError('drain() inside an open span')
        spans = [dict(name=n, start_ns=s, end_ns=e, parent=p, call=c)
                 for n, s, e, p, c in _spans]
        counts = defaultdict(dict)
        for (call, name), n in _counts.items():
            counts[call][name] = n
        _spans.clear()
        _counts.clear()
    return dict(spans=spans, counts=dict(counts))


SPAN_TID = 1 << 30               # the spans' track: above any Linux tid


def _chrome_events(spans: list, base_ns: int) -> list:
    """The spans as Chrome trace complete events ('X', microseconds after
    the trace's base time) on a track of their own in this process."""
    pid = os.getpid()
    named = dict(ph='M', name='thread_name', pid=pid, tid=SPAN_TID,
                 args=dict(name='mcgaze spans'))
    return [named] + [
        dict(ph='X', cat='mcgaze_span', name=s['name'], pid=pid,
             tid=SPAN_TID, ts=(s['start_ns'] - base_ns) / 1e3,
             dur=(s['end_ns'] - s['start_ns']) / 1e3,
             args=dict(call=s['call']))
        for s in spans]


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and CUDA activities (CUDA where
    the build has it), saved as a Chrome trace `trace_<pid>.json` into
    log_dir (TensorBoard's and chrome://tracing's format). The program's
    spans are recorded over the block and written into the same trace, on
    a host track of their own ('mcgaze spans') beside the operators and
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        with recording():
            yield prof
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, f'trace_{os.getpid()}.json')
        prof.export_chrome_trace(path)
        spans = drain()['spans']
        with open(path) as f:
            doc = json.load(f)
        doc['traceEvents'] += _chrome_events(
            spans, doc.get('baseTimeNanoseconds', 0))
        with open(path, 'w') as f:
            json.dump(doc, f)


# ---------------------------------------------------------- cost analysis

def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _roi_inputs(rois, frame_idx):
    rois_np = rois.detach().float().cpu().numpy()
    fidx = None if frame_idx is None else \
        frame_idx.detach().cpu().numpy().astype('int32')
    return rois_np, fidx


def _k1_work(feats, rois, frame_idx, out_size, sampling_ratio, strides,
             finest_scale):
    from ..tools.kernel_bounds import roi_work
    rois_np, fidx = _roi_inputs(rois, frame_idx)
    nbytes, flops = roi_work(
        rois_np, fidx, [tuple(f.shape[1:3]) for f in feats], strides,
        feats[0].shape[-1], _itemsize(feats[0].dtype), out_size,
        sampling_ratio, finest_scale)
    return 'k1', flops, nbytes, 1


def _k3_work(g, rois, frame_idx, level_shapes, out_size, sampling_ratio,
             strides, finest_scale):
    from ..tools.kernel_bounds import roi_bwd_work
    shapes = [level_shapes[i:i + 4] for i in range(0, len(level_shapes), 4)]
    rois_np, fidx = _roi_inputs(rois, frame_idx)
    nbytes, flops = roi_bwd_work(
        rois_np, fidx, [(s[1], s[2]) for s in shapes], strides, shapes[0][3],
        _itemsize(g.dtype), shapes[0][0], out_size, sampling_ratio,
        finest_scale)
    return 'k3', flops, nbytes, 1


def _k4_work(query, wqkv, bqkv, wout, bout, ln_scale, ln_bias, clip_length,
             heads):
    from ..tools.kernel_bounds import k4_bound
    n, q, c = query.shape
    b = k4_bound(n // clip_length, clip_length, q, c)
    return 'k4', b['flops'], b['bytes'], 1


def _k5_work(x, weights, h, w):
    from ..ops.fused_bottleneck import split_blocks
    from ..tools.kernel_bounds import k5_pixels_bound
    blocks = split_blocks(weights)
    a1 = blocks[0][0]
    chain = dict(cin=a1.shape[0], mid=a1.shape[1], blocks=len(blocks),
                 down=blocks[0][6] is not None)
    dtype = {torch.float32: 'float32', torch.bfloat16: 'bfloat16'}[x.dtype]
    b = k5_pixels_bound(x.shape[0] * h * w, chain, dtype)
    return 'k5', b['flops'], b['bytes'], b['launches']


def _operator_work() -> dict:
    """{operator packet: work(*args) -> (kernel, flops, bytes, launches)}."""
    from ..ops import fused_bottleneck, roi_align_cuda, stqi_attention  # noqa: F401 (registers the operators)
    ops = torch.ops.mcgaze
    return {ops.roi_align_fpn: _k1_work, ops.roi_align_fpn_bwd: _k3_work,
            ops.stqi_attention: _k4_work,
            ops.fused_bottleneck_chain: _k5_work}


_formulas_registered = False


def _register_flop_formulas() -> None:
    """The operators' flop formulas, registered once for FlopCounterMode."""
    global _formulas_registered
    if _formulas_registered:
        return
    from torch.utils.flop_counter import register_flop_formula
    for packet, work in _operator_work().items():
        def formula(*args, out_val=None, _work=work, **kwargs):
            return _work(*args, **kwargs)[1]
        register_flop_formula(packet, get_raw=True)(formula)
    _formulas_registered = True


def launch_counts() -> dict:
    """The kernels' launch counters: {'k1', 'k3', 'k4', 'k5'}."""
    from ..ops import fused_bottleneck, roi_align_cuda, stqi_attention
    return dict(k1=roi_align_cuda.launch_count,
                k3=roi_align_cuda.bwd_launch_count,
                k4=stqi_attention.launch_count,
                k5=fused_bottleneck.launch_count)


class _OperatorTally(torch.utils._python_dispatch.TorchDispatchMode):
    """Bytes and launches of the kernels' operators the call reaches (the
    flops come from FlopCounterMode, through the same work functions)."""

    def __init__(self):
        super().__init__()
        self.work = _operator_work()
        self.bytes = 0
        self.launches = dict(k1=0, k3=0, k4=0, k5=0)
        self.calls = dict(k1=0, k3=0, k4=0, k5=0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        work = self.work.get(func.overloadpacket)
        if work is not None:
            kernel, _, nbytes, launches = work(*args, **kwargs)
            self.bytes += nbytes
            self.launches[kernel] += launches
            self.calls[kernel] += 1
        return func(*args, **kwargs)


class _GlobalOnly:
    """FlopCounterMode's module tracker, reduced to the 'Global' entry that
    cost_analysis reads: the tracker's hooks fail on the model's views of
    parameters made under no_grad or inference_mode (its
    register_multi_grad_hook expects them to have a grad_fn)."""
    parents = {'Global'}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def cost_analysis(fn: Callable, *args) -> dict:
    """Run fn(*args) once with the kernels through their operators and
    count it. Returns {'flops': total, 'flops_by_operator': {name: flops},
    'operator bytes accessed': the kernels' operators' bytes,
    'operator calls': {kernel: calls}, 'bytes not counted': what the bytes
    leave out}. Raises RuntimeError if a kernel's launch counter moved more
    than the counted operators launch it (a launch outside them)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.routing import through_operators
    _register_flop_formulas()
    before = launch_counts()
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _GlobalOnly()
    tally = _OperatorTally()
    with through_operators(), counter, tally:
        out = fn(*args)
    _sync(out)
    after = launch_counts()
    for k, n0 in before.items():
        moved = after[k] - n0
        if moved > tally.launches[k]:
            raise RuntimeError(
                f'cost_analysis: kernel {k} launched {moved} times, its '
                f'counted operators {tally.launches[k]}: a launch outside '
                'the operators would go uncounted')
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get('Global', {}).items()}
    return {'flops': int(counter.get_total_flops()),
            'flops_by_operator': by_op,
            'operator bytes accessed': int(tally.bytes),
            'operator calls': dict(tally.calls),
            'bytes not counted': 'every aten operator (convolutions, '
                                 'matmuls, normalisations, elementwise)'}


class IterTimer:
    """data_time = the gap between the end of one iteration and the start
    of the next; time = one whole iteration. `after_iter(sync=t)` waits
    for the card when t is a CUDA tensor, so the time covers the device
    work and not only its enqueue."""

    def __init__(self):
        self._last_end = None
        self._iter_start = None
        self.data_time = 0.0
        self.time = 0.0

    def before_iter(self):
        now = time.perf_counter()
        self.data_time = 0.0 if self._last_end is None else now - self._last_end
        self._iter_start = now

    def after_iter(self, sync: Any = None):
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        now = time.perf_counter()
        self.time = now - (self._iter_start or now)
        self._last_end = now
