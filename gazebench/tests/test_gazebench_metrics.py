"""The metric arithmetic on synthetic timelines: a rate over the whole
window, p95 over every batch, the union of busy intervals for the idle
share, roofline and mfu shares."""
from __future__ import annotations

import statistics
import time

import pytest

from gazebench import metrics_lib, trace, window
from gazebench.counts import kernels as K


class _Eval:
    mode = 'eval'
    clips_per_call = 4

    def __init__(self, delays):
        self.delays = delays
        self.seen = []

    def submit(self, i):
        time.sleep(self.delays[i % len(self.delays)])
        return i

    def readback(self, i, handle):
        self.seen.append(handle)


class _Train:
    mode = 'train'
    clips_per_call = 2

    def __init__(self):
        self.steps, self.synced = 0, 0

    def step(self, i):
        self.steps += 1

    def sync(self):
        self.synced += 1


def test_window_counts_every_call_and_all_the_time():
    entry = _Eval([0.001, 0.004])
    win = window.run(entry, 0.05)
    assert win['calls'] == len(entry.seen) == len(win['latency_s'])
    assert win['seconds'] >= 0.05
    assert win['seconds'] >= sum(win['latency_s'])
    assert win['clips'] == 4 * win['calls']
    m = window.end_to_end('eval', win, 12.5)
    assert m['eval_clips_per_s']['value'] == pytest.approx(
        win['clips'] / win['seconds'])
    assert m['setup_s'] == dict(value=12.5, unit='s')


def test_train_window_ends_with_one_sync():
    entry = _Train()
    win = window.run(entry, 0.0, first=3, count=5)
    assert (entry.steps, entry.synced, win['first']) == (5, 1, 3)
    m = window.end_to_end('train', win, 1.0)
    assert m['train_clips_per_s']['value'] == pytest.approx(
        10 / win['seconds'])
    assert set(m) == {'setup_s', 'train_clips_per_s'}


def test_p95_is_over_all_batches():
    lat = [0.01] * 90 + [0.1 + 0.01 * i for i in range(10)]
    assert window.p95(lat) == pytest.approx(
        statistics.quantiles(lat, n=20)[-1])
    assert window.p95(lat) > 0.1     # the slow tail is not trimmed


def test_busy_is_a_union_not_a_sum():
    ops = [(0.0, 2.0, 'a'), (1.0, 3.0, 'b'), (5.0, 6.0, 'a')]
    ranges = [(0.0, 10.0, 'gazebench.step'), (3.5, 4.5, 'gazebench.sync')]
    rec = trace.busy(ops, 10.0)
    assert rec['window_s'] == 10.0
    assert rec['busy_s'] == 4.0
    assert rec['kernel_s'] == {'a': [2.0, 1.0], 'b': [2.0]}
    rec['gaps'] = trace.gaps(ops, ranges)
    assert rec['gaps'] == {'sync': 2.0, 'step': 4.0}
    # 2 traced calls, 2 s busy a call; the measured window 5 s a call
    rec['calls'] = 2
    win = dict(seconds=50.0, calls=10)
    assert metrics_lib.idle(dict(mode='train', trace=rec, window=win),
                            'train') == pytest.approx(60.0)
    assert metrics_lib.idle(dict(mode='eval', trace=rec, window=win),
                            'train') is None
    bd = trace.breakdown(dict(trace=rec))
    assert bd['device_ops'][0] == ['a', 3.0]
    assert bd['idle_gaps'][0] == ['step', 4.0]


def test_no_device_operation_is_an_error():
    with pytest.raises(RuntimeError):
        trace.busy([], 1.0)
    with pytest.raises(RuntimeError):
        trace.gaps([], [(0.0, 1.0, 'gazebench.entry')])


def test_the_timed_pass_traces_the_device_alone(monkeypatch):
    """The pass that busy_s, window_s and the kernels' times come from
    records CUDA activity only (host tracing would slow the calls it
    times), its window on the host's clock; the harness ranges run only in
    the second pass, which names the idle gaps."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity

    passes, calls = [], []
    monkeypatch.setattr(trace, '_profiler', lambda acts: (
        passes.append(list(acts)), contextlib.nullcontext())[1])
    monkeypatch.setattr(trace, '_events', lambda prof: (
        [(0.0, 0.001, 'k')], [(0.0, 0.004, 'gazebench.entry')]))
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)

    def run(ranges):
        calls.append(ranges)
        time.sleep(0.02)
        return 4

    rec = trace.profile(run)
    assert calls == [False, True]
    assert passes == [[ProfilerActivity.CUDA],
                      [ProfilerActivity.CPU, ProfilerActivity.CUDA]]
    assert rec['calls'] == 4
    assert 0.02 <= rec['window_s'] < 0.04
    assert rec['call_s'] == pytest.approx(rec['window_s'] / 4)
    assert rec['busy_s'] == pytest.approx(0.001)
    assert rec['gaps'] == {'entry': pytest.approx(0.003)}


def test_roofline_and_mfu_shares():
    nbytes, flops = 3.35e6, 1e9              # 1 us of bytes, ~1 us at bf16
    bound = K.bound_s(nbytes, flops, 'bfloat16')
    assert bound == pytest.approx(max(1e-6, 1e9 / 989e12))
    rec = dict(mode='eval', trace=dict(kernel_s={
        'void roi_align_fpn_kernel<8>(Args)': [2 * bound, 2 * bound],
        'roi_align_fpn_bwd_kernel': [bound]}),
        launches=[('k1', nbytes, flops, 'bfloat16')] * 2)
    assert metrics_lib.roofline(rec, 'eval', 'roi_align_fpn_kernel',
                                'k1') == pytest.approx(50.0)
    assert metrics_lib.roofline(rec, 'eval', 'stqi_attention_kernel',
                                'k4') is None
    assert metrics_lib.roofline(rec, 'train', 'roi_align_fpn_kernel',
                                'k1') is None
    win = dict(calls=10, seconds=2.0, host_s=[0.001, 0.003, 0.002])
    rec = dict(mode='eval', window=win, flops_per_call=1e12,
               peak_flops=989e12)
    assert metrics_lib.mfu(rec, 'eval') == pytest.approx(
        100 * 5e12 / 989e12)
    assert metrics_lib.host_ms(rec, 'eval') == pytest.approx(2.0)
    assert metrics_lib.mfu(rec, 'train') is None


def test_a_kernel_at_its_bound_reads_100_and_no_peak_is_below_a_core():
    # the peak of each dtype is the tensor cores' (bf16 989, TF32 495):
    # no implementation computes faster, so no share can pass 100%
    assert K.PEAK_FLOPS == dict(bfloat16=989e12, float32=495e12)
    b = K.bound_s(1e6, 1e12, 'float32')
    rec = dict(mode='eval', trace=dict(kernel_s={'stqi_attention_kernel':
                                                 [b]}),
               launches=[('k4', 1e6, 1e12, 'float32')])
    assert metrics_lib.roofline(rec, 'eval', 'stqi_attention_kernel',
                                'k4') == pytest.approx(100.0)
