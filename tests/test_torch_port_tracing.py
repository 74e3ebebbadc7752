"""The port's spans and counters (mcgaze_tpu_torch/utils/profiling.py:
span, count, recording, drain).

Off (the default) a span is one shared context and nothing is kept or
allocated; inside recording() spans nest with their parents and one call
id a root, counters total a call, and drain() empties the recorder. The
spans are stamped on the torch profiler's clock, so a profiled operator
inside a span lies inside it on the trace's timeline; trace() writes them
into its Chrome file. `weight_cast_bytes` counts the parameter bytes that
a bf16 call converts, and nothing in f32.
"""
import json
import shutil
import threading
import tracemalloc

import pytest
import torch

from mcgaze_tpu_torch.models import layers
from mcgaze_tpu_torch.models.heads import _batched_heads
from mcgaze_tpu_torch.utils import profiling as P
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _empty():
    P.drain()
    yield
    P.drain()


def test_off_keeps_nothing_and_shares_one_context():
    assert P.span('mcgaze.a') is P.span('mcgaze.b') is P.span('x', 3)
    with P.span('mcgaze.a'):
        P.count('n', 5)
        P.count('bytes', torch.ones(4))
    assert P.drain() == dict(spans=[], counts={})


def test_off_span_allocates_nothing():
    """Whatever span, its context and count hand back is kept alive, so an
    object allocated for them would stay in the snapshot."""
    kept = [None] * 3000

    def loop():
        for k in range(0, len(kept), 3):
            ctx = P.span('mcgaze.heads.stage', 2)
            kept[k], kept[k + 1] = ctx, ctx.__enter__()
            kept[k + 2] = P.count(P.WEIGHT_CAST_BYTES, 7)
            ctx.__exit__(None, None, None)
    loop()                                  # warm
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, 'filename')
             if d.size_diff > 0 and 'profiling' in str(d.traceback)]
    assert grown == []
    assert len({id(c) for c in kept[0::3]}) == 1


def test_on_spans_nest_with_parents_and_one_call_id_a_root():
    with P.recording():
        for _ in range(2):
            with P.span('mcgaze.eval'):
                with P.span('mcgaze.heads'):
                    with P.span('mcgaze.heads.stage', 0):
                        P.count('n', 2)
                    with P.span('mcgaze.heads.stage', 1):
                        P.count('n', 3)
                        P.count('b', torch.ones(3, dtype=torch.bfloat16))
        P.count('n', 100)                   # outside every root
    assert P.span('mcgaze.eval') is P.span('other')   # off again
    rec = P.drain()
    names = [s['name'] for s in rec['spans']]
    assert names == ['mcgaze.eval', 'mcgaze.heads', 'mcgaze.heads.stage0',
                     'mcgaze.heads.stage1'] * 2
    assert [s['parent'] for s in rec['spans']] == [None, 0, 1, 1,
                                                   None, 4, 5, 5]
    calls = [s['call'] for s in rec['spans']]
    assert calls[:4] == [calls[0]] * 4 and calls[4:] == [calls[4]] * 4
    assert calls[0] != calls[4]
    for s in rec['spans']:
        assert s['start_ns'] <= s['end_ns']
        if s['parent'] is not None:
            p = rec['spans'][s['parent']]
            assert p['start_ns'] <= s['start_ns'] <= s['end_ns'] <= \
                p['end_ns']
    for call in (calls[0], calls[4]):
        c = rec['counts'][call]
        assert (c['n'], c['b']) == (5, 6)
        assert {k: c[k] for k in c if k.startswith('launch_count.')} == {
            'launch_count.k1': 0, 'launch_count.k3': 0,
            'launch_count.k4': 0, 'launch_count.k5': 0}
    assert rec['counts'][None] == {'n': 100}
    assert P.drain() == dict(spans=[], counts={})


def test_root_counts_the_kernels_launch_counters_it_moved(monkeypatch):
    from mcgaze_tpu_torch.ops import roi_align_cuda, stqi_attention
    with P.recording():
        with P.span('mcgaze.eval'):
            monkeypatch.setattr(roi_align_cuda, 'launch_count',
                                roi_align_cuda.launch_count + 4)
            monkeypatch.setattr(stqi_attention, 'launch_count',
                                stqi_attention.launch_count + 1)
    (counts,) = P.drain()['counts'].values()
    assert (counts['launch_count.k1'], counts['launch_count.k4'],
            counts['launch_count.k3']) == (4, 1, 0)


def test_recording_restores_and_drain_refuses_an_open_span():
    with P.recording():
        with P.recording():
            pass
        with P.span('mcgaze.eval'):
            with pytest.raises(RuntimeError):
                P.drain()
    assert len(P.drain()['spans']) == 1
    assert P.span('a') is P.span('b')


def test_each_thread_opens_its_own_roots():
    seen = []

    def worker():
        with P.span('mcgaze.train'):
            pass
        seen.append(True)

    with P.recording():
        with P.span('mcgaze.eval'):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    spans = P.drain()['spans']
    assert seen == [True]
    by = {s['name']: s for s in spans}
    assert by['mcgaze.train']['parent'] is None
    assert by['mcgaze.train']['call'] != by['mcgaze.eval']['call']


def test_threads_record_without_losing_updates():
    """More threads than cores open roots and children and count, with a
    short switch interval: every span keeps its own parent and call, and
    no count is lost."""
    import os
    import sys
    workers, rounds = 2 * (os.cpu_count() or 4), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with P.span('mcgaze.root'):
                    with P.span('mcgaze.child'):
                        P.count('n', 1)
                    P.count('n', 1)

        with P.recording():
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rec = P.drain()
    spans = rec['spans']
    roots = [s for s in spans if s['parent'] is None]
    children = [s for s in spans if s['parent'] is not None]
    assert len(roots) == len(children) == workers * rounds
    assert len({s['call'] for s in roots}) == workers * rounds
    for c in children:
        p = spans[c['parent']]
        assert (p['name'], p['call']) == ('mcgaze.root', c['call'])
        assert p['start_ns'] <= c['start_ns'] <= c['end_ns'] <= p['end_ns']
    assert sum(c['n'] for c in rec['counts'].values()) == \
        2 * workers * rounds
    assert all(c['n'] == 2 for c in rec['counts'].values())


def test_spans_on_the_profiler_clock():
    """A record_function entered inside a span lies inside the span on the
    profiler's timeline, within 50 us, each of 100 times."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.recording():
            for _ in range(100):
                with P.span('mcgaze.clock'):
                    with record_function('inner_op'):
                        torch.ones(8).sum()
    spans = P.drain()['spans']
    events = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == 'inner_op')
    assert len(spans) == len(events) == 100
    tol = 50_000
    for s, (e0, e1) in zip(spans, events):
        assert s['start_ns'] - tol <= e0 <= e1 <= s['end_ns'] + tol


class _Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = layers.Conv2d(3, 8, 3, padding=1)
        self.fc = layers.Linear(8, 16)
        self.heads = torch.nn.ModuleList(layers.Linear(16, 4)
                                         for _ in range(3))
        self.block = torch.nn.Parameter(torch.randn(5, 16))

    def forward(self, x):
        y = self.conv(x).mean((2, 3))                       # (N, 8)
        y = self.fc(y)                                      # (N, 16)
        z = layers.blocked_linear(y, self.block, rows=2)    # (N, 5)
        h = _batched_heads(y[:, None].expand(-1, 3, -1).contiguous(),
                           list(self.heads))                # (N, 3, 4)
        return z.sum() + h.float().sum()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_weight_cast_bytes_counts_real_conversions(dtype):
    torch.manual_seed(0)
    model = _Small()
    x = torch.randn(2, 3, 8, 8).to(dtype)
    with P.recording():
        with P.span('mcgaze.eval'):
            model(x)
    (counts,) = P.drain()['counts'].values()
    if dtype == torch.float32:
        assert P.WEIGHT_CAST_BYTES not in counts
        return
    params = (list(model.conv.parameters()) + list(model.fc.parameters())
              + [model.block] + list(model.heads.parameters()))
    # every f32 parameter the call reads is converted once: the heads'
    # weights and biases as one stacked tensor each
    assert counts[P.WEIGHT_CAST_BYTES] == sum(p.numel() * 4 for p in params)


def test_cast_param_same_dtype_is_the_parameter():
    p = torch.nn.Parameter(torch.ones(3))
    with P.recording():
        with P.span('mcgaze.eval'):
            assert layers.cast_param(p, torch.float32) is p
            assert layers.cast_param(None, torch.bfloat16) is None
    (counts,) = P.drain()['counts'].values()
    assert P.WEIGHT_CAST_BYTES not in counts


def test_trace_writes_the_program_spans(tmp_path):
    d = tmp_path / 'prof'
    with P.trace(str(d)):
        with P.span('mcgaze.train'):
            with P.span('mcgaze.train.forward'):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = list(d.iterdir())
    events = json.loads(path.read_text())['traceEvents']
    spans = {e['name']: e for e in events if e.get('cat') == 'mcgaze_span'}
    assert set(spans) == {'mcgaze.train', 'mcgaze.train.forward'}
    outer, inner = spans['mcgaze.train'], spans['mcgaze.train.forward']
    assert outer['ts'] <= inner['ts'] and \
        inner['ts'] + inner['dur'] <= outer['ts'] + outer['dur']
    mm = [e for e in events if e.get('name') == 'aten::mm']
    assert mm and all(inner['ts'] - 50 <= e['ts'] and
                      e['ts'] + e['dur'] <= inner['ts'] + inner['dur'] + 50
                      for e in mm)
    assert P.drain() == dict(spans=[], counts={})
    shutil.rmtree(tmp_path)


def test_model_spans_in_a_tiny_eval_and_train_step():
    """The layer spans of MCGazeModel's eval forward (bf16: casts counted)
    and of one train step (f32: none)."""
    from mcgaze_tpu_torch.evaluation.forward import (bind_forward,
                                                     make_eval_forward)
    from mcgaze_tpu_torch.models.mcgaze import ModelConfig
    from mcgaze_tpu_torch.train.loop import (OptimConfig, create_train_state,
                                             make_train_step)
    small = dict(backbone_depth=26, num_stages=2, channels=32,
                 ffn_channels=64, num_heads=4, dyn_feat_channels=16,
                 stage_loss_weights=(1.0, 1.0))
    mc = ModelConfig(dtype='bfloat16', **small)
    _, fwd, fwd_dedup = make_eval_forward(mc, device='cpu')
    forward = bind_forward(fwd, 'cpu', fwd_dedup)
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 255, (9, 32, 32, 3), dtype=torch.uint8,
                           generator=g).numpy()
    whwh = torch.full((9, 4), 32.0).numpy()
    sel = torch.arange(7, dtype=torch.int32).numpy()
    with P.recording():
        forward.dedup(frames, sel, whwh, 7)
    rec = P.drain()
    assert [s['name'][len('mcgaze.'):] for s in rec['spans']] == [
        'eval', 'handover', 'backbone', 'device_normalize', 'fpn', 'heads',
        'heads.stage0', 'heads.stage1', 'select']
    (counts,) = rec['counts'].values()
    assert counts[P.WEIGHT_CAST_BYTES] > 0

    mc32 = ModelConfig(**small)
    oc = OptimConfig(warmup_iters=1)
    state = create_train_state(mc32, oc, seed=0, device='cpu')
    step = make_train_step(mc32, oc)
    b, t = 1, 7
    batch = dict(imgs=torch.randint(0, 255, (b, t, 32, 32, 3),
                                    dtype=torch.uint8, generator=g),
                 img_whwh=torch.full((b, t, 4), 32.0),
                 gt_boxes=torch.tensor([4.0, 4.0, 20.0, 20.0]).expand(
                     b, t, 3, 4).clone(),
                 gt_valid=torch.ones(b, t, 3, dtype=torch.bool),
                 gt_gazes=torch.nn.functional.normalize(
                     torch.randn(b, t, 3, 3, generator=g), dim=-1))
    with P.recording():
        step(state, batch)
    rec = P.drain()
    spans = rec['spans']
    top = [s['name'] for s in spans if s['parent'] == 0]
    assert spans[0]['name'] == 'mcgaze.train'
    assert top == ['mcgaze.train.forward', 'mcgaze.train.backward',
                   'mcgaze.train.update']
    (counts,) = rec['counts'].values()
    assert P.WEIGHT_CAST_BYTES not in counts
