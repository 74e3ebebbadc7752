"""The program-span readings (gazebench/spans.py) on synthetic records:
each device operation put down to the innermost span open when its launch
was made, a span's device time as the union of its operations' intervals,
None where a span did no work, operations a call; and, at a small size on
the CPU, each cell's entry leaving its spans nested as the layers are."""
from __future__ import annotations

import json

import pytest
import torch

from gazebench import spans as S
from gazebench import spec

MS = 1_000_000      # ns


def _span(name, start, end, parent, call):
    return dict(name='mcgaze.' + name, start_ns=start * MS, end_ns=end * MS,
                parent=parent, call=call)


def _eval_spans():
    """Two calls: eval [0, 10] (handover [0, 1], backbone [1, 4],
    heads [4, 9] with stage0 [4, 6] and stage1 [6, 9]), eval [20, 30]."""
    out = [_span('eval', 0, 10, None, 0), _span('handover', 0, 1, 0, 0),
           _span('backbone', 1, 4, 0, 0), _span('heads', 4, 9, 0, 0),
           _span('heads.stage0', 4, 6, 3, 0),
           _span('heads.stage1', 6, 9, 3, 0)]
    out += [_span('eval', 20, 30, None, 1), _span('backbone', 21, 23, 6, 1)]
    return out


def test_innermost_span_names_each_instant():
    spans = _eval_spans()
    tl = S.innermost(spans)
    at = {t: S.label_at(tl, t * MS) for t in (-1, 0.5, 2, 4.5, 7, 9.5,
                                                 15, 22, 25, 31)}
    assert at == {-1: S.OUTSIDE, 0.5: 1, 2: 2, 4.5: 4, 7: 5, 9.5: 0,
                  15: S.OUTSIDE, 22: 7, 25: 6, 31: S.OUTSIDE}


def test_launch_attributed_by_its_host_time_not_its_device_time():
    spans = _eval_spans()
    # kernels run late on the card; their launches were made earlier
    ops = [(5 * MS, 8 * MS, 11),          # launched at 2: backbone
           (7 * MS, 12 * MS, 12),         # launched at 7: heads.stage1
           (12 * MS, 13 * MS, 13),        # launched at 15: outside
           (14 * MS, 15 * MS, 99)]        # no runtime call recorded
    launches = {11: 2 * MS, 12: 7 * MS, 13: 15 * MS}
    got = S.attribute(spans, ops, launches)
    assert [op[2] for op in got['ops']] == [2, 5, S.OUTSIDE, S.UNLINKED]


def test_device_ms_is_a_union_and_none_where_no_work():
    spans = _eval_spans()
    # stage0 launches two overlapping kernels [5, 8] and [6, 9], stage1 one
    # at [9, 10]; call 1's backbone one at [22, 23]
    ops = [[5 * MS, 8 * MS, 4], [6 * MS, 9 * MS, 4], [9 * MS, 10 * MS, 5],
           [22 * MS, 23 * MS, 7]]
    part = dict(spans=spans, ops=ops, counts={})
    assert S.device_ms_by_call(part, ['heads']) == [pytest.approx(5.0)]
    assert S.device_ms_by_call(part, ['heads.stage0']) == [
        pytest.approx(4.0)]       # not 6: the union, not the sum
    assert sorted(S.device_ms_by_call(part, ['backbone'])) == [
        pytest.approx(1.0)]
    assert S.ops_by_call(part) == [3, 1]
    rec = dict(mode='eval', program=dict(device=part))
    assert S.device_ms(rec, 'eval', 'handover') is None
    assert S.device_ms(rec, 'train', 'heads') is None
    assert S.device_ops(rec, 'eval') == 2.0       # median of 3 and 1
    assert S.device_ops(dict(mode='eval'), 'eval') is None


def test_host_ms_and_counters_a_call():
    part = dict(spans=_eval_spans(), counts={
        0: {'weight_cast_bytes': 4_000_000}, 1: {'weight_cast_bytes': 0},
        None: {'weight_cast_bytes': 7}})
    rec = dict(mode='eval', program=dict(host=part))
    assert sorted(S.host_ms_by_call(part, ['backbone'])) == [
        pytest.approx(2.0), pytest.approx(3.0)]
    assert S.host_ms(rec, 'eval', 'backbone', 'handover') == pytest.approx(
        3.0)                      # call 0: 3 + 1, call 1: 2
    assert S.host_ms(rec, 'eval', 'select') is None
    # a call that cast nothing and counts outside every call are left out
    assert S.counter_mb(rec, 'eval', 'weight_cast_bytes') == 4.0
    assert S.counters(part) == {'weight_cast_bytes': 2_000_000}
    assert S.counter_mb(dict(mode='eval', program=dict(host=dict(
        spans=_eval_spans(), counts={}))), 'eval',
        'weight_cast_bytes') is None


def test_idle_named_by_the_span_the_host_was_in():
    spans = _eval_spans()
    ops = [[0, 2 * MS, 1], [3 * MS, 9 * MS, 4], [21 * MS, 31 * MS, 7]]
    idle = S.idle(spans, ops)
    # gaps [2, 3] in backbone, [9, 21] split at its middle 15: outside
    assert idle == {'backbone': pytest.approx(1e-3),
                    'outside': pytest.approx(12e-3)}


def test_summary_coverage():
    spans = _eval_spans()
    host = dict(spans=spans, counts={}, host_s=[0.01, 0.01])
    dev = dict(spans=spans, ops=[[0, 2 * MS, 1], [3 * MS, 9 * MS, 4],
                                 [11 * MS, 12 * MS, S.OUTSIDE],
                                 [21 * MS, 29 * MS, 7]],
               idle={'backbone': 1e-3, 'outside': 1e-3})
    got = S.summary(dict(host=host, device=dev, calls=2))
    assert got['child_share'] == pytest.approx(0.2)   # call 1: 2 of 10
    assert got['device_share'] == pytest.approx(8 / 9)
    assert got['idle_named'] == pytest.approx(0.5)
    assert (got['unlinked'], got['ops']) == (0, 4)


def test_device_events_link_by_correlation():
    class Ev:
        def __init__(self, kind, start, dur, corr, linked=0):
            self.kind, self.s, self.d = kind, start, dur
            self.c, self.l = corr, linked

        def activity_type(self):
            return self.kind

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

        def correlation_id(self):
            return self.c

        def linked_correlation_id(self):
            return self.l

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Ev('cuda_runtime', 5, 1, 7),
                            Ev('kernel', 10, 4, 7),
                            Ev('gpu_memcpy', 20, 2, 0, 8),
                            Ev('cuda_driver', 6, 1, 8),
                            Ev('gpu_user_annotation', 0, 50, 9),
                            Ev('cpu_op', 1, 1, 0)]

    ops, launches = S._device_events(Prof)
    assert ops == [(10, 14, 7), (20, 22, 8)]
    assert launches == {7: 5, 8: 6}


def test_readers_cover_every_layer_metric():
    assert set(S.READERS) == {
        'handover_host_ms.eval', 'backbone_host_ms.eval',
        'heads_host_ms.eval', 'backbone_device_ms.eval',
        'heads_device_ms.eval', 'launches_per_batch.eval',
        'weight_cast_mb.eval', 'forward_host_ms.train',
        'backward_host_ms.train', 'update_host_ms.train',
        'forward_device_ms.train', 'backward_device_ms.train',
        'update_device_ms.train', 'launches_per_step.train'}
    assert S.read_all(dict(mode='eval')) == {}


BENCH = json.loads((spec.ROOT.parent / 'BENCHMARK.json').read_text())
MODEL = dict(num_stages=2, channels=32, ffn_channels=64, num_heads=4,
             dyn_feat_channels=16, stage_loss_weights=[1.0, 1.0])
EVAL = ['eval', 'eval/handover', 'eval/backbone',
        'eval/backbone/device_normalize', 'eval/fpn', 'eval/heads',
        'eval/heads/heads.stage0', 'eval/heads/heads.stage1', 'eval/select']
NESTING = {
    'gaze-eval-b32': EVAL, 'instblink-eval-b8': EVAL,
    'gaze-train-b32': ['train', 'train/train.forward',
                       'train/train.forward/backbone',
                       'train/train.forward/fpn', 'train/train.forward/heads',
                       'train/train.forward/heads/heads.stage0',
                       'train/train.forward/heads/heads.stage1',
                       'train/train.backward', 'train/train.update']}


def _small(cell: str) -> dict:
    tr = spec.load_cell(cell)['traffic']
    if tr['kind'] == 'video_windows':
        traffic = dict(clips=2, height=64, width=96, image_height=60,
                       image_width=96, pool=2, check_calls=1)
        model = dict(MODEL, num_queries=10)
    else:
        traffic = dict(clips=2, height=64, width=64, pool=4, check_calls=1)
        model = dict(MODEL, num_queries=3)
    return dict(traffic=traffic, config=dict(model=model))


def _paths(spans):
    out = []
    for s in spans:
        name = s['name'][len('mcgaze.'):]
        p = s['parent']
        out.append(name if p is None else out[p] + '/' + name)
    return out


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_cell_spans_nest_as_the_layers(cell):
    """A small CPU run of the cell's entry with the recorder on: every call
    is one root span holding the layers in order, and the recorder is off
    and empty after the pass."""
    from mcgaze_tpu_torch.utils import profiling
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        c = spec.load_cell(cell, _small(cell))
        entry = spec.entry_class(c['workload']['entry'])(c, 7, 'cpu')
        entry.setup()
        part = S.host_pass(entry, 0, 2)
        sites = S.sites_a_call(entry, 2)
    finally:
        torch.set_num_threads(threads)
    paths = _paths(part['spans'])
    per_call = len(NESTING[cell])
    assert paths == NESTING[cell] * 2
    assert [s['call'] for s in part['spans']] == \
        [part['spans'][0]['call']] * per_call + \
        [part['spans'][per_call]['call']] * per_call
    assert len(part['host_s']) == 2
    bf16 = c['config']['precision'][entry.mode]['dtype'] == 'bfloat16'
    casts = S.counter_by_call(part, 'weight_cast_bytes')
    assert (len(casts) == 2 and min(casts) > 0) if bf16 else casts == []
    assert (sites['spans'], sites['roots']) == (per_call, 1)
    assert (sites['counts'] > 0) == bf16
    assert profiling.drain() == dict(spans=[], counts={})
    with profiling.span('mcgaze.eval'):
        pass
    assert profiling.drain() == dict(spans=[], counts={})
