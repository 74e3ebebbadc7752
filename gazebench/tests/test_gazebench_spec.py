"""The harness finds each cell, configuration, traffic mix and metric by
name, so a later cell is files added beside these and none edited; the
files it names agree with BENCHMARK.json; the reference's parameters are
the program's, name for name and shape for shape."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from gazebench import spec

BENCH = json.loads((spec.ROOT.parent / 'BENCHMARK.json').read_text())


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / 'gazebench'
    for d in ('workloads', 'configs', 'traffic', 'metrics'):
        shutil.copytree(spec.ROOT / d, root / d)
    before = {p: p.read_bytes() for p in root.rglob('*') if p.is_file()}

    cfg = json.loads((root / 'configs' / 'mcgaze-r50-gaze360.json')
                     .read_text())
    cfg['name'] = 'mcgaze-later'
    (root / 'configs' / 'mcgaze-later.json').write_text(json.dumps(cfg))
    tr = json.loads((root / 'traffic' / 'gaze-clips-b32.json').read_text())
    tr['clips'] = 8
    (root / 'traffic' / 'gaze-clips-b8.json').write_text(json.dumps(tr))
    (root / 'workloads' / 'gaze-eval-b8.json').write_text(json.dumps(dict(
        config='mcgaze-later', traffic='gaze-clips-b8', entry='gaze_eval',
        chips=1, why='a later cell', checks={})))
    (root / 'metrics' / 'later_ms.eval.py').write_text(
        "UNIT = 'ms'\n\n\ndef read(rec):\n    return 1.5\n")

    monkeypatch.setattr(spec, 'ROOT', root)
    cell = spec.load_cell('gaze-eval-b8')
    assert cell['config']['name'] == 'mcgaze-later'
    assert cell['traffic']['clips'] == 8
    assert spec.entry_class(cell['workload']['entry']).mode == 'eval'
    readers = spec.metric_readers()
    assert readers['later_ms.eval'].read({}) == 1.5
    assert {m['name'] for m in BENCH['per_layer']} <= set(readers)
    for p, data in before.items():
        assert p.read_bytes() == data, f'{p} was edited'


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_benchmark_cells_resolve(cell):
    entry = next(w for w in BENCH['workloads'] if w['name'] == cell)
    got = spec.load_cell(cell)
    assert got['workload']['config'] == entry['config']
    assert got['workload']['traffic'] == entry['traffic']
    assert got['workload']['chips'] == entry['chips']
    assert got['workload']['why'] == entry['why']
    conf = next(c for c in BENCH['configs'] if c['name'] == entry['config'])
    assert conf['file'] == f'gazebench/configs/{entry["config"]}.json'
    assert conf['reduced'] == got['config']['reduced']
    assert got['workload']['checks'], 'a cell compares at least one number'
    spec.reference(got['config']['family'])


def test_metric_units_match_benchmark():
    readers = spec.metric_readers()
    for m in BENCH['per_layer']:
        assert readers[m['name']].UNIT == m['unit'], m['name']


CONFIG_CLASSES = {
    'mcgaze': ('mcgaze_tpu_torch.models.mcgaze', 'MCGazeModel',
               'ModelConfig'),
    'instblink': ('mcgaze_tpu_torch.models.query_detector', 'QueryDetector',
                  'QueryDetectorConfig'),
}


@pytest.mark.parametrize('config', [c['name'] for c in BENCH['configs']])
def test_reference_parameters_are_the_programs(config):
    import importlib
    cell = next(w['name'] for w in BENCH['workloads']
                if w['config'] == config)
    cfg = spec.load_cell(cell)['config']
    mod, model_cls, cfg_cls = CONFIG_CLASSES[cfg['family']]
    mod = importlib.import_module(mod)
    fields = {f for f in getattr(mod, cfg_cls).__dataclass_fields__}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in dict(cfg['model'], **cfg['program']).items()
          if k in fields}
    with torch.device('meta'):
        model = getattr(mod, model_cls)(getattr(mod, cfg_cls)(**kw))
    program = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ref = {n: tuple(s) for n, s, _ in
           spec.reference(cfg['family']).param_specs(cfg['model'])}
    assert ref == program
