"""The check of each cell fails what it must, at a size the CPU holds (the
published widths, 64 px frames, two clips):

  * the control, the plain reference one precision below the
    configuration's in the program's place, comes out not correct under
    the cell's limits (on the card the same comparison at the cell's own
    size gives the limits' upper readings: `python3 -m gazebench.control`);
  * a whole run with the timed path broken underneath (the chip check
    skipped, the program run in f32 on the CPU so that a sound run is well
    inside the limits) comes out not correct, once for each fault the cell
    can have: an answer altered where it is produced, half of the batch
    left out, a step that leaves its state unchanged. One chip: no
    exchange between chips to leave out.
"""
from __future__ import annotations

import json

import pytest
import torch

from gazebench import spec
from gazebench.faults import FAULTS, planted
from gazebench.control import readings
from gazebench.run import run_cell

BENCH = json.loads((spec.ROOT.parent / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]


def _small(cell: str, f32: bool) -> dict:
    tr = spec.load_cell(cell)['traffic']
    if tr['kind'] == 'video_windows':
        traffic = dict(clips=2, height=64, width=96, image_height=60,
                       image_width=96, pool=2, check_calls=2)
    else:
        traffic = dict(clips=2, height=64, width=64, pool=4, check_calls=2)
    out = dict(traffic=traffic)
    if f32:
        mode = spec.load_cell(cell)['workload']['entry']
        mode = 'train' if mode.endswith('train') else 'eval'
        out['config'] = dict(precision={mode: dict(dtype='float32')})
    return out


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    got = readings(cell, 5, 0.1, True, 'cpu', _small(cell, False))
    limits = spec.load_cell(cell)['workload']['checks']
    failed = [k for k, lim in limits.items() if got['control'][k] > lim]
    assert failed, (got['control'], limits)


CASES = [(cell, i) for cell in CELLS
         for i in range(len(FAULTS[spec.load_cell(cell)['workload']
                                   ['entry']]))]


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(cell):
    out = run_cell(cell, 11, 0.1, False, 'cpu', _small(cell, True))
    assert out['correct'], out['checks']


@pytest.mark.parametrize('cell,fault', CASES)
def test_fault_is_not_correct(cell, fault):
    entry = spec.load_cell(cell)['workload']['entry']
    with planted(entry, fault):
        out = run_cell(cell, 11, 0.1, False, 'cpu', _small(cell, True))
    assert not out['correct'], out['checks']
