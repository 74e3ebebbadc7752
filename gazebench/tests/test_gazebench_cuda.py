"""Each cell of BENCHMARK.json for a few seconds on the card, untraced and
traced: a result line that is correct and carries the cell's metrics.
Card only: whether there is a card is decided inside the test."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


def _expected(cell: str, key: str) -> set:
    return {m['name'] for m in BENCH[key]
            if cell in m.get('workloads', [cell])}


@pytest.mark.cuda
@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_cell_runs_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    res = subprocess.run(
        [sys.executable, '-m', 'gazebench.run', '--workload', cell,
         '--seed', str(2 ** 31 + 7 + trace), '--seconds', '3', '--trace',
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['correct'], out['checks']
    assert out['device']['platform'] == 'gpu'
    want = _expected(cell, 'per_layer' if trace else 'end_to_end')
    assert set(out['metrics']) == want
    assert list(out)[-1] == 'checks'
