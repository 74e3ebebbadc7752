"""Nothing gazebench runs imports JAX or the JAX package: no module of the
harness names one, and a whole run (at a small size on the CPU) leaves
none in sys.modules. The references and the frozen counts import nothing
of the program. Top-level names are compared whole: mcgaze_tpu_torch is
the program, mcgaze_tpu the JAX package."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gazebench.run import FORBIDDEN

HARNESS = Path(__file__).resolve().parents[1]
ROOT = HARNESS.parent


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split('.')[0])
    return tops


def test_no_harness_module_names_jax():
    for path in HARNESS.rglob('*.py'):
        if 'tests' in path.parts:
            continue
        assert not _imports(path) & set(FORBIDDEN), path


def test_references_and_counts_import_no_program():
    for sub in ('reference', 'counts'):
        for path in (HARNESS / sub).glob('*.py'):
            assert 'mcgaze_tpu_torch' not in _imports(path), path


SMALL = dict(config=dict(model=dict(
    num_stages=2, channels=32, ffn_channels=64, num_heads=4,
    dyn_feat_channels=16, stage_loss_weights=[1.0, 1.0], num_queries=3)),
    traffic=dict(clips=2, height=64, width=64, pool=4, check_calls=1))
SCRIPT = '''
import json, sys
import torch
torch.set_num_threads(1)
from gazebench.run import forbidden_modules, run_cell
out = run_cell(sys.argv[1], 3, 0.1, False, device='cpu',
               overrides=json.loads(sys.argv[2]))
print(json.dumps(dict(bad=forbidden_modules(), correct=out['correct'])))
'''


@pytest.mark.parametrize('cell', ['gaze-eval-b32', 'gaze-train-b32'])
def test_a_run_loads_no_jax(cell):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop('JAX_PLATFORMS', None)
    res = subprocess.run([sys.executable, '-c', SCRIPT, cell,
                          json.dumps(SMALL)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got['bad'] == []


def test_no_card_means_no_result():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES='')
    res = subprocess.run([sys.executable, '-m', 'gazebench.run',
                          '--workload', 'gaze-eval-b32', '--seed', '1',
                          '--seconds', '1', '--trace', '0'], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ''
