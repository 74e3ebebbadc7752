"""The port imports no JAX: a fresh interpreter imports every module of
mcgaze_tpu_torch, and none of jax, flax or mcgaze_tpu is loaded. And
chip_smoke.py refuses to run without a card."""
import os.path as osp
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
import mcgaze_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mcgaze_tpu'))
print(len(names), bad)
print(' '.join(names))
assert not bad, bad
'''


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30, out.stdout
    walked = set(out.stdout.splitlines()[1].split())
    for name in ('ops.losses', 'ops.roi_align_cuda', 'ops.fused_bottleneck',
                 'ops.stqi_attention', 'train.loop',
                 'train.criterion', 'train.hooks', 'train.targets',
                 'tools.train', 'utils.config', 'utils.checkpoint',
                 'data.dataset', 'data.coco_vid'):
        assert f'mcgaze_tpu_torch.{name}' in walked, name


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result when there is no
    card, in the repo and alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    lone = tmp_path / 'chip_smoke.py'
    shutil.copy(osp.join(ROOT, 'chip_smoke.py'), lone)
    for script, cwd in ((osp.join(ROOT, 'chip_smoke.py'), ROOT),
                        (str(lone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout == ''
