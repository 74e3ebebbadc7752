"""The port imports no JAX: a fresh interpreter imports every module of
mcgaze_tpu_torch, and none of jax, flax or mcgaze_tpu is loaded; the
learning proofs load no cv2 either. And chip_smoke.py refuses to run
without a card."""
import os.path as osp
import shutil
import subprocess
import sys

import pytest
import torch
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

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
                 'data.dataset', 'data.coco_vid', 'tools.test_gaze360_gaze',
                 'tools.test', 'tools.calculate_mae_gaze360',
                 'tools.calculate_mae_l2cs', 'data.native_loader',
                 'evaluation.mae_device', 'evaluation.serving',
                 'tools.deployment.serve', 'tools.deployment.package_model',
                 'tools.deployment.test_server',
                 'tools.deployment.export_model',
                 'tools.model_converters.publish_model', 'models.yolov5',
                 'demo.head_det', 'demo.gaze_demo',
                 'utils.query_config', 'models.query_detector',
                 'utils.convert', 'evaluation.forward',
                 'evaluation.track_eval', 'data.instblink_dataset',
                 'evaluation.instblink_driver', 'tools.test_instblink',
                 'train.hungarian', 'train.query_criterion',
                 'train.query_loop', 'tools.train_instblink',
                 'data.gaze360_prepare', 'data.rtgene_prepare',
                 'data.mpeblink_prepare', 'tools.gaze360_img_reorganize',
                 'tools.dataset_converters.gaze360.generate_json_from_ori',
                 'tools.dataset_converters.rtgene.convert',
                 'tools.dataset_converters.mpeblink_build_raw_frames_dataset',
                 'tools.analysis_tools.npy_frames',
                 'tools.analysis_tools.crop_sensitivity',
                 'tools.analysis_tools.instblink_burnin'):
        assert f'mcgaze_tpu_torch.{name}' in walked, name


_LEARNING_PROBE = r'''
import sys
from mcgaze_tpu_torch.tools.analysis_tools import (crop_sensitivity,
                                                   instblink_burnin,
                                                   npy_frames)
with npy_frames.npy_frames():
    pass
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mcgaze_tpu',
                                    'cv2'))
print(bad)
assert not bad, bad
'''


def test_learning_tools_import_no_jax_and_no_cv2():
    """The learning proofs and their frame stand-in (which imports the
    readers it replaces) run where there is no OpenCV: importing them
    pulls in none of jax, mcgaze_tpu or cv2."""
    out = subprocess.run([sys.executable, '-c', _LEARNING_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


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
