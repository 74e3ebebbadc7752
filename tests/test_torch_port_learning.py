"""The port's learning proofs (mcgaze_tpu_torch/tools/analysis_tools/
{crop_sensitivity,instblink_burnin}.py) and their .npy frame stand-in
(npy_frames.py) against the JAX tools and the port's cv2 path, on the CPU.

  * fabrication, from the same seed as the JAX tool (loaded from its path;
    its PNGs written and read back with cv2 here): the same annotation
    JSON once '.png' names map to '.npy'. InstBlink: every frame bit-equal
    to the JAX PNG decoded by cv2. Gaze: every pixel outside the cue's
    bounding box bit-equal, and the cue's pixels (those either painter
    drew) equal on at least CUE_AGREEMENT of them (measured: all of them,
    the port's painter is cv2's line and disc rasterisation written out);
  * the stand-in readers on .npy frames against the port's cv2 readers on
    the same frames as PNGs: the gaze train batches and eval clips (fixed
    and reference crop, which resize), the InstBlink train batches and
    eval windows; u8 frames within 1 level, normalised frames within 1
    level over the ImageNet std (measured: equal); every attribute the
    stand-in replaced is back on exit, also after an exception;
  * each tool's main() at 2 iterations on the CPU: the JAX tool's keys in
    its last JSON line, finite values.
"""
import contextlib
import importlib.util
import io
import json
import os
import os.path as osp
import shutil

import cv2
import numpy as np
import pytest
import torch
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

from mcgaze_tpu_torch.data import transforms as T
from mcgaze_tpu_torch.data.dataset import DataConfig, Gaze360ClipDataset
from mcgaze_tpu_torch.data.instblink_dataset import (InstBlinkClipDataset,
                                                     InstBlinkDataConfig)
from mcgaze_tpu_torch.evaluation.driver import EvalConfig, VideoGazeEvaluator
from mcgaze_tpu_torch.evaluation.instblink_driver import (
    InstBlinkEvalConfig, InstBlinkVideoEvaluator)
from mcgaze_tpu_torch.tools.analysis_tools import crop_sensitivity as pcs
from mcgaze_tpu_torch.tools.analysis_tools import instblink_burnin as pib
from mcgaze_tpu_torch.tools.analysis_tools import npy_frames as nf

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CUE_AGREEMENT = 0.95
# one u8 level after the ImageNet normalisation
NORM_LEVEL = 1.0 / float(T.IMAGENET_STD.min()) * (1 + 1e-6)


def jax_tool(name):
    """The JAX package's tool module, loaded from its path."""
    path = osp.join(ROOT, 'tools', 'analysis_tools', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'jax_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def npy_names(obj):
    """A JSON tree with every '.png' frame name as '.npy'."""
    return json.loads(json.dumps(obj).replace('.png"', '.npy"'))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def png_copy(src_root, dst_root, ann_names):
    """dst_root: src_root's .npy frames as PNGs (cv2.imwrite of the same
    array) and its annotation JSONs with '.png' names."""
    for dirpath, _, files in os.walk(src_root):
        for fn in files:
            src = osp.join(dirpath, fn)
            dst = osp.join(dst_root, osp.relpath(src, src_root))
            os.makedirs(osp.dirname(dst), exist_ok=True)
            if fn.endswith('.npy'):
                cv2.imwrite(dst[:-4] + '.png', np.load(src))
    for name in ann_names:
        text = json.dumps(load_json(osp.join(src_root, name)))
        with open(osp.join(dst_root, name), 'w') as f:
            f.write(text.replace('.npy"', '.png"'))


# --------------------------------------------------------------- fabrication

def test_gaze_fabrication_matches_jax_tool(tmp_path):
    jcs = jax_tool('crop_sensitivity')
    jann, jprefix = jcs.make_dataset(str(tmp_path / 'jax'), 2, 6, seed=7)
    pann, pprefix = pcs.make_dataset(str(tmp_path / 'port'), 2, 6, seed=7)
    jdata = load_json(jann)
    assert npy_names(jdata) == load_json(pann)
    agree = total = 0
    for video in jdata['videos']:
        for name in video['file_names']:
            ref = cv2.imread(osp.join(jprefix, name))
            got = np.load(osp.join(pprefix, name[:-4] + '.npy'))
            assert got.shape == ref.shape == (pcs.H, pcs.W, 3)
            assert got.dtype == np.uint8
            # the noise stays below 40; every cue colour has a 255
            cue = (ref >= 40).any(-1) | (got >= 40).any(-1)
            ys, xs = np.nonzero(cue)
            box = np.zeros_like(cue)
            box[ys.min():ys.max() + 1, xs.min():xs.max() + 1] = True
            assert np.array_equal(got[~box], ref[~box]), name
            agree += int((got[cue] == ref[cue]).all(-1).sum())
            total += int(cue.sum())
    assert total > 0
    assert agree / total >= CUE_AGREEMENT, (agree, total)
    shutil.rmtree(tmp_path)


def test_instblink_fabrication_matches_jax_tool(tmp_path):
    jib = jax_tool('instblink_burnin')
    for split, seed in (('train', 0), ('test', 1000)):
        jib.fabricate(str(tmp_path / 'jax'), 2, np.random.RandomState(seed),
                      split)
        pib.fabricate(str(tmp_path / 'port'), 2, np.random.RandomState(seed),
                      split)
        jdata = load_json(tmp_path / 'jax' / f'{split}.json')
        assert npy_names(jdata) == load_json(tmp_path / 'port' /
                                             f'{split}.json')
        for video in jdata['videos']:
            for name in video['file_names']:
                ref = cv2.imread(str(tmp_path / 'jax' / 'rawframes' / name))
                got = np.load(tmp_path / 'port' / 'rawframes' /
                              (name[:-4] + '.npy'))
                assert got.dtype == np.uint8
                assert np.array_equal(got, ref), name
    shutil.rmtree(tmp_path)


# ------------------------------------------------------------ the stand-in

def test_resize_linear_is_cv2_inter_linear():
    """resize_linear against cv2.resize(INTER_LINEAR) on the shapes the
    tools give it (the gaze crops, 44-64 px, back to 64) and others:
    up, down, an exact halving, one axis each way."""
    rng = np.random.RandomState(0)
    for h, w, nh, nw in ((44, 44, 64, 64), (54, 54, 64, 64),
                         (63, 63, 64, 64), (64, 64, 44, 44),
                         (64, 64, 32, 32), (96, 128, 360, 480),
                         (50, 70, 37, 91), (7, 9, 100, 3)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ref = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        got = nf.resize_linear(img, nw, nh)
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        assert np.array_equal(got, ref), (h, w, nh, nw)


def patched_now():
    return {(owner, name): vars(owner)[name]
            for owner, name, _ in nf._patches()}


def test_stand_in_restores_what_it_replaced():
    before = patched_now()
    with nf.npy_frames():
        inside = patched_now()
        assert all(inside[k] is not v for k, v in before.items())
    assert patched_now() == before
    with pytest.raises(RuntimeError, match='inside'):
        with nf.npy_frames():
            raise RuntimeError('inside')
    assert patched_now() == before


@pytest.fixture(scope='module')
def gaze_data(tmp_path_factory):
    """One gaze dataset as .npy (the port's make_dataset) and as PNGs."""
    root = tmp_path_factory.mktemp('gaze')
    ann, prefix = pcs.make_dataset(str(root / 'npy'), 2, 12, seed=7)
    png_copy(str(root / 'npy'), str(root / 'png'), ['anno.json'])
    yield dict(npy=(ann, prefix),
               png=(str(root / 'png' / 'anno.json'),
                    str(root / 'png' / 'frames') + '/'))
    shutil.rmtree(root)


def gaze_train_batches(ann, prefix, n=2):
    cfg = DataConfig(ann_file=ann, img_prefix=prefix, scale=(64, 64),
                     canvas=(64, 64), crop_size=0.68, batch_size=4)
    ds = Gaze360ClipDataset(cfg, seed=0, use_native=False)
    stream = ds.batches(seed=0)
    return [next(stream) for _ in range(n)]


def test_gaze_train_batches_match_cv2_path(gaze_data):
    with nf.npy_frames():
        got = gaze_train_batches(*gaze_data['npy'])
    ref = gaze_train_batches(*gaze_data['png'])
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == 'imgs':
                assert np.abs(g[k] - r[k]).max() <= NORM_LEVEL
            else:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize('mode', ['fixed', 'reference'])
def test_gaze_eval_clips_match_cv2_path(gaze_data, mode):
    cfg = EvalConfig(scale=(64, 64), canvas=(64, 64), crop_mode=mode,
                     crop_seed=1)
    videos = load_json(gaze_data['png'][0])['videos']
    for video in videos:
        ref_ev = VideoGazeEvaluator(None, cfg)
        ref_ev._native = False
        ref = ref_ev._decode_video(
            [gaze_data['png'][1] + n for n in video['file_names']],
            video['id'])
        assert ref_ev.decoder == 'cv2'
        ev = VideoGazeEvaluator(None, cfg)
        with nf.npy_frames():
            got = ev._decode_video(
                [gaze_data['npy'][1] + n[:-4] + '.npy'
                 for n in video['file_names']], video['id'])
        assert ev.decoder == nf.NPY_DECODE
        assert np.abs(got[0] - ref[0]).max() <= NORM_LEVEL
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g, r)


@pytest.fixture(scope='module')
def instblink_data(tmp_path_factory):
    """One InstBlink dataset as .npy (the port's fabricate) and as PNGs."""
    root = tmp_path_factory.mktemp('instblink')
    pib.fabricate(str(root / 'npy'), 2, np.random.RandomState(0), 'train')
    pib.fabricate(str(root / 'npy'), 2, np.random.RandomState(1000), 'test')
    png_copy(str(root / 'npy'), str(root / 'png'),
             ['train.json', 'test.json'])
    yield {k: str(root / k) for k in ('npy', 'png')}
    shutil.rmtree(root)


def instblink_cfg(root, split, **kw):
    return InstBlinkDataConfig(
        ann_file=f'{root}/{split}.json', img_prefix=f'{root}/rawframes/',
        clip_length=5, scale=(128, 96), canvas=(96, 128), max_instances=2,
        **kw)


def test_instblink_train_batches_match_cv2_path(instblink_data):
    def batches(root):
        ds = InstBlinkClipDataset(instblink_cfg(root, 'train', batch_size=4),
                                  seed=0)
        stream = ds.batches(seed=0)
        return [next(stream) for _ in range(2)]
    with nf.npy_frames():
        got = batches(instblink_data['npy'])
    ref = batches(instblink_data['png'])
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == 'imgs':
                assert np.abs(g[k] - r[k]).max() <= NORM_LEVEL
            else:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_instblink_eval_windows_match_cv2_path(instblink_data):
    dc_kw = dict(flip_ratio=0.0, keep_ratio=False)
    ec = InstBlinkEvalConfig(clip_length=5, overlap=2, max_per_img=4)
    videos = load_json(osp.join(instblink_data['png'], 'test.json'))[
        'videos']
    for video in videos:
        outs = []
        for root, stand_in in ((instblink_data['npy'], True),
                               (instblink_data['png'], False)):
            ev = InstBlinkVideoEvaluator(
                None, ec, data_cfg=instblink_cfg(root, 'test', **dc_kw))
            ev._native = False
            paths = [f'{root}/rawframes/' + (n[:-4] + '.npy' if stand_in
                                             else n)
                     for n in video['file_names']]
            with nf.npy_frames() if stand_in else contextlib.nullcontext():
                outs.append(ev._decode_video(paths))
        (got, ref) = outs
        assert np.abs(got[0] - ref[0]).max() <= NORM_LEVEL
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------- the chains

def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_crop_sensitivity_chain_on_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = pcs.main(['--work', str(tmp_path), '--iters', '2',
                        '--videos', '2', '--frames', '12',
                        '--device', 'cpu'])
    line = last_json(buf.getvalue())
    assert set(line) == {'fixed_mae', 'reference_mae_mean',
                         'reference_seeds', 'delta_deg'}
    values = [line['fixed_mae'], line['reference_mae_mean'],
              line['delta_deg'], *line['reference_seeds']]
    assert len(line['reference_seeds']) == 2
    assert np.isfinite(values).all(), line
    assert len(out['train']['history']) == 2
    for ev in out['evals'].values():
        assert ev['evaluator'].decoder == nf.NPY_DECODE
    shutil.rmtree(tmp_path)


def test_instblink_burnin_chain_on_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = pib.main(['--root', str(tmp_path), '--iters', '2',
                        '--train-videos', '2', '--test-videos', '2',
                        '--device', 'cpu'])
    text = buf.getvalue()
    line = last_json(text)
    assert set(line) == {'1', '2'}
    for scores in line.values():
        assert set(scores) == {'track_mAP', 'track_AP50', 'track_AP75',
                               'blink_ap'}
        assert np.isfinite(list(scores.values())).all(), line
    for step in (1, 2):
        assert any(ln.startswith(f'[burnin] iter {step}: track mAP')
                   and 'blink action AP' in ln for ln in text.splitlines())
    assert len(out['train']['history']) == 2
    shutil.rmtree(tmp_path)


def test_tools_refuse_cuda_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    for main, flag in ((pcs.main, '--work'), (pib.main, '--root')):
        with pytest.raises(RuntimeError, match='cuda'):
            main([flag, str(tmp_path / 'w'), '--device', 'cuda'])
    assert not (tmp_path / 'w').exists()
