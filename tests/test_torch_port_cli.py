"""The port's eval CLIs and scorers against the JAX package's.

One reference-named .pth is written from a seeded port model (R26, FFN
256, 4 stages: the JAX build_forward converts a .pth with its default of
four stages). The shipped gaze360 and l2cs configs are cut to that model
and a 64 px canvas with --cfg-options. Two fabricated videos (12 and 9
frames of 72x96 px, written with cv2; clip batch 2, so one chunk is
padded and the second video ends in a ragged clip) go through the port's
`test_gaze360_gaze.main` and `test.main` with --device cpu, and through
the JAX `build_forward` + `VideoGazeEvaluator.run_videos_from_paths`
in-process (the JAX `main()` would re-platform pytest). Results agree at
1e-3, the model parity tolerance: boxes relative to their largest
coordinate, scores and gazes absolutely; the None pattern of the boxes
where the JAX score lies further than that from the 0.5 threshold. Both
packages decode with the native loader here.

The scorer CLIs of the two packages print byte-identical lines on one
results file; the port's on-device scorer (on the CPU) agrees with the
numpy scorer and the JAX device scorer within 1e-3 deg with exact frame
counts. --ema evaluates exactly the EMA weights the train CLI wrote.
"""
import dataclasses
import json
import os
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from mcgaze_tpu_torch.evaluation.driver import VideoGazeEvaluator
from mcgaze_tpu_torch.evaluation.forward import (bind_forward,
                                                 make_eval_forward)
from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, init_model
from mcgaze_tpu_torch.tools import calculate_mae_gaze360 as pscore
from mcgaze_tpu_torch.tools import calculate_mae_l2cs as pscore_l2cs
from mcgaze_tpu_torch.tools import test as ptest
from mcgaze_tpu_torch.tools import test_gaze360_gaze as pcli
from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
from mcgaze_tpu_torch.utils.config import load_config
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CFG_DIR = osp.join(REPO, 'configs', 'multiclue_gaze')
CONFIGS = dict(gaze360=osp.join(CFG_DIR, 'multiclue_gaze_r50_gaze360.py'),
               l2cs=osp.join(CFG_DIR, 'multiclue_gaze_r50_l2cs.py'))
OPTS = ['model.backbone_depth=26', 'model.ffn_channels=256',
        'eval_cfg.scale=64,64', 'eval_cfg.canvas=64,64']
LENGTHS = (12, 9)
FRAME_HW = (72, 96)
TOL = 1e-3
SCORE_TOL_DEG = 0.1      # MAE of the two packages' results (gazes at 1e-3)


def frontal_track(rng, n):
    g = rng.randn(n, 3) * 0.4
    g[:, 2] = -np.abs(g[:, 2]) - 0.8
    return (g / np.linalg.norm(g, axis=1, keepdims=True)).tolist()


@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    """The fabricated rawframes, the two annotation layouts and the .pth."""
    root = str(tmp_path_factory.mktemp('port_cli'))
    rng = np.random.RandomState(0)
    videos, rows, rows3 = [], [], []
    for vid, n in zip((1, 2), LENGTHS):
        names = []
        for f in range(n):
            name = f'{vid:03d}/{f:05d}.png'
            os.makedirs(osp.join(root, 'frames', f'{vid:03d}'),
                        exist_ok=True)
            cv2.imwrite(osp.join(root, 'frames', name),
                        rng.randint(0, 255, (*FRAME_HW, 3), np.uint8))
            names.append(name)
        videos.append(dict(id=vid, width=FRAME_HW[1], height=FRAME_HW[0],
                           length=n, file_names=names))
        tracks = [frontal_track(rng, n) for _ in range(3)]
        rows.append(dict(video_id=vid, gaze=tracks[0]))
        rows3.extend(dict(video_id=vid, gaze=t) for t in tracks)
    anns = {}
    for layout, annotations in (('gaze360', rows), ('l2cs', rows3)):
        anns[layout] = osp.join(root, f'test_{layout}.json')
        with open(anns[layout], 'w') as f:
            json.dump(dict(videos=videos, annotations=annotations), f)

    # a seeded port model, its norms, biases and proposals spread; the
    # class biases lift face and head scores above the 0.5 threshold (their
    # boxes survive) and push the eyes' below it (theirs are None)
    cfg = apply_overrides(load_config(CONFIGS['gaze360']), OPTS)
    model = init_model(cfg.model, seed=7, device='cpu')
    gen = torch.Generator().manual_seed(8)
    cls_bias = dict(face=1.0, eyes=-1.0, head=1.0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('init_proposal_bboxes.weight'):
                p.copy_(torch.rand(p.shape, generator=gen) * 0.4 + 0.3)
            elif p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
            if name.endswith('_fc_cls.bias'):
                p.add_(cls_bias[name.split('.')[-2][:-len('_fc_cls')]])
    pth = osp.join(root, 'model.pth')
    torch.save({'state_dict': model.state_dict(), 'meta': {'step': 0}}, pth)
    yield dict(root=root, prefix=osp.join(root, 'frames') + '/', anns=anns,
               pth=pth, videos=videos)
    shutil.rmtree(root)     # the .pth, the EMA checkpoints and the results


def jax_results(ws, config):
    """The JAX CLI path in-process: its build_forward on the .pth and the
    pipelined driver (one device)."""
    from mcgaze_tpu.evaluation.driver import VideoGazeEvaluator as JEval
    from mcgaze_tpu.utils.cfg_options import apply_overrides as japply
    from mcgaze_tpu.utils.config import load_config as jload
    from tools.test_gaze360_gaze import build_forward as jbuild

    cfg = japply(jload(CONFIGS[config]), OPTS)
    ecfg = dataclasses.replace(cfg.eval_cfg, clip_batch=2)
    ev = JEval(jbuild(cfg, ws['pth']), ecfg)
    return list(ev.run_videos_from_paths(
        pcli.video_paths(ws['videos'], ws['prefix']),
        devices=jax.local_devices()[:1]))


def cli_args(ws, config, *extra):
    return [CONFIGS[config], ws['pth'], '--json', ws['anns'][config],
            '--root', ws['prefix'], '--clip-batch', '2', '--device', 'cpu',
            *extra, '--cfg-options', *OPTS]


@pytest.fixture(scope='module')
def runs(ws):
    """config -> (JAX results, port test_gaze360_gaze output, port
    tools.test output)."""
    out = {}
    for config in CONFIGS:
        ref = jax_results(ws, config)
        gaze = pcli.main(cli_args(ws, config, '--out-dir',
                                  osp.join(ws['root'], 'results')))
        extra = ['--eval', 'mae', '--out',
                 osp.join(ws['root'], f'inline_{config}.json')]
        if config == 'l2cs':
            extra.append('--l2cs')
        inline = ptest.main(cli_args(ws, config, *extra))
        out[config] = (ref, gaze, inline)
    return out


def assert_results_match(ours, ref):
    assert [r['video_id'] for r in ours] == [r['video_id'] for r in ref]
    compared = 0
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        assert len(a['fusion_gazes']) == len(b['fusion_gazes'])
        np.testing.assert_allclose(a['fusion_gazes'], b['fusion_gazes'],
                                   rtol=0, atol=TOL)
        for clue in ('face', 'eyes', 'head'):
            np.testing.assert_allclose(a[f'{clue}_gazes'],
                                       b[f'{clue}_gazes'], rtol=0, atol=TOL)
            np.testing.assert_allclose(a[f'{clue}_score'],
                                       b[f'{clue}_score'], rtol=0, atol=TOL)
            for x, y, s in zip(a[f'{clue}_bboxes'], b[f'{clue}_bboxes'],
                               b[f'{clue}_score']):
                if abs(s - 0.5) > TOL:
                    assert (x is None) == (y is None), (clue, x, y, s)
                if x is not None and y is not None:
                    scale = max(np.abs(y).max(), 1.0)
                    np.testing.assert_allclose(np.asarray(x) / scale,
                                               np.asarray(y) / scale,
                                               rtol=0, atol=TOL)
                    compared += 1
    assert compared, 'every box is None: the comparison tests nothing'
    assert any(x is None for r in ours for c in ('face', 'eyes', 'head')
               for x in r[f'{c}_bboxes']), 'no box below the threshold'


@pytest.mark.parametrize('config', list(CONFIGS))
def test_gaze360_cli_matches_jax(ws, runs, config):
    ref, gaze, _ = runs[config]
    assert gaze['evaluator'].decoder == 'native'
    base = osp.basename(ws['anns'][config])
    assert gaze['path'] == osp.join(
        ws['root'], 'results',
        f'results_{osp.basename(CONFIGS[config])[:-3]}_{base}')
    with open(gaze['path']) as f:
        written = json.load(f)
    assert written == gaze['results']
    assert gaze['frames'] == sum(LENGTHS)
    assert_results_match(written, ref)


@pytest.mark.parametrize('config', list(CONFIGS))
def test_test_cli_scores_inline(ws, runs, config, capsys):
    """tools.test writes the results of test_gaze360_gaze and prints
    evaluate_results of them; the scores of the two packages' results
    agree within SCORE_TOL_DEG."""
    from mcgaze_tpu.evaluation.mae import evaluate_results as jevaluate
    from mcgaze_tpu_torch.evaluation.mae import evaluate_results

    ref, gaze, inline = runs[config]
    l2cs = config == 'l2cs'
    with open(osp.join(ws['root'], f'inline_{config}.json')) as f:
        written = json.load(f)
    assert written == inline['results'] == gaze['results']
    with open(ws['anns'][config]) as f:
        anno = json.load(f)
    assert inline['metrics'] == evaluate_results(written, anno, l2cs=l2cs)
    theirs = jevaluate(ref, anno, l2cs=l2cs)
    assert inline['metrics']['frames'] == theirs['frames'] == sum(LENGTHS)
    for k in ('MAE-360', 'MAE-Front180', 'MAE-Front20'):
        assert abs(inline['metrics'][k] - theirs[k]) < SCORE_TOL_DEG, k


def run_jax_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', ['prog', *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize('extra', [[], ['--no-smooth']])
def test_gaze360_scorer_cli_byte_identical(ws, runs, extra, monkeypatch,
                                           capsys):
    import tools.calculate_mae_gaze360 as jscore
    argv = ['--evalfile', runs['gaze360'][1]['path'], '--anno',
            ws['anns']['gaze360'], *extra]
    theirs = run_jax_main(jscore, argv, monkeypatch, capsys)
    pscore.main(argv)
    ours = capsys.readouterr().out
    assert ours == theirs and ours.count('\n') == 3


def test_l2cs_scorer_cli_byte_identical(ws, runs, monkeypatch, capsys):
    import tools.calculate_mae_l2cs as jscore
    argv = ['--evalfile', runs['l2cs'][1]['path'], '--anno',
            ws['anns']['l2cs']]
    theirs = run_jax_main(jscore, argv, monkeypatch, capsys)
    pscore_l2cs.main(argv)
    ours = capsys.readouterr().out
    assert ours == theirs and ours.count('\n') == 3


def mae_cases():
    """The cases of tests/test_mae.py::test_device_scorer_matches_numpy:
    three videos (7, 1 and 12 frames) and the l2cs layout."""
    rng = np.random.RandomState(5)
    videos, annos = [], []
    for n in (7, 1, 12):
        gt = rng.randn(n, 3)
        gt /= np.linalg.norm(gt, axis=1, keepdims=True)
        pred = gt + rng.randn(n, 3) * 0.05
        pred /= np.linalg.norm(pred, axis=1, keepdims=True)
        videos.append({'fusion_gazes': pred.tolist()})
        annos.append({'gaze': gt.tolist()})
    annos3 = []
    for a in annos:
        annos3.extend([a, {'gaze': [[1, 0, 0]]}, {'gaze': [[0, 1, 0]]}])
    return videos, {'annotations': annos}, {'annotations': annos3}


@pytest.mark.parametrize('smooth,l2cs', [(True, False), (False, False),
                                         (True, True)])
def test_device_scorer_matches_numpy_and_jax(smooth, l2cs):
    from mcgaze_tpu.evaluation.mae_device import gaze_error_device as jdev
    from mcgaze_tpu_torch.evaluation.mae import gaze_error
    from mcgaze_tpu_torch.evaluation.mae_device import gaze_error_device

    videos, anno, anno3 = mae_cases()
    anno = anno3 if l2cs else anno
    ours = gaze_error_device(videos, anno, smooth=smooth, l2cs=l2cs,
                             device='cpu')
    for ref in (gaze_error(videos, anno, smooth=smooth, l2cs=l2cs),
                jdev(videos, anno, smooth=smooth, l2cs=l2cs)):
        assert ours['frames'] == ref['frames'] == 20
        for k in ('mae360', 'front90', 'front20'):
            assert ours[k] == pytest.approx(ref[k], abs=1e-3), k


def test_device_scorer_on_cli_results(ws, runs):
    """On the CLI's results (unit gazes, frontal GT): the device scorer
    within 1e-3 deg of the numpy one, and no video: zeros."""
    from mcgaze_tpu_torch.evaluation.mae import gaze_error
    from mcgaze_tpu_torch.evaluation.mae_device import gaze_error_device

    results = runs['gaze360'][1]['results']
    with open(ws['anns']['gaze360']) as f:
        anno = json.load(f)
    a = gaze_error(results, anno)
    b = gaze_error_device(results, anno, device='cpu')
    assert a['frames'] == b['frames'] == sum(LENGTHS)
    for k in ('mae360', 'front90', 'front20'):
        assert b[k] == pytest.approx(a[k], abs=1e-3), k
    assert gaze_error_device([], anno, device='cpu')['frames'] == 0


@pytest.fixture(scope='module')
def ema_ckpt(ws):
    """Two train-CLI steps with EMA (momentum 0.5) at the CLI test's
    model: (ckpt_2.pth, the parsed _train file)."""
    from mcgaze_tpu_torch.tools.train import main as train_main
    from mcgaze_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   train_path)
    work = osp.join(ws['root'], 'work_ema')
    out = train_main([CONFIGS['gaze360'], '--synthetic', '--device', 'cpu',
                      '--max-iters', '2', '--work-dir', work,
                      '--cfg-options', 'model.backbone_depth=26',
                      'model.ffn_channels=256', 'data_train.batch_size=1',
                      'data_train.canvas=32,32', 'optim.ema_momentum=0.5'])
    return out['checkpoint'], restore_checkpoint(train_path(
        out['checkpoint']))


def test_ema_evaluates_the_ema_weights(ws, ema_ckpt):
    from mcgaze_tpu_torch.utils.convert import clean_reference_state_dict
    ckpt, train = ema_ckpt
    args = [CONFIGS['gaze360'], ckpt, '--json', ws['anns']['gaze360'],
            '--root', ws['prefix'], '--clip-batch', '2', '--device', 'cpu',
            '--max-videos', '1', '--out-dir', osp.join(ws['root'], 'ema'),
            '--cfg-options', *OPTS]
    ema = pcli.main(args + ['--ema'])['results']
    raw = pcli.main(args)['results']

    cfg = apply_overrides(load_config(CONFIGS['gaze360']), OPTS)
    model = MCGazeModel(cfg.model)
    sd = clean_reference_state_dict(torch.load(ckpt)['state_dict'])
    assert set(train['ema']) == {n for n, _ in model.named_parameters()}
    sd.update(train['ema'])
    model.load_state_dict(sd, strict=True)
    _, fwd, fwd_dedup = make_eval_forward(cfg.model, model=model.eval())
    ev = VideoGazeEvaluator(bind_forward(fwd, 'cpu', fwd_dedup),
                            dataclasses.replace(cfg.eval_cfg, clip_batch=2))
    expected = list(ev.run_videos_from_paths(
        pcli.video_paths(ws['videos'][:1], ws['prefix'])))
    assert ema == expected
    assert not np.allclose(ema[0]['fusion_gazes'], raw[0]['fusion_gazes'])


def test_ema_refuses_without_ema_weights(ws, ema_ckpt, tmp_path):
    ckpt, train = ema_ckpt
    args = [CONFIGS['gaze360'], None, '--json', ws['anns']['gaze360'],
            '--root', ws['prefix'], '--device', 'cpu', '--ema',
            '--cfg-options', *OPTS]
    lone = str(tmp_path / 'ckpt_2.pth')            # no _train file
    shutil.copy(ckpt, lone)
    no_ema = str(tmp_path / 'noema' / 'ckpt_2.pth')
    os.makedirs(osp.dirname(no_ema))
    shutil.copy(ckpt, no_ema)
    torch.save(dict(train, ema=None), no_ema[:-4] + '_train.pth')
    for path in (lone, no_ema):
        args[1] = path
        with pytest.raises(SystemExit, match='ema_momentum > 0'):
            pcli.main(args)
    shutil.rmtree(tmp_path)


def test_cuda_device_refused_without_card(ws):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    args = cli_args(ws, 'gaze360')
    args[args.index('cpu')] = 'cuda'
    for main in (pcli.main, ptest.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pscore.main(['--evalfile', osp.join(ws['root'], 'x.json'),
                     '--anno', ws['anns']['gaze360'], '--device'])
