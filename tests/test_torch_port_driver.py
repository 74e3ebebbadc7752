"""The port's VideoGazeEvaluator against the JAX driver, and the MAE scorer.

Same small model and weights on both sides (tests/test_torch_port_model.py
::random_variables), the fabricated 18-frame video of
tests/test_data_and_driver.py (48x64 RGB, crop 0.84, 32 px canvas,
clip_batch 2, dedup on: clips at 0, 4, 8, 11 in two pow2 chunks). Results
agree at 1e-3 (the model parity tolerance; boxes are rescaled by ~1.7 to
the cropped frame). The scorer is a copy and must agree exactly.
"""
import os.path as osp

import numpy as np
import pytest

from mcgaze_tpu.evaluation import driver as jdriver
from mcgaze_tpu.evaluation.forward import bind_forward as jbind
from mcgaze_tpu.evaluation.forward import make_eval_forward as jmake
from mcgaze_tpu.evaluation.mae import gaze_error as jgaze_error
from mcgaze_tpu.models.mcgaze import ModelConfig as JModelConfig
from mcgaze_tpu_torch.evaluation.driver import EvalConfig, VideoGazeEvaluator
from mcgaze_tpu_torch.evaluation.forward import bind_forward, \
    make_eval_forward
from mcgaze_tpu_torch.evaluation.mae import evaluate_results, gaze_error
from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, ModelConfig
from mcgaze_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.test_torch_port_model import SMALL, random_variables, \
    to_numpy_tree
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

W, H, CANVAS = 64, 48, (32, 32)
BASE = dict(scale=CANVAS, canvas=CANVAS, crop_ratio=0.84, clip_batch=2)


def frames_of(seed, n=18):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (H, W, 3), np.uint8) for _ in range(n)]


@pytest.fixture(scope='module')
def forwards():
    """(JAX forward_fn, port forward_fn) over the same weights."""
    _m, init, fwd, fwd_dedup = jmake(JModelConfig(**SMALL), canvas=CANVAS)
    variables = random_variables(to_numpy_tree(init), seed=21)
    port = MCGazeModel(ModelConfig(**SMALL))
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    _, pfwd, pfwd_dedup = make_eval_forward(port.cfg, model=port.eval())
    return (jbind(fwd, variables, fwd_dedup),
            bind_forward(pfwd, 'cpu', pfwd_dedup))


@pytest.fixture(scope='module')
def results(forwards):
    jfwd, pfwd = forwards
    frames = frames_of(3)
    ref = jdriver.VideoGazeEvaluator(
        jfwd, jdriver.EvalConfig(**BASE)).run_video(frames, 1)
    ours = VideoGazeEvaluator(pfwd, EvalConfig(**BASE)).run_video(frames, 1)
    return ref, ours


def test_run_video_matches_jax_driver(results):
    ref, ours = results
    assert ours.keys() == ref.keys()
    assert ours['video_id'] == ref['video_id'] == 1
    np.testing.assert_allclose(ours['fusion_gazes'], ref['fusion_gazes'],
                               atol=1e-3)
    for clue in ('face', 'eyes', 'head'):
        np.testing.assert_allclose(ours[f'{clue}_gazes'],
                                   ref[f'{clue}_gazes'], atol=1e-3)
        np.testing.assert_allclose(ours[f'{clue}_score'],
                                   ref[f'{clue}_score'], atol=1e-3)
        for a, b in zip(ours[f'{clue}_bboxes'], ref[f'{clue}_bboxes']):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    # the stitched result is not degenerate: some boxes survive
    assert any(b is not None for c in ('face', 'eyes', 'head')
               for b in ours[f'{c}_bboxes'])


@pytest.mark.parametrize('opts', [dict(ship_uint8=False),
                                  dict(crop_mode='reference', crop_seed=3)])
def test_eval_options_match_jax_driver(forwards, opts):
    """Host-normalised f32 frames, and the seeded per-frame reference crop,
    give the JAX driver's results too."""
    jfwd, pfwd = forwards
    frames = frames_of(5, n=11)
    cfg = dict(BASE, **opts)
    ref = jdriver.VideoGazeEvaluator(
        jfwd, jdriver.EvalConfig(**cfg)).run_video(frames, 4)
    ours = VideoGazeEvaluator(pfwd, EvalConfig(**cfg)).run_video(frames, 4)
    np.testing.assert_allclose(ours['fusion_gazes'], ref['fusion_gazes'],
                               atol=1e-3)
    for clue in ('face', 'eyes', 'head'):
        np.testing.assert_allclose(ours[f'{clue}_score'],
                                   ref[f'{clue}_score'], atol=1e-3)


def test_dedup_matches_plain_clips(forwards):
    _, pfwd = forwards
    frames = frames_of(4)
    a = VideoGazeEvaluator(pfwd, EvalConfig(dedup_frames=False, **BASE)
                           ).run_video(frames, 2)
    b = VideoGazeEvaluator(pfwd, EvalConfig(dedup_frames=True, **BASE)
                           ).run_video(frames, 2)
    np.testing.assert_allclose(a['fusion_gazes'], b['fusion_gazes'],
                               atol=1e-5)
    for clue in ('face', 'eyes', 'head'):
        np.testing.assert_allclose(a[f'{clue}_score'], b[f'{clue}_score'],
                                   atol=1e-5)


def test_mae_scorer_matches(results):
    """The copied scorer gives the JAX scorer's numbers on the same
    results, and the two drivers' results score within 0.1 degree."""
    ref, ours = results
    rng = np.random.RandomState(5)
    gt = rng.randn(18, 3)
    gt[:, 2] = -np.abs(gt[:, 2])                 # mostly frontal
    anno = dict(annotations=[dict(gaze=gt.tolist())])
    for l2cs in (False, True):
        a = dict(annotations=anno['annotations'] * 3) if l2cs else anno
        assert gaze_error([ours], a, l2cs=l2cs) == jgaze_error(
            [ours], a, l2cs=l2cs)
    ma, mb = gaze_error([ours], anno), jgaze_error([ref], anno)
    for k in ('mae360', 'front90', 'front20'):
        assert abs(ma[k] - mb[k]) < 0.1, (k, ma[k], mb[k])
    assert evaluate_results([ours], anno)['frames'] == 18.0


def test_pipelined_paths_match_serial(forwards, tmp_path):
    """run_videos_from_paths (cv2 decode in the prefetch thread) yields
    the serial results in input order, and a decode error reaches the
    caller."""
    import cv2
    _, pfwd = forwards
    videos = []
    for vid in (7, 8):
        paths = []
        for i, fr in enumerate(frames_of(vid, n=9)):
            p = str(tmp_path / f'{vid}_{i:03d}.png')
            cv2.imwrite(p, cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            paths.append(p)
        videos.append((vid, paths))
    ev = VideoGazeEvaluator(pfwd, EvalConfig(**BASE))
    serial = [ev.run_video_from_paths(p, v) for v, p in videos]
    piped = list(ev.run_videos_from_paths(iter(videos)))
    assert [r['video_id'] for r in piped] == [7, 8]
    assert piped == serial
    bad = videos[1][1][:3] + [osp.join(str(tmp_path), 'missing.png')]
    with pytest.raises(FileNotFoundError):
        list(ev.run_videos_from_paths([videos[0], (9, bad)]))


def test_unchanged_size_needs_no_resize():
    """Frames already at the eval scale are copied, not resized (no cv2
    on that path), and match the JAX transform."""
    from mcgaze_tpu.data import transforms as JT
    from mcgaze_tpu_torch.data import transforms as PT
    img = np.random.RandomState(6).randint(0, 255, (32, 32, 3), np.uint8)
    out, sf = PT.resize_keep_ratio(img, (32, 32))
    assert out is not img and np.array_equal(out, img)
    ref, _, jsf = JT.resize_keep_ratio(img, (32, 32))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(sf, jsf)
