"""The port's InstBlink data, scorer, eval driver and eval CLI against the JAX
package's, on the CPU.

  * InstBlinkClipDataset on tests/test_instblink_data.py's fabricated
    MPEblink videos: every clip and the first batches equal, u8 exactly,
    f32 at 1e-5, for keep_ratio (with and without a real resize), the
    exact warp, ship_uint8, blink_sampled and a flip drawn per clip;
  * track_eval on tests/test_track_eval_oracle.py's cases: the same
    numbers (the same numpy arithmetic, so exactly);
  * InstBlinkVideoEvaluator.run_video on a 10-frame u8 video whose frames
    (60x90) stop short of the 64x96 canvas, through the batched forward
    (windows of 3 frames, overlap 1, 2 windows a launch, a lone last
    window): the same tracks in the same linked order, scores, boxes and
    blink probabilities at 1e-3 (boxes relative to their largest
    coordinate), on tests/test_torch_port_query.py's tiny model;
  * tools.test_instblink --eval --device cpu on a .pth of that model,
    against the JAX CLI path in-process (its main() would re-platform
    pytest): tracks at 1e-3 and the same printed AP lines; --eval-only
    prints them again.
"""
import contextlib
import dataclasses
import io
import json
import shutil

import numpy as np
import pytest
import torch

import jax

from mcgaze_tpu.data.instblink_dataset import \
    InstBlinkClipDataset as JDataset
from mcgaze_tpu.data.instblink_dataset import InstBlinkDataConfig as JData
from mcgaze_tpu.evaluation import track_eval as jte
from mcgaze_tpu.evaluation.forward import bind_query_forward as jbind
from mcgaze_tpu.evaluation.forward import make_query_eval_forward as jmake
from mcgaze_tpu.evaluation.instblink_driver import (
    InstBlinkEvalConfig as JEvalConfig)
from mcgaze_tpu.evaluation.instblink_driver import (
    InstBlinkVideoEvaluator as JEvaluator)
from mcgaze_tpu.models import query_detector as jq
from mcgaze_tpu_torch.data.instblink_dataset import (InstBlinkClipDataset,
                                                     InstBlinkDataConfig)
from mcgaze_tpu_torch.evaluation import track_eval as pte
from mcgaze_tpu_torch.evaluation.forward import (bind_query_forward,
                                                 make_query_eval_forward)
from mcgaze_tpu_torch.evaluation.instblink_driver import (
    InstBlinkEvalConfig, InstBlinkVideoEvaluator)
from mcgaze_tpu_torch.tools import test_instblink as pcli
from tests.test_instblink_data import tiny_mpeblink  # noqa: F401
from tests.test_torch_port_query import TINY, pair  # noqa: F401
from tests.test_track_eval_oracle import _make_case, _ours_maps
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

TOL = 1e-3


# ------------------------------------------------------------------ data

DATA_CASES = {
    'keep_ratio': dict(),
    'keep_ratio_resized': dict(scale=(96, 72), canvas=(96, 96)),
    'exact_warp_u8': dict(keep_ratio=False, scale=(80, 56), canvas=(64, 96),
                          ship_uint8=True),
    'blink_sampled_flip': dict(blink_sampled=True, flip_ratio=0.5),
}


@pytest.mark.parametrize('case', sorted(DATA_CASES))
def test_dataset_matches_jax(tiny_mpeblink, case):  # noqa: F811
    ann, prefix = tiny_mpeblink
    kw = dict(ann_file=ann, img_prefix=prefix, clip_length=5,
              scale=(64, 48), canvas=(64, 64), batch_size=2,
              max_instances=3, flip_ratio=0.0)
    kw.update(DATA_CASES[case])
    got_ds = InstBlinkClipDataset(InstBlinkDataConfig(**kw), seed=3)
    ref_ds = JDataset(JData(**kw), seed=3)
    assert got_ds.index == ref_ds.index
    clips = [(got_ds.get_clip(i), ref_ds.get_clip(i))
             for i in range(len(ref_ds))]
    batches = [(g, r) for g, r, _ in zip(got_ds.batches(seed=1),
                                         ref_ds.batches(seed=1), range(2))]
    for got, ref in clips + batches:
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            if got[k].dtype == np.float32:
                np.testing.assert_allclose(got[k], ref[k], atol=1e-5,
                                           rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------- scorer

@pytest.mark.parametrize('seed,cats,blinks', [
    (0, (1,), True), (1, (1, 2, 3), False), (2, (1,), True),
    (3, (1,), True)])
def test_track_eval_matches_jax(seed, cats, blinks):
    gt_anns, dt_anns, _, _ = _make_case(seed, cats=cats, with_blinks=blinks)
    gt_map, dt_map = _ours_maps(gt_anns, dt_anns)
    got = pte.evaluate_tracks(gt_map, dt_map)
    ref = jte.evaluate_tracks(gt_map, dt_map)
    assert got == ref
    if blinks:
        gt_ev = {a['id']: [tuple(e) for e in a['blinks']] for a in gt_anns}
        dt_ev = {a['id']: [tuple(e) for e in a['blinks_converted']]
                 for a in dt_anns}
        got = pte.mpeblink_blink_ap(gt_map, dt_map, gt_ev, dt_ev)
        ref = jte.mpeblink_blink_ap(gt_map, dt_map, gt_ev, dt_ev)
        assert got['track'] == ref['track']
        for thr in jte.IOU_THRS:
            np.testing.assert_array_equal(got[float(thr)], ref[float(thr)])
    probs = np.random.RandomState(seed).rand(30)
    assert pte.blinks_to_events(probs) == jte.blinks_to_events(probs)


# ---------------------------------------------------------------- driver

EVAL = dict(clip_length=3, overlap=1, max_per_img=TINY['max_per_img'],
            clip_batch=2)


def assert_tracks_close(got, ref):
    """Two result lists: the same tracks in the same order, categories and
    the None pattern equal, numbers at TOL; blink events equal where no
    probability lies within TOL of the threshold."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert (g['video_id'], g['category_id']) == (r['video_id'],
                                                     r['category_id'])
        assert abs(g['score'] - r['score']) <= TOL
        assert [b is None for b in g['bboxes']] == \
            [b is None for b in r['bboxes']]
        gb = np.asarray([b for b in g['bboxes'] if b is not None])
        rb = np.asarray([b for b in r['bboxes'] if b is not None])
        assert np.abs(gb - rb).max() <= TOL * max(np.abs(rb).max(), 1.0)
        np.testing.assert_allclose(g['blink_scores'], r['blink_scores'],
                                   atol=TOL, rtol=0)
        if np.abs(np.asarray(r['blink_scores']) - 0.5).min() > TOL:
            assert [e[:2] for e in g['blinks_converted']] == \
                [e[:2] for e in r['blinks_converted']]


def test_run_video_matches_jax(pair):  # noqa: F811
    jmodel, variables, port = pair
    rng = np.random.RandomState(7)
    f, h, w = 10, 60, 90
    frames = np.zeros((f, 64, 96, 3), np.uint8)
    frames[:, :h, :w] = rng.randint(0, 256, (f, h, w, 3))
    whwh = np.tile(np.asarray([[w, h, w, h]], np.float32), (f, 1))
    sfs = np.tile(np.asarray([[0.5, 0.4, 0.5, 0.4]], np.float32), (f, 1))

    ref_eval = JEvaluator(jbind(*jmake(jmodel, jq.QueryDetectorConfig(
        **TINY)), variables), JEvalConfig(**EVAL))
    ref = ref_eval.run_video(frames, whwh, sfs, video_id=3)
    evaluator = InstBlinkVideoEvaluator(bind_query_forward(
        *make_query_eval_forward(port, port.cfg), 'cpu'),
        InstBlinkEvalConfig(**EVAL))
    got = evaluator.run_video(frames, whwh, sfs, video_id=3)
    assert len(got) == TINY['max_per_img']
    assert_tracks_close(got, ref)
    # the pad of each frame reads as 0 after normalising: content beyond
    # whwh does not move the result
    noisy = frames.copy()
    noisy[:, h:] = 255
    noisy[:, :, w:] = 255
    assert_tracks_close(evaluator.run_video(noisy, whwh, sfs, 3), got)


def test_linking_matches_jax():
    """A forward whose top-k order permutes from window to window (numpy
    outputs, one window a call): both drivers re-identify the tracks by
    their overlap IoU and give the same results, exactly."""
    t, k, f = 5, 3, 12
    rng = np.random.RandomState(9)
    base = rng.rand(k, 4).astype(np.float32) * 40
    base[:, 2:] += base[:, :2] + 20

    def make_forward():
        def forward(imgs, whwh):
            perm = np.random.RandomState(forward.calls).permutation(k)
            forward.calls += 1
            n = len(imgs)
            return dict(scores=np.linspace(0.9, 0.5, k).astype(np.float32),
                        labels=np.zeros(k, np.int64),
                        boxes=np.broadcast_to(base[perm], (n, k, 4)).copy(),
                        blink=np.tile(perm / k, (n, 1)).astype(np.float32))
        forward.calls = 0
        return forward

    whwh = np.tile(np.asarray([[100.0, 100.0, 100.0, 100.0]], np.float32),
                   (f, 1))
    sfs = np.ones((f, 4), np.float32)
    frames = np.zeros((f, 8, 8, 3), np.float32)
    kw = dict(clip_length=t, overlap=2, max_per_img=k)
    got = InstBlinkVideoEvaluator(make_forward(), InstBlinkEvalConfig(
        **kw)).run_video(frames, whwh, sfs, 4)
    ref = JEvaluator(make_forward(), JEvalConfig(**kw)).run_video(
        frames, whwh, sfs, 4)
    assert got == ref
    for r in got:
        xs = [b[0] for b in r['bboxes']]
        assert np.allclose(xs, xs[0])


# ------------------------------------------------------------------- CLI

CLI_CFG = '''
from mcgaze_tpu.data.instblink_dataset import InstBlinkDataConfig
from mcgaze_tpu.evaluation.instblink_driver import InstBlinkEvalConfig
from mcgaze_tpu.models.query_detector import QueryDetectorConfig
from mcgaze_tpu.train.loop import OptimConfig

model = QueryDetectorConfig(**{model!r})
optim = OptimConfig(lr=1e-4, max_iters=2, warmup_iters=1, lr_steps=(2,))
data_test = InstBlinkDataConfig(
    ann_file={ann!r}, img_prefix={prefix!r}, clip_length=3,
    scale=(64, 48), canvas=(64, 64), max_instances=3, flip_ratio=0.0,
    keep_ratio=False)
eval_cfg = InstBlinkEvalConfig(clip_length=3, overlap=1, max_per_img=4,
                               clip_batch=2)
'''


def _ap_lines(text):
    return [ln for ln in text.splitlines()
            if 'track mAP' in ln or 'blink action' in ln]


def test_cli_matches_jax_cli_path(pair, tiny_mpeblink, tmp_path):  # noqa: F811
    from mcgaze_tpu.utils.query_config import load_query_config as jload
    from mcgaze_tpu.utils.torch_convert import convert_query_torch_checkpoint
    from tools.test_instblink import score_results as jscore

    _, _, port = pair
    ann, prefix = tiny_mpeblink
    cfg_path = tmp_path / 'tiny_instblink.py'
    cfg_path.write_text(CLI_CFG.format(model=TINY, ann=ann, prefix=prefix))
    ckpt = str(tmp_path / 'ckpt_1.pth')
    torch.save({'state_dict': port.state_dict(), 'meta': {'step': 1}}, ckpt)
    out_json = str(tmp_path / 'results.json')

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = pcli.main([str(cfg_path), ckpt, '--out', out_json, '--eval',
                         '--device', 'cpu'])
    got_lines = _ap_lines(buf.getvalue())
    assert len(got_lines) == 2, buf.getvalue()
    assert out['evaluator'].decoder in ('native', 'cv2')
    assert out['frames'] == 24 and out['metrics']['mAP'] >= 0.0
    with open(out_json) as f:
        assert json.load(f) == json.loads(json.dumps(out['results']))

    # the JAX CLI's steps on the same files
    cfg = jload(str(cfg_path))
    model, variables = jq.init_query_model(cfg.model, jax.random.PRNGKey(0),
                                           image_size=cfg.data_test.canvas)
    with pytest.warns(UserWarning, match='blink'):
        variables = convert_query_torch_checkpoint(
            ckpt, variables, num_stages=cfg.model.num_stages)
    ds = JDataset(cfg.data_test)
    evaluator = JEvaluator(jbind(*jmake(model, cfg.model), variables),
                           cfg.eval_cfg, data_cfg=cfg.data_test)
    vids = ds.api.get_vid_ids()
    ref = [t for tracks in evaluator.run_videos_from_paths(
        (v, ds.video_paths(v)) for v in vids) for t in tracks]
    assert_tracks_close(out['results'], ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jscore(ref, ds.api, True)
    assert got_lines == _ap_lines(buf.getvalue())

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        again = pcli.main([str(cfg_path), '--eval-only', out_json])
    assert _ap_lines(buf.getvalue()) == got_lines
    assert again['metrics'] == out['metrics']
    shutil.rmtree(tmp_path)


def test_decoders_agree(tiny_mpeblink):  # noqa: F811
    """The native loader and the cv2 path give the evaluator the same
    frames (u8 and normalised f32), whwh and scale factors, for the exact
    warp and keep_ratio."""
    ann, prefix = tiny_mpeblink
    ds = InstBlinkClipDataset(InstBlinkDataConfig(ann_file=ann,
                                                  img_prefix=prefix))
    paths = ds.video_paths(1)[:4]

    def forward(imgs, whwh):
        raise AssertionError('decode only')

    forward.accepts_uint8 = True
    for keep_ratio, scale in ((False, (80, 56)), (True, (96, 72))):
        dc = InstBlinkDataConfig(scale=scale, canvas=(96, 96),
                                 keep_ratio=keep_ratio)
        for u8 in (True, False):
            outs = {}
            for native in (None, False):
                ev = InstBlinkVideoEvaluator(
                    forward, InstBlinkEvalConfig(ship_uint8=u8), data_cfg=dc)
                ev._native = native
                decoded = ev._decode_video(paths)
                outs[ev.decoder] = decoded
            if 'native' not in outs:
                pytest.skip('the native loader cannot be built here')
            for a, b in zip(outs['native'], outs['cv2']):
                assert a.dtype == b.dtype
                np.testing.assert_allclose(a, b, atol=1e-5)
            assert outs['cv2'][0].dtype == (np.uint8 if u8 else np.float32)


def test_eval_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(InstBlinkEvalConfig)] == \
        [f.name for f in dataclasses.fields(JEvalConfig)]
    assert dataclasses.asdict(InstBlinkEvalConfig()) == \
        dataclasses.asdict(JEvalConfig())
    assert dataclasses.asdict(InstBlinkDataConfig()) == \
        dataclasses.asdict(JData())
