"""The port's data prep (data/{gaze360,rtgene,mpeblink}_prepare.py and its
four CLIs) against the JAX package's, on fabricated raw releases.

Each case runs the JAX CLI (tools/..., in-process through its main() with
sys.argv set) and the port's CLI (main(argv)) on the same inputs into two
output roots. The annotation JSONs are equal (the Gaze360 ones but for
info.date_created, a clock reading) and every written frame decodes to
the same array, bit for bit. The fabricated releases are those of the
JAX package's own tests (tests/test_{gaze360,rtgene,mpeblink}_prepare.py):
Gaze360 frame lists with a frame gap, a person and a recording change, a
frame at another resolution and, for the l2cs setting, a metadata.mat
with undetectable faces; an RT-GENE tree with an unlabelled and an
undetected frame and precomputed detections; an MPEblink video release
with occluded frames and blink events.
"""
import json
import os
import os.path as osp
import runpy
import shutil
import sys

import numpy as np
import pytest

from mcgaze_tpu_torch.data import rtgene_prepare as PR
from mcgaze_tpu_torch.tools import gaze360_img_reorganize as preorganize
from mcgaze_tpu_torch.tools.dataset_converters import \
    mpeblink_build_raw_frames_dataset as pmpeblink
from mcgaze_tpu_torch.tools.dataset_converters.gaze360 import \
    generate_json_from_ori as pgenerate
from mcgaze_tpu_torch.tools.dataset_converters.rtgene import \
    convert as prtgene
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def run_jax_cli(rel_path, argv, monkeypatch):
    """The JAX package's CLI script, its main() under sys.argv = argv."""
    path = osp.join(REPO, rel_path)
    main = runpy.run_path(path, run_name='jax_cli')['main']
    monkeypatch.setattr(sys, 'argv', [path, *argv])
    return main()


def assert_frames_equal(ours, theirs):
    """The two trees hold the same .png files, decoding to equal arrays."""
    def pngs(root):
        return sorted(osp.relpath(osp.join(d, f), root)
                      for d, _, files in os.walk(root)
                      for f in files if f.endswith('.png'))
    names = pngs(theirs)
    assert names and pngs(ours) == names
    for rel in names:
        a = cv2.imread(osp.join(ours, rel), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(osp.join(theirs, rel), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and a.shape == b.shape, rel
        np.testing.assert_array_equal(a, b, err_msg=rel)


def load_json(path, drop_date=False):
    with open(path) as f:
        js = json.load(f)
    if drop_date:
        js['info'].pop('date_created')
    return js


# ----------------------------------------------------------------- Gaze360

# (recording, person, frame, (h, w), face detectable): a frame at another
# resolution (resized to its video's first), a frame gap, a person change,
# a recording change, and undetectable faces that split l2cs videos
GAZE360_FRAMES = [('rec_a', 1, 1, (6, 8), True), ('rec_a', 1, 2, (6, 8), True),
                  ('rec_a', 1, 3, (6, 10), False),
                  ('rec_a', 1, 4, (6, 8), True), ('rec_a', 1, 9, (6, 8), True),
                  ('rec_a', 2, 10, (8, 6), True),
                  ('rec_b', 2, 11, (8, 6), False),
                  ('rec_b', 2, 12, (8, 6), True)]


def fabricate_gaze360(root):
    import scipy.io as sio
    rng = np.random.RandomState(0)
    recordings = sorted({r for r, *_ in GAZE360_FRAMES})
    rows, meta = [], dict(recording=[], person_identity=[], frame=[],
                          person_face_bbox=[])
    for rec, person, frame, hw, detectable in GAZE360_FRAMES:
        rel = f'{rec}/head/{person:06d}/{frame:06d}.jpg'
        os.makedirs(osp.dirname(osp.join(root, 'imgs', rel)), exist_ok=True)
        cv2.imwrite(osp.join(root, 'imgs', rel),
                    rng.randint(0, 255, (*hw, 3), np.uint8))
        g = rng.randn(3)
        rows.append(f'{rel} {g[0]:.6f} {g[1]:.6f} {g[2]:.6f}\n')
        meta['recording'].append(recordings.index(rec))
        meta['person_identity'].append(person)
        meta['frame'].append(frame)
        meta['person_face_bbox'].append([1.0, 2.0, 5.0, 6.0] if detectable
                                        else [-1.0] * 4)
    with open(osp.join(root, 'train.txt'), 'w') as f:
        f.writelines(rows[::-1])             # the CLIs sort the lines
    names = np.empty((1, len(recordings)), dtype=object)
    names[0, :] = recordings
    sio.savemat(osp.join(root, 'metadata.mat'), dict(
        recordings=names, **{k: np.asarray(v) for k, v in meta.items()}))


@pytest.mark.parametrize('setting', ['gaze360', 'l2cs'])
def test_gaze360_reorganize_matches_jax(setting, tmp_path, monkeypatch):
    fabricate_gaze360(str(tmp_path))
    outs = {}
    for side in ('ours', 'jax'):
        argv = ['--imgs', str(tmp_path / 'imgs'), '--metadata',
                str(tmp_path / 'metadata.mat'), '--splits-dir',
                str(tmp_path), '--out', str(tmp_path / side), '--settings',
                setting, '--splits', 'train', '--workers', '2']
        if side == 'ours':
            data = preorganize.main(argv)[setting, 'train']
        else:
            run_jax_cli('tools/gaze360_img_reorganize.py', argv,
                        monkeypatch)
        outs[side] = str(tmp_path / side / setting)
    lengths = [v['length'] for v in data['videos']]
    assert lengths == ([4, 1, 1, 2] if setting == 'gaze360'
                       else [2, 1, 1, 1, 1])
    ann = osp.join('annotations', 'train.json')
    assert (load_json(osp.join(outs['ours'], ann), drop_date=True) ==
            load_json(osp.join(outs['jax'], ann), drop_date=True))
    assert_frames_equal(osp.join(outs['ours'], 'train_rawframes'),
                        osp.join(outs['jax'], 'train_rawframes'))
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize('setting', ['gaze360', 'l2cs'])
def test_gaze360_generate_json_matches_jax(setting, tmp_path, monkeypatch):
    fabricate_gaze360(str(tmp_path))
    paths = {}
    for side in ('ours', 'jax'):
        paths[side] = str(tmp_path / side / 'train.json')
        argv = ['--split-txt', str(tmp_path / 'train.txt'), '--imgs',
                str(tmp_path / 'imgs'), '--out', paths[side], '--setting',
                setting, '--metadata', str(tmp_path / 'metadata.mat')]
        if side == 'ours':
            data = pgenerate.main(argv)
        else:
            run_jax_cli('tools/dataset_converters/gaze360/'
                        'generate_json_from_ori.py', argv, monkeypatch)
    ours = load_json(paths['ours'], drop_date=True)
    assert ours == load_json(paths['jax'], drop_date=True)
    assert data['videos'] == ours['videos']
    assert not osp.exists(tmp_path / 'ours' / '1')      # writes no frame
    shutil.rmtree(tmp_path)


# ------------------------------------------------------------------ RT-GENE

def test_rtgene_helpers_match_jax(tmp_path):
    from mcgaze_tpu.data import rtgene_prepare as JR
    rng = np.random.RandomState(1)
    for phi, theta in rng.uniform(-1.2, 1.2, (20, 2)):
        assert PR.gaze_to_3d(phi, theta) == JR.gaze_to_3d(phi, theta)
    for _ in range(10):
        lm = rng.uniform(0, 112, (5, 2)).astype(np.float32)
        xyxy = sorted(rng.uniform(0, 112, 2)) + sorted(rng.uniform(0, 112, 2))
        xyxy = [xyxy[0], xyxy[2], xyxy[1], xyxy[3]]
        assert PR.eye_box_from_landmarks(lm) == JR.eye_box_from_landmarks(lm)
        assert PR.face_box_xywh(xyxy) == JR.face_box_xywh(xyxy)
    p = tmp_path / 'label_combined.txt'
    p.write_text('4, [0.042150, 0.146170], [0.300000, -0.250000]\n'
                 '\n7, [0.1, 0.2], [-0.700000, 0.100000]\nbad line\n')
    assert PR.parse_labels(str(p)) == JR.parse_labels(str(p))
    assert (PR.TRAIN_FOLDS, PR.TEST_FOLDS, PR.CATEGORIES) == (
        JR.TRAIN_FOLDS, JR.TEST_FOLDS, JR.CATEGORIES)


def test_rtgene_convert_matches_jax(tmp_path, monkeypatch):
    from tests.test_rtgene_prepare import _make_tree
    root = str(tmp_path / 'raw')
    dets = _make_tree(root, PR.TEST_FOLDS[1] + PR.TEST_FOLDS[2], 5,
                      np.random.RandomState(3))
    det_path = str(tmp_path / 'dets.json')
    with open(det_path, 'w') as f:
        json.dump(dets, f)
    for side in ('ours', 'jax'):
        argv = ['--root', root, '--out', str(tmp_path / side),
                '--detections', det_path, '--folds', 'test1', 'train3']
        if side == 'ours':
            stats = prtgene.main(argv)
        else:
            run_jax_cli('tools/dataset_converters/rtgene/convert.py', argv,
                        monkeypatch)
    assert {k: (s.videos, s.frames, s.skipped) for k, s in stats.items()} \
        == {'test1': (4, 12, 8), 'train3': (8, 24, 16)}
    for fold in ('test1', 'train3'):
        ann = osp.join('annotations', f'{fold}.json')
        assert (load_json(str(tmp_path / 'ours' / ann)) ==
                load_json(str(tmp_path / 'jax' / ann)))
    assert_frames_equal(str(tmp_path / 'ours'), str(tmp_path / 'jax'))
    try:
        import facenet_pytorch  # noqa: F401
    except ImportError:
        with pytest.raises(SystemExit, match='--detections'):
            prtgene.main(['--root', root, '--out', str(tmp_path / 'x')])
    shutil.rmtree(tmp_path)


# ----------------------------------------------------------------- MPEblink

def test_mpeblink_build_matches_jax(tmp_path, monkeypatch):
    from tests.test_mpeblink_prepare import make_release
    master = str(tmp_path / 'master')
    spec = make_release(master, np.random.RandomState(7))
    roots = {}
    for side in ('ours', 'jax'):
        roots[side] = str(tmp_path / side)
        shutil.copytree(master, roots[side])
        argv = ['--root', roots[side], '--workers', '3']
        if side == 'ours':
            stats = pmpeblink.main(argv)
        else:
            run_jax_cli('tools/dataset_converters/'
                        'mpeblink_build_raw_frames_dataset.py', argv,
                        monkeypatch)
    assert {k: (s.videos, s.annotations) for k, s in stats.items()} == {
        'train': (2, 4), 'test': (1, 2)}
    for split in spec:
        ann = osp.join('annotations', f'{split}.json')
        assert (load_json(osp.join(roots['ours'], ann)) ==
                load_json(osp.join(roots['jax'], ann)))
        assert_frames_equal(osp.join(roots['ours'], f'{split}_rawframes'),
                            osp.join(roots['jax'], f'{split}_rawframes'))
    with pytest.raises(SystemExit, match='no split dirs'):
        pmpeblink.main(['--root', str(tmp_path / 'empty')])

    # what it wrote drives the port's InstBlink dataset
    from mcgaze_tpu_torch.data.instblink_dataset import (
        InstBlinkClipDataset, InstBlinkDataConfig)
    ds = InstBlinkClipDataset(InstBlinkDataConfig(
        ann_file=osp.join(roots['ours'], 'annotations', 'train.json'),
        img_prefix=osp.join(roots['ours'], 'train_rawframes'),
        clip_length=3, max_instances=4, batch_size=2), seed=0)
    sample = ds.get_clip(0)
    assert sample['imgs'].shape[0] == 3 and np.isfinite(sample['imgs']).all()
    assert sample['inst_valid'].any() and not sample['gt_present'].all()
    shutil.rmtree(tmp_path)
