"""The port's head-detection demo against the JAX package's.

* The helpers (read_labels, group_segments, square_crop, draw_gaze) give
  exactly what demo/gaze_demo.py's give on the cases of tests/test_demo.py.
* End to end with OpenCV: a fabricated 12-frame mp4 goes through the
  port's head_det.main (YOLOv5m at 96 px, a seeded yolov5-named state
  dict, --device cpu); its labels equal the JAX HeadDetector's on the same
  weights and decoded frames within 1e-3 px. Then gaze_demo.main on labels
  with fixed boxes (two persons) writes a 12-frame mp4, and each person's
  fused gazes equal the JAX VideoGazeEvaluator's on the same crops and the
  same .pth (R26, FFN 256, 4 stages, 32 px) at 1e-3.
* The two CLIs default to the card and refuse without one.
"""
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

import demo.gaze_demo as jdemo
from mcgaze_tpu_torch.demo import gaze_demo, head_det
from mcgaze_tpu_torch.models import yolov5 as py
from mcgaze_tpu_torch.models.mcgaze import init_model
from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
from mcgaze_tpu_torch.utils.config import load_config
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
L2CS = osp.join(REPO, 'configs', 'multiclue_gaze',
                'multiclue_gaze_r50_l2cs.py')
GAZE_OPTS = ['model.backbone_depth=26', 'model.ffn_channels=256',
             'eval_cfg.scale=32,32', 'eval_cfg.canvas=32,32',
             'eval_cfg.clip_batch=2']
IMG = 96
N_FRAMES = 12
FRAME_HW = (72, 96)
TOL = 1e-3


def test_read_labels_sorted_and_filtered(tmp_path):
    p = tmp_path / '0.txt'
    p.write_text('0 5 5 20 20\n1 50 10 80 40\n1 10 10 40 40\n')
    for path in (str(p), str(tmp_path / 'missing.txt')):
        assert gaze_demo.read_labels(path) == jdemo.read_labels(path)
    assert gaze_demo.read_labels(str(p)) == [[10, 10, 40, 40],
                                             [50, 10, 80, 40]]


def test_group_segments_constant_person_count():
    frame_boxes = [[[0, 0, 1, 1]], [[0, 0, 1, 1]],
                   [[0, 0, 1, 1], [5, 0, 6, 1]],
                   [[0, 0, 1, 1], [5, 0, 6, 1]], []]
    segs = gaze_demo.group_segments(frame_boxes)
    assert segs == jdemo.group_segments(frame_boxes)
    assert [len(s['frame_id']) for s in segs] == [2, 2, 1]


@pytest.mark.parametrize('box,margin', [((40, 40, 60, 60), 0.8),
                                        ((0, 0, 20, 20), 1.0),
                                        ((85, 90, 99, 99), 0.8)])
def test_square_crop_center_and_clamp(box, margin):
    img = np.arange(100 * 100 * 3, dtype=np.uint8).reshape(100, 100, 3)
    ours = gaze_demo.square_crop(img, box, margin)
    np.testing.assert_array_equal(ours, jdemo.square_crop(img, box, margin))
    assert ours.size


def test_draw_gaze_paints_the_same_pixels():
    pytest.importorskip('cv2')
    a = np.zeros((100, 100, 3), np.uint8)
    b = a.copy()
    gaze = np.asarray([0.3, -0.9, 0.1])
    gaze_demo.draw_gaze(a, (30, 30, 70, 70), gaze)
    jdemo.draw_gaze(b, (30, 30, 70, 70), gaze)
    assert a.sum() > 0
    np.testing.assert_array_equal(a, b)


def yolo_state_dict(seed=0):
    """A seeded yolov5m state dict under yolov5's names; the Detect biases
    spread the scores so some boxes pass the threshold."""
    model = py.YoloV5(py.YoloConfig(img_size=IMG))
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith('num_batches_tracked'):
            sd[k] = v
            continue
        shape = tuple(v.shape)
        if len(shape) == 4:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith(('bn.weight', 'running_var')):
            a = rng.rand(*shape) + 0.5
        elif k.startswith('model.24.'):
            a = rng.randn(*shape) * 1.5
        else:
            a = rng.randn(*shape) * 0.1
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


@pytest.fixture(scope='module')
def demo_run(tmp_path_factory):
    import cv2
    root = str(tmp_path_factory.mktemp('port_demo'))
    video = osp.join(root, 'in.mp4')
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*'mp4v'), 5,
                             FRAME_HW[::-1])
    rng = np.random.RandomState(0)
    for _ in range(N_FRAMES):
        writer.write(rng.randint(0, 255, (*FRAME_HW, 3), np.uint8))
    writer.release()
    weights = osp.join(root, 'yolo.pt')
    sd = yolo_state_dict()
    torch.save(sd, weights)
    work = osp.join(root, 'work')
    out = head_det.main([video, weights, '--out-dir', work, '--img-size',
                         str(IMG), '--batch', '4', '--conf-thres', '0.3',
                         '--save-conf', '--device', 'cpu'])
    yield dict(root=root, video=video, sd=sd, work=work, out=out)
    shutil.rmtree(root)


def test_head_det_matches_jax(demo_run):
    import cv2

    from mcgaze_tpu.models.yolov5 import HeadDetector as JHeadDetector
    from mcgaze_tpu.models.yolov5 import YoloConfig as JYoloConfig
    from mcgaze_tpu.models.yolov5 import convert_torch_yolo

    out, work = demo_run['out'], demo_run['work']
    assert out['frames'] == N_FRAMES
    cfg = JYoloConfig(img_size=IMG)
    detector = JHeadDetector(convert_torch_yolo(demo_run['sd'], cfg), cfg,
                             conf_thres=0.3)
    cap = cv2.VideoCapture(demo_run['video'])
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    ref = []
    for i in range(0, len(frames), 4):
        ref.extend(detector(frames[i:i + 4]))
    assert len(ref) == N_FRAMES and sum(len(d) for d in ref) > N_FRAMES
    for fid, (ours, theirs) in enumerate(zip(out['detections'], ref)):
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)
        # the label file holds the same boxes, %g-formatted
        with open(osp.join(work, 'labels', f'{fid}.txt')) as f:
            rows = [list(map(float, ln.split())) for ln in f]
        assert all(r[0] == 1 for r in rows)
        np.testing.assert_allclose(np.asarray(rows).reshape(-1, 6)[:, 1:],
                                   theirs, rtol=1e-5, atol=TOL)
        assert osp.isfile(osp.join(work, 'frames', f'{fid}.jpg'))


@pytest.fixture(scope='module')
def gaze_pth(tmp_path_factory):
    cfg = apply_overrides(load_config(L2CS), GAZE_OPTS)
    model = init_model(cfg.model, seed=7, device='cpu')
    path = str(tmp_path_factory.mktemp('port_demo_gaze') / 'gaze.pth')
    torch.save({'state_dict': model.state_dict()}, path)
    yield path
    shutil.rmtree(osp.dirname(path))


def test_gaze_demo_matches_jax(demo_run, gaze_pth, tmp_path):
    import cv2

    from mcgaze_tpu.evaluation.driver import VideoGazeEvaluator as JEval
    from mcgaze_tpu.utils.cfg_options import apply_overrides as japply
    from mcgaze_tpu.utils.config import load_config as jload
    from tools.test_gaze360_gaze import build_forward as jbuild

    work = str(tmp_path / 'work')
    os.makedirs(osp.join(work, 'labels'))
    os.symlink(osp.join(demo_run['work'], 'frames'),
               osp.join(work, 'frames'))
    boxes = [[8.0, 10.0, 40.0, 44.0], [50.0, 12.0, 86.0, 50.0]]
    for i in range(N_FRAMES):
        with open(osp.join(work, 'labels', f'{i}.txt'), 'w') as f:
            f.write(''.join(f'1 {b[0] + i} {b[1]} {b[2] + i} {b[3]}\n'
                            for b in boxes))
    video = str(tmp_path / 'new_video.mp4')
    out = gaze_demo.main(['--work', work, '--config', L2CS, '--checkpoint',
                          gaze_pth, '--out', video, '--device', 'cpu',
                          '--cfg-options', *GAZE_OPTS])
    cap = cv2.VideoCapture(video)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == N_FRAMES
    cap.release()
    (seg,) = out['segments']
    assert seg['frame_id'] == list(range(N_FRAMES))
    assert len(seg['gazes']) == 2

    cfg = japply(jload(L2CS), GAZE_OPTS)
    evaluator = JEval(jbuild(cfg, gaze_pth), cfg.eval_cfg)
    frames = [cv2.imread(osp.join(work, 'frames', f'{i}.jpg'))
              for i in range(N_FRAMES)]
    for person, ours in zip(seg['persons'], seg['gazes']):
        crops = [cv2.cvtColor(jdemo.square_crop(frames[fid], box),
                              cv2.COLOR_BGR2RGB)
                 for fid, box in zip(seg['frame_id'], person)]
        ref = np.asarray(evaluator.run_video(crops, video_id=0)[
            'fusion_gazes'])
        assert ours.shape == ref.shape == (N_FRAMES, 3)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    shutil.rmtree(tmp_path)


def test_demo_clis_refuse_cuda_without_card(demo_run, gaze_pth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    weights = osp.join(demo_run['root'], 'yolo.pt')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        head_det.main([demo_run['video'], weights, '--out-dir',
                       str(tmp_path / 'w')])
    assert not osp.exists(tmp_path / 'w')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gaze_demo.main(['--work', demo_run['work'], '--config', L2CS,
                        '--checkpoint', gaze_pth, '--cfg-options',
                        *GAZE_OPTS])
