"""The port's ctypes binding to native/libmcgaze_loader.so against the
port's Python transforms, and the paths built on it: the eval driver's
native decode (u8 and f32) against the JAX driver's on the same files and
against the port's cv2 path, and the clip dataset's native batches against
its Python batches. Same OpenCV underneath, so the tolerance is that of
tests/test_native_loader.py and tests/test_native_dataset.py: 1e-5 on
normalised pixels, exact on u8 pixels, shapes and GT arrays. Skips only
where the library cannot be built.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from mcgaze_tpu_torch.data import transforms as T
from mcgaze_tpu_torch.data.native_loader import (NativeClipLoader,
                                                 native_available)
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')



@pytest.fixture(scope='module', autouse=True)
def native_built():
    """Build the library (make -C native) at the first test, not while the
    module is imported; skip where it cannot be built."""
    if not native_available():
        pytest.skip('native loader cannot be built')

TOL = 1e-5


@pytest.fixture(scope='module')
def frames_on_disk(tmp_path_factory):
    d = tmp_path_factory.mktemp('port_frames')
    rng = np.random.RandomState(7)
    paths, imgs = [], []
    for i, (h, w) in enumerate([(120, 90), (64, 200), (224, 224)]):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        p = str(d / f'{i}.png')
        cv2.imwrite(p, img)
        paths.append(p)
        imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    yield paths, imgs
    shutil.rmtree(d)


def python_u8(img, crop, flip, scale, canvas):
    """The u8 pixels the Python transforms give before normalising."""
    if crop is not None:
        img = T.center_crop(img, crop)
    img, _ = T.resize_keep_ratio(img, scale)
    if flip:
        img = img[:, ::-1]
    return T.pad_to_canvas(img, canvas), img.shape[:2]


@pytest.mark.parametrize('crop,flip', [(None, False), (0.8, False),
                                       (0.68, True)])
def test_loader_matches_python_transforms(frames_on_disk, crop, flip):
    paths, imgs = frames_on_disk
    scale, canvas = (224, 224), (224, 224)
    loader = NativeClipLoader(n_threads=2)
    assert loader.has_u8 and loader.has_warp
    out, meta = loader.load(paths, [crop] * 3, [flip] * 3, scale, canvas)
    out8, meta8 = loader.load_u8(paths, [crop] * 3, [flip] * 3, scale,
                                 canvas)
    np.testing.assert_array_equal(meta, meta8)
    for i, img in enumerate(imgs):
        ref = T.process_frame(img, T.ClipParams(crop, flip), scale, canvas)
        np.testing.assert_allclose(out[i], ref['img'], rtol=0, atol=TOL)
        px, hw = python_u8(img, crop, flip, scale, canvas)
        np.testing.assert_array_equal(out8[i], px)
        assert tuple(meta[i, 4:]) == ref['img_shape'] == hw
        assert tuple(meta[i, :2]) == img.shape[:2]
        if crop is not None:
            ch, cw, _, _ = T.crop_offsets(*img.shape[:2], crop)
            assert tuple(meta[i, 2:4]) == (ch, cw)


def test_loader_missing_file_names_the_path(frames_on_disk):
    paths, _ = frames_on_disk
    loader = NativeClipLoader(n_threads=2)
    bad = '/nonexistent/x.png'
    for load in (loader.load, loader.load_u8):
        with pytest.raises(FileNotFoundError, match=bad):
            load([paths[0], bad], None, None, (224, 224), (224, 224))


def test_loader_large_batch_into_caller_buffer(frames_on_disk):
    paths, imgs = frames_on_disk
    loader = NativeClipLoader(n_threads=8)
    buf = np.full((60, 224, 224, 3), 255, np.uint8)
    out, meta = loader.load_u8(paths * 20, None, None, (224, 224),
                               (224, 224), out=buf)
    assert out is buf and meta.shape == (60, 6)
    for i in (0, 31, 45, 59):
        px, _ = python_u8(imgs[i % 3], None, False, (224, 224), (224, 224))
        np.testing.assert_array_equal(out[i], px)
    with pytest.raises(ValueError, match='C-contiguous'):
        loader.load(paths, None, None, (224, 224), (224, 224),
                    out=np.empty((3, 224, 224, 3), np.uint8))


def test_loader_exact_warp(frames_on_disk):
    """keep_ratio=False resizes to the target exactly (the JAX loader's
    negative-scale encoding)."""
    paths, imgs = frames_on_disk
    out, meta = NativeClipLoader(n_threads=2).load_u8(
        paths, None, None, (80, 48), (64, 96), keep_ratio=False)
    assert (meta[:, 4:] == [48, 80]).all()
    for i, img in enumerate(imgs):
        ref = cv2.resize(img, (80, 48), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(out[i, :48, :80], ref)
        assert not out[i, 48:].any() and not out[i, :, 80:].any()


def _u8_forward():
    """A forward_fn that declares it normalises u8 (so the driver ships
    raw frames); decode tests never call it."""
    def forward(imgs, whwh, t):
        raise AssertionError('not called')
    forward.accepts_uint8 = True
    return forward


@pytest.mark.parametrize('ship_uint8,crop', [(True, 0.84), (False, 0.84),
                                             (True, None)])
def test_driver_native_decode_matches_jax_and_cv2(frames_on_disk, ship_uint8,
                                                  crop):
    from mcgaze_tpu.evaluation import driver as jdriver
    from mcgaze_tpu_torch.evaluation.driver import EvalConfig, \
        VideoGazeEvaluator
    paths, _ = frames_on_disk
    paths = paths[:2] * 3
    kw = dict(scale=(96, 96), canvas=(96, 96), crop_ratio=crop,
              ship_uint8=ship_uint8)
    ours = VideoGazeEvaluator(_u8_forward(), EvalConfig(**kw))
    got = ours._decode_video(paths, 3)
    assert ours.decoder == 'native'
    ref = jdriver.VideoGazeEvaluator(
        _u8_forward(), jdriver.EvalConfig(**kw))._decode_video(paths, 3)
    assert got[0].dtype == (np.uint8 if ship_uint8 else np.float32)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)

    # the cv2 fallback: normalised f32 frames, same geometry
    cv = VideoGazeEvaluator(_u8_forward(), EvalConfig(**kw))
    cv._native = False
    imgs, whwh, sfs, f = cv._decode_video(paths, 3)
    assert cv.decoder == 'cv2' and f == got[3] == 6
    np.testing.assert_array_equal(whwh, got[1])
    np.testing.assert_allclose(sfs, got[2], rtol=1e-6)
    if ship_uint8:
        from mcgaze_tpu_torch.evaluation.forward import device_normalize
        native = device_normalize(torch.from_numpy(got[0]),
                                  torch.from_numpy(got[1])).numpy()
    else:
        native = got[0]
    np.testing.assert_allclose(native, imgs, rtol=0, atol=TOL)


@pytest.fixture(scope='module')
def data_cfg(tmp_path_factory):
    from mcgaze_tpu_torch.data.dataset import DataConfig
    from tests.test_data_and_driver import make_dataset
    root = tmp_path_factory.mktemp('port_native')
    ann, prefix = make_dataset(str(root))
    yield DataConfig(ann_file=ann, img_prefix=prefix, clip_length=7,
                     scale=(32, 32), canvas=(32, 32), crop_size=0.68,
                     flip_ratio=0.5, batch_size=2)
    shutil.rmtree(root)


def test_dataset_native_batches_match_python(data_cfg):
    from mcgaze_tpu_torch.data.dataset import Gaze360ClipDataset
    cfg = dataclasses.replace(data_cfg, ship_uint8=False)
    native = Gaze360ClipDataset(cfg, seed=3, use_native=True)
    python = Gaze360ClipDataset(cfg, seed=3, use_native=False)
    assert native._native is not None and python._native is None
    it_n, it_p = native.batches(seed=5), python.batches(seed=5)
    flips = 0
    for _ in range(3):
        bn, bp = next(it_n), next(it_p)
        assert sorted(bn) == sorted(bp)
        assert bn['imgs'].dtype == np.float32
        for k in bp:
            np.testing.assert_allclose(bn[k], bp[k], rtol=0, atol=TOL,
                                       err_msg=k)
        flips += int((bp['gt_gazes'][..., 0] != 0).any())
    assert flips


def test_dataset_u8_batches_match_f32(data_cfg):
    """DataConfig.ship_uint8: u8 batches whose GT arrays equal the f32
    batch's and whose frames, normalised as the train step does, equal
    its frames."""
    from mcgaze_tpu_torch.data.dataset import Gaze360ClipDataset
    from mcgaze_tpu_torch.evaluation.forward import device_normalize
    a = next(Gaze360ClipDataset(dataclasses.replace(
        data_cfg, ship_uint8=False), seed=3).batches(seed=9))
    b = next(Gaze360ClipDataset(dataclasses.replace(
        data_cfg, ship_uint8=True), seed=3).batches(seed=9))
    assert b['imgs'].dtype == np.uint8
    for k in ('img_whwh', 'gt_boxes', 'gt_valid', 'gt_gazes'):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bs, t = b['imgs'].shape[:2]
    norm = device_normalize(
        torch.from_numpy(b['imgs'].reshape(bs * t, 32, 32, 3)),
        torch.from_numpy(b['img_whwh'].reshape(bs * t, 4)))
    np.testing.assert_allclose(norm.numpy(),
                               a['imgs'].reshape(bs * t, 32, 32, 3),
                               rtol=0, atol=TOL)


def test_dataset_requires_native_when_asked(data_cfg, monkeypatch):
    from mcgaze_tpu_torch.data import dataset, native_loader
    monkeypatch.setattr(native_loader, 'native_available', lambda: False)
    with pytest.raises(RuntimeError, match='make -C'):
        dataset.Gaze360ClipDataset(data_cfg, use_native=True)
    assert dataset.Gaze360ClipDataset(data_cfg)._native is None
