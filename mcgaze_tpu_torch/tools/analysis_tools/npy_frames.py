"""Frame I/O without OpenCV, for the analysis tools that fabricate their
own frames (crop_sensitivity.py, instblink_burnin.py, benchmark.py,
train_bench.py, serve_bench.py) and for chip_smoke.py.

A frame is an HxWx3 uint8 `.npy` file holding the array `cv2.imwrite`
would take: OpenCV's BGR channel order. `read_rgb` gives back what
`cv2.imread` + `cv2.cvtColor(BGR2RGB)` give for the PNG of the same array,
so a dataset written both ways reads the same.

`npy_frames()` is a context manager under which the port's frame readers
take these files and resize without cv2:
  * data/native_loader.py::NativeClipLoader refuses to build, so the gaze
    train dataset and both eval drivers take their Python paths;
  * data/dataset.py::Gaze360ClipDataset._load_image reads `.npy`;
  * data/transforms.py::resize_keep_ratio resizes with `resize_linear`;
  * data/instblink_dataset.py::read_rgb and warp_exact (the InstBlink eval
    driver imports them when it decodes, so it sees these too);
  * evaluation/driver.py::VideoGazeEvaluator._decode_video: its cv2
    branch with the read replaced; the crop, resize and pad around it are
    the driver's own.
On exit everything it replaced is restored, also after an exception.
Nothing of the port's main path changes: the stand-in exists only here.

`npy_request_images()` does the same for a served request's images:
evaluation/serving.py::decode_image_bytes reads a `.npy` array's bytes
(`npy_bytes`, an HxWx3 RGB uint8 frame) where it decodes JPEG/PNG with cv2.
`have_cv2()` says whether OpenCV is there. The tools that fabricate frames
write them with `write_image` (a PNG where it is, a `.npy` file where not)
and read them under `frame_readers()` (nothing where it is, `npy_frames()`
where not).

`resize_linear` is cv2.resize(INTER_LINEAR) on uint8 frames, written out
in numpy: half-pixel centres, no antialias, OpenCV's fixed-point weights
(11 bits per axis) and its rounding back to uint8; an exact 2x downscale
is OpenCV's area average, as cv2 switches to it there.
"""
from __future__ import annotations

import contextlib
import io
import os

import numpy as np

NPY_DECODE = 'npy stand-in (no OpenCV)'
NPY_IMAGE_DECODE = 'npy stand-in for decode_image_bytes (no OpenCV)'

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def have_cv2() -> bool:
    """Whether OpenCV can be imported here."""
    import importlib.util
    return importlib.util.find_spec('cv2') is not None


def write_frame(path: str, bgr: np.ndarray) -> None:
    """Write an HxWx3 uint8 frame (BGR, as cv2.imwrite takes it) to
    `path` (a .npy name), making its directory."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    bgr = np.asarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f'{path}: want HxWx3 uint8, got {bgr.dtype} '
                         f'{bgr.shape}')
    with open(path, 'wb') as f:
        np.save(f, np.ascontiguousarray(bgr))


def write_image(stem: str, bgr: np.ndarray) -> str:
    """A fabricated frame (BGR uint8) as `stem`.png through cv2 where
    OpenCV is installed, else as `stem`.npy. Returns the path."""
    if have_cv2():
        import cv2
        os.makedirs(os.path.dirname(stem) or '.', exist_ok=True)
        cv2.imwrite(stem + '.png', bgr)
        return stem + '.png'
    write_frame(stem + '.npy', bgr)
    return stem + '.npy'


def frame_readers():
    """The context `write_image`'s frames are read under: nothing where
    OpenCV is installed, else npy_frames()."""
    return contextlib.nullcontext() if have_cv2() else npy_frames()


def read_rgb(path: str) -> np.ndarray:
    """One .npy frame as HxWx3 RGB uint8 (cv2.imread + BGR2RGB of the same
    frame's PNG)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.ascontiguousarray(np.load(path)[..., ::-1])


def _taps(src: int, dst: int, clamp_weights: bool):
    """Source index pairs and fixed-point weights along one axis, as
    OpenCV's resize computes them for INTER_LINEAR. Along x a tap past the
    edge takes the edge pixel at full weight; along y it keeps its
    weights and reads the edge row twice (cv2 clamps only the row index)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp_weights:
        f[(s < 0) | (s >= src - 1)] = 0.0
    s0 = np.clip(s, 0, src - 1)
    a1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    a0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    return s0, np.clip(s + 1, 0, src - 1), a0, a1


def resize_linear(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR) for
    an HxWxC uint8 image."""
    if img.dtype != np.uint8:
        raise TypeError(f'resize_linear takes uint8 frames, got {img.dtype}')
    h, w = img.shape[:2]
    if (new_w, new_h) == (w, h):
        return img.copy()
    src = img.astype(np.int64)
    if (w, h) == (2 * new_w, 2 * new_h):
        # cv2 takes its area average for an exact halving of both sides
        s = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
             + src[1::2, 1::2])
        return ((s + 2) >> 2).astype(np.uint8)
    xs0, xs1, a0, a1 = _taps(w, new_w, clamp_weights=True)
    ys0, ys1, b0, b1 = _taps(h, new_h, clamp_weights=False)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    rows = src[:, xs0] * a0.reshape(shape) + src[:, xs1] * a1.reshape(shape)
    col = (-1,) + (1,) * (img.ndim - 1)
    out = (((b0.reshape(col) * (rows[ys0] >> 4)) >> 16)
           + ((b1.reshape(col) * (rows[ys1] >> 4)) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def resize_keep_ratio(img: np.ndarray, scale):
    """data/transforms.py::resize_keep_ratio with resize_linear for cv2."""
    from ...data import transforms as T
    h, w = img.shape[:2]
    new_w, new_h = T.rescale_size(h, w, scale)
    img = resize_linear(img, new_w, new_h)
    sf = np.array([new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
    return img, sf


def warp_exact(img: np.ndarray, scale):
    """data/instblink_dataset.py::warp_exact with resize_linear for cv2."""
    h, w = img.shape[:2]
    new_w, new_h = max(scale), min(scale)
    out = resize_linear(img, new_w, new_h)
    sf = np.array([new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
    return out, sf


class _NoNativeLoader:
    """Stands for NativeClipLoader: the native library links OpenCV."""

    def __init__(self, *args, **kwargs):
        raise RuntimeError('the native loader is off under npy_frames()')


def _load_image(self, vid_id: int, frame: int) -> np.ndarray:
    name = self.api.load_vid(vid_id)['file_names'][frame]
    return read_rgb(os.path.join(self.cfg.img_prefix, name))


def _decode_video(self, paths: list, video_id: int):
    """VideoGazeEvaluator._decode_video's cv2 branch, reading .npy."""
    from ...evaluation import driver
    frames = [read_rgb(p) for p in paths]
    crop = driver.crop_ratios(self.cfg, len(paths), video_id)
    imgs, whwh, sfs = driver.preprocess_frames(frames, self.cfg, crop)
    self.decoder = NPY_DECODE
    return imgs, whwh, sfs, len(paths)


def _patches():
    from ...data import dataset, instblink_dataset, native_loader, transforms
    from ...evaluation import driver
    return ((native_loader, 'NativeClipLoader', _NoNativeLoader),
            (dataset.Gaze360ClipDataset, '_load_image', _load_image),
            (transforms, 'resize_keep_ratio', resize_keep_ratio),
            (instblink_dataset, 'read_rgb', read_rgb),
            (instblink_dataset, 'warp_exact', warp_exact),
            (driver.VideoGazeEvaluator, '_decode_video', _decode_video))


@contextlib.contextmanager
def npy_frames():
    """The port's frame readers on .npy frames, without cv2 (module
    docstring); restores what it replaced on exit."""
    patches = _patches()
    saved = [(owner, name, vars(owner)[name]) for owner, name, _ in patches]
    try:
        for owner, name, new in patches:
            setattr(owner, name, new)
        yield
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)


def npy_bytes(frame: np.ndarray) -> bytes:
    """An HxWx3 RGB uint8 frame as the bytes of its .npy file: a request
    image for `decode_npy_image`."""
    buf = io.BytesIO()
    np.save(buf, frame)
    return buf.getvalue()


def decode_npy_image(data: bytes) -> np.ndarray:
    """evaluation/serving.py::decode_image_bytes for .npy request bodies.
    Raises ValueError on a body that is not an HxWx3 uint8 array, as the
    cv2 decoder does on one it cannot decode."""
    try:
        img = np.load(io.BytesIO(data), allow_pickle=False)
    except (ValueError, OSError, EOFError) as e:
        raise ValueError('request body is not a decodable image') from e
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'request body holds a {img.dtype} {img.shape} '
                         'array, not an RGB image')
    return img


@contextlib.contextmanager
def npy_request_images():
    """The serving stack's request images as .npy bytes, without cv2
    (module docstring); restores decode_image_bytes on exit."""
    from ...evaluation import serving
    saved = serving.decode_image_bytes
    serving.decode_image_bytes = decode_npy_image
    try:
        yield
    finally:
        serving.decode_image_bytes = saved
