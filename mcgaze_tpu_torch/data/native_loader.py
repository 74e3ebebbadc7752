"""ctypes binding to the native C++ clip loader (native/clip_loader.cpp,
built as native/libmcgaze_loader.so by `make -C native`), counterpart of
mcgaze_tpu/data/native_loader.py.

A persistent C++ thread pool decodes frames with OpenCV, centre-crops,
resizes keeping the aspect ratio (or warps exactly), flips, normalises
(or not: the u8 entry point) and pads them straight into a caller-owned
batch buffer. The eval driver and the clip dataset use it when the
library builds, and decode with cv2 in Python otherwise. The library links
OpenCV, so on a machine without OpenCV neither path decodes images.

    loader = NativeClipLoader()          # RuntimeError if unbuildable
    imgs, meta = loader.load(paths, crop_ratios, flips, scale, canvas)
"""
from __future__ import annotations

import ctypes
import os.path as osp
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))), 'native')
SO_PATH = osp.join(NATIVE_DIR, 'libmcgaze_loader.so')

_P = ctypes.POINTER
# mcg_load_frames[_u8](pool, n, paths, crop_ratios, flips, scale_w,
#                      scale_h, canvas_h, canvas_w, out, meta)
_LOAD_ARGS = [ctypes.c_void_p, ctypes.c_int, _P(ctypes.c_char_p),
              _P(ctypes.c_float), _P(ctypes.c_uint8),
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]


def build_native(quiet: bool = True) -> bool:
    """Run `make -C native` unless the library exists; returns whether it
    does afterwards."""
    if osp.exists(SO_PATH):
        return True
    try:
        subprocess.run(['make', '-C', NATIVE_DIR], check=True,
                       capture_output=quiet)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    return osp.exists(SO_PATH)


def native_available() -> bool:
    return osp.exists(SO_PATH) or build_native()


class NativeClipLoader:
    """Thread-pooled decode + augment. One instance owns one C++ pool."""

    def __init__(self, n_threads: int = 0):
        """n_threads 0: the pool's default (the host's hardware threads)."""
        if not native_available():
            raise RuntimeError(
                f'native loader not built: `make -C {NATIVE_DIR}` failed '
                '(it needs g++ and the OpenCV 4 headers and libraries)')
        lib = ctypes.CDLL(SO_PATH)
        lib.mcg_pool_create.restype = ctypes.c_void_p
        lib.mcg_pool_create.argtypes = [ctypes.c_int]
        lib.mcg_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.mcg_load_frames.restype = ctypes.c_int
        lib.mcg_load_frames.argtypes = _LOAD_ARGS + [_P(ctypes.c_float),
                                                     _P(ctypes.c_int32)]
        # a library built before the u8 entry point lacks it
        self.has_u8 = hasattr(lib, 'mcg_load_frames_u8')
        if self.has_u8:
            lib.mcg_load_frames_u8.restype = ctypes.c_int
            lib.mcg_load_frames_u8.argtypes = _LOAD_ARGS + [
                _P(ctypes.c_uint8), _P(ctypes.c_int32)]
        # exact-warp (keep_ratio=False) capability probe
        self.has_warp = hasattr(lib, 'mcg_has_warp')
        self._lib = lib
        self._pool = lib.mcg_pool_create(n_threads)

    def __del__(self):
        pool = getattr(self, '_pool', None)
        if pool:
            self._lib.mcg_pool_destroy(pool)
            self._pool = None

    def _encode_scale(self, scale, keep_ratio):
        """keep_ratio=False rides the negative-scale exact-warp encoding
        (clip_loader.cpp::LoadOne), only where the library has it."""
        if keep_ratio:
            return scale
        if not self.has_warp:
            raise RuntimeError(
                'libmcgaze_loader.so predates exact-warp (keep_ratio='
                'False); rebuild it with `make -C native`')
        return (-abs(int(scale[0])), -abs(int(scale[1])))

    def _run(self, fn, ctype, dtype, paths, crop_ratios, flips, scale,
             canvas, out, keep_ratio):
        scale = self._encode_scale(scale, keep_ratio)
        n = len(paths)
        ch, cw = canvas
        if out is None:
            out = np.empty((n, ch, cw, 3), dtype)
        if out.shape != (n, ch, cw, 3) or out.dtype != dtype \
                or not out.flags.c_contiguous:
            raise ValueError(f'out must be a C-contiguous {(n, ch, cw, 3)} '
                             f'{np.dtype(dtype).name} array, got '
                             f'{out.shape} {out.dtype}')
        meta = np.empty((n, 6), np.int32)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        c_crops = None if crop_ratios is None else (ctypes.c_float * n)(
            *[-1.0 if r is None else float(r) for r in crop_ratios])
        c_flips = None if flips is None else (ctypes.c_uint8 * n)(
            *[1 if f else 0 for f in flips])
        rc = fn(self._pool, n, c_paths,
                ctypes.cast(c_crops, _P(ctypes.c_float)),
                ctypes.cast(c_flips, _P(ctypes.c_uint8)),
                scale[0], scale[1], ch, cw,
                out.ctypes.data_as(_P(ctype)),
                meta.ctypes.data_as(_P(ctypes.c_int32)))
        if rc:
            raise FileNotFoundError(
                f'native loader failed to decode {paths[rc - 1]}')
        return out, meta

    def load(self, paths: Sequence[str],
             crop_ratios: Optional[Sequence[Optional[float]]],
             flips: Optional[Sequence[bool]],
             scale: Tuple[int, int], canvas: Tuple[int, int],
             out: Optional[np.ndarray] = None, keep_ratio: bool = True):
        """Decode and augment `paths` in parallel.

        crop_ratios: per-frame centre-crop ratio (None, or None/<=0 for a
        frame: no crop). flips: per-frame horizontal flip (None: none).
        scale: (w, h) keep-ratio resize target (the exact warp target with
        keep_ratio=False). canvas: (H, W) pad size. Returns (imgs (N, H,
        W, 3) f32 normalised, meta (N, 6) int32 [orig_h, orig_w, crop_h,
        crop_w, new_h, new_w])."""
        return self._run(self._lib.mcg_load_frames, ctypes.c_float,
                         np.float32, paths, crop_ratios, flips, scale,
                         canvas, out, keep_ratio)

    def load_u8(self, paths: Sequence[str],
                crop_ratios: Optional[Sequence[Optional[float]]],
                flips: Optional[Sequence[bool]],
                scale: Tuple[int, int], canvas: Tuple[int, int],
                out: Optional[np.ndarray] = None, keep_ratio: bool = True):
        """load() without the normalise: raw u8 padded frames (pad 0), a
        quarter of the bytes to ship; the consumer normalises on the
        device (evaluation/forward.py::device_normalize)."""
        if not self.has_u8:
            raise RuntimeError('libmcgaze_loader.so predates the uint8 '
                               'entry point; rebuild it with `make -C '
                               'native`')
        return self._run(self._lib.mcg_load_frames_u8, ctypes.c_uint8,
                         np.uint8, paths, crop_ratios, flips, scale,
                         canvas, out, keep_ratio)
