"""Build and load the hand-written CUDA kernels of mcgaze_tpu_torch/csrc.

Each `csrc/<name>.cu` has a plain C interface and may include the shared
headers `csrc/*.cuh`. It is compiled with nvcc
for sm_90a into `mcgaze_tpu_torch/_build/lib<name>-<source hash>.so` at
first use (or by `build_all`, which starts one nvcc per source at once)
and loaded with ctypes. Nothing is built or loaded at import time. One lock
serialises building and loading, so threads that reach a kernel's first
launch together (a server's) build and load each library once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
SOURCES = ('roi_align_fpn', 'roi_align_fpn_bwd', 'fused_bottleneck',
           'stqi_attention')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: dict = {}
_lock = threading.RLock()


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    cands += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found ($CUDA_HOME/bin, $PATH, '
                       '/usr/local/cuda/bin): the CUDA kernels of '
                       'mcgaze_tpu_torch are built on the machine that has '
                       'the card')


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header in csrc/, so a change to a shared header rebuilds every
    library."""
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict:
    """Compile every source whose library is missing, one nvcc each, all
    started together. Returns {name: {'seconds', 'log', 'path'}}; a
    library already built reports seconds 0 and an empty log."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names
                   if not library_path(n).exists()}
        report = {}
        try:
            for n in names:
                if n in started:
                    log = _finish(n, *started.pop(n))
                    report[n] = dict(seconds=time.perf_counter() - t0,
                                     log=log, path=str(library_path(n)))
                else:
                    report[n] = dict(seconds=0.0, log='',
                                     path=str(library_path(n)))
        finally:
            for proc, tmp, _ in started.values():    # only after a failure
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
        return report


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.mcg_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mcg_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        msg = lib.mcg_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
