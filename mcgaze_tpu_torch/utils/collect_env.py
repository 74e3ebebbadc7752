"""Environment report, counterpart of mcgaze_tpu/utils/collect_env.py:
versions, the card, the CUDA toolkit and what of the port's native code is
built. Printed at the start of tools/train.py and by

    python -m mcgaze_tpu_torch.utils.collect_env
"""
from __future__ import annotations

import platform
import subprocess
import sys


def _version(mod: str) -> str:
    try:
        m = __import__(mod)
    except ImportError:
        return 'not installed'
    return getattr(m, '__version__', 'unknown')


def nvcc_version() -> str:
    """The last line of `nvcc --version` ('Build cuda_...'), or why there
    is none."""
    from ..ops._native import find_nvcc
    try:
        out = subprocess.run([find_nvcc(), '--version'], capture_output=True,
                             text=True, timeout=60, check=True)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f'not available ({type(e).__name__})'
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else 'unknown'


def collect_env() -> dict:
    """{field: text}; never raises on a machine without a card or nvcc."""
    import torch

    info = {'python': sys.version.replace('\n', ' '),
            'platform': platform.platform()}
    info['torch'] = torch.__version__
    info['torch cuda'] = torch.version.cuda or 'none (CPU build)'
    cudnn = torch.backends.cudnn.version() if torch.backends.cudnn.is_available() \
        else None
    info['cudnn'] = str(cudnn) if cudnn else 'not available'
    for mod in ('numpy', 'scipy', 'triton', 'cv2'):
        info[mod] = _version(mod)
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        info['cuda'] = 'available'
        info['devices'] = f'{n} x {torch.cuda.get_device_name(0)}'
    else:
        info['cuda'] = 'not available'
        info['devices'] = 'cpu'
    info['nvcc'] = nvcc_version()
    from ..data.native_loader import native_available
    from ..ops import _native
    info['native_loader'] = ('built' if native_available()
                             else 'not built (cv2 or .npy readers)')
    built = [n for n in _native.SOURCES if _native.library_path(n).exists()]
    missing = [n for n in _native.SOURCES if n not in built]
    info['cuda_kernels'] = (f'built: {", ".join(built) or "none"}; '
                            f'not built: {", ".join(missing) or "none"}')
    return info


def main(argv=None):
    for k, v in collect_env().items():
        print(f'{k}: {v}')


if __name__ == '__main__':
    main()
