"""One run of one benchmark cell of the MCGaze PyTorch/CUDA port
(mcgaze_tpu_torch) on the card this process is started on:

    python3 -m gazebench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up builds the cell (spec.py: workloads/, configs/, traffic/), the
program's kernels (mcgaze_tpu_torch/_build/, keyed by their sources, so
only a checkout's first run compiles), the seeded weights and batches on
the device, and warms the cell's shapes; `setup_s` runs from the process's
start to the first timed call. The window (window.py) then runs for
`--seconds`. With --trace 1 a further few calls run under the profiler
(trace.py: the device's activity alone, then again with the host's for
the breakdown) and once more with each kernel launch priced from its
arguments (capture.py), and the per-layer metrics (metrics/*.py) are
read from that record in place of the end-to-end ones. Once the window
has closed and the peak memory is read, the program is freed and the
check (entries/*.py) compares what the window produced with the plain
reference (reference/*.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last `checks`, each
compared number beside its limit, which also end standard error. No card,
or a module of JAX or of the JAX package in the process after the window:
no result and a non-zero exit.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start on the perf_counter clock (from its start time
    in /proc, in clock ticks after boot)."""
    now_perf, now_boot = time.perf_counter(), time.clock_gettime(
        time.CLOCK_BOOTTIME)
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        start_boot = int(fields[19]) / os.sysconf('SC_CLK_TCK')
    except (OSError, IndexError, ValueError):
        return now_perf
    return now_perf - (now_boot - start_boot)


PROCESS_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mcgaze_tpu')
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs():
    """Kernel caches a library might write go inside the checkout, at fixed
    paths (the port's own kernels build into mcgaze_tpu_torch/_build/)."""
    base = os.path.join(CHECKOUT, 'work_dirs', 'gazebench_cache')
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list:
    """Top-level module names of JAX or the JAX package loaded here."""
    tops = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device='cuda', overrides: dict | None = None,
             start: float | None = None) -> dict:
    """The result dict of one run (module docstring). `overrides` and a
    CPU `device` serve the tests at a small size."""
    import torch

    from . import spec, window
    from . import trace as tracing
    from .capture import capture
    from .counts.model import work_flops

    start = PROCESS_START if start is None else start
    cell = spec.load_cell(name, overrides)
    entry = spec.entry_class(cell['workload']['entry'])(cell, seed, device)
    entry.setup()
    setup_s = time.perf_counter() - start

    win = window.run(entry, seconds)
    rec = dict(mode=entry.mode, window=win,
               flops_per_call=work_flops(cell['config']['model'],
                                         **entry.work_shape()),
               peak_flops=entry.precision['mfu_peak_flops'])
    if trace:
        first = win['first'] + win['calls']
        n = cell['traffic']['trace_calls']
        rec['trace'] = tracing.profile(
            lambda ranges: window.run(entry, 0.0, first, count=n,
                                      traced=ranges)['calls'])

        def again():
            for i in range(first, first + n):
                entry.call(i)
            entry.sync()
        rec['launches'] = capture(again)
    cuda = entry.device.type == 'cuda'
    peak = torch.cuda.max_memory_allocated(entry.device) if cuda else 0
    entry.free()
    correct, checks = entry.check(win)

    if trace:
        metrics = {}
        for metric, mod in spec.metric_readers().items():
            value = mod.read(rec)
            if value is not None:
                metrics[metric] = dict(value=value, unit=mod.UNIT)
    else:
        metrics = window.end_to_end(entry.mode, win, setup_s)
    dev = dict(platform='gpu' if cuda else 'cpu',
               kind=torch.cuda.get_device_name(entry.device) if cuda
               else 'cpu', count=1, memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=win['calls'], failed=0,
               metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=rec['trace']['busy_s'],
                   window_s=rec['trace']['window_s'])
        out['breakdown'] = tracing.breakdown(rec)
        print(f"gazebench: traced {1e3 * rec['trace']['call_s']!r} ms a "
              f"call against {1e3 * win['seconds'] / win['calls']!r} in "
              'the measured window', file=sys.stderr)
    out['checks'] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    import torch

    from . import spec
    chips = spec.load_cell(args.workload)['workload'].get('chips', 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'gazebench: the cell needs {chips} CUDA card(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'device_count {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f'gazebench: the process loaded {bad}; the benchmark measures '
              'mcgaze_tpu_torch alone', file=sys.stderr)
        return 3
    for key, c in result['checks'].items():
        print(f'check {key}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
