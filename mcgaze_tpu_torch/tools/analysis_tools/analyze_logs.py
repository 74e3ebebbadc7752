"""Training-log analysis over the port's train_log.jsonl
(train/hooks.py::TextLogger), counterpart of
tools/analysis_tools/analyze_logs.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.analyze_logs \\
        cal_train_time <log.jsonl>
    python -m mcgaze_tpu_torch.tools.analysis_tools.analyze_logs \\
        plot_curve <log.jsonl> --keys loss grad_norm [--out curve.png]

plot_curve --out draws with matplotlib and fails with a message where it
is not installed; without --out it prints a terminal summary (first, last,
min, max and a sparkline per key), which needs nothing. Touches no device.
"""
from __future__ import annotations

import argparse
import json
import sys


def load_log(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def cal_train_time(rows):
    import numpy as np
    times = np.asarray([r['time'] for r in rows if 'time' in r] or
                       [r['sec_per_iter'] for r in rows])
    data_times = np.asarray([r.get('data_time', 0.0) for r in rows])
    print(f'iters logged:     {len(rows)}')
    print(f'avg iter time:    {times.mean():.4f} s '
          f'(std {times.std():.4f}, fastest {times.min():.4f}, '
          f'slowest {times.max():.4f})')
    if data_times.any():
        print(f'avg data time:    {data_times.mean():.4f} s '
              f'({100 * data_times.mean() / max(times.mean(), 1e-9):.1f}% '
              f'of iter)')


def plot_curve(rows, keys, out=None):
    steps = [r['step'] for r in rows]
    if out:
        try:
            import matplotlib
        except ImportError:
            raise SystemExit('plot_curve --out needs matplotlib, which is '
                             'not installed; without --out the terminal '
                             'summary needs none')
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        for k in keys:
            plt.plot(steps, [r.get(k) for r in rows], label=k)
        plt.xlabel('iter')
        plt.legend()
        plt.savefig(out, dpi=120)
        print(f'wrote {out}')
        return
    # terminal sparkline summary
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        if not vals:
            print(f'{k}: (absent)')
            continue
        lo, hi = min(vals), max(vals)
        blocks = ' ▁▂▃▄▅▆▇█'
        line = ''.join(
            blocks[int((v - lo) / (hi - lo + 1e-12) * 8)] for v in
            vals[:: max(1, len(vals) // 80)])
        print(f'{k}: first={vals[0]:.4g} last={vals[-1]:.4g} '
              f'min={lo:.4g} max={hi:.4g}\n  {line}')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('task', choices=['cal_train_time', 'plot_curve'])
    ap.add_argument('log')
    ap.add_argument('--keys', nargs='+', default=['loss'])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    rows = load_log(args.log)
    if not rows:
        sys.exit('empty log')
    if args.task == 'cal_train_time':
        cal_train_time(rows)
    else:
        plot_curve(rows, args.keys, args.out)


if __name__ == '__main__':
    main()
