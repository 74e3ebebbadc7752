"""The readings a cell's check limits are set from, on the card:

    python3 -m gazebench.control --workload <cell> --seeds 1 2 3 ...
        [--seconds 3] [--no-control]

For each seed, in one process: the cell's set-up and a short window at
its own load, then the numbers its check compares for the program (the
lower readings; with --fault i, a fault of faults.py planted under it)
and for the control, the plain reference at the precision
one step below the configuration's (configs/*.json precision.<mode>.
control) put in the program's place (the upper readings). One JSON line a
seed, then the largest program reading and the smallest control reading
of each number. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch

from . import spec, window
from .faults import planted


def readings(name: str, seed: int, seconds: float, control: bool,
             device='cuda', overrides=None, fault: int | None = None
             ) -> dict:
    """One seed's numbers: the program's (with `fault` planted, faults.py)
    and, with `control`, the control's."""
    cell = spec.load_cell(name, overrides)
    entry = spec.entry_class(cell['workload']['entry'])(cell, seed, device)
    with (contextlib.nullcontext() if fault is None
          else planted(cell['workload']['entry'], fault)):
        entry.setup()
        win = window.run(entry, seconds)
    entry.free()
    out = dict(seed=seed, calls=win['calls'], program=entry.numbers(win))
    out['notes'] = getattr(entry, 'notes', None)
    ctrl = entry.precision['control']
    if control and ctrl.startswith('program:'):
        # the program's own lower-precision path, run as the cell runs
        lower = spec.merge(overrides or {}, dict(config=dict(precision={
            entry.mode: dict(dtype=ctrl.split(':', 1)[1])})))
        del entry
        out['control'] = readings(name, seed, seconds, False, device,
                                  lower)['program']
    elif control:
        out['control'] = entry.control_numbers(win, ctrl)
        del entry
    else:
        del entry
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--no-control', action='store_true')
    ap.add_argument('--fault', type=int, default=None,
                    help='plant fault i of the entry (faults.py) under the '
                         'program; implies --no-control')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('gazebench.control: needs a CUDA card', file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        rows.append(readings(args.workload, seed, args.seconds,
                             not (args.no_control or args.fault is not None),
                             fault=args.fault))
        print(json.dumps(rows[-1]), flush=True)
    summary = dict(workload=args.workload, seeds=len(rows),
                   program_max={k: max(r['program'][k] for r in rows)
                                for k in rows[0]['program']})
    if 'control' in rows[0]:
        summary['control_min'] = {k: min(r['control'][k] for r in rows)
                                  for k in rows[0]['control']}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
