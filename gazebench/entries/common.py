"""What every entry driver shares: set-up from the cell's files, the
seeded weights handed to the program and the reference alike, warm-up,
freeing the program before the reference runs, the seeded sample of calls
the check reads, and the check itself against the cell's limits.

An entry subclass gives `mode` ('eval' or 'train'), `build()` (the
program, its pool of batches, `clips_per_call`), the timed calls
(`submit`/`readback` for eval, `step`/`sync` for train), `work_shape()`
(the sizes counts/model.py prices a call at), `numbers(win)` (each number
its check can compare) and, where the configuration's control is the
reference at a lower precision, `control_numbers(win, precision)` (the
same numbers with that reference in the program's place; control.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc

import numpy as np
import torch

from .. import spec, traffic


@contextlib.contextmanager
def reference_precision():
    """f32 products without TF32, restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _stages(patterns, stages: int) -> list:
    """Weight-name patterns with '{early}' (every stage but the last)
    expanded and '{last}' filled in."""
    out = []
    for pat in patterns:
        if '{early}' in pat:
            out += [pat.replace('{early}', str(s)) for s in range(stages - 1)]
        else:
            out.append(pat.replace('{last}', str(stages - 1)))
    return out


class Base:
    mode = 'eval'
    warmup_calls = 3

    def __init__(self, cell: dict, seed: int, device):
        self.cell = cell
        self.config = cell['config']
        self.traffic = cell['traffic']
        self.workload = cell['workload']
        self.precision = self.config['precision'][self.mode]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.ref = spec.reference(self.config['family'])
        self.outputs = {}

    # ----------------------------------------------------------- set-up

    def setup(self):
        torch.backends.cudnn.allow_tf32 = self.precision['cudnn_allow_tf32']
        torch.backends.cuda.matmul.allow_tf32 = \
            self.precision['matmul_allow_tf32']
        if self.device.type == 'cuda':
            from mcgaze_tpu_torch.ops import _native
            _native.build_all(tuple(self.config['kernels']))
        w = self.config.get('weights', {})
        stages = self.config['model']['num_stages']
        self.weights = traffic.make_weights(
            self.ref.param_specs(self.config['model']), self.seed,
            self.device, w.get('proposals'),
            _stages(w.get('zeros', []), stages),
            {p: f for pat, f in w.get('scales', {}).items()
             for p in _stages([pat], stages)},
            w.get('biases'))
        self.build()
        self.warm()

    def program_fields(self, cls, extra=None) -> dict:
        """The config's model sizes, its program options and the mode's
        dtype, as the fields of the program's config dataclass `cls`."""
        names = {f.name for f in dataclasses.fields(cls)}
        merged = dict(self.config['model'], **self.config.get('program', {}),
                      dtype=self.precision['dtype'], **(extra or {}))
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in merged.items() if k in names}

    def load(self, model):
        model.load_state_dict(self.weights, strict=True)

    def warm(self):
        """The cell's own shapes through the timed calls before the clock
        starts; their outputs are not kept."""
        for i in range(self.warmup_calls):
            self.call(i)
        self.sync()
        self.outputs.clear()

    def call(self, i):
        if self.mode == 'eval':
            self.readback(i, self.submit(i))
        else:
            self.step(i)

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ check

    def free(self):
        """Drop the program and its device state before the reference
        runs."""
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def sample(self, win: dict) -> list:
        """The check's calls: `check_calls` of the window's, drawn from the
        seed."""
        rng = np.random.default_rng(traffic.stream(self.seed,
                                                   traffic.SAMPLE))
        calls = list(range(win['first'], win['first'] + win['calls']))
        k = min(self.traffic['check_calls'], len(calls))
        return sorted(int(c) for c in rng.choice(calls, k, replace=False))

    def check(self, win: dict) -> tuple:
        """(correct, {number: {'value', 'limit'}}), with the limits of the
        cell's workload file."""
        limits = self.workload['checks']
        values = self.numbers(win)
        out = {k: dict(value=values[k], limit=limits[k]) for k in limits}
        ok = all(np.isfinite(v['value']) and v['value'] <= v['limit']
                 for v in out.values())
        return ok, out


def worst(gaps: list) -> dict:
    """Per output over the sampled calls: the widest gap (`<name>`) and the
    99th percentile (`<name>_p99`)."""
    out = {}
    for k in gaps[0]:
        v = torch.cat([g[k].double().flatten().cpu() for g in gaps])
        out[k] = float(v.max())
        out[k + '_p99'] = float(torch.quantile(v, 0.99))
    return out
