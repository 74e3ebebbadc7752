"""What a cell is made of, found by name under gazebench/:

  workloads/<cell>.json    the configuration, the traffic mix, the entry
                           it drives, why it exists, its check limits
  configs/<config>.json    the model's sizes at their source, the
                           precision and TF32 settings it runs at, the
                           peak its mfu divides by, its reference family
  traffic/<traffic>.json   the parameters the generator (traffic.py)
                           makes the cell's batches from
  entries/<entry>.py       the driver of one entry point of the program
  reference/<family>.py    the plain reference of a model family
  metrics/<metric>.py      one per-layer metric: read(record) -> number
                           or None

A cell added later is files added beside these; none is edited.
"""
from __future__ import annotations

import copy
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'gazebench: no {kind[:-1]} named {name!r} '
                                f'({path})')
    with open(path) as f:
        return json.load(f)


def merge(base: dict, extra: dict | None) -> dict:
    """A deep copy of base with extra's keys set, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_cell(name: str, overrides: dict | None = None) -> dict:
    """{'name', 'workload', 'config', 'traffic'}; overrides (tests at a
    small size) merge into each part by its key."""
    overrides = overrides or {}
    workload = merge(_json('workloads', name), overrides.get('workload'))
    config = merge(_json('configs', workload['config']),
                   overrides.get('config'))
    traffic = merge(_json('traffic', workload['traffic']),
                    overrides.get('traffic'))
    return dict(name=name, workload=workload, config=config, traffic=traffic)


def entry_class(name: str):
    """The class `Entry` of entries/<name>.py."""
    return importlib.import_module(f'gazebench.entries.{name}').Entry


def reference(family: str):
    return importlib.import_module(f'gazebench.reference.{family}')


def metric_readers() -> dict:
    """{metric name: module} of every metrics/<name>.py, each with UNIT and
    read(record) (a name may hold dots, so each file is loaded by its
    path)."""
    readers = {}
    for path in sorted((ROOT / 'metrics').glob('*.py')):
        if path.name.startswith('_'):
            continue
        name = path.name[:-3]
        mod_name = 'gazebench.metrics.' + name.replace('.', '__')
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[name] = mod
    return readers
