"""Print the resolved config, counterpart of tools/misc/print_config.py:

    python -m mcgaze_tpu_torch.tools.misc.print_config <config>
        [--cfg-options a.b=v ...]

The config is loaded by the port's loader (utils/config.py: native and
legacy configs, without the JAX package) and printed field by field in the
JAX tool's layout. It touches no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import pprint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Print the whole config')
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='+', default=None,
                   help="config overrides 'a.b=val'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ...utils.cfg_options import apply_overrides
    from ...utils.config import load_config

    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    print(f'Config (resolved from {args.config}):')
    for field in dataclasses.fields(cfg):
        val = getattr(cfg, field.name)
        if dataclasses.is_dataclass(val):
            print(f'{field.name} = {type(val).__name__}(')
            for f2 in dataclasses.fields(val):
                print(f'    {f2.name}={getattr(val, f2.name)!r},')
            print(')')
        else:
            print(f'{field.name} = {pprint.pformat(val)}')
    return cfg


if __name__ == '__main__':
    main()
