"""CLI config overrides, `--cfg-options a.b=1 c=2.5 d=true e=1,2`,
counterpart of mcgaze_tpu/utils/cfg_options.py (mmcv DictAction surface):
dotted keys address nested fields, values parse as Python literals
(int/float/bool/str, comma lists to tuples). The targets are frozen
dataclasses, so overrides apply through dataclasses.replace along the path.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Sequence


def parse_value(text: str) -> Any:
    if ',' in text:
        return tuple(parse_value(v) for v in text.split(',') if v != '')
    low = text.lower()
    if low in ('true', 'false'):
        return low == 'true'
    if low in ('none', 'null'):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(cfg: Any, options: Sequence[str] | None) -> Any:
    """Apply 'a.b.c=value' strings to a (possibly nested, possibly frozen)
    dataclass tree; returns the updated tree."""
    for opt in options or []:
        if '=' not in opt:
            raise ValueError(f'--cfg-options entry {opt!r} must be key=val')
        key, _, raw = opt.partition('=')
        cfg = _set_path(cfg, key.strip().split('.'), parse_value(raw))
    return cfg


def _set_path(node: Any, path: list, value: Any) -> Any:
    name = path[0]
    if dataclasses.is_dataclass(node):
        if not hasattr(node, name):
            raise AttributeError(
                f'{type(node).__name__} has no field {name!r}')
        if len(path) == 1:
            return dataclasses.replace(node, **{name: value})
        child = _set_path(getattr(node, name), path[1:], value)
        return dataclasses.replace(node, **{name: child})
    if isinstance(node, dict):
        out = dict(node)
        out[name] = (value if len(path) == 1
                     else _set_path(node[name], path[1:], value))
        return out
    if len(path) == 1 and hasattr(node, name):
        setattr(node, name, value)
        return node
    raise TypeError(f'cannot descend into {type(node).__name__} at {name!r}')
