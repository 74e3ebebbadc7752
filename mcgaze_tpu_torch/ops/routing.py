"""Whether the kernels' eager calls go through their torch.library
operators.

The model's kernel wrappers (roi_align_cuda.roi_align_fpn,
stqi_attention.fused_stqi_attention, fused_bottleneck.fused_bottleneck_chain)
launch their kernels bare when called eagerly: the operators cost host time
a call (PERF.md). A traced program goes through the operators, and so does
an eager call inside `through_operators()`, on any device (the operators'
CPU kernels are the plain versions): a dispatch mode such as
torch.utils.flop_counter.FlopCounterMode sees an operator and its inputs,
and never a bare launch. utils/profiling.py::cost_analysis counts a call
that way.
"""
from __future__ import annotations

import contextlib

_depth = 0


def active() -> bool:
    """True inside `through_operators()`."""
    return _depth > 0


@contextlib.contextmanager
def through_operators():
    """Eager calls of the kernel wrappers go through the operators (RoIAlign's
    backward through mcgaze::roi_align_fpn_bwd)."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
