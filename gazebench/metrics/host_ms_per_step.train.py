"""Median host milliseconds a train step spends inside the step call (the
harness's clock), over the whole window."""
from gazebench.metrics_lib import host_ms

UNIT = 'ms'


def read(rec):
    return host_ms(rec, 'train')
