"""Median host milliseconds a gaze or query eval batch spends inside the
entry call (hand-over and enqueue, the harness's clock), over the whole
window. The host's launch work sets the pace where the device idles."""
from gazebench.metrics_lib import host_ms

UNIT = 'ms'


def read(rec):
    return host_ms(rec, 'eval')
