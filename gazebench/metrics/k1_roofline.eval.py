"""K1 (ops/roi_align_cuda.py, the RoIAlign forward) in an eval window: its
mean bound a launch over its mean device time a launch, %."""
from gazebench.metrics_lib import roofline

UNIT = '%'


def read(rec):
    return roofline(rec, 'eval', 'roi_align_fpn_kernel', 'k1')
