"""K3 (ops/roi_align_cuda.py, the RoIAlign backward) in a train window: its
mean bound a launch over its mean device time a launch, %."""
from gazebench.metrics_lib import roofline

UNIT = '%'


def read(rec):
    return roofline(rec, 'train', 'roi_align_fpn_bwd_kernel', 'k3')
