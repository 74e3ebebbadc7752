"""K5 (ops/fused_bottleneck.py, the fused stride-1 ResNet chains) in an
eval window: its mean bound a launch over its mean device time a launch,
%."""
from gazebench.metrics_lib import roofline

UNIT = '%'


def read(rec):
    return roofline(rec, 'eval', 'conv_gemm', 'k5')
