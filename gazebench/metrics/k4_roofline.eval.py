"""K4 (ops/stqi_attention.py, a stage's fused attention) in an eval window:
its mean bound a launch over its mean device time a launch, %."""
from gazebench.metrics_lib import roofline

UNIT = '%'


def read(rec):
    return roofline(rec, 'eval', 'stqi_attention_kernel', 'k4')
