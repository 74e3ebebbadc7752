"""The train window's share of the TF32 peak (495 TFLOP/s): the frozen
work count of a step (counts/model.py) times the steps completed, over the
window's seconds."""
from gazebench.metrics_lib import mfu

UNIT = '%'


def read(rec):
    return mfu(rec, 'train')
