"""The eval window's share of the card's peak: the frozen work count of a
batch (counts/model.py) times the batches completed, over the window's
seconds and the configuration's peak (bf16 989, TF32 495 TFLOP/s)."""
from gazebench.metrics_lib import mfu

UNIT = '%'


def read(rec):
    return mfu(rec, 'eval')
