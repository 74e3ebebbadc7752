"""The card's idle share in the train window: 1 - (union of busy intervals
of the traced calls, a call) / (the measured window's time a call), %."""
from gazebench.metrics_lib import idle

UNIT = '%'


def read(rec):
    return idle(rec, 'train')
