"""Score a results JSON in the l2cs setting, counterpart of
tools/calculate_mae_l2cs.py:

    python -m mcgaze_tpu_torch.tools.calculate_mae_l2cs --evalfile R.json
        --anno test.json [--gaze-name fusion_gazes]

The GT row of video i is annotation i*3, and the front-20 bucket also
requires |pitch| <= 20 deg. The temporal smoothing is on, as the
reference applies it here too. Prints the gaze360 scorer's three lines.
"""
from __future__ import annotations

import argparse
import json

from ..evaluation.mae import gaze_error
from .calculate_mae_gaze360 import print_buckets


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--evalfile',
                   default='results/results_multiclue_gaze_r50_l2cs_'
                           'test.json')
    p.add_argument('--anno', default='data/l2cs/test.json')
    p.add_argument('--gaze-name', default='fusion_gazes')
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns the bucket dict it printed."""
    args = parse_args(argv)
    with open(args.evalfile) as f:
        eval_data = json.load(f)
    with open(args.anno) as f:
        anno_data = json.load(f)
    res = gaze_error(eval_data, anno_data, args.gaze_name, smooth=True,
                     l2cs=True)
    print_buckets(args.gaze_name, res)
    return res


if __name__ == '__main__':
    main()
