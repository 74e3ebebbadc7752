"""Score a results JSON against Gaze360 GT, counterpart of
tools/calculate_mae_gaze360.py:

    python -m mcgaze_tpu_torch.tools.calculate_mae_gaze360 --evalfile R.json
        --anno test.json [--gaze-name fusion_gazes] [--no-smooth] [--device]

Prints the same three buckets in the same format; "mean angular front 90"
is the published MAE-Front180. The default scorer is the float64 numpy one
(evaluation/mae.py); --device scores on the card in f32
(evaluation/mae_device.py) and refuses without one.
"""
from __future__ import annotations

import argparse
import json

from ..evaluation.mae import gaze_error


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--evalfile',
                   default='results/results_multiclue_gaze_r50_gaze360_'
                           'test.json')
    p.add_argument('--anno', default='data/gaze360/test.json')
    p.add_argument('--gaze-name', default='fusion_gazes')
    p.add_argument('--no-smooth', action='store_true')
    p.add_argument('--device', action='store_true',
                   help='score on the card (one flat f32 program over all '
                        'videos, evaluation/mae_device.py); refuses '
                        'without one')
    return p.parse_args(argv)


def print_buckets(gaze_name: str, res: dict) -> None:
    print('%s mean angular error 360: %.2f' % (gaze_name, res['mae360']))
    print('%s mean angular front 90: %.2f' % (gaze_name, res['front90']))
    print('%s mean angular front 20: %.2f' % (gaze_name, res['front20']))


def main(argv=None) -> dict:
    """Run the CLI; returns the bucket dict it printed."""
    args = parse_args(argv)
    if args.device:
        from ..utils.env import resolve_device
        resolve_device('cuda')          # refuse before reading any file
    with open(args.evalfile) as f:
        eval_data = json.load(f)
    with open(args.anno) as f:
        anno_data = json.load(f)
    if args.device:
        from ..evaluation.mae_device import gaze_error_device
        res = gaze_error_device(eval_data, anno_data, args.gaze_name,
                                smooth=not args.no_smooth, device='cuda')
    else:
        res = gaze_error(eval_data, anno_data, args.gaze_name,
                         smooth=not args.no_smooth)
    print_buckets(args.gaze_name, res)
    return res


if __name__ == '__main__':
    main()
