"""Reorganise the raw Gaze360 release into per-video rawframes + JSONs,
counterpart of tools/gaze360_img_reorganize.py (the same files and JSON,
through the port's data/gaze360_prepare.py):

    python -m mcgaze_tpu_torch.tools.gaze360_img_reorganize
        --imgs /path/to/gaze360/imgs --metadata /path/to/metadata.mat
        --splits-dir /path/to/gaze360 --out data/
        [--settings gaze360 l2cs] [--splits train test] [--workers 16]

Splits the sorted train/test frame lists into continuous single-person
videos, renumbers frames, unifies each video's resolution to its first
frame and, for the l2cs setting, drops frames whose metadata face box is
[-1,-1,-1,-1]; writes <out>/<setting>/<split>_rawframes and
<out>/<setting>/annotations/<split>.json.
"""
from __future__ import annotations

import argparse
import os.path as osp

from ..data.gaze360_prepare import prepare_split


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--imgs', required=True,
                    help='raw Gaze360 imgs/ directory')
    ap.add_argument('--metadata', default=None,
                    help='metadata.mat (required for the l2cs setting)')
    ap.add_argument('--splits-dir', required=True,
                    help='directory holding train.txt/test.txt')
    ap.add_argument('--out', default='data',
                    help='output root; creates <out>/<setting>/...')
    ap.add_argument('--settings', nargs='+', default=['gaze360', 'l2cs'],
                    choices=['gaze360', 'l2cs'])
    ap.add_argument('--splits', nargs='+', default=['train', 'test'])
    ap.add_argument('--workers', type=int, default=16)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns {(setting, split): the annotation JSON}."""
    args = parse_args(argv)
    out = {}
    for setting in args.settings:
        for split in args.splits:
            txt = osp.join(args.splits_dir, f'{split}.txt')
            out_root = osp.join(args.out, setting)
            data = prepare_split(args.imgs, txt, out_root, split,
                                 setting=setting,
                                 metadata_mat=args.metadata,
                                 workers=args.workers)
            n_frames = sum(v['length'] for v in data['videos'])
            print(f'[{setting}/{split}] {len(data["videos"])} videos, '
                  f'{n_frames} frames -> {out_root}')
            out[setting, split] = data
    return out


if __name__ == '__main__':
    main()
