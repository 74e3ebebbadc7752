"""Build MPEblink rawframes + COCO-VID JSONs from the video release,
counterpart of tools/dataset_converters/mpeblink_build_raw_frames_dataset.py
(the same files and JSON, through the port's data/mpeblink_prepare.py):

    python -m mcgaze_tpu_torch.tools.dataset_converters.mpeblink_build_raw_frames_dataset
        --root /path/to/mpeblink [--out OUT] [--workers 4]

--root holds {validate,train,test}/<vid>/{video.mp4, annote.json};
output goes to <root or OUT>/{split}_rawframes and
<root or OUT>/annotations/{split}.json.
"""
from __future__ import annotations

import argparse
import sys
import time

from ...data.mpeblink_prepare import prepare


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', required=True, help='Path to dataset root')
    ap.add_argument('--out', default=None,
                    help='output root (default: --root, like the '
                         'reference)')
    ap.add_argument('--workers', type=int, default=4)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns {split: PrepareStats}."""
    args = parse_args(argv)
    t0 = time.time()
    stats = prepare(args.root, args.out, workers=args.workers)
    if not stats:
        sys.exit(f'no split dirs (validate/train/test) under {args.root}')
    for split, s in stats.items():
        print(f'{split}: {s.videos} videos, {s.frames} frames, '
              f'{s.annotations} tracks')
    print(f'Done in {time.time() - t0:.1f}s')
    return stats


if __name__ == '__main__':
    main()
