"""Convert RT-GENE to the MCGaze COCO-VID 3-fold layout, counterpart of
tools/dataset_converters/rtgene/convert.py (the same files and JSON,
through the port's data/rtgene_prepare.py):

    python -m mcgaze_tpu_torch.tools.dataset_converters.rtgene.convert
        --root /path/to/rtgene --out data/rtgene
        [--detections dets.json] [--folds train1 ... test3]

Detection is pluggable: --detections reads precomputed boxes and
landmarks (data/rtgene_prepare.py::detections_from_json); without it
facenet_pytorch's MTCNN, the reference's detector, is used where that
package is installed.
"""
from __future__ import annotations

import argparse
import sys

from ....data import rtgene_prepare as R

ALL_FOLDS = ('train1', 'train2', 'train3', 'test1', 'test2', 'test3')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', required=True,
                    help='RT-GENE root holding sXXX_glasses/ dirs')
    ap.add_argument('--out', required=True, help='converted-dataset root')
    ap.add_argument('--detections', default=None,
                    help='precomputed detections JSON; omit to use '
                         'facenet_pytorch MTCNN (reference behavior)')
    ap.add_argument('--folds', nargs='+', default=list(ALL_FOLDS),
                    choices=ALL_FOLDS)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns {fold: FoldStats}."""
    args = parse_args(argv)
    if args.detections:
        detect = R.detections_from_json(args.detections)
    else:
        try:
            detect = R.mtcnn_detector()
        except ImportError:
            sys.exit('facenet_pytorch is not installed; provide '
                     '--detections with precomputed boxes+landmarks')
    stats = R.convert(args.root, args.out, detect, folds=args.folds)
    for fold, s in stats.items():
        print(f'{fold}: {s.videos} videos, {s.frames} frames kept, '
              f'{s.skipped} skipped')
    return stats


if __name__ == '__main__':
    main()
