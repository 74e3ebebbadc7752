"""Build the COCO-VID annotation JSON of an already reorganised Gaze360
split, counterpart of tools/dataset_converters/gaze360/
generate_json_from_ori.py (the same JSON, through the port's
data/gaze360_prepare.py):

    python -m mcgaze_tpu_torch.tools.dataset_converters.gaze360.generate_json_from_ori
        --split-txt /path/to/test.txt --out annotations/test.json
        --imgs /path/to/gaze360/imgs
        [--setting l2cs --metadata /path/to/metadata.mat]

It re-runs gaze360_img_reorganize's segmentation from the split txt and
reads each video's first frame for its resolution; no image is written.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp

from ....data.gaze360_prepare import (build_coco_vid_json,
                                      load_face_bbox_index, parse_split_txt,
                                      resolve_records, segment_videos)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--split-txt', required=True)
    ap.add_argument('--imgs', required=True,
                    help='raw imgs/ root (for per-video resolution probe)')
    ap.add_argument('--out', required=True, help='output JSON path')
    ap.add_argument('--setting', default='gaze360',
                    choices=['gaze360', 'l2cs'])
    ap.add_argument('--metadata', default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns the JSON it wrote."""
    args = parse_args(argv)
    import cv2
    bbox_index = (load_face_bbox_index(args.metadata)
                  if args.setting == 'l2cs' else None)
    records = resolve_records(parse_split_txt(args.split_txt), bbox_index)
    videos = segment_videos(records, drop_undetectable=args.setting == 'l2cs')

    entries = []
    for i, frames in enumerate(videos):
        vid = i + 1
        first = cv2.imread(osp.join(args.imgs, frames[0].rel_path))
        if first is None:
            raise FileNotFoundError(frames[0].rel_path)
        h, w = first.shape[:2]
        entries.append(dict(
            height=h, width=w, length=len(frames),
            file_names=[f'{vid}/{j:05d}.png' for j in range(len(frames))],
            id=vid, gazes=[list(f.gaze) for f in frames]))
    data = build_coco_vid_json(entries)
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(data, f)
    print(f'{len(data["videos"])} videos -> {args.out}')
    return data


if __name__ == '__main__':
    main()
