"""MPEblink raw-dataset preparation: video decode + COCO-VID JSON; the
port's copy of mcgaze_tpu/data/mpeblink_prepare.py (numpy only; that
package's __init__ imports JAX, so the port keeps its own). Both write the
same files and the same JSON.

Rebuilds the reference one-shot script
``tools/dataset_converters/mpeblink_build_raw_frames_dataset.py`` (in
zgchen33/MCGaze) as a reusable engine:

  MPEblink release layout  <root>/{split}/<vid>/{video.mp4, annote.json}
    -> per-video rawframe dirs  <out>/<split>_rawframes/<vid>/%05d.png
    -> COCO-VID annotation JSON <out>/annotations/<split>.json

Behavioral spec (matching the reference script, cited by line):
  * splits are ('validate', 'train', 'test'); absent split dirs are
    skipped (reference :20-24).
  * video ids are the integer directory names, processed in numeric
    order (:26-28); the id is reused as ``video_id`` (:80, :112).
  * every frame is resized to 640x360 (cv2 bilinear) and written as
    ``<vid>/%05d.png`` with 5-digit zero padding (:40-41, :72-75).
  * the videos entry records the *annotated* length popped from
    annote.json, not the decoded frame count (:54-57, :62) — the two
    can disagree in the release and the annotation range wins.
  * per-person annotations: bboxes (xywh) and the 68 landmarks are
    rescaled by (640/width, 360/height) (:92-100); frames whose bbox is
    None (occluded) stay None and get ``blinks_binary=None`` (:88-90);
    otherwise ``blinks_binary`` is 1 iff the frame index falls inside
    any closed blink event interval [start, end] (:101-107).
  * event-level ``blinks`` intervals are carried through unscaled
    (:110); ``category_id`` is always 1 / person_face (:33, :85);
    annotation ids count from 1 within each split (:37, :114).

Unlike the reference (single-threaded imwrite inside the decode loop),
frame encode/write here fans out over a thread pool while the decoder
streams; the JSON assembly is identical.

The produced tree is exactly what
``data/instblink_dataset.py::InstBlinkClipDataset`` consumes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

SPLITS = ('validate', 'train', 'test')
TARGET_W, TARGET_H = 640, 360            # reference :40-41
N_LANDMARKS = 68                         # reference :98


@dataclasses.dataclass
class PrepareStats:
    videos: int = 0
    frames: int = 0
    annotations: int = 0


def _scale_track(person: Dict, length: int, scale_w: float,
                 scale_h: float) -> Tuple[List, List, List]:
    """Scale one person's bboxes+landmarks in the reference's order and
    derive per-frame binary blink labels. Returns (bboxes, landmarks,
    blinks_binary); occluded (None-bbox) frames stay None everywhere."""
    bboxes = person['bbox']
    landmarks = person['landmark']
    events = person['blink']
    out_boxes: List[Optional[List[float]]] = []
    out_lms: List[Optional[List[List[float]]]] = []
    binary: List[Optional[int]] = []
    for index in range(length):
        box = bboxes[index] if index < len(bboxes) else None
        if box is None:
            out_boxes.append(None)
            # reference :88-90 keeps the raw (None) landmark row and
            # appends None so every frame stays aligned
            out_lms.append(landmarks[index] if index < len(landmarks)
                           else None)
            binary.append(None)
            continue
        out_boxes.append([box[0] * scale_w, box[1] * scale_h,
                          box[2] * scale_w, box[3] * scale_h])
        lm = landmarks[index]
        out_lms.append([[lm[k][0] * scale_w, lm[k][1] * scale_h]
                        for k in range(N_LANDMARKS)])
        # closed interval containment, first match wins (:101-107)
        binary.append(int(any(s <= index <= e for s, e in events)))
    return out_boxes, out_lms, binary


def _decode_video(video_path: str, save_dir: str,
                  workers: int) -> List[str]:
    """Stream-decode video.mp4, resize to 640x360, write %05d.png.
    Returns relative file names '<vid>/%05d.png'."""
    import cv2
    vid_name = osp.basename(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    file_names: List[str] = []
    try:
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            futs = []
            idx = 0
            while True:
                ok, image = cap.read()
                if not ok:
                    break
                rel = f'{vid_name}/{idx:05d}.png'
                resized = cv2.resize(image, (TARGET_W, TARGET_H))
                futs.append(pool.submit(
                    cv2.imwrite, osp.join(save_dir, f'{idx:05d}.png'),
                    resized))
                file_names.append(rel)
                idx += 1
            for f in futs:
                assert f.result(), 'imwrite failed'
    finally:
        cap.release()
    return file_names


def prepare_split(split_root: str, rawframes_root: str,
                  workers: int = 4) -> Tuple[Dict, PrepareStats]:
    """Build one split: decode every video dir and assemble the JSON."""
    stats = PrepareStats()
    videos, annotations = [], []
    anno_id = 1
    vid_ids = sorted(int(d) for d in os.listdir(split_root)
                     if osp.isdir(osp.join(split_root, d)))
    for vid in vid_ids:
        vdir = osp.join(split_root, str(vid))
        with open(osp.join(vdir, 'annote.json')) as f:
            origin = json.load(f)
        height = origin.pop('height')
        width = origin.pop('width')
        length = origin.pop('length')
        scale_w = TARGET_W / width
        scale_h = TARGET_H / height
        file_names = _decode_video(osp.join(vdir, 'video.mp4'),
                                   osp.join(rawframes_root, str(vid)),
                                   workers)
        videos.append({'height': TARGET_H, 'width': TARGET_W,
                       'length': length, 'file_names': file_names,
                       'id': vid})
        stats.videos += 1
        stats.frames += len(file_names)
        for person in origin:                    # remaining keys = tracks
            boxes, lms, binary = _scale_track(origin[person], length,
                                              scale_w, scale_h)
            annotations.append({
                'height': TARGET_H, 'width': TARGET_W, 'length': 1,
                'category_id': 1, 'bboxes': boxes, 'landmark': lms,
                'blinks': origin[person]['blink'],
                'blinks_binary': binary, 'video_id': vid,
                'id': anno_id})
            anno_id += 1
            stats.annotations += 1
    dataset = {
        'info': {'description': 'MPEblink rawframes (mcgaze_tpu prepare)',
                 'url': '1', 'version': '1', 'year': '2022',
                 'contributor': 'Wenzheng Zeng, Sicheng Wei, '
                                'Jinfang Gan, Xintao Zhang'},
        'licenses': 'only for research',
        'videos': videos,
        'categories': [{'supercategory': 'object', 'id': 1,
                        'name': 'person_face'}],
        'annotations': annotations,
    }
    return dataset, stats


def prepare(root: str, out: Optional[str] = None,
            workers: int = 4) -> Dict[str, PrepareStats]:
    """Prepare every present split under `root`; returns per-split stats.

    `out` defaults to `root` (the reference writes into the dataset
    root: <root>/{split}_rawframes + <root>/annotations)."""
    out = out or root
    all_stats: Dict[str, PrepareStats] = {}
    for split in SPLITS:
        split_root = osp.join(root, split)
        if not osp.isdir(split_root):
            continue
        dataset, stats = prepare_split(
            split_root, osp.join(out, f'{split}_rawframes'), workers)
        ann_dir = osp.join(out, 'annotations')
        os.makedirs(ann_dir, exist_ok=True)
        with open(osp.join(ann_dir, f'{split}.json'), 'w') as f:
            json.dump(dataset, f)
        all_stats[split] = stats
    return all_stats
