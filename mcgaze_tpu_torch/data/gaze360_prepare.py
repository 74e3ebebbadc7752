"""Gaze360 raw-dataset preparation: rawframe reorganisation + COCO-VID JSON;
the port's copy of mcgaze_tpu/data/gaze360_prepare.py (numpy only; that
package's __init__ imports JAX, so the port keeps its own). Both write the
same files and the same JSON.

Rebuilds the behavior of the reference one-shot scripts
(`tools/gaze360_img_reorganize.py` and
`tools/dataset_converters/gaze360/generate_json_from_ori.py` in
zgchen33/MCGaze) as one reusable engine:

  raw Gaze360 (imgs/ + metadata.mat + {split}.txt)
    -> per-video rawframe dirs  data/<setting>/<split>_rawframes/<vid>/%05d.png
    -> COCO-VID annotation JSON data/<setting>/annotations/<split>.json

Behavioral spec (matching the reference):
  * split txt lines are sorted lexicographically; consecutive lines belong to
    the same "video" iff recording dir and person id are unchanged and the
    frame number is exactly previous+1 (reference reorganizer :70-71).
  * frames are renumbered from 00000 within each video; every frame is
    resized to the video's FIRST frame resolution (reference :114-116).
  * video ids start at 1 (reference emits a dummy id-0 entry then drops it,
    converter :121-122).
  * 'l2cs' setting drops frames whose metadata `person_face_bbox` is
    [-1,-1,-1,-1] (face not detectable) and starts a new video at every such
    gap (reference :104-133).
  * JSON schema: videos[{height,width,length,file_names,id}],
    annotations[{height,width,length:1,category_id:1,gaze:[per-frame
    [x,y,z]],video_id,id=video_id}] (single-person tracks),
    categories=[{id:1,name:'person_face'}] (converter :54-58,27-29).

Unlike the reference (O(N^2)-ish circular pointer scan over metadata.mat,
single-threaded imwrite), metadata matching here is a hash join on
(recording, person, frame) and image IO fans out over a thread pool.
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

SETTINGS = ('gaze360', 'l2cs')


@dataclasses.dataclass
class FrameRecord:
    """One line of {split}.txt resolved against metadata.mat."""
    rel_path: str            # e.g. 'rec_000/head/000123/000456.jpg'
    gaze: Tuple[float, float, float]
    recording: str
    person: int
    frame: int
    face_detectable: bool = True


def parse_split_txt(path: str) -> List[Tuple[str, Tuple[float, float, float]]]:
    """Read '<relpath> gx gy gz' lines, sorted like the reference."""
    with open(path) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    lines.sort()
    out = []
    for ln in lines:
        parts = ln.split()
        out.append((parts[0], (float(parts[1]), float(parts[2]),
                               float(parts[3]))))
    return out


def load_face_bbox_index(metadata_mat: str) -> Dict[Tuple[str, int, int],
                                                    np.ndarray]:
    """(recording_name, person_id, frame_no) -> person_face_bbox row.

    The reference resolves this with a wrap-around linear pointer sweep
    (reorganizer :59-68); a dict join gives identical results in O(N).
    """
    import scipy.io as sio
    msg = sio.loadmat(metadata_mat)
    recordings = msg['recordings']
    face_bbox = np.asarray(msg['person_face_bbox'])
    recording_index = np.asarray(msg['recording']).ravel()
    person_index = np.asarray(msg['person_identity']).ravel()
    frame_index = np.asarray(msg['frame']).ravel()
    index: Dict[Tuple[str, int, int], np.ndarray] = {}
    for i in range(recording_index.shape[0]):
        rec = str(recordings[0, recording_index[i]][0])
        key = (rec, int(person_index[i]), int(frame_index[i]))
        index[key] = face_bbox[i]
    return index


def _parse_rel_path(rel_path: str) -> Tuple[str, int, int]:
    """'rec/<crop>/<person>/<frame>.jpg' -> (rec, person, frame)."""
    parts = rel_path.split('/')
    return parts[0], int(parts[2]), int(parts[3].split('.')[0])


def resolve_records(split_entries, bbox_index=None) -> List[FrameRecord]:
    records = []
    for rel_path, gaze in split_entries:
        rec, person, frame = _parse_rel_path(rel_path)
        detectable = True
        if bbox_index is not None:
            bb = bbox_index.get((rec, person, frame))
            # reference semantics (reorganizer :105): detectable iff NO
            # bbox coordinate equals -1 — `(bbox != [-1,-1,-1,-1]).all()`
            detectable = bb is not None and bool((np.asarray(bb) != -1).all())
        records.append(FrameRecord(rel_path, gaze, rec, person, frame,
                                   detectable))
    return records


def segment_videos(records: Sequence[FrameRecord],
                   drop_undetectable: bool) -> List[List[FrameRecord]]:
    """Group frames into continuous single-person videos.

    A new video starts when (recording, person) changes or the frame number
    is not previous+1; in the l2cs setting additionally whenever a dropped
    (face-undetectable) frame interrupts the stream.
    """
    videos: List[List[FrameRecord]] = []
    cur: List[FrameRecord] = []
    prev: FrameRecord | None = None
    for r in records:
        if drop_undetectable and not r.face_detectable:
            prev = None          # gap -> force split
            continue
        discontinuous = (prev is None or r.recording != prev.recording
                         or r.person != prev.person
                         or r.frame != prev.frame + 1)
        if discontinuous and cur:
            videos.append(cur)
            cur = []
        cur.append(r)
        prev = r
    if cur:
        videos.append(cur)
    return videos


def _write_video(vid_id: int, frames: Sequence[FrameRecord],
                 ori_root: str, out_dir: str) -> dict:
    """Write one video's renumbered, resolution-unified rawframes.

    Returns the COCO-VID `videos` entry (+ 'gazes' staging key).
    """
    import cv2
    vdir = osp.join(out_dir, str(vid_id))
    os.makedirs(vdir, exist_ok=True)
    first = cv2.imread(osp.join(ori_root, frames[0].rel_path))
    if first is None:
        raise FileNotFoundError(frames[0].rel_path)
    height, width = first.shape[:2]
    file_names = []
    gazes = []
    for i, fr in enumerate(frames):
        img = first if i == 0 else cv2.imread(osp.join(ori_root, fr.rel_path))
        if img is None:
            raise FileNotFoundError(fr.rel_path)
        if img.shape[:2] != (height, width):
            img = cv2.resize(img, (width, height))
        rel = f'{vid_id}/{i:05d}.png'
        cv2.imwrite(osp.join(out_dir, rel), img)
        file_names.append(rel)
        gazes.append(list(fr.gaze))
    return dict(height=height, width=width, length=len(frames),
                file_names=file_names, id=vid_id, gazes=gazes)


def build_coco_vid_json(video_entries: Sequence[dict]) -> dict:
    """Assemble the annotation JSON (schema: reference converter :27-58)."""
    videos, annotations = [], []
    for v in video_entries:
        gazes = v.pop('gazes')
        videos.append(dict(v))
        annotations.append(dict(height=v['height'], width=v['width'],
                                length=1, category_id=1, gaze=gazes,
                                video_id=v['id'], id=v['id']))
    return {
        'info': {'description': 'converted_gaze360 (mcgaze_tpu)',
                 'version': '1',
                 'date_created': time.strftime('%Y-%m-%d %H:%M:%S')},
        'licenses': 'only for research',
        'videos': videos,
        'categories': [{'supercategory': 'object', 'id': 1,
                        'name': 'person_face'}],
        'annotations': annotations,
    }


def prepare_split(ori_dataset_root: str, split_txt: str, out_root: str,
                  split: str, setting: str = 'gaze360',
                  metadata_mat: str | None = None, workers: int = 16,
                  write_json: bool = True) -> dict:
    """Full pipeline for one (setting, split): rawframes + JSON.

    Returns the JSON dict (also written to
    <out_root>/annotations/<split>.json when write_json).
    """
    assert setting in SETTINGS, setting
    drop = setting == 'l2cs'
    bbox_index = None
    if drop:
        if metadata_mat is None:
            raise ValueError('l2cs setting requires metadata.mat '
                             '(person_face_bbox)')
        bbox_index = load_face_bbox_index(metadata_mat)
    records = resolve_records(parse_split_txt(split_txt), bbox_index)
    videos = segment_videos(records, drop_undetectable=drop)
    out_dir = osp.join(out_root, f'{split}_rawframes')
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        entries = list(pool.map(
            lambda iv: _write_video(iv[0] + 1, iv[1], ori_dataset_root,
                                    out_dir),
            enumerate(videos)))
    data = build_coco_vid_json(entries)
    if write_json:
        jdir = osp.join(out_root, 'annotations')
        os.makedirs(jdir, exist_ok=True)
        with open(osp.join(jdir, f'{split}.json'), 'w') as f:
            json.dump(data, f)
    return data
