"""COCO-VID (YouTubeVIS-style) video-annotation API, counterpart of
mcgaze_tpu/data/coco_vid.py (pure Python, the same surface): indexes
videos, per-video instance tracks and categories, with the cocoapi-style
queries (getAnnIds / getVidIds / getCatIds / loadAnns / loadVids /
loadCats) and the helpers the clip dataset uses (anns_of_video,
load_vid).

json layout:
  videos:      [{id, width, height, length, file_names: [...]}]
  annotations: [{id, video_id, category_id, bboxes: [xywh|None per frame],
                 gaze: [[x,y,z]|[yaw,pitch]|None per frame], ...}]
  categories:  [{id, name, supercategory?}]
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Iterable, List, Optional, Union

IdOrIds = Union[int, Iterable[int], None]


def _as_list(x: IdOrIds) -> Optional[List[int]]:
    if x is None:
        return None
    if isinstance(x, int):
        return [x]
    out = list(x)
    return out if out else None


class CocoVid:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            self.dataset = json.load(f)
        self.vids = {v['id']: v for v in self.dataset.get('videos', [])}
        self.anns = {a['id']: a for a in self.dataset.get('annotations', [])}
        self.cats = {c['id']: c for c in self.dataset.get('categories', [])}
        self.vid_to_anns = defaultdict(list)
        for a in self.dataset.get('annotations', []):
            self.vid_to_anns[a['video_id']].append(a)
        for v in self.vid_to_anns.values():
            v.sort(key=lambda a: a['id'])
        self.cat_to_vids = defaultdict(set)
        for a in self.dataset.get('annotations', []):
            self.cat_to_vids[a.get('category_id')].add(a['video_id'])

    # ---- cocoapi-style query surface (reference mpeblink_api.py:42-130)

    def getAnnIds(self, vidIds: IdOrIds = None, catIds: IdOrIds = None
                  ) -> List[int]:
        """Annotation ids filtered by video and/or category, sorted."""
        vid_ids, cat_ids = _as_list(vidIds), _as_list(catIds)
        if vid_ids is None:
            anns = self.dataset.get('annotations', [])
        else:
            anns = [a for v in vid_ids for a in self.vid_to_anns[v]]
        if cat_ids is not None:
            cat_set = set(cat_ids)
            anns = [a for a in anns if a.get('category_id') in cat_set]
        return sorted(a['id'] for a in anns)

    def getVidIds(self, vidIds: IdOrIds = None, catIds: IdOrIds = None
                  ) -> List[int]:
        """Video ids, optionally intersected with the given ids and
        restricted to videos containing the given categories."""
        ids = set(self.vids)
        vid_ids, cat_ids = _as_list(vidIds), _as_list(catIds)
        if vid_ids is not None:
            ids &= set(vid_ids)
        for c in cat_ids or []:
            ids &= self.cat_to_vids[c]
        return sorted(ids)

    def getCatIds(self, catNms: Iterable[str] | None = None,
                  catIds: IdOrIds = None) -> List[int]:
        cats = self.dataset.get('categories', [])
        if catNms:
            names = set(catNms)
            cats = [c for c in cats if c.get('name') in names]
        cat_ids = _as_list(catIds)
        if cat_ids is not None:
            cats = [c for c in cats if c['id'] in set(cat_ids)]
        return sorted(c['id'] for c in cats)

    def loadAnns(self, ids: IdOrIds = None) -> List[dict]:
        if isinstance(ids, int):
            return [self.anns[ids]]
        return [self.anns[i] for i in (ids if ids is not None
                                       else sorted(self.anns))]

    def loadVids(self, ids: IdOrIds = None) -> List[dict]:
        if isinstance(ids, int):
            return [self.vids[ids]]
        return [self.vids[i] for i in (ids if ids is not None
                                       else sorted(self.vids))]

    def loadCats(self, ids: IdOrIds = None) -> List[dict]:
        if isinstance(ids, int):
            return [self.cats[ids]]
        return [self.cats[i] for i in (ids if ids is not None
                                       else sorted(self.cats))]

    # ---- direct helpers used by the clip dataset

    def get_vid_ids(self):
        return sorted(self.vids)

    def get_cat_ids(self):
        return sorted(self.cats)

    def load_vid(self, vid_id: int) -> dict:
        return self.vids[vid_id]

    def anns_of_video(self, vid_id: int) -> list:
        """Per-instance annotation tracks of a video, ordered by ann id
        (face, eyes, head instance order relies on this, matching the
        reference's getAnnIds ordering consumed by gaze_fixed_assigner)."""
        return self.vid_to_anns[vid_id]
