"""RT-GENE raw-dataset conversion to the MCGaze COCO-VID layout; the
port's copy of mcgaze_tpu/data/rtgene_prepare.py (numpy only; that
package's __init__ imports JAX, so the port keeps its own). Both write the
same files and the same JSON.

Rebuilds the reference one-shot script
``tools/dataset_converters/rtgene/convert.py`` (zgchen33/MCGaze) as a
reusable engine with a *pluggable face detector*: the reference
hard-codes facenet_pytorch's MTCNN on CUDA (convert.py:4,35), an optional
package the port does not need; detection is an injected callable (or a
precomputed-detections JSON at the CLI), keeping the deterministic
conversion math exactly the reference's.

Behavioral spec (matching convert.py, cited by line):
  * six outputs over the 3-fold subject protocol: train{1,2,3}.json /
    test{1,2,3}.json with the fixed subject lists (:11-20).
  * per subject ``sXXX_glasses``: labels from ``label_combined.txt``
    parsed by re.split('[| |,|]'), gaze = (token 9, token 11) =
    (phi/yaw, theta/pitch) (:48-56); frames from
    ``inpainted/face_after_inpainting`` sorted by name (:70-71),
    matched to labels via ``str(int(name[:6]))`` (:77-78).
  * every frame is resized to 112x112 BEFORE detection (:75-76), so
    all emitted boxes live in 112px coordinates; frames with no label
    or no detection are skipped (:77-85).
  * 3D gaze = (-cos(theta)sin(phi), -sin(theta), -cos(theta)cos(phi))
    (:22-26).
  * boxes (all int-truncated, xywh): face = detector box xyxy->xywh
    (:89-90); eyes = [lm0.x-30, min(lm0.y, lm1.y)-18,
    lm1.x-lm0.x+60, 36] from the two eye landmarks (:91-94);
    head = [0, 0, 224, 224] (:88) — note the reference records
    224x224 video dims and head box although the stored frames are
    112x112; replicated verbatim for checkpoint/eval compatibility.
  * output frames ``<int(subject)>/%06d.png`` renumbered from 0 (:105);
    videos[{height:224, width:224, length, file_names, id}] (:112);
    per video THREE single-person tracks sharing the gaze list:
    category 1 = face, 2 = eye, 3 = head boxes (:116-131), annotation
    ids sequential from 1 within each fold file (:37); categories
    [person_face, eye, head] (:37-39).

The emitted JSON is the 3-boxes-per-frame convention consumed by
``data/dataset.py`` / FixedAssigner (one gaze category per clue).
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

TEST_FOLDS = {
    1: ('s001', 's002', 's008', 's010'),
    2: ('s003', 's004', 's007', 's009'),
    3: ('s005', 's006', 's011', 's012', 's013'),
}
TRAIN_FOLDS = {          # train_k = the other two test folds (:16-18)
    1: TEST_FOLDS[3] + TEST_FOLDS[2],
    2: TEST_FOLDS[1] + TEST_FOLDS[3],
    3: TEST_FOLDS[1] + TEST_FOLDS[2],
}
CATEGORIES = [
    {'supercategory': 'object', 'id': 1, 'name': 'person_face'},
    {'supercategory': 'object', 'id': 2, 'name': 'eye'},
    {'supercategory': 'object', 'id': 3, 'name': 'head'},
]
FACE_SIZE = 112          # detection+storage resolution (:75-76)
HEAD_BOX = [0, 0, 224, 224]

# detector: BGR uint8 (112,112,3) -> (face_xyxy (4,), landmarks (5,2))
# or None when no face is found. Landmarks rows 0/1 = left/right eye
# centers (the MTCNN convention the eye-box formula assumes).
DetectFn = Callable[[np.ndarray], Optional[Tuple[np.ndarray, np.ndarray]]]


def gaze_to_3d(phi: float, theta: float) -> List[float]:
    """RT-GENE (phi, theta) -> unit-ish 3D gaze (convert.py:22-26)."""
    return [float(-np.cos(theta) * np.sin(phi)),
            float(-np.sin(theta)),
            float(-np.cos(theta) * np.cos(phi))]


def parse_labels(path: str) -> Dict[str, List[float]]:
    """frame-id string -> 3D gaze, from label_combined.txt (:48-56)."""
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            tok = re.split(r'\[| |,|\]', line.strip())
            if len(tok) < 12 or not tok[0]:
                continue
            out[tok[0]] = gaze_to_3d(float(tok[9]), float(tok[11]))
    return out


def eye_box_from_landmarks(lm: np.ndarray) -> List[int]:
    """Eye-strip xywh from the two eye-center landmarks (:91-94)."""
    return [int(lm[0, 0] - 30), int(min(lm[0, 1], lm[1, 1]) - 18),
            int(lm[1, 0] - lm[0, 0] + 60), 36]


def face_box_xywh(xyxy: Sequence[float]) -> List[int]:
    return [int(xyxy[0]), int(xyxy[1]),
            int(xyxy[2] - xyxy[0]), int(xyxy[3] - xyxy[1])]


@dataclasses.dataclass
class FoldStats:
    videos: int = 0
    frames: int = 0
    skipped: int = 0


def detections_from_json(path: str) -> DetectFn:
    """Precomputed detections: {'<subject>/<frame-id>':
    {'box': [x1,y1,x2,y2], 'landmarks': [[x,y]x5]}}; the returned fn
    closes over a (subject, frame) cursor set by convert_fold."""
    with open(path) as f:
        table = json.load(f)

    def fn(img):
        rec = table.get(fn.key)           # type: ignore[attr-defined]
        if rec is None:
            return None
        return (np.asarray(rec['box'], np.float32),
                np.asarray(rec['landmarks'], np.float32))
    fn.key = ''                           # type: ignore[attr-defined]
    return fn


def mtcnn_detector() -> DetectFn:
    """The reference's detector, if facenet_pytorch is installed."""
    from facenet_pytorch import MTCNN     # pragma: no cover
    det = MTCNN()

    def fn(img):                          # pragma: no cover
        boxes, score, lms = det.detect(img, landmarks=True)
        if boxes is None or score[0] is None or len(boxes[0]) == 0:
            return None
        return np.asarray(boxes[0]), np.asarray(lms[0])
    return fn


def convert_fold(root: str, out: str, subjects: Sequence[str],
                 json_name: str, detect: DetectFn) -> FoldStats:
    """One fold file: iterate subjects, detect, write frames + JSON."""
    import cv2
    stats = FoldStats()
    videos, annotations = [], []
    anno_id, vid = 1, 1
    for subj in subjects:
        sdir = osp.join(root, subj + '_glasses')
        labels = parse_labels(osp.join(sdir, 'label_combined.txt'))
        frame_dir = osp.join(sdir, 'inpainted', 'face_after_inpainting')
        out_dir = osp.join(out, str(int(subj[1:4])))
        os.makedirs(out_dir, exist_ok=True)
        file_names, gazes = [], []
        face_boxes, eye_boxes, head_boxes = [], [], []
        frame_id = 0
        for frame in sorted(os.listdir(frame_dir)):
            key = str(int(frame[:6]))
            if key not in labels:
                stats.skipped += 1
                continue
            img = cv2.imread(osp.join(frame_dir, frame))
            img = cv2.resize(img, (FACE_SIZE, FACE_SIZE))
            if hasattr(detect, 'key'):
                detect.key = f'{subj}/{key}'   # type: ignore[attr-defined]
            det = detect(img)
            if det is None:
                stats.skipped += 1
                continue
            box_xyxy, lms = det
            gazes.append(labels[key])
            face_boxes.append(face_box_xywh(box_xyxy))
            eye_boxes.append(eye_box_from_landmarks(np.asarray(lms)))
            head_boxes.append(list(HEAD_BOX))
            rel = osp.join(str(int(subj[1:4])),
                           str(frame_id).rjust(6, '0') + '.png')
            cv2.imwrite(osp.join(out, rel), img)
            file_names.append(rel)
            frame_id += 1
        videos.append({'height': 224, 'width': 224,
                       'length': len(file_names),
                       'file_names': file_names, 'id': vid})
        stats.videos += 1
        stats.frames += len(file_names)
        for cat, boxes in ((1, face_boxes), (2, eye_boxes),
                           (3, head_boxes)):
            annotations.append({'category_id': cat, 'gaze': gazes,
                                'bboxes': boxes, 'video_id': vid,
                                'id': anno_id})
            anno_id += 1
        vid += 1
    ann_dir = osp.join(out, 'annotations')
    os.makedirs(ann_dir, exist_ok=True)
    with open(osp.join(ann_dir, json_name), 'w') as f:
        json.dump({'categories': CATEGORIES, 'videos': videos,
                   'annotations': annotations}, f)
    return stats


def convert(root: str, out: str, detect: DetectFn,
            folds: Sequence[str] = ('train1', 'train2', 'train3',
                                    'test1', 'test2', 'test3'),
            ) -> Dict[str, FoldStats]:
    """Run the requested fold files (reference order :19-20, :28)."""
    stats = {}
    for fold in folds:
        split, k = fold[:-1], int(fold[-1])
        table = TRAIN_FOLDS if split == 'train' else TEST_FOLDS
        stats[fold] = convert_fold(root, out, table[k],
                                   f'{fold}.json', detect)
    return stats
