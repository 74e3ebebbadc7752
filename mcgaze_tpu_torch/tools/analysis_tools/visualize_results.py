"""Draw a results JSON (tools/test_gaze360_gaze.py's output) onto the
rawframes, counterpart of tools/analysis_tools/visualize_results.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.visualize_results \\
        --results R.json --anno A.json --root FRAMES/ --out DIR
        [--videos 5] [--mp4]

Per frame the face, eyes and head boxes with their scores (those at or
above SCORE_THRESHOLD), then the fusion gaze arrow from the head box's
centre; annotated PNGs per video and, with --mp4, an .mp4. Reading,
drawing and encoding need OpenCV, imported inside main; it runs on the
CPU and touches no device.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp

CLUE_COLORS = {'face': (0, 200, 255), 'eyes': (0, 255, 0),
               'head': (255, 80, 80)}                       # BGR
SCORE_THRESHOLD = 0.5


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--results', required=True)
    p.add_argument('--anno', required=True)
    p.add_argument('--root', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--videos', type=int, default=5,
                   help='first N videos (0 = all)')
    p.add_argument('--mp4', action='store_true',
                   help='also encode an .mp4 per video')
    return p.parse_args(argv)


def draw_frame(img, res, t):
    import cv2
    for clue, color in CLUE_COLORS.items():
        box = res[f'{clue}_bboxes'][t]
        score = res[f'{clue}_score'][t]
        if box is None or score < SCORE_THRESHOLD:
            continue
        x, y, w, h = (int(round(v)) for v in box)
        cv2.rectangle(img, (x, y), (x + w, y + h), color, 1)
        cv2.putText(img, f'{clue} {score:.2f}', (x, max(y - 2, 10)),
                    cv2.FONT_HERSHEY_PLAIN, 0.9, color, 1)
    head = res['head_bboxes'][t]
    if head is not None:
        gx, gy, _gz = res['fusion_gazes'][t]
        cx = int(round(head[0] + head[2] / 2))
        cy = int(round(head[1] + head[3] / 2))
        ln = 0.6 * head[2]
        # drawn along (-gx, -gy), the reference's rendering convention
        cv2.arrowedLine(img, (cx, cy),
                        (int(round(cx - ln * gx)),
                         int(round(cy - ln * gy))),
                        (255, 255, 0), 2)
    return img


def main(argv=None):
    args = parse_args(argv)
    import cv2

    with open(args.results) as f:
        results = json.load(f)
    with open(args.anno) as f:
        anno = json.load(f)
    videos = {v['id']: v for v in anno['videos']}
    by_vid = {r['video_id']: r for r in results}
    todo = list(by_vid)[:args.videos] if args.videos else list(by_vid)
    for vid in todo:
        res, video = by_vid[vid], videos[vid]
        d = osp.join(args.out, str(vid))
        os.makedirs(d, exist_ok=True)
        writer = None
        for t, name in enumerate(video['file_names']):
            img = cv2.imread(osp.join(args.root, name))
            if img is None:
                raise FileNotFoundError(osp.join(args.root, name))
            img = draw_frame(img, res, t)
            cv2.imwrite(osp.join(d, f'{t:05d}.png'), img)
            if args.mp4:
                if writer is None:
                    writer = cv2.VideoWriter(
                        osp.join(args.out, f'{vid}.mp4'),
                        cv2.VideoWriter_fourcc(*'mp4v'), 24,
                        (img.shape[1], img.shape[0]))
                writer.write(img)
        if writer is not None:
            writer.release()
        print(f'wrote {d} ({len(video["file_names"])} frames)')


if __name__ == '__main__':
    main()
