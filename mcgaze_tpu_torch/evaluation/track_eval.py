"""Track AP and the MPEblink blink action AP, the port's numpy copy of
mcgaze_tpu/evaluation/track_eval.py (the rebuild of the reference's
mmdet/datasets/mpeblink_eval_api.py, a YouTubeVIS cocoeval fork):

  * spatio-temporal track IoU: per-frame intersections and unions summed
    over the video; a frame where only one side has a box adds its area to
    the union;
  * per-video greedy matching at IoU 0.5:0.95 in descending score order,
    101-point interpolated precision per category;
  * blink action AP: at each instance-IoU threshold, the GT tracks a
    detection matched pair their blink events with that detection's
    converted events, then ActivityNet-style temporal AP at tIoU
    0.5:0.95;
  * `blinks_to_events`: maximal runs of probability >= threshold become
    one event (start, end) inclusive, scored by the run's mean.

Host numpy, as in the reference; the device's work ends at the per-frame
blink probabilities.
"""
from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


def _frame_iou_parts(d, g):
    """Intersection and union of two xywh boxes (reference :228-258)."""
    lx = max(d[0], g[0])
    rx = min(d[0] + d[2], g[0] + g[2])
    ty = max(d[1], g[1])
    by = min(d[1] + d[3], g[1] + g[3])
    inter = 0.0 if (lx >= rx or by <= ty) else (by - ty) * (rx - lx)
    union = d[2] * d[3] + g[2] * g[3] - inter
    return inter, union


def iou_seq(d_seq, g_seq) -> float:
    """Spatio-temporal IoU of two tracks of per-frame xywh-or-None boxes
    (reference :207-227): absent-on-one-side frames count their present
    box's area as union only."""
    i = u = 0.0
    for d, g in zip(d_seq, g_seq):
        if d and g:
            fi, fu = _frame_iou_parts(d, g)
            i += fi
            u += fu
        elif g:
            u += g[2] * g[3]
        elif d:
            u += d[2] * d[3]
    return i / u if u > 0 else 0.0


def _match_video(gt_tracks, dt_tracks, iou_thrs):
    """cocoeval greedy matching for one (video, category).

    gt_tracks / dt_tracks: lists of dicts with 'track' ([xywh|None]*F),
    'id', and for dt 'score'. Returns (dtm, gtm, dt_scores) where
    dtm/gtm (T, D)/(T, G) hold matched counterpart ids (0 = unmatched).
    """
    dt = sorted(dt_tracks, key=lambda d: -d['score'])
    g = len(gt_tracks)
    d = len(dt)
    ious = np.zeros((d, g))
    for di in range(d):
        for gi in range(g):
            ious[di, gi] = iou_seq(dt[di]['track'], gt_tracks[gi]['track'])
    t = len(iou_thrs)
    dtm = np.zeros((t, d))
    gtm = np.zeros((t, g))
    for ti, thr in enumerate(iou_thrs):
        for di in range(d):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(g):
                if gtm[ti, gi] > 0:
                    continue
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m >= 0:
                dtm[ti, di] = gt_tracks[m]['id']
                gtm[ti, m] = dt[di]['id']
    return dtm, gtm, np.asarray([x['score'] for x in dt])


def evaluate_tracks(gt_by_vid_cat: dict, dt_by_vid_cat: dict,
                    iou_thrs=IOU_THRS, rec_thrs=REC_THRS,
                    max_det: int = 100):
    """Track AP over {(vid, cat): [track dicts]} maps.

    cocoeval accumulation semantics (reference :385-520): one PR curve
    per CATEGORY (detections pooled over videos, mergesort by score,
    101-point interpolation), mAP = mean over categories that have GT;
    per-video detections truncated to max_det by score.

    Returns dict(mAP, AP50, AP75, AR, per_thr_gt_matches) where
    per_thr_gt_matches[ti] maps gt id -> matched dt id (for the blink
    action-AP pairing, reference :423-446).
    """
    keys = sorted(set(gt_by_vid_cat) | set(dt_by_vid_cat))
    cats = sorted({k[1] for k in keys})
    t = len(iou_thrs)
    gt_matches = [dict() for _ in range(t)]
    per_cat_prec, per_cat_rec = [], []
    for cat in cats:
        all_scores, all_tp = [], []
        npig = 0
        for key in [k for k in keys if k[1] == cat]:
            gts = gt_by_vid_cat.get(key, [])
            dts = sorted(dt_by_vid_cat.get(key, []),
                         key=lambda d: -d['score'])[:max_det]
            npig += len(gts)
            if not dts:
                continue
            dtm, gtm, scores = _match_video(gts, dts, iou_thrs)
            all_scores.append(scores)
            all_tp.append(dtm > 0)
            for ti in range(t):
                for gi, gt in enumerate(gts):
                    if gtm[ti, gi] > 0:
                        gt_matches[ti][gt['id']] = int(gtm[ti, gi])
        if npig == 0:
            continue          # cocoeval: precision = -1, excluded from mean
        if not all_scores:
            per_cat_prec.append(np.zeros((t, len(rec_thrs))))
            per_cat_rec.append(np.zeros((t,)))
            continue
        scores = np.concatenate(all_scores)
        tps = np.concatenate(all_tp, axis=1)
        order = np.argsort(-scores, kind='mergesort')
        tps = tps[:, order]
        precision = np.zeros((t, len(rec_thrs)))
        recall = np.zeros((t,))
        for ti in range(t):
            tp = np.cumsum(tps[ti])
            fp = np.cumsum(~tps[ti])
            rc = tp / npig
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            recall[ti] = rc[-1] if len(rc) else 0.0
            pr = pr.tolist()
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, rec_thrs, side='left')
            q = np.zeros(len(rec_thrs))
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precision[ti] = q
        per_cat_prec.append(precision)
        per_cat_rec.append(recall)
    if not per_cat_prec:
        return dict(mAP=0.0, AP50=0.0, AP75=0.0, AR=0.0,
                    per_thr_gt_matches=gt_matches)
    prec = np.stack(per_cat_prec)       # (K, T, R)
    rec = np.stack(per_cat_rec)         # (K, T)
    return dict(
        mAP=float(prec.mean()),
        AP50=float(prec[:, 0].mean()),
        AP75=float(prec[:, 5].mean()),
        AR=float(rec.mean()),
        per_thr_gt_matches=gt_matches,
    )


def segment_iou(target, candidates: np.ndarray) -> np.ndarray:
    """Temporal IoU of one [t0, t1] segment vs (N, 2) candidates
    (reference :634-666)."""
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = np.clip(tt2 - tt1, 0, None)
    union = ((candidates[:, 1] - candidates[:, 0])
             + (target[1] - target[0]) - inter)
    return inter.astype(float) / np.maximum(union, np.spacing(1))


def interpolated_prec_rec(prec, rec) -> float:
    """Pascal-VOC interpolated AP (reference :667-675)."""
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def action_ap(gt_events, dt_events,
              tiou_thresholds=IOU_THRS) -> np.ndarray:
    """ActivityNet-style temporal AP (reference :554-632).

    gt_events: [(track_id, t0, t1)]; dt_events: [(track_id, t0, t1,
    score)]. Returns per-tIoU AP array.
    """
    ap = np.zeros(len(tiou_thresholds))
    npos = float(len(gt_events))
    if npos == 0:
        return ap
    gt_by_track = {}
    for gi, (tid, t0, t1) in enumerate(gt_events):
        gt_by_track.setdefault(tid, []).append((gi, t0, t1))
    dt = sorted(dt_events, key=lambda e: -e[3])
    lock = -np.ones((len(tiou_thresholds), len(gt_events)))
    tp = np.zeros((len(tiou_thresholds), len(dt)))
    fp = np.zeros((len(tiou_thresholds), len(dt)))
    for di, (tid, t0, t1, _score) in enumerate(dt):
        cands = gt_by_track.get(tid)
        if not cands:
            fp[:, di] = 1
            continue
        seg = np.asarray([(c[1], c[2]) for c in cands], float)
        tious = segment_iou((t0, t1), seg)
        order = tious.argsort()[::-1]
        for ti, thr in enumerate(tiou_thresholds):
            for j in order:
                if tious[j] < thr:
                    fp[ti, di] = 1
                    break
                if lock[ti, cands[j][0]] >= 0:
                    continue
                tp[ti, di] = 1
                lock[ti, cands[j][0]] = di
                break
            if fp[ti, di] == 0 and tp[ti, di] == 0:
                fp[ti, di] = 1
    tp_c = np.cumsum(tp, axis=1)
    fp_c = np.cumsum(fp, axis=1)
    rec = tp_c / npos
    prec = tp_c / np.maximum(tp_c + fp_c, np.spacing(1))
    for ti in range(len(tiou_thresholds)):
        ap[ti] = interpolated_prec_rec(prec[ti], rec[ti])
    return ap


def blinks_to_events(probs, threshold: float = 0.5):
    """Per-frame blink probabilities -> [(start, end, score)] events,
    end-inclusive (the GT `blinks` convention); score = run mean.
    See module docstring — the reference's converter is upstream-only.
    """
    probs = np.asarray(probs, float)
    above = probs >= threshold
    events = []
    start = None
    for f, a in enumerate(above):
        if a and start is None:
            start = f
        elif not a and start is not None:
            events.append((start, f - 1, float(probs[start:f].mean())))
            start = None
    if start is not None:
        events.append((start, len(probs) - 1,
                       float(probs[start:].mean())))
    return events


def mpeblink_blink_ap(gt_tracks_by_vid_cat, dt_tracks_by_vid_cat,
                      gt_blink_events: dict, dt_blink_events: dict,
                      iou_thrs=IOU_THRS):
    """The reference's two-stage blink metric (accumulate :423-446 +
    action_ap :520-552): at each instance-IoU threshold, pair the gt
    tracks
    that found a match with their matched detection's blink events, then
    temporal AP over the pairs.

    gt_blink_events: gt track id -> [(t0, t1)];
    dt_blink_events: dt track id -> [(t0, t1, score)].
    Returns {iou_thr: per-tIoU AP array}.
    """
    res = evaluate_tracks(gt_tracks_by_vid_cat, dt_tracks_by_vid_cat,
                          iou_thrs)
    out = {}
    for ti, thr in enumerate(iou_thrs):
        gt_ev, dt_ev = [], []
        for gt_id, dt_id in res['per_thr_gt_matches'][ti].items():
            for (t0, t1) in gt_blink_events.get(gt_id, []):
                gt_ev.append((gt_id, t0, t1))
            for (t0, t1, s) in dt_blink_events.get(dt_id, []):
                dt_ev.append((gt_id, t0, t1, s))
        out[float(thr)] = action_ap(gt_ev, dt_ev)
    out['track'] = {k: v for k, v in res.items()
                    if k != 'per_thr_gt_matches'}
    return out
