"""InstBlink video inference and evaluation with the port: counterpart of
tools/test_instblink.py.

    python -m mcgaze_tpu_torch.tools.test_instblink <config> <ckpt.pth>
        [--out results.json] [--eval] [--max-videos N]
        [--device cuda|cpu] [--cfg-options a.b=v ...]
    python -m mcgaze_tpu_torch.tools.test_instblink <config>
        --eval-only results.json

Per video of the config's data_test: windows, the forward with top-k
tracks on the device, FaceLinker linking across windows
(evaluation/instblink_driver.py); frames are decoded by the native C++
loader (cv2 where it cannot be built) in a background thread. --eval scores
the tracks with the MPEblink track AP and blink action AP
(evaluation/track_eval.py), or the track AP alone for a config without
blinks. --eval-only re-scores a saved results file without a checkpoint or
a card. The checkpoint is a torch .pth: a reference InstBlink checkpoint or
the port's ckpt_<step>.pth. --device defaults to the card and refuses
without one. One process; its videos round-robin over the visible cards
(evaluation/driver.py::eval_devices), as the JAX CLI's over its devices.
"""
from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out', default=None, help='results JSON path')
    p.add_argument('--eval', action='store_true',
                   help='score tracks (+blinks) against the ann_file GT')
    p.add_argument('--eval-only', default=None, metavar='RESULTS_JSON',
                   help='re-score a saved results JSON, no inference')
    p.add_argument('--max-videos', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None,
                   help="config overrides 'a.b=val'")
    args = p.parse_args(argv)
    if args.eval_only is None and args.checkpoint is None:
        p.error('checkpoint is required unless --eval-only is given')
    return args


def gt_tracks_from_api(api, with_blinks):
    """GT maps for evaluation/track_eval.py from a COCO-VID annotation."""
    gt_by_vid_cat, blink_events = {}, {}
    for vid_id in api.get_vid_ids():
        for ann in api.anns_of_video(vid_id):
            key = (vid_id, ann['category_id'])
            gt_by_vid_cat.setdefault(key, []).append(
                dict(id=ann['id'], track=ann['bboxes']))
            if with_blinks and 'blinks' in ann:
                blink_events[ann['id']] = [tuple(e) for e in ann['blinks']]
    return gt_by_vid_cat, blink_events


def score_results(results, api, with_blinks) -> dict:
    """Score a results list against the annotation GT, print the APs as the
    JAX CLI does and return them: track mAP, AP50, AP75, AR and, with
    blinks, blink_ap (mean over tIoU .5:.95 at instance IoU .5) and
    blink_ap50."""
    from ..evaluation.track_eval import evaluate_tracks, mpeblink_blink_ap
    gt_by_vid_cat, gt_blinks = gt_tracks_from_api(api, with_blinks)
    dt_by_vid_cat, dt_blinks = {}, {}
    for di, r in enumerate(results):
        key = (r['video_id'], r['category_id'])
        dt_by_vid_cat.setdefault(key, []).append(
            dict(id=di + 1, score=r['score'], track=r['bboxes']))
        dt_blinks[di + 1] = [tuple(e) for e in r.get('blinks_converted', [])]
    metrics = {}
    if with_blinks and gt_blinks:
        res = mpeblink_blink_ap(gt_by_vid_cat, dt_by_vid_cat, gt_blinks,
                                dt_blinks)
        tr = res['track']
        blink_at_50 = res[0.5]
        metrics.update(blink_ap=float(blink_at_50.mean()),
                       blink_ap50=float(blink_at_50[0]))
    else:
        tr = evaluate_tracks(gt_by_vid_cat, dt_by_vid_cat)
    metrics.update({k: tr[k] for k in ('mAP', 'AP50', 'AP75', 'AR')})
    print(f"track mAP {tr['mAP']:.4f}  AP50 {tr['AP50']:.4f}  "
          f"AP75 {tr['AP75']:.4f}  AR {tr['AR']:.4f}")
    if 'blink_ap' in metrics:
        print(f"blink action AP@[tIoU .5:.95] (inst IoU .5): "
              f"{metrics['blink_ap']:.4f}  AP@.5 {metrics['blink_ap50']:.4f}")
    return metrics


def build_forward(cfg, checkpoint: str, device='cuda'):
    """InstBlinkVideoEvaluator's forward_fn for cfg.model holding the .pth
    checkpoint's weights, on `device`."""
    import torch

    from ..evaluation.forward import bind_query_forward, make_query_eval_forward
    from ..models.query_detector import QueryDetector
    from ..utils.checkpoint import require_pth
    from ..utils.convert import clean_reference_query_state_dict
    from ..utils.env import resolve_device

    device = resolve_device(device)
    require_pth(checkpoint)
    # a reference checkpoint's meta holds more than tensors
    ckpt = torch.load(checkpoint, map_location='cpu', weights_only=False)
    model = QueryDetector(cfg.model)
    model.load_state_dict(clean_reference_query_state_dict(
        ckpt.get('state_dict', ckpt)), strict=True)
    model = model.to(device).eval()
    fwd, fwd_batched = make_query_eval_forward(model, cfg.model)
    return bind_query_forward(fwd, fwd_batched, device)


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(results, path, frames, seconds, metrics,
    evaluator); --eval-only returns dict(metrics)."""
    args = parse_args(argv)
    from ..data.coco_vid import CocoVid
    from ..utils.cfg_options import apply_overrides
    from ..utils.query_config import load_query_config

    cfg = apply_overrides(load_query_config(args.config), args.cfg_options)
    if args.eval_only:
        with open(args.eval_only) as f:
            results = json.load(f)
        return dict(metrics=score_results(
            results, CocoVid(cfg.data_test.ann_file),
            cfg.data_test.with_blinks))

    from ..data.instblink_dataset import InstBlinkClipDataset
    from ..evaluation.instblink_driver import InstBlinkVideoEvaluator

    forward = build_forward(cfg, args.checkpoint, args.device)
    ds = InstBlinkClipDataset(cfg.data_test)
    evaluator = InstBlinkVideoEvaluator(forward, cfg.eval_cfg,
                                        data_cfg=cfg.data_test)
    vids = ds.api.get_vid_ids()
    if args.max_videos:
        vids = vids[:args.max_videos]
    results = []
    total_frames = 0
    t0 = time.time()
    stream = evaluator.run_videos_from_paths(
        (vid_id, ds.video_paths(vid_id)) for vid_id in vids)
    for vid_id, tracks in zip(vids, stream):
        results.extend(tracks)
        total_frames += len(ds.video_paths(vid_id))
        print(f'video {vid_id}: {len(results)} tracks total, '
              f'{total_frames / (time.time() - t0):.1f} frames/s')
    seconds = time.time() - t0

    out_path = args.out or 'results_instblink.json'
    with open(out_path, 'w') as f:
        json.dump(results, f)
    print(f'wrote {out_path} ({len(results)} tracks)')
    metrics = (score_results(results, ds.api, cfg.data_test.with_blinks)
               if args.eval else None)
    return dict(results=results, path=out_path, frames=total_frames,
                seconds=seconds, metrics=metrics, evaluator=evaluator)


if __name__ == '__main__':
    main()
