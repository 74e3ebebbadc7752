"""Generic test entry with the port, counterpart of tools/test.py:

    python -m mcgaze_tpu_torch.tools.test <config> [ckpt.pth] [--json J]
        [--root R] [--out results.json] [--eval mae] [--l2cs]
        [--clip-batch 8] [--max-videos N] [--dtype bfloat16] [--ema]
        [--device cuda|cpu] [--cfg-options a.b=v ...]

Runs the video eval of test_gaze360_gaze (same build_forward, same driver)
and, with --eval mae, scores the results inline
(evaluation/mae.py::evaluate_results; --l2cs for the l2cs GT layout), in
place of the two-step test_gaze360_gaze -> calculate_mae_gaze360 round
trip. Under a launcher (torchrun, parallel/distributed.py::init_distributed)
each process evaluates its rank-strided share of the videos on its own
card, the results are gathered in video order, and rank 0 writes and
scores them.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--json', default='data/gaze360/test.json',
                   help='COCO-VID annotation JSON')
    p.add_argument('--root', default='data/gaze360/test_rawframes/')
    p.add_argument('--out', default=None, help='results JSON path')
    p.add_argument('--eval', nargs='*', default=[], choices=['mae'],
                   help='metrics to compute inline')
    p.add_argument('--l2cs', action='store_true',
                   help='use the l2cs GT indexing for --eval mae')
    p.add_argument('--clip-batch', type=int, default=8)
    p.add_argument('--max-videos', type=int, default=0)
    p.add_argument('--dtype', default=None)
    p.add_argument('--ema', action='store_true',
                   help='evaluate the EMA weights of <ckpt>_train.pth '
                        '(reference EMAHook eval-swap semantics)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None,
                   help="config overrides 'a.b=val'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(results, metrics (None without --eval
    mae), seconds, evaluator); on ranks other than 0, results and metrics
    are None (rank 0 holds the gathered results)."""
    from ..parallel.distributed import (gather_objects, init_distributed,
                                        process_index,
                                        shard_across_processes)
    from .test_gaze360_gaze import build_evaluator, video_paths

    args = parse_args(argv)
    init_distributed(args.device)
    evaluator, _cfg, anno, videos = build_evaluator(args)
    t0 = time.time()
    # decode of the next video overlaps this one's forwards
    results = list(evaluator.run_videos_from_paths(
        video_paths(shard_across_processes(videos), args.root)))
    seconds = time.time() - t0
    results = gather_objects(results)
    if process_index() != 0:
        return dict(results=None, metrics=None, seconds=seconds,
                    evaluator=evaluator)

    if args.out:
        os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(results, f)
        print(f'wrote {args.out} ({len(results)} videos)')

    metrics = None
    if 'mae' in args.eval:
        from ..evaluation.mae import evaluate_results
        metrics = evaluate_results(results, anno, l2cs=args.l2cs)
        for k, v in metrics.items():
            print(f'{k}: {v:.4f}')
    return dict(results=results, metrics=metrics, seconds=seconds,
                evaluator=evaluator)


if __name__ == '__main__':
    main()
