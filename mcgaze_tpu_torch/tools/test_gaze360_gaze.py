"""Gaze video evaluation with the port, counterpart of
tools/test_gaze360_gaze.py:

    python -m mcgaze_tpu_torch.tools.test_gaze360_gaze <config> [ckpt.pth]
        [--json test.json] [--root rawframes/] [--out-dir results]
        [--clip-batch 8] [--max-videos N] [--ema] [--dtype bfloat16]
        [--device cuda|cpu] [--cfg-options a.b=v ...]

Writes `results_<config>_<json basename>` into --out-dir: one dict per
video (fusion gazes, per-clue boxes, gazes and scores), which
calculate_mae_gaze360 scores. The checkpoint is a torch .pth: a reference
mmdet checkpoint or the port's own ckpt_<step>.pth; without one the model
has seeded random weights. --ema evaluates the EMA copy that the train
CLI keeps in ckpt_<step>_train.pth. Videos are decoded by the native C++
loader (cv2 where it cannot be built) in a background thread while the
previous video computes. --device defaults to the card and refuses
without one.

Under a launcher (torchrun, parallel/distributed.py::init_distributed) each
process evaluates its rank-strided share of the videos on its own card;
the results are gathered in video order and rank 0 writes them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='torch .pth (reference or the port\'s ckpt_N.pth); '
                        'omit for seeded random weights')
    p.add_argument('--json', default='data/gaze360/test.json')
    p.add_argument('--root', default='data/gaze360/test_rawframes/')
    p.add_argument('--out-dir', default='results')
    p.add_argument('--clip-batch', type=int, default=8)
    p.add_argument('--max-videos', type=int, default=0)
    p.add_argument('--ema', action='store_true',
                   help='evaluate the EMA weights of <ckpt>_train.pth '
                        '(reference EMAHook eval-swap semantics)')
    p.add_argument('--dtype', default=None,
                   help='override the model dtype (e.g. bfloat16)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None,
                   help="config overrides 'a.b=val'")
    return p.parse_args(argv)


def load_weights(model, checkpoint: str, ema: bool = False) -> None:
    """A .pth into `model` with strict key matching; with ema, the `ema`
    entry of the checkpoint's _train file replaces every parameter (the
    buffers, BN statistics, stay the checkpoint's)."""
    import torch

    from ..utils.checkpoint import ema_weights, require_pth, train_path
    from ..utils.convert import clean_reference_state_dict

    require_pth(checkpoint)
    # a reference checkpoint's meta holds more than tensors, as the JAX
    # package's converter expects (weights_only=False)
    ckpt = torch.load(checkpoint, map_location='cpu', weights_only=False)
    sd = clean_reference_state_dict(ckpt.get('state_dict', ckpt))
    if ema:
        averaged = ema_weights(checkpoint)
        params = {n for n, _ in model.named_parameters()}
        if set(averaged) != params:
            raise SystemExit(
                f'{train_path(checkpoint)}: the ema keys are not the '
                'model\'s parameters '
                f'(missing {sorted(params - set(averaged))[:3]}, extra '
                f'{sorted(set(averaged) - params)[:3]})')
        sd.update(averaged)
    model.load_state_dict(sd, strict=True)


def build_forward(cfg, checkpoint, dtype=None, ema=False, device='cuda'):
    """The driver's forward_fn for cfg.model (dtype replaced by `dtype`)
    holding the checkpoint's weights (seeded random weights without one),
    on `device`."""
    from ..evaluation.forward import bind_forward, make_eval_forward
    from ..models.mcgaze import MCGazeModel, init_model
    from ..utils.env import resolve_device

    device = resolve_device(device)
    model_cfg = cfg.model
    if dtype:
        model_cfg = dataclasses.replace(model_cfg, dtype=dtype)
    if checkpoint:
        model = MCGazeModel(model_cfg)
        load_weights(model, checkpoint, ema)
        model = model.to(device).eval()
    elif ema:
        raise SystemExit('--ema needs a checkpoint')
    else:
        model = init_model(model_cfg, seed=0, device=device)
    _, fwd, fwd_dedup = make_eval_forward(model_cfg, device=device,
                                          model=model)
    return bind_forward(fwd, device, fwd_dedup)


def build_evaluator(args):
    """(evaluator, cfg, anno, videos) of parsed CLI args."""
    from ..evaluation.driver import VideoGazeEvaluator
    from ..utils.cfg_options import apply_overrides
    from ..utils.config import load_config

    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    eval_cfg = dataclasses.replace(cfg.eval_cfg, clip_batch=args.clip_batch)
    forward = build_forward(cfg, args.checkpoint, args.dtype, ema=args.ema,
                            device=args.device)
    with open(args.json) as f:
        anno = json.load(f)
    videos = anno['videos']
    if args.max_videos:
        videos = videos[:args.max_videos]
    return VideoGazeEvaluator(forward, eval_cfg), cfg, anno, videos


def video_paths(videos, root):
    """(video_id, frame paths) per video, for run_videos_from_paths."""
    return ((v['id'], [osp.join(root, name) for name in v['file_names']])
            for v in videos)


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(results, path, frames, seconds,
    evaluator); on ranks other than 0, results and path are None."""
    from ..parallel.distributed import (gather_objects, init_distributed,
                                        process_index,
                                        shard_across_processes)
    args = parse_args(argv)
    init_distributed(args.device)
    evaluator, _cfg, _anno, videos = build_evaluator(args)
    videos = shard_across_processes(videos)

    results = []
    t0 = time.time()
    total_frames = 0
    stream = evaluator.run_videos_from_paths(video_paths(videos, args.root))
    for i, (video, res) in enumerate(zip(videos, stream)):
        results.append(res)
        total_frames += len(video['file_names'])
        if (i + 1) % 50 == 0:
            print(f'{i + 1}/{len(videos)} videos, '
                  f'{total_frames / (time.time() - t0):.1f} frames/s')
    seconds = time.time() - t0
    results = gather_objects(results)
    if process_index() != 0:
        return dict(results=None, path=None, frames=None, seconds=seconds,
                    evaluator=evaluator)

    os.makedirs(args.out_dir, exist_ok=True)
    cfg_name = osp.basename(args.config)
    cfg_name = cfg_name[:-3] if cfg_name.endswith('.py') else cfg_name
    write_path = osp.join(
        args.out_dir, f'results_{cfg_name}_{osp.basename(args.json)}')
    with open(write_path, 'w') as f:
        json.dump(results, f)
    frames = sum(len(r['fusion_gazes']) for r in results)
    print(f'wrote {write_path} ({len(results)} videos, {frames} frames, '
          f'{total_frames / seconds:.1f} frames/s/process)')
    return dict(results=results, path=write_path, frames=frames,
                seconds=seconds, evaluator=evaluator)


if __name__ == '__main__':
    main()
