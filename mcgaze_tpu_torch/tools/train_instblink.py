"""Train the InstBlink query detector with the port: counterpart of
tools/train_instblink.py.

    python -m mcgaze_tpu_torch.tools.train_instblink <config> [--synthetic]
        [--max-iters N] [--device cuda|cpu] [--work-dir DIR] [--seed S]
        [--resume-from CKPT] [--log-interval N] [--cfg-options a.b=v ...]

The config is a configs/instblink/ file (or a legacy MPEblink dataset
config), loaded without the JAX package. --synthetic trains on the JAX
CLI's random batches, drawn from the seed; otherwise the MPEblink clip
dataset of the config's data_train is read. The model starts from seeded
random weights (or a checkpoint with --resume-from). Every
`checkpoint_interval` steps and at the end it writes ckpt_<step>.pth (the
model under the reference names, which the port's and the JAX package's
eval CLIs read) and ckpt_<step>_train.pth (optimizer and step). --device
defaults to the card and refuses without one.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('--work-dir')
    p.add_argument('--max-iters', type=int)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume-from')
    p.add_argument('--synthetic', action='store_true',
                   help='random in-memory batches (no dataset needed)')
    p.add_argument('--log-interval', type=int)
    p.add_argument('--max-keep-ckpts', type=int, default=None,
                   help='keep only the newest N checkpoints (model and '
                        'train files); default: keep all, as the JAX CLI')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None,
                   help="config overrides 'a.b=val'")
    return p.parse_args(argv)


def synthetic_batches(cfg, seed=0):
    """The JAX CLI's synthetic stream, number for number: random frames and
    multi-instance GT with per-frame presence, one padded slot."""
    mc, dc = cfg.model, cfg.data_train
    rng = np.random.RandomState(seed)
    b, t, m = dc.batch_size, mc.clip_length, mc.max_instances
    h, w = dc.canvas
    while True:
        boxes = rng.rand(b, m, t, 4).astype(np.float32)
        boxes[..., 0] *= w * 0.7
        boxes[..., 1] *= h * 0.7
        boxes[..., 2] = boxes[..., 0] + 20 + boxes[..., 2] * 60
        boxes[..., 3] = boxes[..., 1] + 20 + boxes[..., 3] * 60
        batch = dict(
            imgs=rng.randn(b * t, h, w, 3).astype(np.float32) * 0.2,
            whwh=np.tile(np.asarray([[w, h, w, h]], np.float32),
                         (b * t, 1)),
            gt_boxes=boxes,
            gt_labels=rng.randint(0, mc.num_classes,
                                  size=(b, m)).astype(np.int32),
            gt_present=rng.rand(b, m, t) > 0.2,
            inst_valid=np.concatenate(
                [np.ones((b, max(m - 1, 1)), bool),
                 np.zeros((b, m - max(m - 1, 1)), bool)], axis=1),
        )
        if mc.with_blink:
            batch['gt_blinks'] = rng.randint(
                0, 2, size=(b, m, t)).astype(np.float32)
        yield batch


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(state, history: one dict of floats per
    step (the logs with match_ms, lr, time, data_time), checkpoint: the
    last model file written, work_dir)."""
    args = parse_args(argv)
    from ..data.prefetch import device_put_batches
    from ..train.hooks import CheckInvalidLoss, TextLogger
    from ..train.loop import step_warmup_schedule
    from ..train.query_loop import (create_query_train_state,
                                    make_query_train_step)
    from ..utils.cfg_options import apply_overrides
    from ..utils.checkpoint import save_checkpoint
    from ..utils.convert import clean_reference_query_state_dict
    from ..utils.env import resolve_device
    from ..utils.profiling import IterTimer
    from ..utils.query_config import load_query_config
    from .train import restore_train_state, train_state_dict

    device = resolve_device(args.device)
    cfg = apply_overrides(load_query_config(args.config), args.cfg_options)
    work_dir = args.work_dir or cfg.work_dir
    os.makedirs(work_dir, exist_ok=True)
    max_iters = args.max_iters or cfg.optim.max_iters
    log_interval = args.log_interval or cfg.log_interval

    seed = cfg.seed + args.seed
    state = create_query_train_state(cfg.model, cfg.optim, seed=seed,
                                     device=device)
    if args.resume_from:
        restore_train_state(state, args.resume_from,
                            clean=clean_reference_query_state_dict)
        print(f'resumed from {args.resume_from} at step {state.step}')

    if args.synthetic:
        host = synthetic_batches(cfg, args.seed)
    else:
        from ..data.instblink_dataset import InstBlinkClipDataset
        ds = InstBlinkClipDataset(cfg.data_train, seed=seed)
        print(f'dataset: {len(ds)} annotated frames')
        host = ds.batches(seed=seed)
    batches = device_put_batches(host, device)

    step_fn = make_query_train_step(cfg.model, cfg.optim)
    sched = step_warmup_schedule(cfg.optim)
    logger = TextLogger(work_dir, max_iters, log_interval)
    nan_guard = CheckInvalidLoss(interval=log_interval)
    timer = IterTimer()
    history, path = [], None
    try:
        for it in range(state.step, max_iters):
            timer.before_iter()
            batch = next(batches)
            lr = sched(it)
            logs = step_fn(state, batch)
            timer.after_iter(sync=logs['loss'])
            nan_guard.after_iter(it + 1, logs)
            logger.after_iter(it + 1, logs, lr, timer)
            history.append(dict({k: float(v) for k, v in logs.items()},
                                lr=lr, time=timer.time,
                                data_time=timer.data_time))
            if (it + 1) % cfg.checkpoint_interval == 0 or it + 1 == max_iters:
                path = save_checkpoint(work_dir, it + 1,
                                       state.model.state_dict(),
                                       train_state=train_state_dict(state),
                                       max_to_keep=args.max_keep_ckpts)
                print(f'saved {path}')
    finally:
        batches.close()
    print(f'done: {max_iters} iters, work_dir={work_dir}')
    return dict(state=state, history=history, checkpoint=path,
                work_dir=work_dir)


if __name__ == '__main__':
    main()
