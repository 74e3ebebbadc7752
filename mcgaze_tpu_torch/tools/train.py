"""Train MCGaze with the port: counterpart of tools/train.py.

    python -m mcgaze_tpu_torch.tools.train <config> [--synthetic]
        [--max-iters N] [--device cuda|cpu] [--work-dir DIR] [--seed S]
        [--resume-from CKPT | --auto-resume] [--log-interval N]
        [--mesh D,M] [--validate [--val-interval N] [--val-json J]
        [--val-root R] [--val-max-videos N] [--val-l2cs]]
        [--profile-dir DIR] [--cfg-options a.b=v ...]
    torchrun --nproc-per-node N -m mcgaze_tpu_torch.tools.train <config> ...

The config is one of configs/ (native or legacy), loaded without the JAX
package. --synthetic trains on random batches made from the seed, as the
JAX CLI's --synthetic does; otherwise the Gaze360 clip dataset of the
config's data_train is read. The model starts from seeded random weights
(or a checkpoint with --resume-from). Every `checkpoint_interval` steps
and at the end it writes ckpt_<step>.pth (the model under the reference
names) and ckpt_<step>_train.pth (optimizer, step, EMA).

Under a launcher (torchrun; parallel/distributed.py::init_distributed
reads its environment) every process drives one device (NCCL on the card,
gloo on the CPU), and --mesh D,M lays the N = D x M processes out as the
JAX CLI's mesh (default: D = N, M = 1; parallel/mesh.py):
  * D, the data axis: the config's global batch_size is split over the D
    data ranks, each data rank's stream is seeded with seed + its data
    index (rank 0's seed, broadcast), and DDP over the data axis averages
    the gradients before the clip (train/loop.py);
  * M, the model axis (tensor parallelism): the M ranks of a model group
    read the same batch, and each holds a 1/M slice of every head's FFN
    (fc1's weight and bias along its ffn_channels outputs, fc2's weight
    along its inputs) and of DynamicConv's fc_layer weight (along its
    roi_size^2 x channels inputs), every other parameter whole
    (parallel/tensor_parallel.py). M must divide both widths.
Rank 0 alone logs and writes checkpoints; every rank gathers the split
tensors first, so a checkpoint holds full tensors whatever the mesh and
resumes under any other (--resume-from). --validate runs the gaze video
eval of the val set every --val-interval steps (default: the checkpoint
interval) with the live weights (under a model axis, a full model from
the gathered weights on every rank), rank-sharded, and logs its MAE
(train/hooks.py::ValidationHook).

At start every process prints its environment (utils/collect_env.py).
--profile-dir DIR records a torch.profiler trace of iterations start+3 to
start+8, counted from the resumed step (utils/profiling.py::trace, a
Chrome trace in DIR), or to the run's end if that comes first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp

import numpy as np

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('--work-dir')
    p.add_argument('--max-iters', type=int)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--resume-from')
    p.add_argument('--auto-resume', action='store_true')
    p.add_argument('--synthetic', action='store_true',
                   help='random batches instead of the dataset')
    p.add_argument('--log-interval', type=int)
    p.add_argument('--max-keep-ckpts', type=int, default=None,
                   help='keep only the newest N checkpoints (model and '
                        'train files); default: keep all, as the JAX CLI')
    p.add_argument('--cfg-options', nargs='+', default=None,
                   help="config overrides 'a.b=val'")
    p.add_argument('--mesh', default=None, metavar='D,M',
                   help='data,model axis sizes over D x M processes: D '
                        'splits the batch, M (tensor parallelism) splits '
                        "each head's FFN and DynamicConv fc_layer weights "
                        '(default: every process on the data axis)')
    p.add_argument('--validate', action='store_true',
                   help='run the val MAE every --val-interval iters')
    p.add_argument('--val-interval', type=int, default=None,
                   help='default: the checkpoint interval')
    p.add_argument('--val-json', default=None,
                   help='val COCO-VID JSON (default: the config\'s test '
                        'annotation)')
    p.add_argument('--val-root', default=None,
                   help='val rawframes root (default: from the config)')
    p.add_argument('--val-max-videos', type=int, default=0)
    p.add_argument('--val-l2cs', action='store_true',
                   help='score validation with the l2cs GT layout')
    p.add_argument('--profile-dir', default=None,
                   help='record a torch.profiler trace of iterations 3-8 '
                        '(after the resumed step) into this directory')
    return p.parse_args(argv)


def synthetic_batches(cfg, seed=0):
    """The JAX CLI's synthetic stream, number for number: f32 normal
    frames and three fixed boxes per frame with a random unit gaze."""
    from ..train.targets import slot_layout_from_counts
    rng = np.random.RandomState(seed)
    b, t = cfg.data_train.batch_size, cfg.model.clip_length
    h, w = cfg.data_train.canvas
    while True:
        boxes = np.zeros((b, t, 3, 4), np.float32)
        valid = np.zeros((b, t, 3), np.float32)
        gazes = np.zeros((b, t, 3, 3), np.float32)
        for i in range(b):
            for j in range(t):
                g = rng.randn(3)
                g /= np.linalg.norm(g)
                bb, vv, gg = slot_layout_from_counts(
                    [[20, 20, 120, 120], [30, 40, 90, 70],
                     [10, 10, 160, 160]], [g.tolist()] * 3)
                boxes[i, j], valid[i, j], gazes[i, j] = bb, vv, gg
        yield dict(
            imgs=rng.randn(b, t, h, w, 3).astype(np.float32),
            img_whwh=np.tile(np.array([w, h, w, h], np.float32),
                             (b, t, 1)),
            gt_boxes=boxes, gt_valid=valid, gt_gazes=gazes)


def _moments(opt_sd: dict, names: list, fn) -> dict:
    """opt_sd (an optimizer state dict) with each parameter's AdamW moments
    passed through fn({name: moment}) per moment kind, by the parameter
    names in the optimizer's numbering."""
    state = {i: dict(st) for i, st in opt_sd['state'].items()}
    for kind in ('exp_avg', 'exp_avg_sq'):
        new = fn({names[i]: st[kind] for i, st in state.items()
                  if kind in st})
        for i, st in state.items():
            if kind in st:
                st[kind] = new[names[i]]
    return dict(opt_sd, state=state)


def optimizer_names(state) -> list:
    """The model's parameter names in the order the optimizer's state
    dict numbers them."""
    by_id = {id(p): n for n, p in state.model.named_parameters()}
    return [by_id[id(p)] for g in state.optimizer.param_groups
            for p in g['params']]


def model_state_dict(state) -> dict:
    """The model's full state dict under the reference names; under a
    model axis a collective that every rank calls."""
    from ..parallel.tensor_parallel import gather_state_dict
    return gather_state_dict(state.model, state.mesh)


def train_state_dict(state) -> dict:
    """What resume needs beside the model: optimizer, step, EMA, as full
    tensors whatever the mesh (the AdamW moments and the EMA of a split
    parameter gathered over the model group: a collective that every
    rank calls)."""
    from ..parallel.tensor_parallel import gather_state_dict

    def gather(named):
        return gather_state_dict(named, state.mesh)

    ema = None if state.ema is None else gather(state.ema)
    return dict(optimizer=_moments(state.optimizer.state_dict(),
                                   optimizer_names(state), gather),
                step=state.step,
                ema=None if ema is None
                else {k: v.detach().cpu() for k, v in ema.items()})


def restore_train_state(state, path: str, clean=None) -> None:
    """Load ckpt_<step>.pth (and its _train file when present) into state,
    in place. `clean` maps the file's state dict to the model's keys
    (default: utils/convert.py::clean_reference_state_dict). The files
    hold full tensors; under a model axis each rank keeps its slices of
    the split ones (tensor_parallel.shard_state_dict), so a checkpoint of
    any mesh resumes under any other."""
    from ..parallel.tensor_parallel import shard_state_dict
    from ..utils.checkpoint import restore_checkpoint, train_path
    from ..utils.convert import clean_reference_state_dict

    def shard(named):
        return shard_state_dict(named, state.mesh)

    ckpt = restore_checkpoint(path)
    state.model.load_state_dict(
        shard((clean or clean_reference_state_dict)(ckpt['state_dict'])),
        strict=True)
    if osp.exists(train_path(path)):
        tr = restore_checkpoint(train_path(path))
        state.optimizer.load_state_dict(_moments(
            tr['optimizer'], optimizer_names(state), shard))
        state.step = int(tr['step'])
        if tr['ema'] is not None and state.ema is not None:
            for k, v in shard(tr['ema']).items():
                state.ema[k].copy_(v)
    else:
        print(f'warning: {train_path(path)} missing: optimizer state and '
              'the schedule position restart from 0')


def main(argv=None) -> dict:
    """Run the CLI. Returns dict(state, history: one dict of floats per
    step (the logs, lr, time, data_time), checkpoint: the last model file
    written (None on ranks other than 0), work_dir, validation: the
    ValidationHook's metrics per interval (rank 0))."""
    args = parse_args(argv)
    from ..parallel.distributed import (barrier, data_index,
                                        init_distributed, process_count,
                                        process_index, sync_random_seed)
    from ..parallel.mesh import check_model_axis, parse_mesh, wrap_model
    from ..train.hooks import CheckInvalidLoss, TextLogger, ValidationHook
    from ..train.loop import (create_train_state, make_train_step,
                              step_warmup_schedule)
    from ..utils.cfg_options import apply_overrides
    from ..utils.checkpoint import find_latest_checkpoint, save_checkpoint
    from ..utils.config import load_config
    from ..utils.env import resolve_device
    from ..utils.collect_env import collect_env
    from ..utils.profiling import IterTimer, trace
    from ..data.prefetch import device_put_batches

    device = resolve_device(args.device)
    init_distributed(device)         # NCCL: selects this process's card
    for k, v in collect_env().items():
        print(f'env: {k}: {v}')
    args.seed = sync_random_seed(args.seed)
    mesh = parse_mesh(args.mesh)
    rank, n_proc = process_index(), process_count()
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    work_dir = args.work_dir or cfg.work_dir
    os.makedirs(work_dir, exist_ok=True)
    max_iters = args.max_iters or cfg.optim.max_iters
    log_interval = args.log_interval or cfg.log_interval
    check_model_axis(mesh.n_model, cfg.model)
    if mesh.n_data > 1:
        # the config's batch is global; each data rank loads its share
        global_b = cfg.data_train.batch_size
        if global_b % mesh.n_data:
            raise SystemExit(f'batch_size {global_b} does not divide over '
                             f'{mesh.n_data} data ranks')
        cfg = dataclasses.replace(cfg, data_train=dataclasses.replace(
            cfg.data_train, batch_size=global_b // mesh.n_data))
    if rank == 0:
        print(f'mesh: data={mesh.n_data} model={mesh.n_model}, '
              f'{n_proc} processes')

    state = create_train_state(cfg.model, cfg.optim, seed=args.seed,
                               device=device, mesh=mesh)
    resume = args.resume_from or (
        find_latest_checkpoint(work_dir) if args.auto_resume else None)
    if resume:
        restore_train_state(state, resume)
        print(f'resumed from {resume} at step {state.step}')
    state.ddp = wrap_model(state.model, device, mesh)

    # streams differ by the data index: a model group reads one batch
    if args.synthetic:
        host = synthetic_batches(cfg, args.seed + data_index())
    else:
        from ..data.dataset import Gaze360ClipDataset
        ds = Gaze360ClipDataset(cfg.data_train, seed=args.seed)
        print(f'dataset: {len(ds)} annotated frames')
        host = ds.batches(seed=args.seed + data_index())
    batches = device_put_batches(host, device)

    val_hook = None
    if args.validate:
        val_hook = ValidationHook(
            cfg, args.val_json or cfg.data_test.ann_file,
            args.val_root or cfg.data_test.img_prefix,
            interval=args.val_interval or cfg.checkpoint_interval,
            max_videos=args.val_max_videos, l2cs=args.val_l2cs,
            work_dir=work_dir, device=device)

    step_fn = make_train_step(cfg.model, cfg.optim)
    sched = step_warmup_schedule(cfg.optim)
    logger = TextLogger(work_dir if rank == 0 else None, max_iters,
                        log_interval, quiet=rank != 0)
    nan_guard = CheckInvalidLoss(interval=log_interval)
    timer = IterTimer()
    history, path, validation = [], None, []
    start_step = state.step
    prof = None                       # the --profile-dir trace, recording
    barrier('train_start')
    try:
        for it in range(start_step, max_iters):
            if args.profile_dir is not None:
                # iterations start+3 .. start+7, as the JAX CLI traces
                if it == start_step + 3 and it + 1 < max_iters:
                    prof = trace(args.profile_dir)
                    prof.__enter__()
                elif it == start_step + 8 and prof is not None:
                    prof.__exit__(None, None, None)
                    prof = None
                    print(f'profiler trace -> {args.profile_dir}')
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
            if ((it + 1) % cfg.checkpoint_interval == 0
                    or it + 1 == max_iters) and (rank == 0
                                                 or mesh.n_model > 1):
                # the gathers are collectives: every rank of a model
                # axis takes part, rank 0 alone writes
                model_sd = model_state_dict(state)
                train_sd = train_state_dict(state)
                if rank == 0:
                    path = save_checkpoint(work_dir, it + 1, model_sd,
                                           train_state=train_sd,
                                           max_to_keep=args.max_keep_ckpts)
                    print(f'saved {path}')
                del model_sd, train_sd
            if val_hook is not None:
                metrics = val_hook.after_iter(it + 1, state)
                if metrics is not None:
                    validation.append(dict(step=it + 1, **metrics))
        if prof is not None:
            prof.__exit__(None, None, None)
            prof = None
            print(f'profiler trace -> {args.profile_dir}')
    finally:
        if prof is not None:              # an exception: stop recording
            prof.__exit__(None, None, None)
        batches.close()
    return dict(state=state, history=history, checkpoint=path,
                work_dir=work_dir, validation=validation)


if __name__ == '__main__':
    main()
