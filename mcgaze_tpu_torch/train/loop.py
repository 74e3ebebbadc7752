"""Optimizer, LR schedule and the train step, counterpart of
mcgaze_tpu/train/loop.py.

Optimizer (configs/multiclue_gaze/multiclue_gaze_r50_gaze360.py): AdamW
lr 1e-3, wd 1e-4; backbone lr x0.1; stem and stage 1 frozen
(frozen_stages=1); global-norm clip 0.1; linear warmup 1000 iters from
ratio 1e-3; step x0.1 at iter 6000; 7000 iters.

The step reproduces the JAX chain masked(set_to_zero) -> clip_by_global_norm
-> multi_transform(adamw) as follows:
  * frozen parameters keep requires_grad, so their raw gradient enters the
    logged `grad_norm` (the JAX step logs the norm of the raw gradients),
    but they are in no optimizer group and not in the clip norm: no update,
    no weight decay;
  * a trainable parameter that autograd leaves without a gradient (the
    learned proposal boxes reach the loss only through detached boxes) gets
    a zero gradient, so AdamW still decays it, as optax does;
  * the clip is optax's rule, g * (max / norm) when norm >= max (torch's
    clip_grad_norm_ divides by norm + 1e-6);
  * each group's lr is sched(step) * lr_mult, set before the update with
    the step count before it increments (optax's `count`).
torch.optim.AdamW's update is optax.adamw's (decoupled decay
p -= lr * wd * p, bias-corrected moments, eps outside the square root).

Data parallel (parallel/mesh.py): TrainState.ddp wraps the model in
DistributedDataParallel, which averages the gradients over the data axis
in backward; the losses divide by global counts, so that average is the
gradient of the global loss. The global-norm clip and the update run after
it, on every process alike, and the logs are averaged over the data axis.

Tensor parallel (TrainState.mesh with a model axis, parallel/
tensor_parallel.py): the parameters TP_RULES name are this process's
slices. The clip's norm and the logged grad_norm count a split gradient's
squares summed over the model group and a replicated one once, so every
rank clips by the one-process factor; AdamW and the EMA work element by
element on the slices.

Spans (utils/profiling.py, recorded only inside `recording()`): the step
is `mcgaze.train`, with `train.forward` (model and criterion),
`train.backward` and `train.update` (apply_update) inside it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..evaluation.forward import device_normalize
from ..models.mcgaze import MCGazeModel, ModelConfig, init_model
from ..parallel.distributed import average_over_processes
from ..parallel.mesh import Mesh, tp_rule
from ..parallel.tensor_parallel import shard_model
from ..utils.profiling import span
from .criterion import total_loss
from .hooks import ema_update
from .targets import flatten_targets


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4
    backbone_lr_mult: float = 0.1
    grad_clip_norm: float = 0.1
    warmup_iters: int = 1000
    warmup_ratio: float = 1e-3
    lr_steps: Sequence[int] = (6000,)
    lr_gamma: float = 0.1
    max_iters: int = 7000
    # EMA of the parameters after every step (reference mmcv EMAHook);
    # 0.0 disables. Typical momentum 0.0002.
    ema_momentum: float = 0.0


def step_warmup_schedule(oc: OptimConfig) -> Callable[[int], float]:
    """mmcv StepLrUpdaterHook: the step lr, scaled by the linear-warmup
    factor 1 - (1 - t/w)(1 - ratio) for t < w. Computed in float32, as
    the JAX schedule is (1 - k rounds to ~1e-5 relative at t = 0)."""
    f32 = np.float32

    def sched(t) -> float:
        t = f32(t)
        n = sum(int(t >= s) for s in oc.lr_steps)
        regular = f32(oc.lr) * f32(oc.lr_gamma) ** f32(n)
        if t < oc.warmup_iters:
            k = ((f32(1.0) - t / f32(oc.warmup_iters))
                 * f32(1.0 - oc.warmup_ratio))
            return float(regular * (f32(1.0) - k))
        return float(regular)

    return sched


def param_group(name: str) -> str:
    """'frozen' (stem + layer1: frozen_stages=1), 'backbone' or 'head' (the
    neck included), by the parameter's reference name."""
    if name.startswith('backbone.'):
        if name.startswith(('backbone.conv1.', 'backbone.bn1.',
                            'backbone.layer1.')):
            return 'frozen'
        return 'backbone'
    return 'head'


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # EMA copy of the parameters by name, when OptimConfig.ema_momentum
    ema: Optional[dict] = None
    # the model under DistributedDataParallel in a data-parallel run
    ddp: Optional[torch.nn.Module] = None
    # the (data, model) mesh; with a model axis the model is sharded
    mesh: Optional[Mesh] = None

    @property
    def forward_model(self) -> torch.nn.Module:
        """What the step calls forward on: the DDP wrapper, else the model.
        Names, the optimizer and checkpoints use `model`."""
        return self.ddp if self.ddp is not None else self.model


def make_optimizer(model: torch.nn.Module,
                   oc: OptimConfig) -> torch.optim.AdamW:
    """AdamW over the parameters of any model named as the reference's
    (MCGazeModel, QueryDetector), in the groups of `param_group`."""
    groups = {'backbone': [], 'head': []}
    for name, p in model.named_parameters():
        g = param_group(name)
        if g != 'frozen':
            groups[g].append(p)
    mults = {'backbone': oc.backbone_lr_mult, 'head': 1.0}
    return torch.optim.AdamW(
        [dict(params=groups[g], lr_mult=mults[g])
         for g in ('backbone', 'head')],
        lr=oc.lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=oc.weight_decay)


def create_train_state(cfg: ModelConfig, oc: OptimConfig, seed: int = 0,
                       device='cuda', model: MCGazeModel | None = None,
                       mesh: Mesh | None = None) -> TrainState:
    """A seeded random model (unless `model` is given) in train mode, a
    fresh AdamW and, with ema_momentum, an EMA copy of the parameters.
    With a model axis in `mesh` the model is sharded first
    (tensor_parallel.shard_model: every rank draws the full seeded model
    and keeps its slices), and the optimizer and EMA hold the slices."""
    if model is None:
        model = init_model(cfg, seed, device)
    if mesh is not None:
        shard_model(model, mesh)
    model.train()
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if oc.ema_momentum else None)
    return TrainState(model=model, optimizer=make_optimizer(model, oc),
                      step=0, ema=ema, mesh=mesh)


def global_norm(tensors, split=(), mesh: Mesh | None = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm).
    `split`: further tensors that are this process's slices along the
    mesh's model axis, whose squares are summed over the model group."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    total = torch.linalg.vector_norm(torch.stack(norms))
    split = [t.float() for t in split]
    if not split or mesh is None or mesh.n_model == 1:
        return total
    squares = torch.stack(torch._foreach_norm(split)).square().sum()
    torch.distributed.all_reduce(squares, group=mesh.model_group)
    return torch.sqrt(total.square() + squares)


def _split_norm(state: 'TrainState', named) -> torch.Tensor:
    """global_norm of the gradients of `named` (name, parameter) pairs,
    each split one counted over the model axis."""
    sharded = state.mesh is not None and state.mesh.n_model > 1
    whole, split = [], []
    for name, p in named:
        (split if sharded and tp_rule(name) else whole).append(p.grad)
    return global_norm(whole, split, state.mesh)


def loss_fn(cfg: ModelConfig, model: MCGazeModel, batch: dict):
    """batch (leading dims (B, T)): imgs (B,T,H,W,3) f32 normalised or u8,
    img_whwh (B,T,4), gt_boxes (B,T,3,4), gt_valid (B,T,3),
    gt_gazes (B,T,3,3). Returns (loss, logs)."""
    b, t = batch['imgs'].shape[:2]
    imgs = batch['imgs'].reshape(b * t, *batch['imgs'].shape[2:])
    whwh = batch['img_whwh'].reshape(b * t, 4)
    out = model(device_normalize(imgs, whwh), whwh, clip_length=t)
    tg = flatten_targets(batch['gt_boxes'], batch['gt_valid'],
                         batch['gt_gazes'], batch['img_whwh'])
    return total_loss(cfg, out, tg, t)


def make_train_step(cfg: ModelConfig, oc: OptimConfig):
    """Returns train_step(state, batch) -> logs: one forward and backward,
    the clip and the AdamW update, in place on state. Logs are detached
    scalar tensors on the model's device: every `stage{i}_*` loss, 'loss'
    and 'grad_norm'."""
    sched = step_warmup_schedule(oc)

    def train_step(state: TrainState, batch: dict) -> dict:
        with span('mcgaze.train'):
            for p in state.model.parameters():
                p.grad = None
            with span('mcgaze.train.forward'):
                loss, logs = loss_fn(cfg, state.forward_model, batch)
            with span('mcgaze.train.backward'):
                loss.backward()
            logs = average_over_processes({k: v.detach()
                                           for k, v in logs.items()})
            with span('mcgaze.train.update'):
                logs['grad_norm'] = apply_update(state, oc, sched)
            return logs

    return train_step


def apply_update(state: TrainState, oc: OptimConfig, sched) -> torch.Tensor:
    """After backward: fill missing gradients with zeros, clip the
    trainable ones, set each group's lr from sched(step), step AdamW and
    the EMA, count the step. Returns the raw gradients' global norm (frozen
    parameters included), which the step logs as grad_norm."""
    named = list(state.model.named_parameters())
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = _split_norm(state, named)

    live = [(name, p) for name, p in named if param_group(name) != 'frozen']
    for name, p in named:
        if param_group(name) == 'frozen':
            p.grad = None
    trainable = [p.grad for _, p in live]
    norm = _split_norm(state, live)
    factor = torch.where(norm < oc.grad_clip_norm, torch.ones_like(norm),
                         oc.grad_clip_norm / norm)
    torch._foreach_mul_(trainable, factor)

    lr = sched(state.step)
    for group in state.optimizer.param_groups:
        group['lr'] = lr * group['lr_mult']
    state.optimizer.step()
    state.step += 1
    if state.ema is not None:
        ema_update(state.ema, dict(named), oc.ema_momentum)
    return grad_norm
