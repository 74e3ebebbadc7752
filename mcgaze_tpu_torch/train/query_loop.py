"""The train step of the query detector, counterpart of
mcgaze_tpu/train/query_loop.py: forward, clip-level Hungarian matching,
the QueryInst losses, the global-norm clip and AdamW, with the gaze loop's
optimizer (train/loop.py: parameter groups by reference name, frozen stem
and layer1, backbone lr x0.1, the step warmup schedule). The matching
costs are computed on the device; their solve is one host round trip per
step (train/hungarian.py::solve_assignments).

MsgShifT (TeViT) trains with DropPath when msg_drop_path_rate > 0. Its
masks come from a torch.Generator on the model's device seeded from the
step counter and the process rank (`droppath_generator`), so a resumed run
replays the same masks; the JAX step's fold_in(PRNGKey(0x0d0b), step)
stream cannot be reproduced bit for bit, so the two packages agree at rate
0 and in eval.
"""
from __future__ import annotations

import torch

from ..evaluation.forward import device_normalize
from ..models.query_detector import (QueryDetector, QueryDetectorConfig,
                                     init_query_model)
from ..parallel.distributed import average_over_processes, process_index
from .loop import (OptimConfig, TrainState, apply_update, make_optimizer,
                   step_warmup_schedule)
from .query_criterion import total_loss


def create_query_train_state(cfg: QueryDetectorConfig, oc: OptimConfig,
                             seed: int = 0, device='cuda',
                             model: QueryDetector | None = None
                             ) -> TrainState:
    """A seeded random model (unless `model` is given) in train mode and a
    fresh AdamW. EMA (OptimConfig.ema_momentum) is the gaze loop's only."""
    if model is None:
        model = init_query_model(cfg, seed, device)
    model.train()
    return TrainState(model=model, optimizer=make_optimizer(model, oc))


DROPPATH_SEED = 0x0d0b


def uses_droppath(cfg: QueryDetectorConfig) -> bool:
    return cfg.backbone == 'msgshift' and cfg.msg_drop_path_rate > 0.0


def droppath_generator(step: int, device, rank: int = 0) -> torch.Generator:
    """The DropPath masks' generator of one train step on one process: a
    function of (step, rank) alone."""
    gen = torch.Generator(device=device)
    return gen.manual_seed((DROPPATH_SEED << 40) + (step << 12) + rank)


def query_loss_fn(cfg: QueryDetectorConfig, model, batch: dict,
                  generator: torch.Generator | None = None):
    """batch: imgs (B*T, H, W, 3) f32 normalised or u8, whwh (B*T, 4),
    gt_boxes (B, M, T, 4) xyxy, gt_labels (B, M), gt_present (B, M, T),
    inst_valid (B, M), gt_blinks (B, M, T) with cfg.with_blink. generator:
    MsgShifT's DropPath masks (None: no DropPath). Returns (loss, logs,
    host seconds of the assignment solves)."""
    t = cfg.clip_length
    imgs = device_normalize(batch['imgs'], batch['whwh'])
    out = model(imgs, batch['whwh'], clip_length=t,
                train=generator is not None, generator=generator)
    return total_loss(cfg, out, batch, t)


def make_query_train_step(cfg: QueryDetectorConfig, oc: OptimConfig):
    """Returns train_step(state, batch) -> logs: one forward and backward,
    the clip and the AdamW update, in place on state (through state.ddp in
    a data-parallel run, as train/loop.py's step). Logs are detached
    scalar tensors, averaged over the processes: every `stage{i}_*` loss
    and num_pos, 'loss', 'grad_norm', and 'match_ms', this process's host
    ms of the step's assignment solves. MsgShifT's DropPath draws from
    droppath_generator(step, rank)."""
    sched = step_warmup_schedule(oc)

    def train_step(state: TrainState, batch: dict) -> dict:
        for p in state.model.parameters():
            p.grad = None
        gen = None
        if uses_droppath(cfg):
            gen = droppath_generator(state.step, batch['imgs'].device,
                                     process_index())
        loss, logs, solve_s = query_loss_fn(cfg, state.forward_model, batch,
                                            gen)
        loss.backward()
        logs = average_over_processes({k: v.detach()
                                       for k, v in logs.items()})
        logs['grad_norm'] = apply_update(state, oc, sched)
        logs['match_ms'] = torch.tensor(solve_s * 1e3)
        return logs

    return train_step
