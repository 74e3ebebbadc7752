"""Gaze training through the port's train step,
`train/loop.py::make_train_step` (forward, backward, then `apply_update`:
zero-filled missing gradients, the global-norm clip, the warmed-up lr and
AdamW), on one `create_train_state` object, as tools/train.py calls it.
Batches are already on the device; steps are queued back to back and one
sync on the last loss closes the window.

Set-up drives that same object through its first three steps, on three
different batches of the pool, through the same call, and keeps what the
check needs: each step's loss, each trainable leaf's first gradient as
AdamW got it (its first moment after one step over 1 - beta1, after the
clip) and each leaf's change after the three. The window's steps follow
from the fourth.

Check, once the program is freed: the plain reference (reference/
mcgaze.py, f32, TF32 off) runs the same three steps from the same weights
on the same batches. Compared: the widest relative loss gap over the three
steps; by the worst leaf, the gap of the first gradient's norm and of the
change's norm, each over the reference's norm of that leaf or the median
leaf's, whichever is larger, the change over the leaves whose reference
gradient is at least a thousandth of the median leaf's (the others move
by rounding alone); and `rounding_x`, the median leaf's gaps over those of
the reference run at the configuration's own TF32 settings.
"""
from __future__ import annotations

import torch

from .. import traffic
from ..reference import common as C
from . import common as E

CHECK_STEPS = 3
# the least own-precision gap a `*_x` number divides by: relative gaps of
# f32 sums in another order lie far below it, TF32's (2**-11 a product)
# above it
OWN_FLOOR = 1e-4


class Entry(E.Base):
    mode = 'train'
    warmup_calls = 0

    def build(self):
        from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, ModelConfig
        from mcgaze_tpu_torch.train.loop import (OptimConfig,
                                                 create_train_state,
                                                 make_train_step)

        lw = self.config['model']['loss_weights']
        mc = ModelConfig(**self.program_fields(ModelConfig, dict(
            loss_cls_weight=lw['cls'], loss_bbox_weight=lw['bbox'],
            loss_iou_weight=lw['iou'], loss_gaze_weight=lw['gaze'],
            loss_temp_weight=lw['temporal'])))
        o = self.config['optimizer']
        oc = OptimConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in o.items()})
        with torch.device(self.device):
            model = MCGazeModel(mc)
        self.load(model)
        self.state = create_train_state(mc, oc, model=model)
        self.train_step = make_train_step(mc, oc)
        self.pool = traffic.make_pool(self.traffic, self.seed, self.device)
        if len(self.pool) <= CHECK_STEPS:
            raise ValueError(f'a pool of {len(self.pool)} batches; the '
                             f'check steps take {CHECK_STEPS} of them')
        self.clips_per_call = self.traffic['clips']
        self._first_steps()

    def _first_steps(self):
        model, opt = self.state.model, self.state.optimizer
        named = dict(model.named_parameters())
        live = {id(p) for g in opt.param_groups for p in g['params']}
        beta1 = opt.param_groups[0]['betas'][0]
        self.losses, self.first, self.change = [], {}, {}
        for s in range(CHECK_STEPS):
            logs = self.train_step(self.state, self.pool[s])
            self.losses.append(float(logs['loss']))
            if s == 0:
                self.first = {
                    n: float((opt.state[p]['exp_avg'] / (1 - beta1))
                             .double().norm())
                    for n, p in named.items() if id(p) in live}
        self.change = {n: float((p.detach() - self.weights[n]).double()
                                .norm())
                       for n, p in named.items() if id(p) in live}

    def step(self, i):
        pool = self.pool
        self.logs = self.train_step(
            self.state, pool[(CHECK_STEPS + i) % len(pool)])

    def sync(self):
        if hasattr(self, 'logs'):
            float(self.logs['loss'])
        super().sync()

    def free(self):
        del self.state, self.train_step
        self.__dict__.pop('logs', None)
        super().free()

    def _reference(self, own_precision=False):
        """The reference's three steps in f32 with TF32 off, or with
        `own_precision` at the configuration's TF32 settings (the rounding
        a plain computation at the stated precision makes)."""
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        with E.reference_precision():
            if own_precision:
                torch.backends.cudnn.allow_tf32 = flags[0]
                torch.backends.cuda.matmul.allow_tf32 = flags[1]
            return self.ref.train_steps(
                self.weights, self.config['model'],
                self.config['optimizer'], self.pool[:CHECK_STEPS],
                C.Prec())

    def _gaps(self, got, ref) -> dict:
        losses, first, change = got
        r_losses, r_first, r_change = ref
        loss = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
        grad, grad_leaf, grad_median = self.ref.leaf_gaps(first, r_first)
        moved = self.ref.moved_leaves(r_first)
        chg, chg_leaf, chg_median = self.ref.leaf_gaps(change, r_change,
                                                       moved)
        self.notes = dict(grad_leaf=grad_leaf, change_leaf=chg_leaf,
                          loss_steps=loss,
                          unmoved=sorted(set(r_first) - moved))
        return dict(loss=max(loss), grad=grad, grad_median=grad_median,
                    change=chg, change_median=chg_median)

    def numbers(self, win):
        """The gaps against the f32 reference, and the median leaf's
        gradient and change gaps over those that the reference makes at the
        configuration's own TF32 settings (`*_x`: about 1 for a program
        computing at the stated precision; `rounding_x` the larger)."""
        r32 = self._reference()
        own = self._gaps(self._reference(own_precision=True), r32)
        out = self._gaps((self.losses, self.first, self.change), r32)
        for k in ('grad_median', 'change_median'):
            out[k.replace('median', 'x')] = out[k] / max(own[k], OWN_FLOOR)
        out['rounding_x'] = max(out['grad_x'], out['change_x'])
        return out

    def work_shape(self):
        n = self.traffic['clips'] * self.traffic['clip_length']
        return dict(frames=n, height=self.traffic['height'],
                    width=self.traffic['width'], slots=n,
                    clip_length=self.traffic['clip_length'], train=True,
                    with_gaze=True)
