"""Gaze video evaluation through the port's deduplicated eval entry,
`evaluation/forward.py::bind_forward(fwd, device, fwd_dedup).dedup`, as
`evaluation/driver.py` calls it for each chunk of a video: the chunk's
unique uint8 frames and slot -> frame map handed over from the host, the
forward, the outputs packed (`driver.pack_outputs`) and read back.

Check: every packed output of a sample of the window's batches, drawn
from the seed, against the plain reference (reference/mcgaze.py, f32, TF32
off) on the same frames and weights: the number of boxes whose gap over
the reference box's longer side passes the workload's `box_tolerance`
(`box_over`), the widest score gap and gaze gap (reference/mcgaze.py
eval_gaps).
"""
from __future__ import annotations

import torch

from .. import traffic
from ..reference import common as C
from . import common as E


class Entry(E.Base):
    mode = 'eval'

    def build(self):
        from mcgaze_tpu_torch.evaluation.driver import pack_outputs
        from mcgaze_tpu_torch.evaluation.forward import (bind_forward,
                                                         make_eval_forward)
        from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, ModelConfig

        mc = ModelConfig(**self.program_fields(ModelConfig))
        with torch.device(self.device):
            model = MCGazeModel(mc)
        self.load(model)
        model.eval()
        _, fwd, fwd_dedup = make_eval_forward(mc, device=self.device,
                                              model=model)
        self.model = model
        self.forward = bind_forward(fwd, self.device, fwd_dedup)
        self.pack = pack_outputs
        self.pool = traffic.make_pool(self.traffic, self.seed, self.device)
        self.t = self.traffic['clip_length']
        self.clips_per_call = self.traffic['clips']

    def submit(self, i):
        p = self.pool
        return self.forward.dedup(p['frames'][i % len(p['frames'])],
                                  p['sel'], p['whwh'], self.t)

    def readback(self, i, out):
        _, flat = self.pack(*out)
        self.outputs[i] = flat.cpu().numpy()

    def free(self):
        del self.forward, self.model
        super().free()

    def _gaps(self, sample, prec_mode=None) -> dict:
        """{number: widest gap} over the sampled calls of the program's
        outputs (or, with prec_mode, of the reference at that precision in
        the program's place) against the f32 reference."""
        p, m = self.pool, self.config['model']
        sel = torch.from_numpy(p['sel']).to(self.device)
        whwh = torch.from_numpy(p['whwh']).to(self.device)
        size = float(max(self.traffic['height'], self.traffic['width']))
        refs, gaps = {}, []
        with E.reference_precision():
            for i in sample:
                b = i % len(p['frames'])
                frames = torch.from_numpy(p['frames'][b]).to(self.device)
                if b not in refs:
                    refs[b] = self.ref.eval_forward(self.weights, m, frames,
                                                    whwh, sel, self.t,
                                                    C.Prec())
                if prec_mode is None:
                    got = torch.from_numpy(self.outputs[i]).to(self.device)
                else:
                    got = self.ref.eval_forward(self.weights, m, frames,
                                                whwh, sel, self.t,
                                                C.Prec(prec_mode))[:, :27]
                gaps.append(self.ref.eval_gaps(got, refs[b], size))
        out = E.worst(gaps)
        tol = self.workload.get('box_tolerance')
        if tol is not None:
            out['box_over'] = float(sum(int((g['box_rel'] > tol).sum())
                                        for g in gaps))
        return out

    def numbers(self, win):
        return self._gaps(self.sample(win))

    def control_numbers(self, win, prec_mode):
        return self._gaps(self.sample(win), prec_mode)

    def work_shape(self):
        return dict(frames=self.pool['frames'].shape[1],
                    height=self.traffic['height'],
                    width=self.traffic['width'],
                    slots=len(self.pool['sel']), clip_length=self.t,
                    with_gaze=True)
