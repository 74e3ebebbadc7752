"""InstBlink evaluation through the port's batched query entry,
`evaluation/forward.py::bind_query_forward(fwd, fwd_batched,
device).batched(imgs, whwh, kq)`, as `evaluation/instblink_driver.py`
calls it: `clips` windows of uint8 frames handed over from the host, the
forward and the top-k track selection on the device, every output packed
into one f32 tensor (the driver's key order) and read back.

Check: a sample of the window's batches, drawn from the seed, against the
plain reference (reference/instblink.py, f32, TF32 off) over every query
of the last stage, judged at the queries the program chose (`topk_gaps`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import traffic
from ..reference import common as C
from . import common as E


class Entry(E.Base):
    mode = 'eval'

    def build(self):
        from mcgaze_tpu_torch.evaluation.forward import (
            bind_query_forward, make_query_eval_forward)
        from mcgaze_tpu_torch.models.query_detector import (
            QueryDetector, QueryDetectorConfig)

        mc = QueryDetectorConfig(**self.program_fields(QueryDetectorConfig))
        with torch.device(self.device):
            model = QueryDetector(mc)
        self.load(model)
        model.eval()
        fwd, fwd_batched = make_query_eval_forward(model, mc)
        self.model = model
        self.forward = bind_query_forward(fwd, fwd_batched, self.device)
        self.pool = traffic.make_pool(self.traffic, self.seed, self.device)
        self.clips_per_call = self.traffic['clips']

    def submit(self, i):
        frames = self.pool['frames']
        return self.forward.batched(frames[i % len(frames)],
                                    self.pool['whwh'], self.clips_per_call)

    def readback(self, i, out):
        keys = sorted(out)
        flat = torch.cat([out[k].float().reshape(-1) for k in keys])
        self.outputs[i] = (keys, [tuple(out[k].shape) for k in keys],
                           flat.cpu().numpy())

    def free(self):
        del self.forward, self.model
        super().free()

    def _unpack(self, i) -> dict:
        keys, shapes, flat = self.outputs[i]
        out, off = {}, 0
        for k, s in zip(keys, shapes):
            n = int(np.prod(s))
            out[k] = torch.from_numpy(flat[off:off + n].reshape(s)).to(
                self.device)
            off += n
        return out

    def _gaps(self, sample) -> dict:
        p, m = self.pool, self.config['model']
        whwh = torch.from_numpy(p['whwh']).to(self.device)
        size = float(max(self.traffic['image_height'],
                         self.traffic['image_width']))
        classes = m['num_classes']
        refs, gaps = {}, []
        with E.reference_precision():
            for i in sample:
                b = i % len(p['frames'])
                frames = torch.from_numpy(p['frames'][b]).to(self.device)
                if b not in refs:
                    refs[b] = self.ref.eval_forward(
                        self.weights, m, frames, whwh, self.clips_per_call,
                        C.Prec())
                got = self._unpack(i)
                gaps.append(self.ref.topk_gaps(got, refs[b], classes, size))
        return E.worst(gaps)

    def numbers(self, win):
        return self._gaps(self.sample(win))

    def work_shape(self):
        n = self.pool['frames'].shape[1]
        return dict(frames=n, height=self.traffic['height'],
                    width=self.traffic['width'], slots=n,
                    clip_length=self.traffic['clip_length'])
