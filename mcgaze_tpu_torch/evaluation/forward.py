"""Eval forward, counterpart of mcgaze_tpu/evaluation/forward.py.

`make_eval_forward` builds the model on a device and returns two forwards
over it, both run under torch.inference_mode():
  fwd(imgs (N,H,W,3) u8|f32, whwh (N,4), t) -> (boxes (N,3,4),
      scores (N,3), gazes {fusion, face, eyes, head} -> (N,3))
  fwd_dedup(frames (U,H,W,3), sel (N,), whwh_u (U,4), t) -> the same,
      with backbone + FPN run once per unique frame and each clip slot
      reading frame sel[slot] (the RoIAlign kernel's frame_idx form).
`bind_forward` adapts them to the driver's forward_fn signature.

On a CUDA device the bound `.dedup` replays a CUDA graph of `fwd_dedup`
(`EvalGraphs`): one graph per input shape, captured on the second call of
that shape and replayed from then on, so a batch costs the host a few
copies and one graph launch in place of ~2,000 kernel launches. The CPU,
a model in training mode, and calls inside ops/routing.py::
through_operators() or under a dispatch mode (the benchmark's and
cost_analysis's operator counts) run `fwd_dedup` eagerly.

For the query family (InstBlink, TeViT), `make_query_eval_forward` and
`bind_query_forward` give InstBlinkVideoEvaluator its forward: u8 frames
normalised on the device, the top-k track selection on the device, the
outputs left there for the driver's one readback per video.

Several cards: the drivers place each video's frames on one card in turn;
a bound forward runs where its inputs already lie (a tensor on a device of
the bound device's type stays there) and the forwards run a copy of the
model made once per card (`ModelReplicas`).
"""
from __future__ import annotations

import copy
import functools
import threading
from collections import OrderedDict

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..geometry import device_const
from ..models.mcgaze import MCGazeModel, ModelConfig, init_model
from ..ops import routing
from ..utils.env import resolve_device
from ..utils.profiling import count, span


def device_normalize(imgs: torch.Tensor, whwh: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalised f32 with the pad region zeroed
    AFTER normalising (the reference pads after Normalize, so the pad is 0
    in normalised space). Float frames (normalised on the host) pass
    through."""
    if imgs.dtype != torch.uint8:
        return imgs
    mean = device_const(IMAGENET_MEAN, torch.float32, imgs.device)
    std = device_const(IMAGENET_STD, torch.float32, imgs.device)
    out = (imgs.to(torch.float32) - mean) / std
    hh, ww = imgs.shape[-3], imgs.shape[-2]
    xx = torch.arange(ww, device=imgs.device)[None, None, :]
    yy = torch.arange(hh, device=imgs.device)[None, :, None]
    valid = (xx < whwh[:, 0, None, None]) & (yy < whwh[:, 1, None, None])
    return out * valid[..., None]


class ModelReplicas:
    """The model on its own device and a copy of it on each other device a
    forward is asked to run on, made at the first such call."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self._by_device = {}

    def on(self, device: torch.device) -> torch.nn.Module:
        home = next(self.model.parameters()).device
        if device == home:
            return self.model
        if device not in self._by_device:
            self._by_device[device] = copy.deepcopy(self.model).to(device)
        return self._by_device[device]


def _last_stage(out):
    last = out['stages'][-1]
    return (last['boxes'], torch.sigmoid(last['cls_logits'])[..., 0],
            last['gaze'])


def make_eval_forward(model_cfg: ModelConfig, seed: int = 0,
                      device='cuda', model: MCGazeModel | None = None):
    """Returns (model, fwd, fwd_dedup). A seeded random model is built on
    `device` unless `model` is given (e.g. one holding converted
    weights). `fwd_dedup.model_on(device)` is the model a device runs
    (EvalGraphs keys its graphs on it)."""
    if model is None:
        model = init_model(model_cfg, seed, device)
    replicas = ModelReplicas(model)

    @torch.inference_mode()
    def fwd(imgs, whwh, t):
        imgs = device_normalize(imgs, whwh)
        return _last_stage(replicas.on(imgs.device)(imgs, whwh,
                                                    clip_length=t))

    @torch.inference_mode()
    def fwd_dedup(frames, sel, whwh_u, t):
        m = replicas.on(frames.device)
        feats = m.extract_features(frames, functools.partial(
            device_normalize, whwh=whwh_u))
        sel = sel.to(torch.int32)
        out = m.run_heads(feats, whwh_u[sel.long()], clip_length=t,
                          frame_idx=sel)
        with span('mcgaze.select'):
            return _last_stage(out)

    fwd_dedup.model_on = replicas.on
    return model, fwd, fwd_dedup


def to_device(x, device: torch.device) -> torch.Tensor:
    """numpy or tensor -> tensor on `device`; host arrays go through
    pinned memory and copy without blocking the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == 'cuda':
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def run_device(x, device: torch.device) -> torch.device:
    """Where a bound forward runs on input x: the device x lies on when it
    is a tensor on a device of `device`'s type (a driver placed it there),
    else `device`."""
    if isinstance(x, torch.Tensor) and x.device.type == device.type:
        return x.device
    return device


MAX_GRAPHS = 8


def graph_path(device: torch.device, model) -> bool:
    """Whether an eval call of `model` on `device` may run as a CUDA graph:
    a CUDA device, the model in eval mode, and nothing that watches the
    forward's operators. A replay dispatches no operator, so inside
    routing.through_operators() or under a dispatch mode (the benchmark's
    and utils/profiling.py::cost_analysis's counts of the kernels'
    operators) the forward runs eagerly."""
    return (device.type == 'cuda' and not model.training
            and not routing.active()
            and _get_current_dispatch_mode() is None)


def tensor_dicts(model) -> list:
    """The parameter and buffer dicts of the model's modules. A key read
    from them at each call sees a tensor that `.to()` or
    `load_state_dict(assign=True)` put in a module; an update in place
    keeps the key (a graph reads its parameters on every replay)."""
    return [d for m in model.modules() for d in (m._parameters, m._buffers)
            if d]


def graph_key(model, dicts, args, t) -> tuple:
    """The key of one graph: the device, each input's shape and dtype, t,
    the model's config, the TF32 and cuDNN-determinism settings that pick
    its kernels, and the data pointers of its parameters and buffers."""
    return (args[0].device, tuple((tuple(a.shape), a.dtype) for a in args),
            t, model.cfg, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            tuple(p.data_ptr() for d in dicts for p in d.values()
                  if p is not None))


def _keep(cache: OrderedDict, key, value):
    """cache[key] = value as the most recently used entry; the least
    recently used go beyond MAX_GRAPHS."""
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > MAX_GRAPHS:
        cache.popitem(last=False)


def _outputs(out) -> list:
    boxes, scores, gazes = out
    return [boxes, scores, *gazes.values()]


class _Graph:
    """One captured forward: the graph, its static inputs and outputs, and
    the tensors it reads, kept alive."""
    __slots__ = ('graph', 'inputs', 'outputs', 'reads')


class EvalGraphs:
    """`fwd_dedup(frames, sel, whwh_u, t)` through CUDA graphs, for one
    bound forward.

    A call that graph_path allows looks up its graph_key. The first call
    of a key runs fwd_dedup eagerly, the second captures it and replays,
    every later call replays: a shape seen once is never captured, and no
    forward runs twice. Eager runs, captures and replays use one side
    stream a device, which waits for the caller's current stream before
    and which the caller's stream waits for after; they hold one lock, so
    a thread never sees another's static buffers. A replay copies the
    inputs into the graph's static ones and returns clones of its
    outputs, never the static buffers. The graphs of a device share one
    memory pool: replays run one at a time on one stream, and what one
    graph leaves there is cloned before another replays. At most
    MAX_GRAPHS graphs, and as many keys seen once, are kept; the least
    recently used go first (VideoGazeEvaluator's power-of-two clip
    buckets make at most 6 shapes a frame size).

    The kernels' launch counters (`launch_count` in ops/) count their
    wrappers' calls: an eager run and a capture each count a forward's
    launches, a replay calls no wrapper and counts none (the card's own
    trace names the kernels a replay runs). Counters (inside recording()):
    `eval_graph_eager` a call run eagerly on a CUDA device,
    `eval_graph_captures`, `eval_graph_replays`; a replay is the span
    `mcgaze.eval_graph`. `fwd.model_on` (set by make_eval_forward) gives
    the model a device runs."""

    def __init__(self, fwd):
        self.fwd = fwd
        self.model_on = fwd.model_on
        self.graphs = OrderedDict()     # key -> _Graph
        self.seen = OrderedDict()       # key -> None: run once, eagerly
        self._lock = threading.Lock()
        self._dicts = {}                # device -> (model, tensor_dicts)
        self._streams = {}
        self._pools = {}

    def __call__(self, frames, sel, whwh_u, t):
        args = (frames, sel, whwh_u)
        dev = frames.device
        model = self.model_on(dev)
        if not graph_path(dev, model):
            if dev.type == 'cuda':
                count('eval_graph_eager', 1)
            return self.fwd(*args, t)
        known = self._dicts.get(dev)
        if known is None or known[0] is not model:
            known = self._dicts[dev] = (model, tensor_dicts(model))
        key = graph_key(model, known[1], args, t)
        with self._lock:
            graph = self.graphs.get(key)
            if graph is None:
                if key not in self.seen:
                    _keep(self.seen, key, None)
                    count('eval_graph_eager', 1)
                    return self._eager(dev, args, t)
                del self.seen[key]
                graph = self._capture(dev, args, t, known[1])
                count('eval_graph_captures', 1)
            _keep(self.graphs, key, graph)
            count('eval_graph_replays', 1)
            return self._replay(dev, graph, args)

    def _join(self, dev) -> tuple:
        """(the caller's stream, the side stream, which now waits for
        it)."""
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        caller = torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        return caller, side

    @staticmethod
    def _hand_back(caller, side, out):
        """out, made on the side stream, to the caller's stream."""
        caller.wait_stream(side)
        for o in _outputs(out):
            o.record_stream(caller)
        return out

    def _eager(self, dev, args, t):
        # on the stream that will capture: what a first call makes (K1's
        # RoI counter, cuBLAS's workspace) exists before the capture
        caller, side = self._join(dev)
        with torch.cuda.stream(side):
            out = self.fwd(*args, t)
        return self._hand_back(caller, side, out)

    def _capture(self, dev, args, t, dicts) -> _Graph:
        _, side = self._join(dev)
        g = _Graph()
        with torch.cuda.stream(side):
            g.inputs = tuple(a.clone() for a in args)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, pool=self._pools.get(dev),
                              stream=side,
                              capture_error_mode='thread_local'):
            g.outputs = self.fwd(*g.inputs, t)
        self._pools.setdefault(dev, g.graph.pool())
        g.reads = [p for d in dicts for p in d.values() if p is not None]
        return g

    def _replay(self, dev, g: _Graph, args):
        with span('mcgaze.eval_graph'), torch.inference_mode():
            caller, side = self._join(dev)
            with torch.cuda.stream(side):
                for dst, src in zip(g.inputs, args):
                    dst.copy_(src)
                g.graph.replay()
                boxes, scores, gazes = g.outputs
                out = (boxes.clone(), scores.clone(),
                       {k: v.clone() for k, v in gazes.items()})
            return self._hand_back(caller, side, out)


def bind_forward(fwd, device, fwd_dedup=None):
    """The driver's forward_fn: forward(imgs, whwh, t) with host or device
    inputs, outputs left on the device the forward ran on (run_device).
    Marks itself accepts_uint8 (the forwards normalise u8 on the device)
    and carries `.device`; with fwd_dedup it also carries `.dedup(frames,
    sel, whwh_u, t)`, which VideoGazeEvaluator prefers
    (EvalConfig.dedup_frames), run through `EvalGraphs` (`.dedup.graphs`)."""
    device = resolve_device(device)

    def forward(imgs, whwh, t):
        dev = run_device(imgs, device)
        return fwd(to_device(imgs, dev), to_device(whwh, dev), t)

    forward.accepts_uint8 = True
    forward.device = device
    if fwd_dedup is not None:
        graphs = EvalGraphs(fwd_dedup)

        def dedup(frames, sel, whwh_u, t):
            with span('mcgaze.eval'):
                dev = run_device(frames, device)
                with span('mcgaze.handover'):
                    args = (to_device(frames, dev), to_device(sel, dev),
                            to_device(whwh_u, dev))
                return graphs(*args, t)

        dedup.graphs = graphs
        forward.dedup = dedup
    return forward


def make_query_eval_forward(model, mc):
    """(fwd, fwd_batched) over a QueryDetector `model` of config `mc`, both
    under torch.inference_mode():
      fwd(imgs (T, H, W, 3) u8|f32, whwh (T, 4)) -> topk_tracks dict
      fwd_batched(imgs (Kq*T, ...), whwh, kq) -> topk_tracks_batched dict
    """
    from ..models.query_detector import topk_tracks, topk_tracks_batched

    replicas = ModelReplicas(model)

    @torch.inference_mode()
    def fwd(imgs, whwh):
        imgs = device_normalize(imgs, whwh)
        t = imgs.shape[0]
        out = replicas.on(imgs.device)(imgs, whwh, clip_length=t)
        return topk_tracks(out['stages'][-1], t, mc.max_per_img,
                           mc.num_classes)

    @torch.inference_mode()
    def fwd_batched(imgs, whwh, kq):
        m = replicas.on(imgs.device)
        t = imgs.shape[0] // kq
        feats = m.extract_features(imgs, t, normalize=functools.partial(
            device_normalize, whwh=whwh))
        out = m.run_heads(feats, whwh, t)
        with span('mcgaze.select'):
            return topk_tracks_batched(out['stages'][-1], kq, t,
                                       mc.max_per_img, mc.num_classes)

    return fwd, fwd_batched


def bind_query_forward(fwd, fwd_batched, device):
    """InstBlinkVideoEvaluator's forward_fn: forward(imgs, whwh) with host
    or device inputs, `.batched(imgs, whwh, kq)` beside it, outputs left on
    the device; marks itself accepts_uint8 and carries `.device`."""
    device = resolve_device(device)

    def forward(imgs, whwh):
        dev = run_device(imgs, device)
        return fwd(to_device(imgs, dev), to_device(whwh, dev))

    def batched(imgs, whwh, kq):
        with span('mcgaze.eval'):
            dev = run_device(imgs, device)
            with span('mcgaze.handover'):
                args = (to_device(imgs, dev), to_device(whwh, dev))
            return fwd_batched(*args, kq)

    forward.batched = batched
    forward.accepts_uint8 = True
    forward.device = device
    return forward
