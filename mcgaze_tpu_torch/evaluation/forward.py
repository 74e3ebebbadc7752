"""Eval forward, counterpart of mcgaze_tpu/evaluation/forward.py.

`make_eval_forward` builds the model on a device and returns two forwards
over it, both run under torch.inference_mode():
  fwd(imgs (N,H,W,3) u8|f32, whwh (N,4), t) -> (boxes (N,3,4),
      scores (N,3), gazes {fusion, face, eyes, head} -> (N,3))
  fwd_dedup(frames (U,H,W,3), sel (N,), whwh_u (U,4), t) -> the same,
      with backbone + FPN run once per unique frame and each clip slot
      reading frame sel[slot] (the RoIAlign kernel's frame_idx form).
`bind_forward` adapts them to the driver's forward_fn signature.

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

import numpy as np
import torch

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..models.mcgaze import MCGazeModel, ModelConfig, init_model
from ..utils.env import resolve_device


def device_normalize(imgs: torch.Tensor, whwh: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalised f32 with the pad region zeroed
    AFTER normalising (the reference pads after Normalize, so the pad is 0
    in normalised space). Float frames (normalised on the host) pass
    through."""
    if imgs.dtype != torch.uint8:
        return imgs
    mean = torch.as_tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.as_tensor(IMAGENET_STD, device=imgs.device)
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
    weights)."""
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
        frames = device_normalize(frames, whwh_u)
        feats = m.extract_features(frames)
        sel = sel.to(torch.int32)
        out = m.run_heads(feats, whwh_u[sel.long()], clip_length=t,
                          frame_idx=sel)
        return _last_stage(out)

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


def bind_forward(fwd, device, fwd_dedup=None):
    """The driver's forward_fn: forward(imgs, whwh, t) with host or device
    inputs, outputs left on the device the forward ran on (run_device).
    Marks itself accepts_uint8 (the forwards normalise u8 on the device)
    and carries `.device`; with fwd_dedup it also carries `.dedup(frames,
    sel, whwh_u, t)`, which the driver prefers (EvalConfig.dedup_frames)."""
    device = resolve_device(device)

    def forward(imgs, whwh, t):
        dev = run_device(imgs, device)
        return fwd(to_device(imgs, dev), to_device(whwh, dev), t)

    forward.accepts_uint8 = True
    forward.device = device
    if fwd_dedup is not None:
        def dedup(frames, sel, whwh_u, t):
            dev = run_device(frames, device)
            return fwd_dedup(to_device(frames, dev), to_device(sel, dev),
                             to_device(whwh_u, dev), t)

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
        imgs = device_normalize(imgs, whwh)
        t = imgs.shape[0] // kq
        out = replicas.on(imgs.device)(imgs, whwh, clip_length=t)
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
        dev = run_device(imgs, device)
        return fwd_batched(to_device(imgs, dev), to_device(whwh, dev), kq)

    forward.batched = batched
    forward.accepts_uint8 = True
    forward.device = device
    return forward
