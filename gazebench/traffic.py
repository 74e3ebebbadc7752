"""The one generator of the cells' batches and the seeded weights, made on
the device from the seed in a few large draws.

A traffic file under traffic/ names its `kind` and its sizes:

  dedup_clips    gaze eval: `clips` clips of `clip_length` frames at
                 `stride` over one video window, sent as the window's
                 unique uint8 frames, the slot -> frame map and the frames'
                 (w, h) of `width` x `height` (canvas) images
  video_windows  query eval: `clips` windows of `clip_length` frames at
                 stride clip_length - `overlap` over a video of
                 `image_width` x `image_height` frames on a `width` x
                 `height` canvas, each window's frames sent in full
  train_clips    gaze training: `clips` clips of `clip_length` uint8
                 frames with face, eyes and head boxes (a
                 `head_only_share` of frames carry the head alone) and one
                 unit gaze a frame

Every kind makes `pool` batches; a run cycles through them, so every seed
gives the same sizes and only the pixel values, boxes and weights
change.
"""
from __future__ import annotations

import fnmatch
import math

import numpy as np
import torch


def stream(seed: int, purpose: int) -> int:
    """An independent 63-bit seed for one purpose (weights, traffic, the
    check's sample) of a run's seed."""
    return int(np.random.SeedSequence([int(seed), purpose])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHTS, TRAFFIC, SAMPLE = 1, 2, 3


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, purpose))


def proposal_boxes(n: int, spec: dict, g, device) -> torch.Tensor:
    """(n, 4) learned proposals (cx, cy, w, h, normalised to the image):
    centres in the middle 60% of the image, each box's side sqrt(w h) in
    pixels drawn in one of spec['sides'] (bands that keep every proposal
    clear of an FPN level boundary), aspect w/h in [0.75, 1.33]."""
    iw, ih = spec['image']
    bands = torch.tensor(spec['sides'], dtype=torch.float32, device=device)
    pick = torch.randint(0, len(bands), (n,), generator=g, device=device)
    lo, hi = bands[pick, 0], bands[pick, 1]
    r = torch.rand((n, 4), generator=g, device=device)
    side = lo + (hi - lo) * r[:, 0]
    aspect = 0.75 + (1.33 - 0.75) * r[:, 1]
    w = side * aspect.sqrt() / iw
    h = side / aspect.sqrt() / ih
    return torch.stack([0.3 + 0.4 * r[:, 2], 0.3 + 0.4 * r[:, 3], w, h], -1)


def make_weights(specs, seed: int, device, proposals: dict | None = None,
                 zeros=(), scales=None, biases=None) -> dict:
    """A state dict of `specs` [(name, shape, init)]: 'lecun' N(0,
    1/fan_in) (flax's default kernel init, the port's too), 'normal' N(0,
    1), 'zeros', 'ones', 'whole_image' proposal boxes (0.5, 0.5, 1, 1), or
    with `proposals` (a config's weights.proposals) `proposal_boxes`.
    Tensors whose name matches a pattern of `zeros` (fnmatch) are zero;
    `scales` {pattern: factor} multiplies a random tensor, `biases`
    {pattern: vector} sets a bias. One normal draw on the device covers
    every random tensor."""
    g = generator(seed, WEIGHTS, device)
    specs = [(n, s, 'zeros' if any(fnmatch.fnmatchcase(n, z) for z in zeros)
              else i) for n, s, i in specs]
    total = sum(math.prod(s) for _, s, i in specs if i in ('lecun', 'normal'))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, init in specs:
        if init in ('lecun', 'normal'):
            k = math.prod(shape)
            t = flat[off:off + k].view(shape)
            off += k
            if init == 'lecun':
                t = t * (1.0 / math.sqrt(math.prod(shape[1:])))
            for pat, factor in (scales or {}).items():
                if fnmatch.fnmatchcase(name, pat):
                    t = t * factor
            out[name] = t
        elif init == 'zeros':
            out[name] = torch.zeros(shape, device=device)
        elif init == 'ones':
            out[name] = torch.ones(shape, device=device)
        elif init == 'whole_image' and proposals:
            out[name] = proposal_boxes(shape[0], proposals, g, device)
        elif init == 'whole_image':
            out[name] = torch.tensor([0.5, 0.5, 1.0, 1.0],
                                     device=device).expand(shape).clone()
        else:
            raise ValueError(f'{name}: init {init!r}')
        for pat, vec in (biases or {}).items():
            if fnmatch.fnmatchcase(name, pat):
                out[name] = torch.tensor(vec, dtype=torch.float32,
                                         device=device).expand(shape).clone()
    return out


def dedup_pool(tr: dict, seed: int, device) -> dict:
    """Host batches of the gaze eval: frames (pool, U, H, W, 3) uint8,
    sel (N,) int32, whwh (U, 4) f32."""
    starts = [i * tr['stride'] for i in range(tr['clips'])]
    u = starts[-1] + tr['clip_length']
    sel = np.concatenate([np.arange(s, s + tr['clip_length'])
                          for s in starts]).astype(np.int32)
    g = generator(seed, TRAFFIC, device)
    frames = torch.randint(0, 256, (tr['pool'], u, tr['height'], tr['width'],
                                    3), generator=g, device=device,
                           dtype=torch.uint8).cpu().numpy()
    w, h = tr['width'], tr['height']
    whwh = np.tile(np.array([[w, h, w, h]], np.float32), (u, 1))
    return dict(frames=frames, sel=sel, whwh=whwh)


def window_pool(tr: dict, seed: int, device) -> dict:
    """Host batches of the query eval: frames (pool, clips * T, H, W, 3)
    uint8 (the windows of one video, overlaps repeated as the driver
    sends them), whwh (clips * T, 4) f32 of the un-padded image."""
    t, k = tr['clip_length'], tr['clips']
    stride = t - tr['overlap']
    video = stride * (k - 1) + t
    sel = np.concatenate([np.arange(i * stride, i * stride + t)
                          for i in range(k)])
    g = generator(seed, TRAFFIC, device)
    canvas = torch.zeros((tr['pool'], video, tr['height'], tr['width'], 3),
                         dtype=torch.uint8, device=device)
    canvas[:, :, :tr['image_height'], :tr['image_width']] = torch.randint(
        0, 256, (tr['pool'], video, tr['image_height'], tr['image_width'], 3),
        generator=g, device=device, dtype=torch.uint8)
    frames = canvas[:, torch.from_numpy(sel).to(device)].cpu().numpy()
    w, h = tr['image_width'], tr['image_height']
    whwh = np.tile(np.array([[w, h, w, h]], np.float32), (k * t, 1))
    return dict(frames=frames, whwh=whwh)


def train_pool(tr: dict, seed: int, device) -> list:
    """Device batches of the gaze training, each a dict of imgs (B, T, H,
    W, 3) uint8, img_whwh (B, T, 4), gt_boxes (B, T, 3, 4) xyxy in the
    slot layout (face, eyes, head; zero where absent), gt_valid (B, T, 3),
    gt_gazes (B, T, 3, 3)."""
    b, t, h, w = tr['clips'], tr['clip_length'], tr['height'], tr['width']
    g = generator(seed, TRAFFIC, device)
    pool = []
    for _ in range(tr['pool']):
        def u(*shape):
            return torch.rand(shape, generator=g, device=device)

        size = torch.tensor([w, h], device=device, dtype=torch.float32)
        centre = (0.35 + 0.3 * u(b, t, 2)) * size
        half = (0.175 + 0.125 * u(b, t, 2)) * size
        head = torch.cat([centre - half, centre + half], -1)
        face = torch.cat([centre - 0.7 * half, centre + 0.7 * half], -1)
        fh = face[..., 3] - face[..., 1]
        fw = face[..., 2] - face[..., 0]
        eyes = torch.stack([face[..., 0] + 0.1 * fw, face[..., 1] + 0.25 * fh,
                            face[..., 2] - 0.1 * fw, face[..., 1] + 0.45 * fh],
                           -1)
        full = (u(b, t) >= tr['head_only_share']).float()
        valid = torch.stack([full, full, torch.ones_like(full)], -1)
        boxes = torch.stack([face, eyes, head], 2) * valid[..., None]
        gaze = torch.randn((b, t, 3), generator=g, device=device)
        gaze = gaze / torch.linalg.norm(gaze, dim=-1, keepdim=True)
        gazes = gaze[:, :, None, :] * valid[..., None]
        imgs = torch.randint(0, 256, (b, t, h, w, 3), generator=g,
                             device=device, dtype=torch.uint8)
        whwh = torch.tensor([w, h, w, h], dtype=torch.float32,
                            device=device).expand(b, t, 4).contiguous()
        pool.append(dict(imgs=imgs, img_whwh=whwh, gt_boxes=boxes,
                         gt_valid=valid, gt_gazes=gazes))
    return pool


POOLS = dict(dedup_clips=dedup_pool, video_windows=window_pool,
             train_clips=train_pool)


def make_pool(tr: dict, seed: int, device):
    """The batches of the traffic file's `kind`."""
    return POOLS[tr['kind']](tr, seed, device)
