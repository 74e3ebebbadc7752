"""Model serving, counterpart of mcgaze_tpu/evaluation/serving.py
(reference surface: tools/deployment/mmdet2torchserve.py + mmdet_handler.py
+ test_torchserver.py).

The reference deploys through TorchServe: an archive of config +
checkpoint + a python handler, HTTP endpoints ``GET /ping`` and
``POST /predictions/<model_name>``. This module serves the port's eval
forward the same way:

* **pow2 clip buckets**: every micro-batch is padded to a power-of-two
  clip count (the eval driver's bucketing), so a bounded set of shapes
  serves every load and `warmup` can run each one before traffic;
* **micro-batching**: concurrent requests ride one device forward; a
  request waits at most ``batch_timeout_ms`` for co-riders;
* **eval numerics**: frames run through the driver's preprocessing and
  the same forward as the eval CLIs, so a served prediction equals the
  offline results entry.

Request surface (mirrors the TorchServe handler):
  * raw image bytes (JPEG/PNG body) -> flat list of
    ``{class_name: face|eyes|head, bbox: [x1,y1,x2,y2], score, gaze}``
    entries filtered at ``score_thr``, plus one
    ``{class_name: 'fusion', gaze}`` entry. The image is tiled to a full
    clip.
  * JSON body ``{"frames": [<base64 jpg/png>, ...]}`` ->
    ``{"frames": [<per-frame list as above>], "fusion_gazes": [...]}``.
    Up to ``clip_length`` frames run through the micro-batcher
    (right-padded by repeating the last frame); longer sequences run the
    video driver with overlap-averaged stitching and return the results
    JSON schema.

Boxes are in cropped-image coordinates (``rescale=True``), xyxy like the
reference handler. Decoding JPEG/PNG needs OpenCV.
"""
from __future__ import annotations

import base64
import dataclasses
import itertools
import json
import os.path as osp
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np
import torch

from .driver import (EvalConfig, PERSON_THRESHOLD, VideoGazeEvaluator,
                     pack_outputs, preprocess_frames, preprocess_frames_u8)
from .forward import to_device

CLUES = ('face', 'eyes', 'head')


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    model_name: str = 'mcgaze'
    score_thr: float = PERSON_THRESHOLD
    # upper micro-batch bound, in clips; batches are pow2-bucketed up to
    # next_pow2(max_batch)
    max_batch: int = 8
    # how long a request waits for co-riders before the batch launches
    batch_timeout_ms: float = 5.0


def decode_image_bytes(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> HxWx3 RGB uint8 (the handler's imfrombytes)."""
    import cv2
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError('request body is not a decodable image')
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def is_json_body(body: bytes, content_type: str = '') -> bool:
    return 'json' in (content_type or '').lower() or (
        body[:1] in (b'{', b'[') and b'"frames"' in body[:256])


def parse_request_body(body: bytes, content_type: str = '') -> list:
    """Request body -> list of RGB uint8 frames: base64 frames of a JSON
    body (``{"frames": [...]}``), else one raw image."""
    if is_json_body(body, content_type):
        payload = json.loads(body)
        frames_b64 = payload['frames'] if isinstance(payload, dict) \
            else payload
        if not frames_b64:
            raise ValueError('"frames" is empty')
        return [decode_image_bytes(base64.b64decode(f))
                for f in frames_b64]
    return [decode_image_bytes(body)]


def packed_readback(boxes, scores, gazes):
    """Forward outputs -> host numpy (boxes, scores, gazes) through one
    device -> host copy of the driver's packed (N, 27) layout."""
    names, flat = pack_outputs(boxes, scores, gazes)
    n = boxes.shape[0]
    b, s, g = VideoGazeEvaluator._split_flat(flat.cpu().numpy(), 1, 1,
                                             names, n)
    return b[0], s[0], {m: v[0] for m, v in g.items()}


class MicroBatcher:
    """Gathers concurrent clip requests into one padded device forward.

    forward(imgs (K*T, H, W, 3) u8|f32, whwh (K*T, 4), T) ->
        (boxes (K*T, 3, 4), scores (K*T, 3), gazes dict name->(K*T, 3))
    as tensors (evaluation/forward.py::bind_forward).

    Each client thread copies its frames to the forward's `.device` (the
    CPU for a forward without one) in `submit`, through pinned memory
    without blocking. One worker thread owns the forward: it blocks for
    the first request, drains co-riders for up to timeout_ms (or
    max_batch), pads the clip count to the next power of two by repeating
    the first request's first clip, concatenates on the device, runs ONE
    forward, reads it back in one copy and fans results out through
    per-request events. A queued item holds one clip from `submit`, or
    the clips of a whole bucket from `run_bucket`.
    """

    def __init__(self, forward: Callable, clip_length: int,
                 max_batch: int = 8, timeout_ms: float = 5.0):
        self.forward = forward
        self.device = getattr(forward, 'device', torch.device('cpu'))
        self.clip_length = clip_length
        self.max_batch = max_batch
        self.timeout_s = timeout_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._stopped = False
        self.batch_sizes: list = []  # observability: clips per launch
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, imgs: np.ndarray, whwh: np.ndarray):
        """imgs (T, H, W, 3) u8|f32, whwh (T, 4) -> (boxes (T,3,4),
        scores (T,3), gazes dict name->(T,3)) as numpy. Blocks until
        served."""
        t = self.clip_length
        if imgs.shape[0] != t:
            raise ValueError(f'need exactly {t} frames, got '
                             f'{imgs.shape[0]} (pad upstream)')
        return self._enqueue(imgs, whwh)

    def run_bucket(self, imgs: np.ndarray, whwh: np.ndarray):
        """Serve imgs (K*T, H, W, 3), K whole clips, in one batch of the
        worker thread and wait for it (warmup, before any traffic): cuDNN
        and cuBLAS handles and their workspaces belong to the thread that
        calls them, so a bucket run on another thread would leave the
        worker's first batch to create its own."""
        if imgs.shape[0] % self.clip_length:
            raise ValueError(f'{imgs.shape[0]} frames are not whole clips')
        return self._enqueue(imgs, whwh)

    def _enqueue(self, imgs, whwh):
        if self._stopped:
            raise RuntimeError('MicroBatcher is stopped')
        # producer-side upload: each client's copy runs on its own thread,
        # so the batch never waits on k uploads in a row
        imgs = to_device(imgs, self.device)
        done = threading.Event()
        slot: dict = {}
        self._queue.put((imgs, whwh, done, slot))
        done.wait()
        if 'error' in slot:
            raise slot['error']
        return slot['result']

    def stop(self):
        self._stopped = True
        self._queue.put(None)
        self._worker.join(timeout=5)
        # fail (don't hang) requests still queued behind the sentinel: a
        # submit() racing stop() would otherwise wait forever
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                _, _, done, slot = item
                slot['error'] = RuntimeError('MicroBatcher stopped')
                done.set()

    def _drain(self):
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        deadline = time.monotonic() + self.timeout_s
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                return items  # serve what we have; next loop sees stop
            items.append(nxt)
        return items

    def _run(self):
        while not self._stopped:
            items = self._drain()
            if items is None:
                return
            try:
                self._serve(items)
            except Exception as e:  # surface to every waiter
                for _, _, done, slot in items:
                    slot['error'] = e
                    done.set()

    def _serve(self, items):
        t = self.clip_length
        k = sum(it[0].shape[0] for it in items) // t
        k_pad = 1 << (k - 1).bit_length()
        self.batch_sizes.append(k)
        # device-side concat: the frames arrived on the device in submit
        imgs = torch.cat([it[0] for it in items] +
                         [items[0][0][:t]] * (k_pad - k))
        whwh = np.concatenate([it[1] for it in items] +
                              [items[0][1][:t]] * (k_pad - k))
        boxes, scores, gazes = packed_readback(
            *self.forward(imgs, whwh, t))
        row = 0
        for item_imgs, _, done, slot in items:
            s = slice(row, row + item_imgs.shape[0])
            row = s.stop
            slot['result'] = (boxes[s], scores[s],
                              {name: g[s] for name, g in gazes.items()})
            done.set()


class GazeRequestProcessor:
    """Decodes request payloads, preprocesses with the eval pipeline,
    forwards through the micro-batcher, and formats handler-style JSON
    (the reference handler's entries plus per-clue gaze vectors)."""

    def __init__(self, forward_fn: Callable, eval_cfg: EvalConfig,
                 serve_cfg: ServeConfig = ServeConfig()):
        self.eval_cfg = eval_cfg
        self.cfg = serve_cfg
        # ship raw u8 frames when the forward normalises on the device:
        # 4x less host -> device traffic per request
        self.ship_u8 = bool(getattr(forward_fn, 'accepts_uint8', False))
        self.batcher = MicroBatcher(forward_fn, eval_cfg.clip_length,
                                    serve_cfg.max_batch,
                                    serve_cfg.batch_timeout_ms)
        # long requests (> clip_length frames) take the video path:
        # stitched, overlap-averaged, identical to the eval CLIs' output
        self.evaluator = VideoGazeEvaluator(forward_fn, eval_cfg)
        self._video_counter = itertools.count()

    def close(self):
        self.batcher.stop()

    def warmup(self, video_path: bool = True) -> dict:
        """Run every shape a request can reach before accepting traffic:
        nothing compiles on the card, but a first forward at a new shape,
        or on a new thread, pays for cuDNN's algorithm choice, the
        allocator's growth and the thread's cuDNN and cuBLAS handles.

        Micro-batch buckets go up to next_pow2(max_batch), each served by
        the batcher's worker thread (MicroBatcher.run_bucket): _serve pads
        the drained clip count to a power of two, so a non-pow2 max_batch
        (say 6) still launches the 8-bucket under a full burst.
        video_path=True also runs the long-request flow (> clip_length
        frames -> VideoGazeEvaluator), which runs on the requests' own
        threads: one synthetic video per pow2 clip-chunk bucket up to
        clip_batch, on a thread that then ends, so the handles it made
        return to the pool that request threads draw from. Each bucket
        ends in a host read, so its time is the device's too. Returns
        {'clip_<k>' | 'video_<k>': seconds}."""
        t = self.eval_cfg.clip_length
        h, w = self.eval_cfg.canvas
        dtype = np.uint8 if self.ship_u8 else np.float32
        seconds = {}
        k = 1
        while True:
            imgs = np.zeros((k * t, h, w, 3), dtype)
            whwh = np.tile(np.array([w, h, w, h], np.float32), (k * t, 1))
            t0 = time.perf_counter()
            self.batcher.run_bucket(imgs, whwh)
            seconds[f'clip_{k}'] = time.perf_counter() - t0
            if k >= self.cfg.max_batch:
                break
            k *= 2
        if video_path:
            failed = []

            def videos():
                stride = self.eval_cfg.stride
                frame = np.zeros((h, w, 3), np.uint8)
                k = 1
                try:
                    while k <= self.eval_cfg.clip_batch:
                        # F frames -> exactly k clips at the eval stride
                        t0 = time.perf_counter()
                        self.evaluator.run_video(
                            [frame] * (stride * (k - 1) + t), video_id=-1)
                        seconds[f'video_{k}'] = time.perf_counter() - t0
                        k *= 2
                except Exception as e:  # re-raised on the caller's thread
                    failed.append(e)

            thread = threading.Thread(target=videos)
            thread.start()
            thread.join()
            if failed:
                raise failed[0]
        return seconds

    def _preprocess(self, frames: list):
        prep = preprocess_frames_u8 if self.ship_u8 else preprocess_frames
        return prep(frames, self.eval_cfg)

    def _forward_clip(self, frames: list):
        """<= clip_length RGB frames -> per-frame (boxes, scores, gazes),
        truncated back to the real frame count."""
        t = self.eval_cfg.clip_length
        f = len(frames)
        if f > t:
            raise ValueError(f'clip path takes <= {t} frames')
        frames = list(frames) + [frames[-1]] * (t - f)
        imgs, whwh, sfs = self._preprocess(frames)
        boxes, scores, gazes = self.batcher.submit(imgs, whwh)
        # rescale=True semantics: boxes back to cropped-image coords
        boxes = boxes / sfs[:, None, :]
        return (boxes[:f], scores[:f],
                {name: g[:f] for name, g in gazes.items()})

    def _format_frame(self, boxes, scores, gazes, fusion) -> list:
        out = []
        for qi, clue in enumerate(CLUES):
            score = float(scores[qi])
            if score < self.cfg.score_thr:
                continue
            out.append(dict(class_name=clue,
                            bbox=[float(v) for v in boxes[qi]],
                            score=score,
                            gaze=[float(v) for v in gazes[clue]]))
        out.append(dict(class_name='fusion',
                        gaze=[float(v) for v in fusion]))
        return out

    def process_image_bytes(self, body: bytes) -> list:
        """Single raw image -> flat handler-style list."""
        return self._single_frame(decode_image_bytes(body))

    def _single_frame(self, frame: np.ndarray) -> list:
        t = self.eval_cfg.clip_length
        # preprocess once and tile on the host: the clip is t copies of
        # the same frame
        imgs, whwh, sfs = self._preprocess([frame])
        boxes, scores, gazes = self.batcher.submit(
            np.repeat(imgs, t, axis=0), np.repeat(whwh, t, axis=0))
        boxes = boxes / sfs[0][None, :]
        # identical frames -> any row works; frame 0 by convention
        return self._format_frame(
            boxes[0], scores[0],
            {name: g[0] for name, g in gazes.items()},
            gazes['fusion'][0])

    def process_frames(self, frames: list):
        """Frame list -> clip response dict (or the stitched results JSON
        schema when the request is longer than one clip)."""
        if len(frames) > self.eval_cfg.clip_length:
            vid = next(self._video_counter)
            return self.evaluator.run_video(frames, video_id=vid)
        boxes, scores, gazes = self._forward_clip(frames)
        per_frame = [
            self._format_frame(boxes[i], scores[i],
                               {n: g[i] for n, g in gazes.items()},
                               gazes['fusion'][i])
            for i in range(len(frames))]
        return dict(frames=per_frame,
                    fusion_gazes=[[float(v) for v in gazes['fusion'][i]]
                                  for i in range(len(frames))])

    def process_body(self, body: bytes, content_type: str = ''):
        """Raw image bytes -> flat handler list; JSON {"frames": [...]}
        -> the clip/video response dict whatever the frame count, so a
        JSON client's response shape never depends on how many frames a
        request carries."""
        frames = parse_request_body(body, content_type)
        if not is_json_body(body, content_type):
            return self._single_frame(frames[0])
        return self.process_frames(frames)


# ---------------------------------------------------------------- server

def resolve_package(path: str):
    """A model package dir (tools/deployment/package_model.py, the
    mmdet2torchserve .mar analogue) -> (config_path, checkpoint_path,
    model_name). Returns None when `path` is not a package."""
    manifest_path = osp.join(path, 'MANIFEST.json')
    if not (osp.isdir(path) and osp.isfile(manifest_path)):
        return None
    with open(manifest_path) as f:
        manifest = json.load(f)
    return (osp.join(path, manifest['config']),
            osp.join(path, manifest['checkpoint']),
            manifest['model_name'])


def make_server(processor: GazeRequestProcessor, host: str = '127.0.0.1',
                port: int = 8080) -> ThreadingHTTPServer:
    """TorchServe-surface HTTP server: GET /ping, GET /models,
    POST /predictions/<model_name>."""
    model_name = processor.cfg.model_name

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet per-request stderr
            pass

        def _json(self, code: int, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == '/ping':
                self._json(200, {'status': 'Healthy'})
            elif self.path == '/models':
                self._json(200, {'models': [
                    {'modelName': model_name,
                     'modelUrl': f'/predictions/{model_name}'}]})
            else:
                self._json(404, {'error': f'no such path {self.path}'})

        def do_POST(self):
            if self.path != f'/predictions/{model_name}':
                self._json(404, {'error': f'no model at {self.path}; '
                                 f'serving /predictions/{model_name}'})
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                body = self.rfile.read(length)
                result = processor.process_body(
                    body, self.headers.get('Content-Type', ''))
                self._json(200, result)
            except (ValueError, KeyError, TypeError) as e:
                # a malformed payload (undecodable image, bad JSON shape,
                # missing 'frames') is the client's fault: 400, so
                # retry-on-5xx clients and load balancers don't treat a
                # healthy server as down
                self._json(400, {'error': str(e)})
            except Exception as e:
                traceback.print_exc()
                self._json(503, {'error': str(e)})

    return ThreadingHTTPServer((host, port), Handler)
