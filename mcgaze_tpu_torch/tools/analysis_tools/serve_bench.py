"""Serving latency and rate under concurrent load, counterpart of
tools/analysis_tools/serve_bench.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.serve_bench
        [--image 224] [--dtype bfloat16] [--requests 48]
        [--concurrency 1 4 8] [--max-batch 8] [--batch-timeout-ms 5]
        [--frames 1] [--http] [--device cuda|cpu]

The micro-batched engine of evaluation/serving.py on the full-width model
(seeded random weights), warmed up on every bucket first. Engine mode
(default): client threads call GazeRequestProcessor.process_body directly
(preprocessing, micro-batching, the forward, formatting). --http: they
POST to a ThreadingHTTPServer on localhost, adding HTTP parsing and
serialisation; the server is shut down at the end. Per concurrency level:
p50, p99 (nearest rank) and mean latency, requests/s, and the mean clips
per device launch (the batching at work).

Request images are PNG bytes where OpenCV is installed; where it is not,
.npy bytes decoded under npy_frames.npy_request_images(), which the
printed `decode` names.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import threading
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--image', type=int, default=224)
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--requests', type=int, default=48,
                   help='requests per client')
    p.add_argument('--concurrency', type=int, nargs='+',
                   default=[1, 4, 8])
    p.add_argument('--max-batch', type=int, default=8)
    p.add_argument('--batch-timeout-ms', type=float, default=5.0)
    p.add_argument('--http', action='store_true')
    p.add_argument('--frames', type=int, default=1,
                   help='frames per request (1 = single image tiled to a '
                        'clip; the served unit is one clip either way)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def run_load(do_request, n_clients: int, n_requests: int):
    """n_clients threads x n_requests each -> (latencies_s, wall_s)."""
    latencies = []
    lock = threading.Lock()
    start_barrier = threading.Barrier(n_clients + 1)
    errors = []

    def client():
        start_barrier.wait()
        mine = []
        try:
            for _ in range(n_requests):
                t0 = time.perf_counter()
                do_request()
                mine.append(time.perf_counter() - t0)
        except BaseException as e:           # raised in the caller
            errors.append(e)
        with lock:
            latencies.extend(mine)

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    for t in threads:
        t.start()
    start_barrier.wait()
    wall0 = time.perf_counter()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return latencies, time.perf_counter() - wall0


def image_body(img: np.ndarray):
    """(request bytes of one RGB frame, decode context, its name): PNG with
    OpenCV, else .npy bytes under the serving stand-in."""
    from .npy_frames import (NPY_IMAGE_DECODE, have_cv2, npy_bytes,
                             npy_request_images)
    if have_cv2():
        import cv2
        ok, buf = cv2.imencode('.png', img)
        assert ok
        return buf.tobytes(), contextlib.nullcontext(), 'png (cv2)'
    return npy_bytes(img), npy_request_images(), NPY_IMAGE_DECODE


def main(argv=None):
    """Returns dict(image, dtype, frames, decode, results: the rows)."""
    args = parse_args(argv)
    from ...evaluation.driver import EvalConfig
    from ...evaluation.forward import bind_forward, make_eval_forward
    from ...evaluation.serving import (GazeRequestProcessor, ServeConfig,
                                       make_server)
    from ...models.mcgaze import ModelConfig
    from ...utils.env import resolve_device

    device = resolve_device(args.device)
    size = (args.image, args.image)
    model_cfg = ModelConfig(dtype=args.dtype)
    eval_cfg = EvalConfig(scale=size, canvas=size)
    _, fwd, fwd_dedup = make_eval_forward(model_cfg, device=device)
    processor = GazeRequestProcessor(
        bind_forward(fwd, device, fwd_dedup), eval_cfg,
        ServeConfig(max_batch=args.max_batch,
                    batch_timeout_ms=args.batch_timeout_ms))
    server = None
    try:
        print('running every micro-batch bucket once ...', flush=True)
        t0 = time.perf_counter()
        processor.warmup()
        print(f'warmup {time.perf_counter() - t0:.1f}s', flush=True)

        rng = np.random.RandomState(0)
        img = rng.randint(0, 255, (args.image, args.image, 3)).astype(
            np.uint8)
        body, decode, decode_name = image_body(img)
        if args.frames > 1:
            import base64
            b64 = base64.b64encode(body).decode()
            body = json.dumps({'frames': [b64] * args.frames}).encode()

        if args.http:
            import http.client
            server = make_server(processor, '127.0.0.1', 0)
            port = server.server_address[1]
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()

            def do_request():
                conn = http.client.HTTPConnection('127.0.0.1', port,
                                                  timeout=120)
                conn.request('POST',
                             f'/predictions/{processor.cfg.model_name}',
                             body=body)
                resp = conn.getresponse()
                data = resp.read()
                assert resp.status == 200, data[:200]
                json.loads(data)
                conn.close()
        else:
            def do_request():
                processor.process_body(body)

        results = []
        with decode:
            for c in args.concurrency:
                do_request()  # first-call effects at this concurrency
                # cleared after the solo call, so it does not deflate the
                # measured micro-batch occupancy
                processor.batcher.batch_sizes.clear()
                lat, wall = run_load(do_request, c, args.requests)
                n = len(lat)
                sizes = processor.batcher.batch_sizes
                row = dict(
                    concurrency=c,
                    mode='http' if args.http else 'engine',
                    p50_ms=round(statistics.median(lat) * 1e3, 2),
                    # nearest-rank p99: index ceil(0.99 n) - 1
                    p99_ms=round(sorted(lat)[min(n - 1, max(
                        0, -(-99 * n // 100) - 1))] * 1e3, 2),
                    mean_ms=round(statistics.mean(lat) * 1e3, 2),
                    requests_per_s=round(n / wall, 2),
                    mean_batch_clips=round(statistics.mean(sizes), 2)
                    if sizes else None,
                    launches=len(sizes),
                )
                results.append(row)
                print(json.dumps(row), flush=True)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        processor.close()
    out = dict(image=args.image, dtype=args.dtype, frames=args.frames,
               decode=decode_name, results=results)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
