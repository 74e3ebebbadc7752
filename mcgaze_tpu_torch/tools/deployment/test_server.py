"""Served result against the local one, counterpart of
tools/deployment/test_server.py (reference surface:
tools/deployment/test_torchserver.py: run the model locally AND through
the server on the same image, assert the predictions agree):

    python -m mcgaze_tpu_torch.tools.deployment.serve <config> <ckpt> &
    python -m mcgaze_tpu_torch.tools.deployment.test_server img.jpg
        <config> <ckpt> <model_name> [--inference-addr 127.0.0.1:8080]
        [--device cuda|cpu]

--device defaults to the card and refuses without one. Decoding the image
needs OpenCV.
"""
from __future__ import annotations

import argparse
import json
import urllib.request

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('img', help='image file')
    p.add_argument('config')
    p.add_argument('checkpoint', help='torch .pth')
    p.add_argument('model_name', help='the model name in the server')
    p.add_argument('--inference-addr', default='127.0.0.1:8080')
    p.add_argument('--score-thr', type=float, default=0.5,
                   help='must match the server\'s --score-thr (both sides '
                        'filter before comparing, as the reference client '
                        'does)')
    p.add_argument('--atol', type=float, default=1e-4)
    p.add_argument('--dtype', default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None)
    return p.parse_args(argv)


def post_image(addr: str, model_name: str, body: bytes):
    url = f'http://{addr}/predictions/{model_name}'
    req = urllib.request.Request(url, data=body, method='POST')
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def assert_same(local: list, served: list, atol: float) -> float:
    """Two handler-style entry lists agree: the same classes in order,
    bbox, score and gaze within atol. Returns the largest difference."""
    if len(local) != len(served):
        raise AssertionError(f'{len(local)} local entries vs {len(served)} '
                             'served')
    worst = 0.0
    for lo, se in zip(local, served):
        if lo['class_name'] != se['class_name']:
            raise AssertionError(f"{lo['class_name']} vs {se['class_name']}")
        for key in ('bbox', 'score', 'gaze'):
            if key in lo or key in se:
                diff = float(np.max(np.abs(np.subtract(lo[key], se[key]))))
                if not diff <= atol:
                    raise AssertionError(f"{lo['class_name']}.{key}: "
                                         f'{lo[key]} vs {se[key]}')
                worst = max(worst, diff)
    return worst


def main(argv=None) -> dict:
    from ...evaluation.serving import GazeRequestProcessor, ServeConfig
    from ...utils.cfg_options import apply_overrides
    from ...utils.config import load_config
    from ..test_gaze360_gaze import build_forward

    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    forward = build_forward(cfg, args.checkpoint, args.dtype,
                            device=args.device)
    processor = GazeRequestProcessor(
        forward, cfg.eval_cfg, ServeConfig(score_thr=args.score_thr))
    with open(args.img, 'rb') as f:
        body = f.read()
    try:
        local = processor.process_image_bytes(body)
    finally:
        processor.close()
    print('local result:')
    print(json.dumps(local, indent=2))

    served = post_image(args.inference_addr, args.model_name, body)
    print('server result:')
    print(json.dumps(served, indent=2))

    worst = assert_same(local, served, args.atol)
    print(f'PARITY OK ({len(local)} entries, atol={args.atol})')
    return dict(local=local, served=served, max_abs_diff=worst)


if __name__ == '__main__':
    main()
