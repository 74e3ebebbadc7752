"""Inference server of the port, counterpart of tools/deployment/serve.py
(reference deployment surface: TorchServe's GET /ping, GET /models,
POST /predictions/<model_name>):

    python -m mcgaze_tpu_torch.tools.deployment.serve <config> <ckpt.pth>
        [--port 8080] [--device cuda|cpu] [--dtype bfloat16] ...
    python -m mcgaze_tpu_torch.tools.deployment.serve <package_dir>

A package directory comes from tools/deployment/package_model.py.
Concurrent requests are micro-batched into one padded device forward
(evaluation/serving.py); every batch and video-chunk shape runs once
before the server accepts traffic. --device defaults to the card and
refuses without one. JPEG/PNG request bodies are decoded with OpenCV.
"""
from __future__ import annotations

import argparse
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('model',
                   help='config file, or a package dir from '
                        'tools/deployment/package_model.py')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='torch .pth (omit for package dirs; a config '
                        'without one serves seeded random weights)')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--model-name', default=None,
                   help='name under /predictions/ (default: package '
                        'manifest name or config stem)')
    p.add_argument('--score-thr', type=float, default=0.5)
    p.add_argument('--max-batch', type=int, default=8,
                   help='micro-batch upper bound, in clips')
    p.add_argument('--batch-timeout-ms', type=float, default=5.0)
    p.add_argument('--dtype', default=None)
    p.add_argument('--ema', action='store_true',
                   help='serve the EMA weights of <ckpt>_train.pth')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--cfg-options', nargs='+', default=None)
    return p.parse_args(argv)


def build_processor(args):
    """The GazeRequestProcessor of parsed CLI args, not yet warmed up."""
    from ...evaluation.serving import (GazeRequestProcessor, ServeConfig,
                                       resolve_package)
    from ...utils.cfg_options import apply_overrides
    from ...utils.config import load_config
    from ..test_gaze360_gaze import build_forward

    config_path, checkpoint, name = args.model, args.checkpoint, None
    pkg = resolve_package(args.model)
    if pkg is not None:
        config_path, pkg_ckpt, name = pkg
        checkpoint = args.checkpoint or pkg_ckpt
    name = args.model_name or name or \
        osp.splitext(osp.basename(config_path))[0]

    cfg = apply_overrides(load_config(config_path), args.cfg_options)
    forward = build_forward(cfg, checkpoint, args.dtype, ema=args.ema,
                            device=args.device)
    serve_cfg = ServeConfig(model_name=name, score_thr=args.score_thr,
                            max_batch=args.max_batch,
                            batch_timeout_ms=args.batch_timeout_ms)
    return GazeRequestProcessor(forward, cfg.eval_cfg, serve_cfg)


def main(argv=None):
    from ...evaluation.serving import make_server

    args = parse_args(argv)
    processor = build_processor(args)
    name = processor.cfg.model_name
    try:
        print(f'running every request shape of {name} once ...', flush=True)
        processor.warmup()
        server = make_server(processor, args.host, args.port)
        print(f'serving {name} at http://{args.host}:{args.port}'
              f'/predictions/{name} (ping: /ping)', flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        processor.close()


if __name__ == '__main__':
    main()
