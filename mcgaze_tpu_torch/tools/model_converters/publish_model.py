"""Prepare a checkpoint for publication, counterpart of
tools/model_converters/publish_model.py (reference surface:
tools/model_converters/publish_model.py: strip the optimizer state, then
content-hash the file and rename it `{out}-{sha256[:8]}.pth`):

    python -m mcgaze_tpu_torch.tools.model_converters.publish_model
        work_dirs/x/ckpt_7000.pth release/mcgaze_r50_gaze360 [--ema]
    -> release/mcgaze_r50_gaze360-<sha8>.pth (loadable by every CLI)

The checkpoint is a torch .pth: a reference mmdet one or the port's
ckpt_<step>.pth. --ema publishes the EMA weights that the train CLI keeps
in ckpt_<step>_train.pth in place of the parameters (the buffers, BN
statistics, stay the checkpoint's), as the eval CLIs' --ema evaluates
them.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('in_file', help='torch .pth')
    p.add_argument('out_file', help='output path (hash suffix appended)')
    p.add_argument('--ema', action='store_true',
                   help='publish the EMA weights of <in>_train.pth as the '
                        'parameters')
    return p.parse_args(argv)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def publish_checkpoint(in_file: str, out_file: str,
                       ema: bool = False) -> str:
    import torch

    from ...utils.checkpoint import ema_weights, require_pth

    require_pth(in_file)
    # a reference checkpoint's meta holds more than tensors
    ckpt = torch.load(in_file, map_location='cpu', weights_only=False)
    ckpt.pop('optimizer', None)
    if ema:
        averaged = ema_weights(in_file)
        sd = ckpt.get('state_dict', ckpt)
        missing = sorted(set(averaged) - set(sd))
        if missing:
            raise SystemExit(f'{in_file}: ema keys not in its state dict: '
                             f'{missing[:3]}')
        sd.update(averaged)
    if not out_file.endswith('.pth'):
        out_file += '.pth'
    os.makedirs(osp.dirname(osp.abspath(out_file)), exist_ok=True)
    torch.save(ckpt, out_file)
    sha = sha256_file(out_file)
    final = f'{out_file[:-4]}-{sha[:8]}.pth'
    os.replace(out_file, final)
    print(f'published {final} (sha256 {sha[:8]})')
    return final


def main(argv=None) -> str:
    args = parse_args(argv)
    return publish_checkpoint(args.in_file, args.out_file, args.ema)


if __name__ == '__main__':
    main()
