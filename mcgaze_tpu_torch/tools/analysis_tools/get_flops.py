"""FLOPs of the gaze model's eval forward or train step, counterpart of
tools/analysis_tools/get_flops.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.get_flops <config>
        [--shape H W] [--clip-length T] [--train] [--device cuda|cpu]
        [--cfg-options a.b=v ...]

One clip of zero frames through the config's model (seeded random
weights), counted by utils/profiling.py::cost_analysis: torch's
FlopCounterMode over the aten operators, and the port's kernels (K1, K3,
K4, K5) through their operators, each counted as tools/kernel_bounds.py
counts its work on the call's inputs. The call fails if a kernel launches
outside a counted operator. Bytes are printed for the kernels' operators
alone; the program's other traffic is not estimated. --train counts one
train step: the forward, the backward and the AdamW update.
"""
from __future__ import annotations

import argparse


def human(n, unit=''):
    for div, suf in ((1e12, 'T'), (1e9, 'G'), (1e6, 'M'), (1e3, 'K')):
        if n >= div:
            return f'{n / div:.3f} {suf}{unit}'
    return f'{n:.1f} {unit}'


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('--shape', type=int, nargs=2, default=None,
                    help='input H W (default: config canvas)')
    ap.add_argument('--clip-length', type=int, default=None)
    ap.add_argument('--train', action='store_true',
                    help='count one train step (forward, backward, '
                         'optimizer) instead of the eval forward')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument('--cfg-options', nargs='+', default=None,
                    help="config overrides 'a.b=val'")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns cost_analysis's dict with 'label' and 'params'."""
    args = parse_args(argv)
    import torch

    from ...utils.cfg_options import apply_overrides
    from ...utils.config import load_config
    from ...utils.env import resolve_device
    from ...utils.profiling import cost_analysis

    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    h, w = args.shape or cfg.eval_cfg.canvas
    t = args.clip_length or cfg.model.clip_length

    if args.train:
        from ...train.loop import create_train_state, make_train_step
        state = create_train_state(cfg.model, cfg.optim, seed=0,
                                   device=device)
        step = make_train_step(cfg.model, cfg.optim)
        b = 1
        batch = dict(
            imgs=torch.zeros((b, t, h, w, 3), device=device),
            img_whwh=torch.tensor([w, h, w, h], dtype=torch.float32,
                                  device=device).repeat(b, t, 1),
            gt_boxes=torch.zeros((b, t, 3, 4), device=device),
            gt_valid=torch.ones((b, t, 3), device=device),
            gt_gazes=torch.tensor([0., 0., -1.], device=device).repeat(
                b, t, 3, 1))
        ca = cost_analysis(step, state, batch)
        model = state.model
        label = f'train step (1 clip x {t} frames, {h}x{w})'
    else:
        from ...models.mcgaze import init_model
        model = init_model(cfg.model, seed=0, device=device)

        @torch.inference_mode()
        def fwd(imgs, whwh):
            last = model(imgs, whwh, clip_length=t)['stages'][-1]
            return last['boxes'], last['cls_logits'], last['gaze']['fusion']

        imgs = torch.zeros((t, h, w, 3), device=device)
        whwh = torch.tensor([[w, h, w, h]], dtype=torch.float32,
                            device=device).repeat(t, 1)
        ca = cost_analysis(fwd, imgs, whwh)
        label = f'eval forward (1 clip x {t} frames, {h}x{w})'

    n_params = sum(p.numel() for p in model.parameters())
    print('=' * 60)
    print(label)
    print(f'Params:         {human(float(n_params))}')
    print(f'FLOPs:          {human(ca["flops"], "FLOPs")}')
    calls = ', '.join(f'{k} {v}' for k, v in ca['operator calls'].items()
                      if v)
    print(f'Kernel operator bytes: '
          f'{human(ca["operator bytes accessed"], "B")} ({calls or "none"}; '
          f'not counted: {ca["bytes not counted"]})')
    print('=' * 60)
    return dict(ca, label=label, params=n_params)


if __name__ == '__main__':
    main()
