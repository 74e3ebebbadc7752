"""On-card certifier of the FPN RoIAlign kernels, counterpart of
tools/analysis_tools/roi_kernel_check.py:

    python -m mcgaze_tpu_torch.tools.analysis_tools.roi_kernel_check
        [--tol 1e-4] [--device cuda|cpu]

Holds the forward kernel (K1, csrc/roi_align_fpn.cu) and the backward
kernel (K3, csrc/roi_align_fpn_bwd.cu) against the plain formulation
(ops/roi_align.py::roi_align_fpn_mm) and its autograd vjp, f32 with TF32
off, at the gaze shape (8 frames x 3 RoIs on 56/28/14/7, C=256) and the
InstBlink shape (8 x 100 on 96x160 .. 12x20, C=256), on the JAX tool's
inputs (the same make_case and RandomState(0) stream). The JAX tool's two
operand regimes (traced and constant-folded jit arguments) become the
port's two routes to the kernels:

  * eager     ops/roi_align_cuda.py::roi_align_fpn and its autograd
              Function: the ctypes launch wrappers, as the model calls them;
  * operator  the same call inside ops/routing.py::through_operators():
              the torch.library operators mcgaze::roi_align_fpn and
              mcgaze::roi_align_fpn_bwd, which export and
              utils/profiling.py::cost_analysis go through.

Each route runs one forward (case fwd_<route>) and its backward
(bwd_<route>): one K1 and one K3 launch a route and shape on the card. One
JSON line per case (shape, case, maxdiff, rel = maxdiff / max|reference|,
ok); `FAILED: ...` and exit code 1 on any breach. --device defaults to
cuda and is refused without a card; on the CPU the eager route is the
plain version itself and the operator route the operators' CPU kernels.
"""
from __future__ import annotations

import argparse
import json

SHAPES = (
    ('gaze', 8, 3, ((56, 56), (28, 28), (14, 14), (7, 7)), 256),
    ('instblink', 8, 100, ((96, 160), (48, 80), (24, 40), (12, 20)), 256),
)


def make_case(rng, np, n, r, sizes, c):
    """The JAX tool's inputs: features (n, h, w, c) per level, RoIs of
    sizes 25/90/300 that run off the image, and a cotangent."""
    feats = tuple(rng.randn(n, h, w, c).astype(np.float32)
                  for h, w in sizes)
    rois = np.zeros((n, r, 4), np.float32)
    for i in range(n):
        for j in range(r):
            s = rng.choice([25, 90, 300])
            x1 = rng.uniform(-10, 300)
            y1 = rng.uniform(-10, 200)
            rois[i, j] = [x1, y1, x1 + s * rng.uniform(0.5, 1.5), y1 + s]
    g = rng.randn(n, r, 7, 7, c).astype(np.float32)
    return feats, rois, g


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--tol', type=float, default=1e-4,
                    help='relative tolerance against the mm formulation')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import contextlib

    import numpy as np
    import torch

    from ...ops import roi_align_cuda
    from ...ops.roi_align import roi_align_fpn_mm
    from ...ops.routing import through_operators
    from ...utils.env import resolve_device

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'device: {device} ({name})')
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    failures = 0
    try:
        for shape, n, r, sizes, c in SHAPES:
            f_np, rois_np, g_np = make_case(rng, np, n, r, sizes, c)
            feats = [torch.from_numpy(x).to(device).requires_grad_()
                     for x in f_np]
            rois = torch.from_numpy(rois_np).to(device)
            g = torch.from_numpy(g_np).to(device)

            fwd_ref = roi_align_fpn_mm(feats, rois)
            bwd_ref = torch.autograd.grad(fwd_ref, feats, g)
            fwd_ref = fwd_ref.detach()
            scale_f = fwd_ref.abs().max().item()
            scale_b = max(x.abs().max().item() for x in bwd_ref)
            for route, ctx in (('eager', contextlib.nullcontext),
                               ('operator', through_operators)):
                with ctx():
                    out = roi_align_cuda.roi_align_fpn(feats, rois)
                    grads = torch.autograd.grad(out, feats, g)
                md_f = (out.detach() - fwd_ref).abs().max().item()
                md_b = max((a - b).abs().max().item()
                           for a, b in zip(grads, bwd_ref))
                for case, md, scale in (('fwd', md_f, scale_f),
                                        ('bwd', md_b, scale_b)):
                    rel = md / scale
                    ok = rel <= args.tol
                    failures += not ok
                    print(json.dumps(dict(shape=shape,
                                          case=f'{case}_{route}',
                                          maxdiff=round(md, 8),
                                          rel=round(rel, 8), ok=bool(ok))))
                del out, grads
            del feats, g, fwd_ref, bwd_ref
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    if failures:
        print(f'FAILED: {failures} case(s) over tol={args.tol}')
        return 1
    print(f'all kernel/formulation cross-checks passed on {device} '
          f'({name})')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
