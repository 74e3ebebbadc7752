"""Fused ResNet bottleneck chains: the stride-1 bottlenecks of one stage
with frozen BN folded into the convolutions, counterpart of
mcgaze_tpu/ops/fused_bottleneck.py.

    x (N, H*W, C) -> [per block: y1 = relu(x @ A1 + b1)             (Cm)
                      y2 = relu(im2col3x3(y1) @ A2 + b2)             (Cm)
                      y3 = y2 @ A3 + b3                               (C')
                      x  = relu(y3 + (x or x @ Ad + bd))] -> out

  * `fold_block_params` folds a port `Bottleneck` into the flat per-block
    tuple (A1, b1, A2, b2, A3, b3[, Ad, bd]): A's in the model dtype, b's
    f32 of shape (1, C'); A2's rows are ordered (dy, dx, cin).
  * `chain_reference` is the plain version, with the JAX package's rounding
    points: every product accumulates in f32 and takes its f32 bias before
    it is rounded to the dtype once (y1, y2, y3, the downsample identity);
    the residual adds in the dtype.
  * `launch_fused_bottleneck_chain` runs the chain on the card through the
    hand-written kernel csrc/fused_bottleneck.cu: one implicit-GEMM launch
    per convolution, with bias, identity and ReLU in its epilogue (bf16:
    wgmma fed through a ring of TMA and cp.async copies; f32: FMA).
    `launch_count` counts those launches.
  * `FusedBottleneckChainFunction`: the kernel forward; the backward is
    autograd of `chain_reference` (the JAX `_chain_bwd`; the JAX package
    has no backward kernel).
  * `fused_bottleneck_chain` is what the model calls: CPU tensors go to
    `chain_reference`, CUDA tensors to the Function. There is no fallback
    from the card to the plain version.
  * The forward is also the operator `torch.ops.mcgaze.fused_bottleneck_chain`,
    so a traced program (`torch.export`, tools/deployment/export_model.py)
    records each chain as one node: its CUDA kernel is
    `launch_fused_bottleneck_chain`, its CPU kernel `chain_reference`, its
    fake kernel gives the output's shape. `fused_bottleneck_chain` goes
    through it only while a program is being traced, and it has no
    gradient: eager training keeps the Function.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _native

launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's tile: Cin a multiple of its K step (64 bf16, one 128-byte
# swizzled row, so a K tile never straddles two 3x3 taps), Cout of its
# smallest N tile
_CIN_MULTIPLE, _COUT_MULTIPLE = 64, 64


def _bn_affine(bn):
    """FrozenBatchNorm as (w, b) in f32: y = x * w + b."""
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return inv, bn.bias - bn.running_mean * inv


def _fold(conv_weight, bn, dtype):
    """Conv weight (O, I, kh, kw) scaled by the BN's w, as the (kh*kw*I, O)
    matrix with rows ordered (dy, dx, cin), folded in f32 and then cast;
    the BN's b as an f32 (1, O) row."""
    w, b = _bn_affine(bn)
    o = conv_weight.shape[0]
    a = conv_weight.permute(2, 3, 1, 0).reshape(-1, o) * w[None, :]
    return a.to(dtype).contiguous(), b[None, :].to(torch.float32)


def fold_block_params(block, dtype=torch.bfloat16) -> tuple:
    """A stride-1 port Bottleneck -> (A1, b1, A2, b2, A3, b3[, Ad, bd]),
    differentiable in the block's parameters."""
    if block.conv2.stride != (1, 1):
        raise ValueError('fused chains take stride-1 bottlenecks only')
    out = [*_fold(block.conv1.weight, block.bn1, dtype),
           *_fold(block.conv2.weight, block.bn2, dtype),
           *_fold(block.conv3.weight, block.bn3, dtype)]
    if block.downsample is not None:
        out += _fold(block.downsample[0].weight, block.downsample[1], dtype)
    return tuple(out)


def split_blocks(weights) -> list:
    """The flat tuple -> one (A1, b1, A2, b2, A3, b3, Ad, bd) per block
    (Ad, bd None where the block has no downsample; only the first may)."""
    weights = list(weights)
    has_down = len(weights) % 6 == 2
    if len(weights) % 6 not in (0, 2) or len(weights) < 6:
        raise ValueError(f'{len(weights)} weights: 6 per block, plus 2 for a '
                         'downsample on the first')
    blocks = []
    i = 0
    while i < len(weights):
        down = has_down and i == 0
        blk = weights[i:i + 6] + (weights[i + 6:i + 8] if down
                                  else [None, None])
        blocks.append(tuple(blk))
        i += 8 if down else 6
    return blocks


def _mm(x, a, b):
    """x @ a + b with f32 products from the dtype's operands (no rounding
    before the bias)."""
    return torch.matmul(x.float(), a.float()) + b


def im2col3x3(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> (N, H*W, 9C): column block dy*3+dx holds pixel
    (y+dy-1, x+dx-1) of the same frame, 0 outside it (zero padding)."""
    n, _, c = y.shape
    p = F.pad(y.reshape(n, h, w, c), (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(n, h * w, 9 * c)


def chain_reference(x: torch.Tensor, weights, h: int, w: int) -> torch.Tensor:
    """The plain version of the chain, differentiable; x (N, H*W, C) ->
    (N, H*W, C') in x's dtype."""
    dt = x.dtype
    for a1, b1, a2, b2, a3, b3, ad, bd in split_blocks(weights):
        y = torch.relu(_mm(x, a1, b1)).to(dt)
        y = torch.relu(_mm(im2col3x3(y, h, w), a2, b2)).to(dt)
        y = _mm(y, a3, b3).to(dt)
        idn = x if ad is None else _mm(x, ad, bd).to(dt)
        x = torch.relu(y + idn)
    return x


def fused_bottleneck_chain(x: torch.Tensor, weights, h: int, w: int
                           ) -> torch.Tensor:
    """x (N, H*W, C) NHWC rows; weights the flat folded tuple. CPU tensors
    run `chain_reference`; CUDA tensors the kernel, with the plain
    version's autograd as the backward."""
    if torch.compiler.is_compiling():
        return torch.ops.mcgaze.fused_bottleneck_chain(x, list(weights), h, w)
    devices = {t.device for t in (x, *weights)}
    if len(devices) != 1:
        raise ValueError(f'fused_bottleneck_chain: inputs on several devices '
                         f'{sorted(map(str, devices))}')
    if x.device.type == 'cpu':
        return chain_reference(x, weights, h, w)
    return FusedBottleneckChainFunction.apply(x, h, w, *weights)


def _op_cpu(x, weights, h, w):
    # looked up at call time, as fused_bottleneck_chain's CPU path is, so a
    # test can wrap both at once
    return chain_reference(x, weights, h, w)


fused_bottleneck_chain_op = torch.library.custom_op(
    'mcgaze::fused_bottleneck_chain', _op_cpu, mutates_args=(),
    device_types='cpu',
    schema='(Tensor x, Tensor[] weights, int h, int w) -> Tensor')


@fused_bottleneck_chain_op.register_kernel('cuda')
def _op_cuda(x, weights, h, w):
    # the operator has no gradient: its launches never build a graph
    with torch.no_grad():
        return launch_fused_bottleneck_chain(x, weights, h, w)


@fused_bottleneck_chain_op.register_fake
def _op_fake(x, weights, h, w):
    a3 = split_blocks(weights)[-1][4]
    return x.new_empty((x.shape[0], x.shape[1], a3.shape[1]))


class FusedBottleneckChainFunction(torch.autograd.Function):
    """Forward: the kernel. Backward: recompute `chain_reference` under
    autograd and return the gradients of x and of every folded weight."""

    @staticmethod
    def forward(ctx, x, h, w, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.hw = (h, w)
        return launch_fused_bottleneck_chain(x, weights, h, w)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, *weights)]
        with torch.enable_grad():
            out = chain_reference(leaves[0], leaves[1:], *ctx.hw)
            grads = torch.autograd.grad(out, leaves, g.to(x.dtype))
        return (grads[0], None, None, *grads[1:])


def _signature(lib):
    fn = lib.mcg_conv_gemm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 8 + [p]
    fn.restype = ctypes.c_int
    return fn


def _conv(fn, lib, x, a, b, idn, out, h, w, ksize, relu):
    global launch_count
    m, cin = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(),
             None if idn is None else idn.data_ptr(), out.data_ptr(),
             m, h, w, cin, a.shape[1], ksize, int(relu), _DTYPES[x.dtype],
             stream)
    _native.check(lib, err, 'fused_bottleneck conv kernel launch')
    launch_count += 1
    return out


def _check(what, x, weights, h, w):
    """Raise on what the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f'{what}: x {x.dtype}; it takes float32 or bfloat16')
    if x.dim() != 3 or x.shape[1] != h * w:
        raise ValueError(f'{what}: x {tuple(x.shape)}, needs (N, {h}*{w}, C)')
    blocks = split_blocks(weights)
    cin = x.shape[2]
    for k, blk in enumerate(blocks):
        a1, b1, a2, b2, a3, b3, ad, bd = blk
        mid, cout = a1.shape[1], a3.shape[1]
        shapes = [(a1, (cin, mid)), (a2, (9 * mid, mid)), (a3, (mid, cout))]
        if ad is not None:
            shapes.append((ad, (cin, cout)))
        elif cin != cout:
            raise ValueError(f'{what}: block {k} maps {cin} to {cout} '
                             'channels without a downsample')
        for a, shape in shapes:
            if tuple(a.shape) != shape:
                raise ValueError(f'{what}: block {k} weight '
                                 f'{tuple(a.shape)}, needs {shape}')
            if a.dtype != x.dtype:
                raise TypeError(f'{what}: weight {a.dtype}, x {x.dtype}: '
                                'fold the weights to the dtype of x')
        for b, (_, shape) in zip((b1, b2, b3, bd), shapes):
            if b.dtype != torch.float32 or b.numel() != shape[1]:
                raise TypeError(f'{what}: bias {b.dtype} '
                                f'{tuple(b.shape)}, needs float32 '
                                f'({shape[1]},)')
        for c in (cin, mid):
            if c % _CIN_MULTIPLE:
                raise ValueError(f'{what}: {c} input channels; the kernel '
                                 f'takes multiples of {_CIN_MULTIPLE}')
        for c in (mid, cout):
            if c % _COUT_MULTIPLE:
                raise ValueError(f'{what}: {c} output channels; the kernel '
                                 f'takes multiples of {_COUT_MULTIPLE}')
        cin = cout
    for t in (x, *weights):
        if not t.is_cuda:
            raise RuntimeError(f'{what}: a {t.device} tensor given; the '
                               'kernel runs on a CUDA device only')
        if t.device != x.device:
            raise ValueError(f'{what}: inputs on several devices')
        if not t.is_contiguous():
            raise ValueError(f'{what}: non-contiguous input '
                             f'{tuple(t.shape)} stride {t.stride()}')
        if t.data_ptr() % 16:
            raise ValueError(f'{what}: a pointer not 16-byte aligned')
    if x.shape[0] * h * w >= 2 ** 31:
        raise ValueError(f'{what}: {x.shape[0] * h * w} rows; the kernel '
                         'indexes rows with 32-bit integers')
    return blocks


def launch_fused_bottleneck_chain(x: torch.Tensor, weights, h: int, w: int
                                  ) -> torch.Tensor:
    """The chain on the card: x (N, H*W, C) contiguous CUDA rows, the
    folded weights in x's dtype with f32 biases. One kernel launch per
    convolution on the current stream (3 per block, 4 with a downsample),
    each output allocated here; no synchronisation. It builds no autograd
    graph, so it refuses inputs that need a gradient while grad mode is
    on: that path goes through fused_bottleneck_chain."""
    what = 'fused_bottleneck kernel'
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *weights)):
        raise RuntimeError(f'{what}: inputs that need a gradient; call '
                           'fused_bottleneck_chain, whose autograd Function '
                           'gives the backward')
    blocks = _check(what, x, weights, h, w)
    n = x.shape[0]
    lib = _native.load('fused_bottleneck')
    fn = _signature(lib)
    y = x.reshape(n * h * w, x.shape[2])
    with torch.cuda.device(x.device):
        for a1, b1, a2, b2, a3, b3, ad, bd in blocks:
            mid, cout = a1.shape[1], a3.shape[1]
            y1 = _conv(fn, lib, y, a1, b1, None, y.new_empty(len(y), mid),
                       h, w, 1, True)
            y2 = _conv(fn, lib, y1, a2, b2, None, y.new_empty(len(y), mid),
                       h, w, 3, True)
            idn = y if ad is None else _conv(
                fn, lib, y, ad, bd, None, y.new_empty(len(y), cout), h, w, 1,
                False)
            y = _conv(fn, lib, y2, a3, b3, idn, y.new_empty(len(y), cout),
                      h, w, 1, True)
    return y.view(n, h * w, -1)
