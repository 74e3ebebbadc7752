"""Fused clue x frame attention of the STQI head, counterpart of
mcgaze_tpu/ops/stqi_attention.py.

Per clip of T frames x Q clue tokens (t-major, q-minor), the head's one
shared 8-head attention runs twice with its residual and the one shared
LayerNorm (eps 1e-5): first spatially (a token sees the Q tokens of its
frame), then temporally (a token sees the T tokens of its clue), the qkv
and out projections included.

  * `stqi_attention_reference` is the plain version: the math of the JAX
    kernel's `_kernel` / `_masked_attention` in torch f32, as full
    attention over a clip's T*Q tokens with logits scaled by 1/sqrt(hd)
    and a -1e9 additive mask.
  * `launch_stqi_attention` runs the hand-written kernel
    csrc/stqi_attention.cu: per clip a thread-block cluster of G CTAs that
    split the heads (`cluster_plan`: 4 CTAs of 2 heads at the gaze shape)
    and exchange attention outputs, LayerNorm statistics and normalised
    rows through distributed shared memory; `launch_count` counts its
    launches. Forward only, like the JAX kernel (it has no vjp).
  * `fused_stqi_attention` is what the head calls: CPU tensors go to the
    plain version, CUDA tensors to the kernel. There is no fallback from
    the card to the plain version.
  * The kernel is also the operator `torch.ops.mcgaze.stqi_attention`, so a
    traced program (`torch.export`, tools/deployment/export_model.py)
    records it as one node: its CUDA kernel is `launch_stqi_attention`, its
    CPU kernel the plain version, its fake kernel gives the output's shape.
    `fused_stqi_attention` goes through it only while a program is being
    traced or inside ops/routing.py::through_operators() (on any device,
    so a dispatch mode sees it: utils/profiling.py::cost_analysis); it has
    no gradient, as the kernel has none.

Weights are in the JAX layout: wqkv (C, 3C) and wout (C, C) are applied as
x @ w (the transposes of torch's in_proj_weight and out_proj.weight).
"""
from __future__ import annotations

import ctypes

import torch

from . import _native, routing

launch_count = 0

LN_EPS = 1e-5
_MAX_C = 256                    # csrc/stqi_attention.cu: its limits
_MAX_TOKENS = 32
_MAX_HEAD_DIM = 32              # one lane per channel of a head
_MAX_CLUSTER = 8                # the portable cluster size
_NARROW_COLS = 64               # per-CTA channels of the 3-column tile
_STAGES, _STAGE_FLOATS = 4, 3072   # the weight ring: 4 stages of <= 12 KB
_MAX_SMEM = 232448              # a block's limit on sm_90


def _layer_norm(x, scale, bias, eps=LN_EPS):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _masked_attention(x, wqkv, bqkv, wout, bout, allowed, heads):
    """x (B, S, C); allowed (S, S) bool. Returns x + out_proj(attn)."""
    b, s, c = x.shape
    hd = c // heads
    qkv = torch.matmul(x, wqkv) + bqkv
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
    logits = logits + torch.where(allowed, 0.0, -1e9)
    attn = torch.softmax(logits, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, c)
    return x + (torch.matmul(out, wout) + bout)


def stqi_attention_reference(query, wqkv, bqkv, wout, bout, ln_scale,
                             ln_bias, clip_length: int, heads: int = 8
                             ) -> torch.Tensor:
    """query (N = B*T, Q, C) -> (N, Q, C), computed in f32 and returned in
    query's dtype."""
    n, nq, c = query.shape
    t = clip_length
    s = t * nq
    x = query.float().reshape(n // t, s, c)
    tok = torch.arange(s, device=query.device)
    spatial = (tok[:, None] // nq) == (tok[None, :] // nq)     # same frame
    temporal = (tok[:, None] % nq) == (tok[None, :] % nq)      # same clue
    w = [p.float() for p in (wqkv, bqkv, wout, bout, ln_scale, ln_bias)]
    y = _layer_norm(_masked_attention(x, *w[:4], spatial, heads), *w[4:])
    y = _layer_norm(_masked_attention(y, *w[:4], temporal, heads), *w[4:])
    return y.reshape(n, nq, c).to(query.dtype)


def fused_stqi_attention(query, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                         clip_length: int, heads: int = 8) -> torch.Tensor:
    """Spatial attention + LN + temporal attention + LN of the STQI head:
    CPU tensors through the plain version, CUDA tensors through the
    kernel. Only a traced program goes through the mcgaze::stqi_attention
    operator: called eagerly, it costs 31-52 us of host time a call above
    the bare launch (queued, one clip and 32 clips; chip_smoke.py
    kernel_k4, H100 80GB HBM3 at 700 W), ~0.2 ms of a forward's four
    calls."""
    tensors = (query, wqkv, bqkv, wout, bout, ln_scale, ln_bias)
    if torch.compiler.is_compiling() or routing.active():
        return torch.ops.mcgaze.stqi_attention(*tensors, clip_length, heads)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'fused_stqi_attention: inputs on several devices '
                         f'{sorted(map(str, devices))}')
    if query.device.type == 'cpu':
        return stqi_attention_reference(*tensors, clip_length, heads)
    return launch_stqi_attention(*tensors, clip_length, heads)


def _op_cpu(query, wqkv, bqkv, wout, bout, ln_scale, ln_bias, clip_length,
            heads):
    # looked up at call time, as fused_stqi_attention's CPU path is, so a
    # test can wrap both at once
    return stqi_attention_reference(query, wqkv, bqkv, wout, bout, ln_scale,
                                    ln_bias, clip_length, heads)


stqi_attention_op = torch.library.custom_op(
    'mcgaze::stqi_attention', _op_cpu, mutates_args=(),
    device_types='cpu',
    schema='(Tensor query, Tensor wqkv, Tensor bqkv, Tensor wout, '
           'Tensor bout, Tensor ln_scale, Tensor ln_bias, int clip_length, '
           'int heads) -> Tensor')


@stqi_attention_op.register_kernel('cuda')
def _op_cuda(query, wqkv, bqkv, wout, bout, ln_scale, ln_bias, clip_length,
             heads):
    # forward-only, as the kernel is: its launch never builds a graph
    with torch.no_grad():
        return launch_stqi_attention(query, wqkv, bqkv, wout, bout, ln_scale,
                                     ln_bias, clip_length, heads)


@stqi_attention_op.register_fake
def _op_fake(query, wqkv, bqkv, wout, bout, ln_scale, ln_bias, clip_length,
             heads):
    return query.new_empty(query.shape)


def cluster_plan(tokens: int, c: int, heads: int) -> dict:
    """How the kernel splits a clip of `tokens` tokens: `cluster` CTAs (G,
    a divisor of `heads` up to 8 whose C/G is a multiple of 4: the smallest
    with C/G <= 64, else the largest), each with heads_per_cta heads and
    cols_per_cta = C/G channels; token rows padded to a multiple of 8;
    `kc` weight rows per ring stage; and the shared memory of a CTA: the
    tokens, its qkv (then the gathered attention output), its own
    attention output and normalised columns, the LN statistics and the
    weight ring (csrc/stqi_attention.cu::smem_floats)."""
    sizes = [g for g in range(1, min(heads, _MAX_CLUSTER) + 1)
             if heads % g == 0 and (c // g) % 4 == 0]
    narrow = [g for g in sizes if c // g <= _NARROW_COLS]
    cluster = min(narrow) if narrow else max(sizes)
    cpc = c // cluster
    ncols = 3 * cpc
    rows = -(-tokens // 8) * 8
    kc = max(4, min(16, _STAGE_FLOATS // ncols // 4 * 4))
    floats = (rows * c + rows * max(ncols + 1, c) + 2 * rows * cpc + 4 * 32
              + _STAGES * kc * ncols)
    return dict(cluster=cluster, heads_per_cta=heads // cluster,
                cols_per_cta=cpc, rows=rows, kc=kc, stages=_STAGES,
                smem_bytes=4 * floats)


def launch_stqi_attention(query, wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                          clip_length: int, heads: int = 8) -> torch.Tensor:
    """The kernel alone: f32 contiguous CUDA tensors, a cluster of
    `cluster_plan` CTAs per clip on the current stream; no
    synchronisation. Refuses a query that needs a gradient while grad mode
    is on (the kernel has no backward). A tensor
    not 16-byte aligned (a view into another) is copied first: the kernel
    reads in 16-byte vectors."""
    global launch_count
    what = 'stqi_attention kernel'
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (query, wqkv, bqkv, wout, bout,
                                      ln_scale, ln_bias)):
        raise RuntimeError(f'{what}: inputs that need a gradient; the kernel '
                           'is forward-only, like the JAX kernel')
    if query.dim() != 3:
        raise ValueError(f'{what}: query {tuple(query.shape)}, needs '
                         '(B*T, Q, C)')
    n, nq, c = query.shape
    t = clip_length
    if t <= 0 or n % t:
        raise ValueError(f'{what}: {n} query rows are not whole clips of '
                         f'{t} frames')
    if heads <= 0 or c % heads or c // heads > _MAX_HEAD_DIM:
        raise ValueError(f'{what}: C={c} over {heads} heads; it takes heads '
                         f'of at most {_MAX_HEAD_DIM} channels')
    if c % 4 or c > _MAX_C or nq * t > _MAX_TOKENS:
        raise ValueError(f'{what}: C={c}, {nq * t} tokens per clip; it takes '
                         f'C a multiple of 4 up to {_MAX_C} and at most '
                         f'{_MAX_TOKENS} tokens')
    plan = cluster_plan(nq * t, c, heads)
    if plan['smem_bytes'] > _MAX_SMEM:
        raise ValueError(f'{what}: {plan["smem_bytes"]} bytes of shared '
                         f'memory a CTA, above {_MAX_SMEM}')
    shapes = dict(wqkv=(c, 3 * c), bqkv=(3 * c,), wout=(c, c), bout=(c,),
                  ln_scale=(c,), ln_bias=(c,))
    weights = (wqkv, bqkv, wout, bout, ln_scale, ln_bias)
    for (name, shape), w in zip(shapes.items(), weights):
        if tuple(w.shape) != shape:
            raise ValueError(f'{what}: {name} {tuple(w.shape)}, needs {shape}')
    for x in (query, *weights):
        if x.dtype != torch.float32:
            raise TypeError(f'{what}: {x.dtype}; it takes float32')
        if not x.is_cuda:
            raise RuntimeError(f'{what}: a {x.device} tensor given; the '
                               'kernel runs on a CUDA device only')
        if x.device != query.device:
            raise ValueError(f'{what}: inputs on several devices')
        if not x.is_contiguous():
            raise ValueError(f'{what}: non-contiguous input '
                             f'{tuple(x.shape)} stride {x.stride()}')

    query, *weights = (x if x.data_ptr() % 16 == 0 else x.clone()
                       for x in (query, *weights))
    out = torch.empty_like(query)
    lib = _native.load('stqi_attention')
    fn = lib.mcg_stqi_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = fn(query.data_ptr(), *(w.data_ptr() for w in weights),
                 out.data_ptr(), n // t, t, nq, c, heads, plan['cluster'],
                 plan['kc'], plan['rows'], float((c // heads) ** -0.5),
                 stream)
    _native.check(lib, err, 'stqi_attention kernel launch')
    launch_count += 1
    return out
