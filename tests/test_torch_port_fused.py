"""The port's fused configuration (backbone_impl='fused', fused_attention=
True) against the JAX package's, weights carried across by
jax_variables_to_state_dict.

The JAX Pallas kernels run as the JAX package's own tests run them on the
CPU: fused_stqi_attention interprets off the TPU by itself, and
fused_bottleneck_chain is swapped for its interpret=True form while the
JAX side is traced (tests/test_fused_bottleneck.py does the same). On the
CPU the port runs its plain versions (chain_reference,
stqi_attention_reference); the kernels are held against those on the card
(tests/test_torch_port_kernels.py).

Tolerances: the fold f32 1e-6 and bf16 bit-equal; the chain rtol 1e-5,
atol 2e-5 (tests/test_fused_bottleneck.py's); its gradients 1e-4; a fused
ResNet-50 1e-4 of each level's scale (f32 summed in another order through
~50 layers); the attention and the STQIHead 2e-5 (LN outputs are O(1));
the whole model 1e-3 (the model parity tolerance).
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcgaze_tpu.models.mcgaze import MCGazeModel as JModel
from mcgaze_tpu.models.mcgaze import ModelConfig as JModelConfig
from mcgaze_tpu.models.resnet import ResNet as JResNet
from mcgaze_tpu.ops import fused_bottleneck as jfb
from mcgaze_tpu.ops.stqi_attention import fused_stqi_attention as jattention
from mcgaze_tpu_torch.evaluation.forward import make_eval_forward
from mcgaze_tpu_torch.models.heads import STQIHead
from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, ModelConfig
from mcgaze_tpu_torch.models.resnet import Bottleneck, ResNet
from mcgaze_tpu_torch.ops import fused_bottleneck, stqi_attention
from mcgaze_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.test_torch_port_model import (SMALL, T, clip_inputs,
                                         random_variables, to_numpy_tree)

FUSED = dict(backbone_impl='fused', fused_attention=True)


def interpret_chain(mp):
    """Trace the JAX fused chain in Pallas interpret mode."""
    mp.setattr(jfb, 'fused_bottleneck_chain',
               partial(jfb.fused_bottleneck_chain, interpret=True))


@pytest.fixture(scope='module')
def small_fused():
    """(JAX fused model, its variables (numpy), port fused model, port
    plain model), all on the same weights. The JAX parameter trees of the
    fused and plain models are equal, so the plain model's init serves."""
    from mcgaze_tpu.models.mcgaze import init_model as jinit_model
    _, init = jinit_model(JModelConfig(**SMALL), jax.random.PRNGKey(0),
                          image_size=(64, 64))
    variables = random_variables(to_numpy_tree(init), seed=21)
    sd = jax_variables_to_state_dict(variables)
    ports = []
    for extra in (FUSED, {}):
        port = MCGazeModel(ModelConfig(**SMALL, **extra))
        port.load_state_dict(sd, strict=True)
        ports.append(port.eval())
    return JModel(JModelConfig(**SMALL, **FUSED)), variables, *ports


# ------------------------------------------------------------------ fold

def _jax_fold(block_params, block_stats, dtype, affine=None):
    """JAX fold_block_params of one block's variables. The BN pairs are
    the JAX FrozenBatchNorm's (w, b), or `affine`'s where given."""
    def bn(name):
        if affine is not None:
            return affine[name]
        p, s = block_params[name], block_stats[name]
        inv = p['scale'] * jax.lax.rsqrt(s['var'] + 1e-5)
        return inv, p['bias'] - s['mean'] * inv

    args = [block_params['conv1']['kernel'], bn('bn1'),
            block_params['conv2']['kernel'], bn('bn2'),
            block_params['conv3']['kernel'], bn('bn3')]
    if 'downsample_conv' in block_params:
        args += [block_params['downsample_conv']['kernel'],
                 bn('downsample_bn')]
    return jfb.fold_block_params(*args, dtype=dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fold_block_params_matches_jax(small_fused, dtype):
    """layer1's first block (with its downsample): A1, b1, A2 (rows dy, dx,
    cin), b2, A3, b3, Ad, bd as the JAX fold gives them. In bf16 both
    folds take the port's BN pairs, so that the test reads the layout,
    the scaling and the cast bit for bit: rsqrt rounds one ulp apart in the
    two frameworks, which flips an occasional bf16 rounding."""
    _, variables, port, _ = small_fused
    block = port.backbone.layer1[0]
    affine = None
    if dtype == 'bfloat16':
        bns = dict(bn1=block.bn1, bn2=block.bn2, bn3=block.bn3,
                   downsample_bn=block.downsample[1])
        with torch.no_grad():
            affine = {k: tuple(jnp.asarray(t.numpy())
                               for t in fused_bottleneck._bn_affine(bn))
                      for k, bn in bns.items()}
    ref = _jax_fold(variables['params']['backbone']['layer1_0'],
                    variables['stats']['backbone']['layer1_0'],
                    jnp.dtype(dtype), affine)
    with torch.no_grad():
        got = fused_bottleneck.fold_block_params(
            block, getattr(torch, dtype))
    assert len(got) == len(ref) == 8
    for i, (a, b) in enumerate(zip(got, ref)):
        assert tuple(a.shape) == b.shape, i
        if dtype == 'float32' or i % 2:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=str(i))
        else:
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(),
                np.asarray(b).view(np.int16), err_msg=str(i))


# ----------------------------------------------------------------- chain

def random_blocks(seed, cin, mid, n_blocks):
    """Port Bottlenecks with seeded weights and BN statistics."""
    rng = np.random.RandomState(seed)
    blocks = []
    for _ in range(n_blocks):
        blk = Bottleneck(cin, mid, 1)
        with torch.no_grad():
            for name, t in blk.state_dict().items():
                if name.endswith('running_var'):
                    v = rng.rand(*t.shape) + 0.5
                elif t.dim() == 4:
                    v = rng.randn(*t.shape) * 0.2
                else:
                    v = rng.randn(*t.shape) * 0.2 + (
                        1.0 if name.endswith('weight') else 0.0)
                t.copy_(torch.from_numpy(v.astype(np.float32)))
        blocks.append(blk)
        cin = 4 * mid
    return blocks


def chain_inputs(h, w, seed=0, frames=2, cin=16, mid=8):
    """x (frames, h*w, cin) and the folded f32 weights of 2 blocks (the
    first with a downsample, cin -> 4*mid), tests/test_fused_bottleneck.py's
    shapes."""
    blocks = random_blocks(seed, cin, mid, 2)
    x = np.random.RandomState(seed + 1).randn(frames, h * w, cin).astype(
        np.float32)
    with torch.no_grad():
        weights = [a for b in blocks
                   for a in fused_bottleneck.fold_block_params(
                       b, torch.float32)]
    return blocks, x, weights


@pytest.mark.parametrize('h,w', [(8, 8), (6, 10)])
def test_chain_reference_matches_jax(h, w):
    """The plain chain against the JAX chain_reference and the JAX Pallas
    kernel (interpret); the 6x10 frame pins the 3x3's edges."""
    _, x, weights = chain_inputs(h, w)
    got = fused_bottleneck.chain_reference(torch.from_numpy(x), weights, h,
                                           w).numpy()
    jw = tuple(jnp.asarray(a.numpy()) for a in weights)
    ref = jfb.chain_reference(jnp.asarray(x), jw, h, w)
    kernel = jfb.fused_bottleneck_chain(jnp.asarray(x), jw, h, w,
                                        interpret=True)
    for name, r in (('chain_reference', ref), ('pallas', kernel)):
        np.testing.assert_allclose(got, np.asarray(r), rtol=1e-5, atol=2e-5,
                                   err_msg=name)


def test_chain_reference_bf16_rounds_where_jax_does():
    """bf16 in, f32 products, rounding after each bias: the plain chain
    equals the JAX chain_reference up to one bf16 rounding of the output
    (both sides add the same f32 products in another order)."""
    h, w = 6, 10
    _, x, weights = chain_inputs(h, w, seed=5)
    # A's (even places) in bf16, the biases stay f32
    w16 = [a.to(torch.bfloat16) if i % 2 == 0 else a
           for i, a in enumerate(weights)]
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    got = fused_bottleneck.chain_reference(x16, w16, h, w)
    assert got.dtype == torch.bfloat16
    jw = tuple(jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
        for a in w16)
    ref = jfb.chain_reference(jnp.asarray(x16.float().numpy()).astype(
        jnp.bfloat16), jw, h, w)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(ref).max())


def test_chain_gradients_match_jax():
    """Gradients of x and of every folded weight of the port's chain (on
    the CPU: autograd of chain_reference, as the Function's backward is on
    the card) against jax.grad of fused_bottleneck_chain_diff (the Pallas
    kernel forward in interpret mode, its custom_vjp backward)."""
    h, w = 6, 10
    _, x, weights = chain_inputs(h, w, seed=2)
    g = np.random.RandomState(3).randn(2, h * w, 32).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        a.clone().requires_grad_() for a in weights]
    out = fused_bottleneck.fused_bottleneck_chain(leaves[0], leaves[1:], h, w)
    out.backward(torch.from_numpy(g))

    with pytest.MonkeyPatch.context() as mp:
        interpret_chain(mp)
        jg = jax.grad(lambda xx, ww: (jfb.fused_bottleneck_chain_diff(
            xx, ww, h, w) * g).sum(), argnums=(0, 1))(
            jnp.asarray(x), tuple(jnp.asarray(a.numpy()) for a in weights))
    ref = [jg[0]] + list(jg[1])
    for i, (a, b) in enumerate(zip(leaves, ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(),
                                   err_msg=str(i))


# ---------------------------------------------------------------- resnet

@pytest.fixture(scope='module')
def resnet50_pair():
    """JAX ResNet-50 variables (numpy, randomised) and the four outputs of
    the JAX fused ResNet on 2 frames at 64x64, and the port's fused and
    plain ResNet-50 on the same weights."""
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    init = JResNet(50).init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(to_numpy_tree(init), seed=8)
    with pytest.MonkeyPatch.context() as mp:
        interpret_chain(mp)
        ref = jax.jit(JResNet(50, fused_blocks=True).apply)(
            variables, jnp.asarray(x))
    sd = jax_variables_to_state_dict(
        {'params': {'backbone': variables['params']},
         'stats': {'backbone': variables['stats']}})
    sd = {k[len('backbone.'):]: v for k, v in sd.items()}
    ports = []
    for fused in (True, False):
        net = ResNet(50, fused_blocks=fused)
        net.load_state_dict(sd, strict=True)
        ports.append(net.eval())
    return x, [np.asarray(r) for r in ref], ports


def test_fused_resnet50_matches_jax(resnet50_pair):
    x, ref, (fused, _) = resnet50_pair
    with torch.inference_mode():
        got = fused(torch.from_numpy(x).permute(0, 3, 1, 2))
    for lvl, (a, b) in enumerate(zip(got, ref)):
        a = a.permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-4,
                                   err_msg=f'level {lvl}')


def test_fused_resnet50_matches_plain(resnet50_pair):
    """The fused chains against the port's own cuDNN-path blocks, 2e-5 of
    each level's scale, and in the channels_last layout the FPN takes."""
    x, _, (fused, plain) = resnet50_pair
    inp = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got, ref = fused(inp), plain(inp)
    for lvl, (a, b) in enumerate(zip(got, ref)):
        assert a.is_contiguous(memory_format=torch.channels_last)
        scale = b.abs().max().item()
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=2e-5,
                                   msg=f'level {lvl}')


@pytest.mark.parametrize('fused_blocks', [True, (0, 2)])
def test_fused_resnet_state_dict_is_plain(fused_blocks):
    with torch.device('meta'):
        a = ResNet(50, fused_blocks=fused_blocks).state_dict()
        b = ResNet(50).state_dict()
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}


# ------------------------------------------------------------- attention

B, Q, C, HEADS = 3, 3, 256, 8


def attention_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B * T, Q, C).astype(np.float32),
            rng.randn(C, 3 * C).astype(np.float32) / 16,
            0.1 * rng.randn(3 * C).astype(np.float32),
            rng.randn(C, C).astype(np.float32) / 16,
            0.1 * rng.randn(C).astype(np.float32),
            1.0 + 0.1 * rng.randn(C).astype(np.float32),
            0.1 * rng.randn(C).astype(np.float32))


def test_stqi_attention_reference_matches_jax():
    arrays = attention_inputs(0)
    got = stqi_attention.fused_stqi_attention(
        *map(torch.from_numpy, arrays), clip_length=T, heads=HEADS)
    ref = jattention(*map(jnp.asarray, arrays), clip_length=T, heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)


def test_stqi_attention_clips_are_independent():
    """Permuting the other clips leaves clip 0's output unchanged."""
    query, *weights = map(torch.from_numpy, attention_inputs(1))
    out = stqi_attention.stqi_attention_reference(query, *weights, T, HEADS)
    perm = torch.cat([query[:T], query[2 * T:], query[T:2 * T]])
    again = stqi_attention.stqi_attention_reference(perm, *weights, T, HEADS)
    torch.testing.assert_close(again[:T], out[:T], rtol=0, atol=1e-6)
    torch.testing.assert_close(again[T:2 * T], out[2 * T:], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('stage', [0, 1])
def test_fused_stqi_head_matches_jax(small_fused, stage):
    """The fused STQIHead of each stage against the JAX fused head (2e-5),
    and against the port's own unfused head on the same weights."""
    jmodel, variables, port, plain = small_fused
    rng = np.random.RandomState(9 + stage)
    roi = rng.randn(2 * T * Q, 7, 7, C).astype(np.float32)
    query = rng.randn(2 * T, Q, C).astype(np.float32)
    ref = jax.jit(lambda v, r, qq: jmodel.apply(
        v, r, qq, method=lambda m, a, b: m.bbox_head[stage](a, b, T)))(
        variables, jnp.asarray(roi), jnp.asarray(query))
    with torch.inference_mode():
        args = (torch.from_numpy(roi), torch.from_numpy(query), T)
        got = port.roi_head.bbox_head[stage](*args)
        unfused = plain.roi_head.bbox_head[stage](*args)
    assert port.roi_head.bbox_head[stage].fused_attention
    for name, a, b, u in zip(('cls', 'deltas', 'obj'), got, ref, unfused):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
        torch.testing.assert_close(a, u, rtol=2e-5, atol=2e-5, msg=name)


def test_fused_head_state_dict_is_plain():
    a = STQIHead(fused_attention=True).state_dict()
    b = STQIHead().state_dict()
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}


# ----------------------------------------------------------------- model

def test_fused_model_matches_jax(small_fused):
    """Per-stage boxes, scores and gazes of the whole fused model."""
    jmodel, variables, port, _ = small_fused
    imgs, whwh = clip_inputs(12)
    with pytest.MonkeyPatch.context() as mp:
        interpret_chain(mp)
        jout = jax.jit(lambda v, i, w: jmodel.apply(v, i, w, clip_length=T))(
            variables, jnp.asarray(imgs), jnp.asarray(whwh))
    with torch.inference_mode():
        pout = port(torch.from_numpy(imgs), torch.from_numpy(whwh))
    for s, (js, ps) in enumerate(zip(jout['stages'], pout['stages'])):
        np.testing.assert_allclose(
            torch.sigmoid(ps['cls_logits']).numpy(),
            np.asarray(jax.nn.sigmoid(js['cls_logits'])), atol=1e-3,
            err_msg=f'stage{s} scores')
        np.testing.assert_allclose(ps['boxes'].numpy(),
                                   np.asarray(js['boxes']), rtol=1e-3,
                                   atol=1e-3, err_msg=f'stage{s} boxes')
        for k in ('fusion', 'face', 'eyes', 'head'):
            np.testing.assert_allclose(ps['gaze'][k].numpy(),
                                       np.asarray(js['gaze'][k]), atol=1e-3,
                                       err_msg=f'stage{s} gaze {k}')


def test_fused_fwd_dedup_equals_fwd(small_fused):
    """Two clips sharing 3 frames through the fused model: the pyramid of
    the 11 unique frames, mapped per slot, equals the forward over the 14
    duplicated frames."""
    _, _, port, _ = small_fused
    _, fwd, fwd_dedup = make_eval_forward(port.cfg, model=port)
    rng = np.random.RandomState(13)
    frames = rng.randint(0, 255, (11, 64, 64, 3), np.uint8)
    whwh_u = np.tile(np.array([[60.0, 52.0, 60.0, 52.0]], np.float32),
                     (11, 1))
    sel = np.concatenate([np.arange(0, 7), np.arange(4, 11)])
    a = fwd(torch.from_numpy(frames[sel]), torch.from_numpy(whwh_u[sel]), T)
    b = fwd_dedup(torch.from_numpy(frames), torch.from_numpy(
        sel.astype(np.int32)), torch.from_numpy(whwh_u), T)
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(b[1], a[1], rtol=0, atol=1e-5)
    for k in a[2]:
        torch.testing.assert_close(b[2][k], a[2][k], rtol=0, atol=1e-5)


# ------------------------------------------------------------- refusals

def test_kernel_launchers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only; on the CPU the model
    goes through the plain versions instead, never by a fallback."""
    _, x, weights = chain_inputs(8, 8, cin=64, mid=64)
    with pytest.raises(RuntimeError, match='CUDA device only'):
        fused_bottleneck.launch_fused_bottleneck_chain(
            torch.from_numpy(x), weights, 8, 8)
    arrays = [torch.from_numpy(a) for a in attention_inputs(2)]
    with pytest.raises(RuntimeError, match='CUDA device only'):
        stqi_attention.launch_stqi_attention(*arrays, T, HEADS)


def test_backbone_impl_is_checked():
    with pytest.raises(ValueError, match="'plain' or 'fused'"):
        MCGazeModel(ModelConfig(**SMALL, backbone_impl='pallas'))
