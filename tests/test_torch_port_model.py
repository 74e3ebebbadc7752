"""The port's MCGazeModel against the JAX MCGazeModel, weights carried
across by jax_variables_to_state_dict.

Small config (R26, 2 stages, FFN 256, 64 px, two 7-frame clips), seeded
random weights at O(1) activation scale. Per-stage boxes, scores and gazes
agree at 1e-3 (the tolerance of tests/test_full_model_parity.py: f32 on
both sides, summed in another order through ~30 layers). Also: the
converter is the exact inverse of convert_mcgaze_checkpoint_dict, the
full-width port's state-dict keys and shapes are the reference's, and
fwd_dedup equals fwd.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcgaze_tpu.models.mcgaze import ModelConfig as JModelConfig
from mcgaze_tpu.models.mcgaze import init_model as jinit_model
from mcgaze_tpu.utils.torch_convert import convert_mcgaze_checkpoint_dict
from mcgaze_tpu_torch.evaluation.forward import make_eval_forward
from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, ModelConfig
from mcgaze_tpu_torch.utils.convert import (clean_reference_state_dict,
                                            jax_variables_to_state_dict)
from tests.test_torch_convert import reference_state_dict

SMALL = dict(backbone_depth=26, num_stages=2, ffn_channels=256,
             stage_loss_weights=(1.0, 1.0))
T, IMG = 7, 64


def random_variables(variables, seed):
    """The JAX init tree with seeded random numpy leaves: lecun-scaled
    kernels, perturbed norm scales, biases and BN statistics, and
    proposals spread over the image."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if path[0].key == 'stats':
            x = (0.1 * rng.randn(*shape) if name == 'mean'
                 else np.abs(rng.randn(*shape)) + 0.5)
        elif name == 'init_proposal_bboxes':
            x = np.concatenate([rng.uniform(0.3, 0.7, shape[:1] + (2,)),
                                rng.uniform(0.2, 0.9, shape[:1] + (2,))],
                               -1)
        elif name == 'kernel':
            x = rng.randn(*shape) / math.sqrt(math.prod(shape[:-1]))
        elif name == 'scale':
            x = 1.0 + 0.1 * rng.randn(*shape)
        else:
            x = (rng.randn(*shape) if name == 'init_proposal_features'
                 else 0.1 * rng.randn(*shape))
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def small_pair():
    """(JAX model, JAX variables (numpy), port model on the CPU) holding
    the same weights."""
    jmodel, init = jinit_model(JModelConfig(**SMALL), jax.random.PRNGKey(0),
                               image_size=(IMG, IMG))
    variables = random_variables(to_numpy_tree(init), seed=11)
    port = MCGazeModel(ModelConfig(**SMALL))
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return jmodel, variables, port.eval()


def clip_inputs(seed, n=2 * T):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(n, IMG, IMG, 3).astype(np.float32)
    whwh = np.tile(np.array([[60.0, 52.0, 60.0, 52.0]], np.float32),
                   (n, 1))
    return imgs, whwh


def test_converter_is_inverse_of_torch_convert(small_pair):
    _, variables, _ = small_pair
    sd = {k: v.numpy() for k, v in
          jax_variables_to_state_dict(variables).items()}
    back = convert_mcgaze_checkpoint_dict(sd, num_stages=SMALL['num_stages'])
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_state_dict_surface_is_reference():
    """Full-width port: keys and shapes equal the reference checkpoint's
    (tests/test_torch_convert.py::reference_state_dict); the reference
    dict, plus the benign keys, loads with strict=True."""
    ref = reference_state_dict(np.random.RandomState(0))
    with torch.device('meta'):
        port = MCGazeModel(ModelConfig())
    ours = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert ours == {k: v.shape for k, v in ref.items()}
    ref['backbone.bn1.num_batches_tracked'] = np.array(7)
    ref['roi_head.bbox_head.0.fc_cls.weight'] = np.zeros((2, 12544),
                                                         np.float32)
    port.load_state_dict(clean_reference_state_dict(ref), strict=True,
                         assign=True)


def test_stages_match_jax(small_pair):
    jmodel, variables, port = small_pair
    imgs, whwh = clip_inputs(1)
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


# the port's bf16 stage 0 may sit from JAX's bf16 stage 0 at most this
# many times JAX's own bf16-vs-f32 error there (stage 1 is chaotic in bf16:
# JAX against itself moves its boxes by tens of px, so only stage 0 bounds)
BF16_VS_JAX = 1.25


def test_bf16_stage0_within_jax_bf16_error(small_pair):
    """The same weights in bf16 in both packages: the port's stage-0 boxes
    (px) and gazes (the worst of the four) sit from JAX's bf16 model within
    1.25x JAX's own bf16-vs-f32 error. A LayerNorm that rounds its scale
    and bias to bf16 (flax keeps them in f32) reads ~1.4x here."""
    jmodel, variables, _ = small_pair
    jmodel16, _ = jinit_model(JModelConfig(**SMALL, dtype='bfloat16'),
                              jax.random.PRNGKey(0), image_size=(IMG, IMG))
    imgs, whwh = clip_inputs(1)
    j32, j16 = (jax.jit(lambda v, i, w, m=m: m.apply(v, i, w, clip_length=T))(
        variables, jnp.asarray(imgs), jnp.asarray(whwh))['stages'][0]
        for m in (jmodel, jmodel16))
    port = MCGazeModel(ModelConfig(**SMALL, dtype='bfloat16'))
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        p16 = port.eval()(torch.from_numpy(imgs),
                          torch.from_numpy(whwh))['stages'][0]

    def f32(x):
        return (x.float().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(jnp.asarray(x, jnp.float32)))

    def err(a, b):
        box = np.abs(f32(a['boxes']) - f32(b['boxes'])).max()
        gaze = max(np.abs(f32(a['gaze'][k]) - f32(b['gaze'][k])).max()
                   for k in b['gaze'])
        return box, gaze

    (box, gaze), (box_ref, gaze_ref) = err(p16, j16), err(j16, j32)
    assert box <= BF16_VS_JAX * box_ref, (box, box_ref)
    assert gaze <= BF16_VS_JAX * gaze_ref, (gaze, gaze_ref)


def test_fwd_dedup_equals_fwd(small_pair):
    """Two clips sharing 3 frames: the pyramid of the 11 unique frames,
    mapped per slot, equals the forward over the 14 duplicated frames."""
    _, _, port = small_pair
    _, fwd, fwd_dedup = make_eval_forward(port.cfg, model=port)
    rng = np.random.RandomState(2)
    frames = rng.randint(0, 255, (11, IMG, IMG, 3), np.uint8)
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


def test_entry_points_refuse_missing_card():
    """Entry points default to 'cuda' and never move to the CPU on their
    own."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    from mcgaze_tpu_torch.models.mcgaze import init_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(ModelConfig(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_forward(ModelConfig(**SMALL))


@pytest.mark.parametrize('field,value', [('batched_clue_heads', True)])
def test_unported_options_raise(field, value):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        MCGazeModel(ModelConfig(**SMALL, **{field: value}))
