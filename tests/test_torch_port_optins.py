"""The JAX package's two opt-ins in the port: `ResNet(s2d_stem=True)` and
`ModelConfig(batched_clue_heads=True)`, on the same weights as their plain
forms.

  * the space-to-depth stem against the plain stem (the same products,
    summed in another order) and against the JAX s2d ResNet, at 2e-5
    relative to each level's scale (tests/test_torch_port_modules.py);
  * the batched clue heads against the JAX batched model on one state
    dict at 1e-3 (the model parity tolerance) and against the port's
    unbatched model at 2e-5;
  * the confidence towers read detached features in both forms: with the
    gaze towers' first layer zeroed, nothing of the gaze output depends on
    obj_feat but through them, and its gradient there is exactly zero.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcgaze_tpu.models.mcgaze import MCGazeModel as JModel
from mcgaze_tpu.models.mcgaze import ModelConfig as JModelConfig
from mcgaze_tpu_torch.models.heads import CLUES, GazeHead
from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, ModelConfig
from mcgaze_tpu_torch.models.resnet import ResNet
from mcgaze_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.test_torch_port_model import (SMALL, T, clip_inputs,  # noqa: F401
                                         random_variables, small_pair,
                                         to_numpy_tree)
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

TOL = 2e-5
TOL_JAX_MODEL = 1e-3


@pytest.fixture(scope='module')
def resnets():
    """(JAX s2d ResNet-26, its variables, port plain and s2d ResNet-26 on
    the same weights)."""
    from mcgaze_tpu.models.resnet import ResNet as JResNet
    jnet = JResNet(depth=26, s2d_stem=True)
    init = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = random_variables(to_numpy_tree(init), seed=13)
    sd = jax_variables_to_state_dict(
        {c: {'backbone': variables[c]} for c in ('params', 'stats')})
    sd = {k[len('backbone.'):]: v for k, v in sd.items()}
    plain, s2d = ResNet(26), ResNet(26, s2d_stem=True)
    plain.load_state_dict(sd, strict=True)
    s2d.load_state_dict(sd, strict=True)
    assert s2d.state_dict().keys() == plain.state_dict().keys()
    return jnet, variables, plain.eval(), s2d.eval()


def test_s2d_stem_matches_plain_and_jax(resnets):
    jnet, variables, plain, s2d = resnets
    imgs, _ = clip_inputs(9, n=4)
    ref = jax.jit(jnet.apply)(variables, jnp.asarray(imgs))
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    with torch.inference_mode():
        ours, base = s2d(x), plain(x)
    for lvl, (a, b, r) in enumerate(zip(ours, base, ref)):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        scale = np.abs(r).max()
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   rtol=0, atol=TOL, err_msg=f'plain {lvl}')
        np.testing.assert_allclose(a.numpy() / scale, r / scale, rtol=0,
                                   atol=TOL, err_msg=f'jax {lvl}')


def test_s2d_stem_needs_even_size(resnets):
    s2d = resnets[3]
    with pytest.raises(ValueError, match='even'):
        s2d(torch.zeros(1, 3, 64, 63))


@pytest.fixture(scope='module')
def batched_outputs(small_pair):  # noqa: F811
    """Stage outputs of the JAX batched model, the port's batched and the
    port's unbatched model on small_pair's weights."""
    _, variables, port = small_pair
    jmodel = JModel(JModelConfig(**SMALL, batched_clue_heads=True))
    imgs, whwh = clip_inputs(2)
    jout = jax.jit(lambda v, i, w: jmodel.apply(v, i, w, clip_length=T))(
        variables, jnp.asarray(imgs), jnp.asarray(whwh))
    batched = MCGazeModel(ModelConfig(**SMALL, batched_clue_heads=True))
    batched.load_state_dict(port.state_dict(), strict=True)
    with torch.inference_mode():
        args = torch.from_numpy(imgs), torch.from_numpy(whwh)
        return jout, batched.eval()(*args), port(*args)


def stage_arrays(stage):
    """name -> numpy: scores, boxes and the four gazes of one stage."""
    cls = stage['cls_logits']
    out = dict(boxes=np.asarray(stage['boxes']),
               scores=np.asarray(jax.nn.sigmoid(cls)) if isinstance(
                   cls, jax.Array) else torch.sigmoid(cls).numpy())
    out.update({k: np.asarray(v) for k, v in stage['gaze'].items()})
    return out


@pytest.mark.parametrize('ref_side,tol', [('jax', TOL_JAX_MODEL),
                                          ('port_unbatched', TOL)])
def test_batched_clue_heads_match(batched_outputs, ref_side, tol):
    jout, ours, unbatched = batched_outputs
    ref = jout if ref_side == 'jax' else unbatched
    for s, (a, b) in enumerate(zip(ours['stages'], ref['stages'])):
        a, b = stage_arrays(a), stage_arrays(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                       err_msg=f'stage{s} {k}')


@pytest.mark.parametrize('batched', [False, True])
def test_confidence_towers_read_detached_features(batched):
    torch.manual_seed(0)
    head = GazeHead(64, batched_clues=batched)
    with torch.no_grad():
        for clue in CLUES:
            getattr(head, f'gaze_{clue}_fcs')[0].weight.zero_()
    obj = torch.randn(5, 3, 64, requires_grad=True)
    out = head(obj)
    loss = sum(v.sum() for v in out.values())
    (grad,) = torch.autograd.grad(loss, obj)
    assert torch.equal(grad, torch.zeros_like(grad))
    # the confidence towers are on the graph: their weights get gradient
    conf = head.gaze_face_confidence[0].weight
    (g_conf,) = torch.autograd.grad(head(obj)['fusion'].sum(), conf)
    assert g_conf.abs().max() > 0


def test_batched_heads_share_the_state_dict():
    cfg = ModelConfig(**SMALL)
    with torch.device('meta'):
        plain = MCGazeModel(cfg).state_dict()
        batched = MCGazeModel(dataclasses.replace(
            cfg, batched_clue_heads=True)).state_dict()
    assert {k: v.shape for k, v in plain.items()} == \
        {k: v.shape for k, v in batched.items()}
