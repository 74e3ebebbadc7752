"""The port's MsgShifT backbone (TeViT) against the JAX package's, on the CPU.

Tiny two-stage MsgShifT (tests/test_msgshift_torch_parity.py's sizes:
stage 0 of even depth with sr_ratio 2, stage 1 of odd depth with sr_ratio
1, so both shift directions, the unshifted last layer and both key-value
forms run), seeded random weights carried from the JAX tree by
jax_query_variables_to_state_dict, the same numpy inputs. Tolerances:
  * each of CrossMHA, PatchEmbed, SRAttention (both forms), MixFFN,
    PVTEncoderLayer and shift_msg_tokens: 2e-5 (one or two layers in f32);
  * the whole backbone: 1e-4 per level;
  * the roll semantics: exact against np.roll, with the odd-depth rule;
  * the summed-kernel identity: 1e-5 against the convolution of a constant
    patch holding the token;
  * clip_length=1 makes the backbone frame-independent (2e-5), eval equals
    a train forward at rate 0 bit for bit;
  * the converter: every leaf of the JAX tree has a slot in the port's
    state dict (strict=True), the reference .pth layout of
    test_msgshift_torch_parity.py loads natively and through the JAX
    converter to the same tensors.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mcgaze_tpu.models import msgshift as jm
from mcgaze_tpu.utils.torch_convert import convert_msgshift_backbone
from mcgaze_tpu_torch.models import msgshift as pm
from mcgaze_tpu_torch.utils.convert import (clean_reference_query_state_dict,
                                            jax_query_variables_to_state_dict)
from tests.test_msgshift_torch_parity import (DEPTHS, EMBED, HEADS, MLP,
                                              PADS, PATCH, SHIFT, SR,
                                              STRIDES, msgshift_state_dict)
from tests.test_torch_port_model import random_variables, to_numpy_tree
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

M = 4
CHS = tuple(EMBED * h for h in HEADS)
B, T = 2, 2
H, W = 16, 32
KW = dict(num_msg_tokens=M, shift_strides=SHIFT, embed_dim=EMBED,
          num_layers=DEPTHS, num_heads=HEADS, patch_sizes=PATCH,
          strides=STRIDES, paddings=PADS, sr_ratios=SR, mlp_ratios=MLP)


def port_backbone(variables, **overrides):
    """The port's MsgShifT holding the JAX backbone variables."""
    sd = jax_query_variables_to_state_dict({'params': {
        'backbone': variables['params']}})
    model = pm.MsgShifT(**KW, **overrides)
    model.load_state_dict({k[len('backbone.'):]: v for k, v in sd.items()},
                          strict=True)
    return model.eval()


@pytest.fixture(scope='module')
def pair():
    jmodel = jm.MsgShifT(**KW)
    init = jax.jit(jmodel.init, static_argnames='clip_length')(
        jax.random.PRNGKey(0), jnp.zeros((B * T, H, W, 3)), clip_length=T)
    variables = random_variables(to_numpy_tree(init), seed=3)
    return jmodel, variables, port_backbone(variables)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(got, ref, tol, msg=''):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol, err_msg=msg)


# ------------------------------------------------------------- the modules

def test_cross_mha_matches_jax(pair):
    _, variables, port = pair
    p = variables['params']['stage0_layer0']['attn']['attn']
    q, kv = rand(0, 3, 7, CHS[0]), rand(1, 3, 5, CHS[0])
    ref = jm.CrossMHA(CHS[0], HEADS[0]).apply({'params': p}, q, kv)
    got = port.layers[0][1][0].attn.attn(torch.from_numpy(q),
                                         torch.from_numpy(kv))
    close(got, ref, 2e-5)


def test_patch_embed_matches_jax(pair):
    _, variables, port = pair
    x, msg = rand(2, B, H, W, 3), rand(3, B, M, 3)
    ref_x, ref_hw, ref_msg = jm.PatchEmbed(
        CHS[0], PATCH[0], STRIDES[0], PADS[0]).apply(
            {'params': variables['params']['patch_embed0']}, x, msg)
    got_x, got_hw, got_msg = port.layers[0][0](nchw(x),
                                               torch.from_numpy(msg))
    assert got_hw == tuple(ref_hw)
    close(got_x, ref_x, 2e-5)
    close(got_msg, ref_msg, 2e-5)


@pytest.mark.parametrize('stage', [0, 1], ids=['sr2', 'sr1'])
def test_sr_attention_matches_jax(pair, stage):
    _, variables, port = pair
    c = CHS[stage]
    hw = (H // 4, W // 4) if stage == 0 else (H // 8, W // 8)
    x, msg = rand(4, B, hw[0] * hw[1], c), rand(5, B, M, c)
    ref = jm.SRAttention(c, HEADS[stage], SR[stage]).apply(
        {'params': variables['params'][f'stage{stage}_layer0']['attn']},
        x, hw, msg)
    got = port.layers[stage][1][0].attn(torch.from_numpy(x), hw,
                                        torch.from_numpy(msg))
    close(got[0], ref[0], 2e-5, 'spatial')
    close(got[1], ref[1], 2e-5, 'messengers')


def test_sr_attention_refuses_indivisible_stage(pair):
    port = pair[2]
    x = torch.zeros(1, 3 * 4, CHS[0])
    with pytest.raises(ValueError, match='sr_ratio'):
        port.layers[0][1][0].attn(x, (3, 4), torch.zeros(1, M, CHS[0]))


def test_mix_ffn_matches_jax(pair):
    _, variables, port = pair
    c, hw = CHS[0], (H // 4, W // 4)
    x, msg = rand(6, B, hw[0] * hw[1], c), rand(7, B, M, c)
    ref = jm.MixFFN(c, MLP[0] * c).apply(
        {'params': variables['params']['stage0_layer0']['ffn']}, x, hw, msg)
    got = port.layers[0][1][0].ffn(torch.from_numpy(x), hw,
                                   torch.from_numpy(msg))
    close(got[0], ref[0], 2e-5, 'spatial')
    close(got[1], ref[1], 2e-5, 'messengers')


def test_encoder_layer_matches_jax(pair):
    _, variables, port = pair
    c, hw = CHS[0], (H // 4, W // 4)
    x, msg = rand(8, B, hw[0] * hw[1], c), rand(9, B, M, c)
    ref = jm.PVTEncoderLayer(c, HEADS[0], MLP[0] * c, SR[0]).apply(
        {'params': variables['params']['stage0_layer0']}, x, hw, msg)
    got = port.layers[0][1][0](torch.from_numpy(x), hw,
                               torch.from_numpy(msg))
    close(got[0], ref[0], 2e-5, 'spatial')
    close(got[1], ref[1], 2e-5, 'messengers')


@pytest.mark.parametrize('strides', [(1, -1), (1, -1, 2, -2)])
def test_shift_msg_tokens_matches_jax_and_np_roll(strides):
    b, t, m, c = 2, 4, 8, 3
    msg = np.arange(b * t * m * c, dtype=np.float32).reshape(b * t, m, c)
    got = pm.shift_msg_tokens(torch.from_numpy(msg), t, strides).numpy()
    ref = np.asarray(jm.shift_msg_tokens(jnp.asarray(msg), t, strides))
    np.testing.assert_array_equal(got, ref)
    g = len(strides)
    view = msg.reshape(b, t, g, m // g, c)
    want = np.stack([np.roll(view[:, :, i], s, axis=1)
                     for i, s in enumerate(strides)], axis=2)
    np.testing.assert_array_equal(got, want.reshape(b * t, m, c))


def test_shift_directions_and_odd_depth_rule(monkeypatch, pair):
    """Layer l of a stage shifts by the strides when l is even and by their
    negation when odd; the last layer of an odd-depth stage does not shift
    (DEPTHS = (2, 1): two shifts in stage 0, none in stage 1)."""
    port = pair[2]
    calls = []
    real = pm.shift_msg_tokens

    def spy(msg, clip_length, strides):
        calls.append(tuple(strides))
        return real(msg, clip_length, strides)

    monkeypatch.setattr(pm, 'shift_msg_tokens', spy)
    port(nchw(rand(10, B * T, H, W, 3)), T)
    assert calls == [SHIFT, tuple(-s for s in SHIFT)]
    assert DEPTHS == (2, 1)


# ------------------------------------------------------------ the backbone

def test_backbone_matches_jax_per_level(pair):
    jmodel, variables, port = pair
    x = rand(11, B * T, H, W, 3)
    ref = jmodel.apply(variables, jnp.asarray(x), clip_length=T)
    got = port(nchw(x), T)
    assert len(got) == len(ref) == 2
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.shape[1] == CHS[lvl]
        close(g.permute(0, 2, 3, 1), r, 1e-4, f'level {lvl}')


def test_summed_kernel_identity(pair):
    """A messenger through PatchEmbed's summed kernel equals the strided
    convolution run on a constant patch holding the token."""
    embed = pair[2].layers[0][0]
    k = PATCH[0]
    msg = torch.from_numpy(rand(12, 1, 3, 3))
    w, b = pm._summed(embed.projection, torch.float32)
    for ti in range(3):
        patch = msg[0, ti][None, :, None, None].expand(1, 3, k, k)
        conv = F.conv2d(patch, embed.projection.weight,
                        embed.projection.bias)[0, :, 0, 0]
        torch.testing.assert_close(msg[0, ti] @ w + b, conv, rtol=1e-5,
                                   atol=1e-5)


def test_clip_length_one_is_frame_independent(pair):
    port = pair[2]
    x = nchw(rand(13, 2, H, W, 3))
    both = port(x, 1)
    one = port(x[:1], 1)
    for a, b in zip(both, one):
        torch.testing.assert_close(a[:1], b, rtol=2e-5, atol=2e-5)


def test_messengers_carry_frames_within_a_clip_only(pair):
    port = pair[2]
    base = rand(14, 4, H, W, 3)
    pert = base.copy()
    pert[0] += 1.0
    d = (port(nchw(base), 2)[-1] - port(nchw(pert), 2)[-1]).abs()
    assert d[1].max() > 1e-6
    assert d[2].max() == 0 and d[3].max() == 0


def test_eval_equals_rate_zero_and_train_drops(pair):
    _, variables, _ = pair
    x = nchw(rand(15, B * T, H, W, 3))
    base = port_backbone(variables)(x, T)
    rated = port_backbone(variables, drop_path_rate=0.5)
    for a, b in zip(base, rated(x, T)):
        assert torch.equal(a, b)
    zero = port_backbone(variables, drop_path_rate=0.0)
    gen = torch.Generator().manual_seed(0)
    for a, b in zip(base, zero(x, T, gen)):
        assert torch.equal(a, b)
    dropped = rated(x, T, torch.Generator().manual_seed(0))
    assert max((a - b).abs().max().item()
               for a, b in zip(base, dropped)) > 1e-3
    assert all(torch.isfinite(d).all() for d in dropped)


# ------------------------------------------------------------ the converter

def test_converter_covers_every_leaf(pair):
    _, variables, port = pair
    sd = jax_query_variables_to_state_dict({'params': {
        'backbone': variables['params']}})
    n_leaves = len(jax.tree.leaves(variables['params']))
    assert len(sd) == n_leaves
    assert set(sd) == {f'backbone.{k}' for k in port.state_dict()}


def test_reference_state_dict_round_trip():
    """The reference-named MsgShifT state dict loads into the port with
    strict=True, and the JAX converter's tree of it comes back to the same
    tensors through jax_query_variables_to_state_dict."""
    sd = msgshift_state_dict(np.random.RandomState(0))
    model = pm.MsgShifT(**KW)
    clean = clean_reference_query_state_dict(sd)
    model.load_state_dict({k[len('backbone.'):]: v
                           for k, v in clean.items()}, strict=True)
    params = {}
    convert_msgshift_backbone(params, sd)
    back = jax_query_variables_to_state_dict({'params': params})
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
