"""The port's LayerNorm against flax's `nn.LayerNorm(dtype=...)`, which the
JAX heads use in every head (mcgaze_tpu/models/heads.py).

flax keeps scale and bias in f32 against f32 statistics and rounds y once
to the compute dtype; the port must do the same in bf16 (a form that
rounds scale and bias to bf16 first differs from flax in ~32% of the
outputs at scale 1 + 0.3 N(0,1), bias 0.2 N(0,1)). The bound: at most
1e-3 of the bf16 outputs may differ from flax's, the share that f32
arithmetic in another order leaves (one rounding of y apart). In f32 the
port's output is the plain torch LayerNorm's, bit for bit.
"""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcgaze_tpu_torch.models.layers import LN_EPS, LayerNorm
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

MAX_DIFFERING = 1e-3


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (2.0 * rng.randn(*shape) + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    return x, scale, bias


def _port(scale, bias, x):
    ln = LayerNorm(len(scale))
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        return ln(x)


@pytest.mark.parametrize('shape', [(4096, 256), (96, 49, 64)])
def test_layernorm_bf16_matches_flax(shape):
    x, scale, bias = _inputs(shape)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = nn.LayerNorm(epsilon=LN_EPS, dtype=jnp.bfloat16).apply(
        {'params': {'scale': scale, 'bias': bias}}, xb)
    assert ref.dtype == jnp.bfloat16
    got = _port(scale, bias, torch.from_numpy(
        np.asarray(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    differ = float(np.mean(got.float().numpy()
                           != np.asarray(ref.astype(jnp.float32))))
    assert differ <= MAX_DIFFERING, differ


def test_layernorm_f32_is_torch_layer_norm():
    x, scale, bias = _inputs((512, 256), seed=1)
    xt = torch.from_numpy(x)
    got = _port(scale, bias, xt)
    want = F.layer_norm(xt, (256,), torch.from_numpy(scale),
                        torch.from_numpy(bias), LN_EPS)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    ref = nn.LayerNorm(epsilon=LN_EPS).apply(
        {'params': {'scale': scale, 'bias': bias}}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
