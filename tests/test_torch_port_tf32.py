"""The arithmetic of K5's float32 body (csrc/fused_bottleneck.cu), on the CPU.

The card runs each f32 convolution of the chain as three TF32 products on
the tensor cores (3xTF32): every operand v splits into hi = v rounded to
the nearest TF32 and lo = v - hi, and each term adds lo_a*hi_b + hi_a*lo_b
+ hi_a*hi_b in f32, the tensor cores reading each operand's top 10
mantissa bits (they truncate the rest). The weights split on the host
(ops/fused_bottleneck.py::tf32_split, (K, Cout) -> K-major (2, Cout, K)),
the activations in the kernel's registers (cvt.rna). The kernel adds each
32-wide K stage's products to its sum with f32 adds; the emulation sums
all of K in torch's f32.

Held here: tf32_split on seeded weights of every ResNet-50 chain shape
(hi TF32-exact, hi + lo == w bit for bit, |lo| <= 2^-11 |w|, the layout),
its ties; and a plain-torch emulation of a whole chain in 3xTF32 against
the port's chain_reference and the JAX package's at chip_smoke's
TOL_K5_F32_REL (1e-4 of the largest output) -- the kernel's arithmetic,
without the card. A single TF32 pass, for contrast, sits at least ten
times farther from the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL_K5_F32_REL
from mcgaze_tpu.ops import fused_bottleneck as jfb
from mcgaze_tpu_torch.ops import fused_bottleneck as fb
from mcgaze_tpu_torch.tools import kernel_bounds
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

LOW_BITS = 0x1FFF            # the 13 mantissa bits TF32 drops


def _bits(t):
    return t.contiguous().view(torch.int32)


def truncate(t):
    """What the tensor cores read of an f32 operand: its top 10 mantissa
    bits (the low 13 cut, not rounded)."""
    return (_bits(t) & ~LOW_BITS).view(torch.float32)


@pytest.mark.parametrize('stage', [1, 2, 3, 4])
def test_tf32_split_on_every_resnet50_chain_shape(stage):
    """Each convolution of the chain: hi's low 13 mantissa bits zero (the
    hardware reads it whole), hi + lo == w exactly, |lo| <= 2^-11 |w| (hi
    the nearest TF32), and the K-major (2, Cout, K) layout: [i, c, k] is
    the split of w[k, c]."""
    chain = kernel_bounds.chains(50, 224)[stage - 1]
    rng = np.random.RandomState(stage)
    for cin, cout, ksize, _ in kernel_bounds.k5_convs(chain):
        k = ksize * ksize * cin
        w = torch.from_numpy((rng.randn(k, cout) * (2.0 / k) ** 0.5).astype(
            np.float32))
        s = fb.tf32_split(w)
        assert s.shape == (2, cout, k) and s.dtype == torch.float32
        assert s.is_contiguous()
        hi, lo = s[0], s[1]
        assert int((_bits(hi) & LOW_BITS).abs().max()) == 0
        assert torch.equal(hi + lo, w.t())
        assert bool((lo.abs() <= 2.0 ** -11 * w.t().abs()).all())
        # the layout, element by element at a few places
        for kk, c in ((0, 0), (k - 1, cout - 1), (k // 3, cout // 2)):
            assert float(hi[c, kk] + lo[c, kk]) == float(w[kk, c])


def test_tf32_split_rounds_to_nearest_ties_away():
    """Ties round away from zero, as cvt.rna does on the card: 1 + 2^-11
    (half a TF32 step above 1) goes to 1 + 2^-10, its negative to -(1 +
    2^-10); 1 + 2^-12 goes down to 1; values already TF32 stay."""
    w = torch.tensor([[1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                       1 + 2 ** -10, -3.0, 0.0]], dtype=torch.float32).t()
    hi, lo = fb.tf32_split(w)[:, 0]
    assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                           1 + 2 ** -10, -3.0, 0.0]
    assert lo.tolist() == [-2 ** -11, 2 ** -11, 2 ** -12, 0.0, 0.0, 0.0]


def _split_rows(x):
    """(M, K) activations -> (hi, lo), each (M, K): the kernel's split in
    registers (the same rounding as tf32_split)."""
    s = fb.tf32_split(x)
    return s[0].t(), s[1].t()


def _mm_3xtf32(x, a, b):
    """x @ a + b as K5's f32 body computes it: lo_x hi_a + hi_x lo_a + hi_x
    hi_a, each operand as the tensor cores read it, summed in f32."""
    xh, xl = _split_rows(x)
    s = fb.tf32_split(a)
    ah, al = s[0].t(), truncate(s[1]).t()
    return truncate(xl) @ ah + xh @ al + xh @ ah + b


def _mm_1xtf32(x, a, b):
    """One TF32 pass, each operand rounded to TF32 (cuDNN's TF32 mode)."""
    return _split_rows(x)[0] @ fb.tf32_split(a)[0].t() + b


def chain_emulated(x, weights, h, w, mm):
    """chain_reference's f32 chain with each convolution's product taken by
    `mm` ((M, K) rows against the folded (K, Cout) weight)."""
    n = x.shape[0]

    def conv(t, a, b):
        return mm(t.reshape(-1, t.shape[-1]), a, b).reshape(n, h * w, -1)

    for a1, b1, a2, b2, a3, b3, ad, bd in fb.split_blocks(weights):
        y = torch.relu(conv(x, a1, b1))
        y = torch.relu(conv(fb.im2col3x3(y, h, w), a2, b2))
        y = conv(y, a3, b3)
        idn = x if ad is None else conv(x, ad, bd)
        x = torch.relu(y + idn)
    return x


def seeded_chain(seed, cin, mid, n_blocks, frames=2, h=6, w=5):
    """x (frames, h*w, cin), ReLU'd as a chain's input is, and the folded
    f32 weights of n_blocks stride-1 blocks (a downsample on the first
    where cin != 4 mid), seeded with numpy: A's He-scaled, biases 0.1."""
    rng = np.random.RandomState(seed)

    def a(k, c):
        return torch.from_numpy((rng.randn(k, c) * (2.0 / k) ** 0.5).astype(
            np.float32))

    def b(c):
        return torch.from_numpy((rng.randn(1, c) * 0.1).astype(np.float32))

    weights = []
    c = cin
    for i in range(n_blocks):
        weights += [a(c, mid), b(mid), a(9 * mid, mid), b(mid),
                    a(mid, 4 * mid), b(4 * mid)]
        if i == 0 and c != 4 * mid:
            weights += [a(c, 4 * mid), b(4 * mid)]
        c = 4 * mid
    x = torch.from_numpy(np.maximum(rng.randn(frames, h * w, cin), 0)
                         .astype(np.float32))
    return x, weights, h, w


@pytest.mark.parametrize('cin, mid, n_blocks', [
    (64, 64, 2),        # Cin 64 with a downsample, then an identity block
    (512, 128, 2),      # 512 -> 128 -> 512, the identity x on the first
])
def test_chain_in_3xtf32_holds_the_reference(cin, mid, n_blocks):
    """The chain with every product in 3xTF32, as the card computes it,
    against the port's chain_reference and the JAX chain_reference (both
    f32 products) at TOL_K5_F32_REL of the largest output; one TF32 pass
    sits at least ten times farther off."""
    x, weights, h, w = seeded_chain(cin + mid, cin, mid, n_blocks)
    ref = fb.chain_reference(x, weights, h, w)
    jref = torch.from_numpy(np.array(jfb.chain_reference(
        jnp.asarray(x.numpy()), tuple(jnp.asarray(t.numpy())
                                      for t in weights), h, w)))
    got = chain_emulated(x, weights, h, w, _mm_3xtf32)
    one_pass = chain_emulated(x, weights, h, w, _mm_1xtf32)
    scale = ref.abs().max().item()
    assert scale > 0
    err = (got - ref).abs().max().item()
    jax_err = (got - jref).abs().max().item()
    assert err <= TOL_K5_F32_REL * scale, (err, scale)
    assert jax_err <= TOL_K5_F32_REL * scale, (jax_err, scale)
    assert 10 * err < (one_pass - ref).abs().max().item()
