"""What the CPU can check of K5 (csrc/fused_bottleneck.cu) without a card:
the channel constraints its tiles impose, refused before any device test,
and the per-launch floor (kernel_bounds.k5_launch_floor) that its times are
held against, by a count made by hand."""
import pytest
import torch

from mcgaze_tpu_torch.models.layers import init_weights
from mcgaze_tpu_torch.models.resnet import Bottleneck
from mcgaze_tpu_torch.ops import fused_bottleneck
from mcgaze_tpu_torch.tools import kernel_bounds
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401


def _folded(cin, mid, dtype):
    blk = Bottleneck(cin, mid, 1)
    init_weights(blk, torch.Generator().manual_seed(0))
    with torch.no_grad():
        return list(fused_bottleneck.fold_block_params(blk, dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cin, mid, bad', [(48, 64, 48), (64, 96, 96),
                                           (128, 32, 32)])
def test_channel_constraint_refused_before_device_check(dtype, cin, mid,
                                                        bad):
    """The K step is 64 channels (one 128-byte swizzled row), so Cin and
    the middle width must be multiples of 64. CPU tensors reach that test
    before the one that asks for a CUDA device."""
    weights = _folded(cin, mid, dtype)
    x = torch.zeros(1, 6 * 5, cin, dtype=dtype)
    with pytest.raises(ValueError, match=f'{bad} input channels; the kernel '
                                         'takes multiples of 64'):
        fused_bottleneck.launch_fused_bottleneck_chain(x, weights, 6, 5)


def test_channel_multiples_pass_to_the_device_check():
    """With every width a multiple of 64, the CPU tensor is refused for its
    device, not its shape."""
    weights = _folded(64, 64, torch.bfloat16)
    x = torch.zeros(1, 6 * 5, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match='CUDA device only'):
        fused_bottleneck.launch_fused_bottleneck_chain(x, weights, 6, 5)


def test_launch_floor_layer1_by_hand():
    """layer1 at the eval shape (131 frames of 56x56, bf16), counted by
    hand: per pixel, block 0 moves 64+64 (conv1), 64+64 (conv2), 64+256
    (downsample) and 64+256+256 (conv3 with its identity) channels, blocks
    1 and 2 256+64, 64+64 and 64+256+256 each; plus the folded weights in
    bf16 and the f32 biases. 2.630 GB."""
    pixels = 131 * 56 * 56
    activations = pixels * 2 * (128 + 128 + 320 + 576 + 2 * (320 + 128 + 576))
    weights = 2 * (64 * 64 + 9 * 64 * 64 + 2 * 64 * 256
                   + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256))
    biases = 4 * (64 + 64 + 2 * 256 + 2 * (64 + 64 + 256))
    layer1 = kernel_bounds.chains(50, 224)[0]
    got = kernel_bounds.k5_launch_floor(131, layer1, 'bfloat16')
    assert got['bytes'] == activations + weights + biases
    assert round(got['bytes'] / 1e9, 3) == 2.630
    assert got['launches'] == kernel_bounds.k5_launches(layer1) == 10
    # every launch of layer1 is bound by its bytes at the bf16 peak
    assert got['bytes_bound_launches'] == 10
    assert got['floor_ms'] == pytest.approx(got['bytes'] / 3.35e12 * 1e3)


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('frames', [1, 131, 224])
def test_launch_floor_never_below_the_bound(dtype, frames):
    """The per-launch floor counts every byte and flop that k5_bound
    counts, and more (y1, y2 and the identity through device memory); the
    flops agree, and the chains sum to 1.76 ms at 131 bf16 frames."""
    total = 0.0
    for chain in kernel_bounds.chains(50, 224):
        floor = kernel_bounds.k5_launch_floor(frames, chain, dtype)
        bound = kernel_bounds.k5_bound(frames, chain, dtype)
        # equal where every launch is bound by its flops (f32): up to the
        # rounding of a sum of per-launch times
        assert floor['floor_ms'] >= bound['bound_ms'] * (1 - 1e-12)
        assert floor['bytes'] > bound['bytes']
        assert floor['flops'] == bound['flops']
        assert floor['launches'] == bound['launches']
        total += floor['floor_ms']
    if frames == 131 and dtype == 'bfloat16':
        assert total == pytest.approx(1.761, abs=1e-3)
        paths = kernel_bounds.path_bounds(131, 32, dtype)['K5']['total']
        assert paths['launch_floor_ms'] == pytest.approx(total)
