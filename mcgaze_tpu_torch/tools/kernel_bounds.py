"""Least device time of the two TPU kernels not yet ported, K4
(mcgaze_tpu/ops/stqi_attention.py::fused_stqi_attention) and K5
(mcgaze_tpu/ops/fused_bottleneck.py::fused_bottleneck_chain), worked out
from their code and the gaze model's shapes, on one H100 SXM:

    python -m mcgaze_tpu_torch.tools.kernel_bounds

Prints one JSON object. Bound = max(bytes / 3.35 TB/s, flops / peak),
each input read once and each output written once. Peaks (NVIDIA's data
sheet, dense, at 700 W) follow the precision each path runs at with the
card's defaults: eval in bf16 on the tensor cores (989 TFLOP/s); train in
f32, where the attention's matmuls run outside the tensor cores (matmul
TF32 off, 67 TFLOP/s) and the convolutions in cuDNN TF32 (495 TFLOP/s).
Neither kernel runs on a main path (both are opt-in);
`launches_if_enabled` is what a forward would launch with the option on.
No card is used.
"""
import json

HBM_BYTES_PER_S = 3.35e12
PEAKS = dict(bf16=989e12, tf32=495e12, f32=67e12)


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes=nbytes, flops=flops,
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def k4_bound(clips, itemsize, peak, c=256, q=3, t=7):
    """One call per stage over (clips*T*Q, C) tokens: per pass (over the 3
    clues, then the T frames) the packed qkv projection, the out
    projection, logits and values over the pass's sequence, a LayerNorm."""
    tokens = clips * t * q
    flops = sum(2 * tokens * c * 3 * c + 2 * tokens * c * c
                + 4 * tokens * seq * c + 8 * tokens * c for seq in (q, t))
    weights = c * 3 * c + 3 * c + c * c + 3 * c
    nbytes = 2 * tokens * c * itemsize + weights * 4
    return bound(nbytes, flops, peak)


def k5_bound(frames, itemsize, peak, budget=10 * 2 ** 20):
    """Every stride-1 bottleneck of each R50 stage per frame (layer1 from
    block 0 with its downsample, the others after their stride-2
    lead-in), chained in groups of at most `budget` bytes of folded
    weights (models/resnet.py). Returns the bound and the launches."""
    size, flops, nbytes, launches = 56, 0, 0, 0
    for stage, (n_blocks, mid) in enumerate(((3, 64), (4, 128), (6, 256),
                                             (3, 512))):
        cin = 64 if stage == 0 else 4 * mid
        size = size if stage == 0 else size // 2
        nbytes += size * size * cin * itemsize * frames
        group = 0
        for b in range(0 if stage == 0 else 1, n_blocks):
            macs = cin * mid + 9 * mid * mid + mid * 4 * mid
            if b == 0:
                macs += cin * 4 * mid
            w_bytes = (macs + 6 * mid + (4 * mid if b == 0 else 0)) * itemsize
            flops += 2 * macs * size * size * frames
            nbytes += w_bytes
            if group == 0 or group + w_bytes > budget:
                launches += 1
                group = 0
            group += w_bytes
            cin = 4 * mid
        nbytes += size * size * 4 * mid * itemsize * frames
    return dict(bound(nbytes, flops, peak), launches_if_enabled=launches)


def queued_bounds(clips=32, stages=4):
    """Eval: 32 clips -> 224 slots, 131 unique frames, bf16. Train: 32
    clips = 224 frames, f32."""
    return dict(
        eval=dict(frames=131, clips=clips, dtype='bfloat16',
                  K4=dict(k4_bound(clips, 2, PEAKS['bf16']), peak='bf16',
                          launches_if_enabled=stages),
                  K5=dict(k5_bound(131, 2, PEAKS['bf16']), peak='bf16')),
        train=dict(frames=224, clips=clips, dtype='float32',
                   K4=dict(k4_bound(clips, 4, PEAKS['f32']), peak='f32',
                           launches_if_enabled=stages),
                   K5=dict(k5_bound(224, 4, PEAKS['tf32']), peak='tf32')))


if __name__ == '__main__':
    print(json.dumps(queued_bounds(), indent=1))
