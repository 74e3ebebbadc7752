// Fused FPN RoIAlign forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (mcgaze_tpu_torch/ops/roi_align_cuda.py).
//
// Replaces the TPU kernel mcgaze_tpu/ops/roi_align_pallas.py::
// roi_align_fpn_pallas (bodies _make_kernel / _make_kernel_vec), in both of
// its forms: the identity form reached through roi_align_fpn_pallas_diff and
// the slot -> unique-frame form reached through
// roi_align_fpn_pallas_gather_diff. Here frame_idx is one pointer offset per
// block, not a second kernel.
//
// What it computes, per output out[n, r, i, j, c] (n < N slots, r < R RoIs,
// an out_size x out_size bin grid, C channels): the RoI rois[n, r] is routed
// to one FPN level l (roi_levels: floor(log2(sqrt(area)/finest + 1e-6))
// clipped to [0, L-1], as power-of-two comparisons on the clipped SIGNED
// area), and the bin is the mean of sampling_ratio^2 aligned bilinear
// samples of level l of frame f = frame_idx[n] (or n). Coordinates are
// x / stride - 0.5; a sample is valid iff it lies in [-1, size]; corners are
// clamped with mmcv's degenerate-edge rule. The sum is accumulated in f32
// and cast once to the feature dtype.
//
// What bounds it on the card: bytes. Each output element costs 16 fused
// multiply-adds (4 samples x 4 corners) against up to 16 loads, far below
// the H100's ~20 flop/byte balance point, so the floor is moving the output
// plus the pyramid cells the RoIs touch. The TPU kernel brought each frame's
// whole pyramid into VMEM and contracted it with one-hot matrices on the
// MXU; on the card that would read the whole pyramid (4.3 MB per frame in
// f32 at 224 px) for three RoIs, so this kernel gathers only the corners it
// needs.
//
// Design: one block per (slot, RoI, bin row i). The block computes the
// level, the bin geometry and the corner indices and weights of its row's
// samples once, into shared memory. Threads are laid out (channel vector,
// bin column j): threadIdx.x walks the channels in 16-byte vectors, so the
// four corner loads of a sample are coalesced along C of the NHWC pyramid,
// and threadIdx.y is the bin column. There is no one-hot matmul, no VMEM
// sizing, no RoI chunking and no level sort: those were TPU workarounds.
// The level rule and the row geometry live in roi_align_common.cuh, which
// the backward (roi_align_fpn_bwd.cu) includes as well.

#include "roi_align_common.cuh"

namespace {

using Pyramid = PyramidT<const void*>;

template <typename T, int VEC>
__global__ void roi_align_fpn_kernel(Pyramid pyr,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ frame_idx,
                                     T* __restrict__ out, int num_rois,
                                     int channels, float finest_scale,
                                     int out_size, int sampling) {
  __shared__ Axis ys[kMaxSampling];
  __shared__ Axis xs[kMaxOut * kMaxSampling];

  const int i = blockIdx.x % out_size;    // bin row
  const int nr = blockIdx.x / out_size;   // slot * R + RoI
  const int n = nr / num_rois;
  const int frame = frame_idx ? frame_idx[n] : n;
  // level and bin geometry of this row, once per block
  const int lvl = row_geometry(pyr, rois + 4 * nr, i, finest_scale, out_size,
                               sampling, ys, xs);
  const int h = pyr.h[lvl];
  const int w = pyr.w[lvl];
  __syncthreads();

  const int j = threadIdx.y;
  T* dst = out + (static_cast<int64_t>(nr) * out_size * out_size +
                  static_cast<int64_t>(i) * out_size + j) * channels;
  const int nvec = channels / VEC;
  if (frame < 0 || frame >= pyr.num_frames) {
    // a slot mapped outside the pyramid reads nothing: its RoIs come out NaN
    float nan_v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) nan_v[e] = __int_as_float(0x7fc00000);
    for (int cv = threadIdx.x; cv < nvec; cv += blockDim.x) {
      Vec<T, VEC>::store(dst + cv * VEC, nan_v);
    }
    return;
  }
  const T* base = static_cast<const T*>(pyr.ptr[lvl]) +
                  static_cast<int64_t>(frame) * h * w * channels;
  const float scale = 1.0f / static_cast<float>(sampling * sampling);

  for (int cv = threadIdx.x; cv < nvec; cv += blockDim.x) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int sy = 0; sy < sampling; ++sy) {
      const Axis ay = ys[sy];
      if (ay.w_lo == 0.0f && ay.w_hi == 0.0f) continue;
      const T* row_lo = base + static_cast<int64_t>(ay.lo) * w * channels;
      const T* row_hi = base + static_cast<int64_t>(ay.hi) * w * channels;
      for (int sx = 0; sx < sampling; ++sx) {
        const Axis ax = xs[j * sampling + sx];
        if (ax.w_lo == 0.0f && ax.w_hi == 0.0f) continue;
        float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
        const int64_t c0 = static_cast<int64_t>(cv) * VEC;
        Vec<T, VEC>::load(row_lo + static_cast<int64_t>(ax.lo) * channels + c0, v00);
        Vec<T, VEC>::load(row_lo + static_cast<int64_t>(ax.hi) * channels + c0, v01);
        Vec<T, VEC>::load(row_hi + static_cast<int64_t>(ax.lo) * channels + c0, v10);
        Vec<T, VEC>::load(row_hi + static_cast<int64_t>(ax.hi) * channels + c0, v11);
        const float w00 = ay.w_lo * ax.w_lo;
        const float w01 = ay.w_lo * ax.w_hi;
        const float w10 = ay.w_hi * ax.w_lo;
        const float w11 = ay.w_hi * ax.w_hi;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[e] += w00 * v00[e] + w01 * v01[e] + w10 * v10[e] + w11 * v11[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= scale;
    Vec<T, VEC>::store(dst + cv * VEC, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const Pyramid& pyr, const float* rois, const int* frame_idx,
                   void* out, int n, int r, int c, float finest_scale,
                   int out_size, int sampling, cudaStream_t stream) {
  const dim3 block = row_block(c, VEC, out_size);
  const dim3 grid(n * r * out_size);
  roi_align_fpn_kernel<T, VEC><<<grid, block, 0, stream>>>(
      pyr, rois, frame_idx, static_cast<T*>(out), r, c, finest_scale,
      out_size, sampling);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: 1 for scalar loads, or 16 bytes
// of channels per load (4 f32 / 8 bf16), which the caller may pick only when
// C is a multiple of it and every pointer is 16-byte aligned. frame_idx may
// be NULL (identity form, U == N). Returns the cudaError_t of the launch.
int mcg_roi_align_fpn_fwd(const void* f0, const void* f1, const void* f2,
                          const void* f3, int h0, int w0, int h1, int w1,
                          int h2, int w2, int h3, int w3, float s0, float s1,
                          float s2, float s3, int num_levels, int num_frames,
                          const float* rois, const int* frame_idx, void* out,
                          int n, int r, int c, int dtype, int vec,
                          float finest_scale, int out_size, int sampling,
                          void* stream) {
  if (!valid_config(num_levels, out_size, sampling)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || r == 0) return 0;
  const Pyramid pyr = make_pyramid<const void*>(
      f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3, s0, s1, s2, s3,
      num_levels, num_frames);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(pyr, rois, frame_idx, out, n, r, c, finest_scale,
                           out_size, sampling, st);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(pyr, rois, frame_idx, out, n, r, c, finest_scale,
                           out_size, sampling, st);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(pyr, rois, frame_idx, out, n, r, c,
                                   finest_scale, out_size, sampling, st);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(pyr, rois, frame_idx, out, n, r, c,
                                   finest_scale, out_size, sampling, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
