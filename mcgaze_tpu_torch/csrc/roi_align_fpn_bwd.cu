// Fused FPN RoIAlign backward for Hopper (sm_90a): the feature gradient, as
// a bilinear scatter. Bound through a plain C interface and loaded with
// ctypes (mcgaze_tpu_torch/ops/roi_align_cuda.py, RoIAlignFPNFunction).
//
// Replaces the TPU kernel mcgaze_tpu/ops/roi_align_pallas.py::
// roi_align_fpn_pallas_bwd (body _make_bwd_kernel), which _diff_bwd
// dispatches on TPU training. It also covers what the JAX package leaves to
// the matmul transpose: the slot -> unique-frame form (_gdiff_bwd), where
// each slot's terms land in frame frame_idx[n].
//
// What it computes: the exact transpose of roi_align_fpn.cu. With g the
// cotangent (N, R, out, out, C) in the feature dtype,
//   dF_l[f, y, x, c] = sum over (n, r) routed to level l with frame(n) = f,
//                      over bins (i, j), the sampling^2 samples and their 4
//                      bilinear corners at (y, x), of w * g[n, r, i, j, c]
//                      / sampling^2.
// Routing and sampling come from roi_align_common.cuh, the code the forward
// runs, so the two cannot drift apart. The rois get no gradient.
//
// What bounds it on the card: bytes. The dense gradient covers every cell of
// the pyramid (4,165 cells x 256 channels per 224 px frame) and has to be
// written once however few cells the RoIs touch; against it each term is one
// multiply and one add. The least work is that write, g read once, and the
// touched cells read and written once.
//
// Design: the forward's block layout, one block per (slot, RoI, bin row i),
// threads over (16-byte channel vector of g, bin column j). Each thread
// reads its g vector once and adds w * g / sampling^2 into every corner of
// its bin's samples with f32 atomicAdd, into one f32 buffer per level that
// the wrapper allocates zeroed. In f32 that buffer is the output; in bf16 the
// wrapper casts it once (one elementwise pass), so partial sums are never
// rounded to bf16 (the Pallas kernel's bf16 accumulator re-rounds them). The atomics add
// a cell's terms in an order that changes from run to run, so the result is
// not bitwise reproducible; f32 keeps that difference at rounding level.
// Not done yet: vector atomics, one buffer shared by the 4 stages of a step,
// a deterministic gather form.

#include "roi_align_common.cuh"

namespace {

using GradPyramid = PyramidT<float*>;

template <typename T, int VEC>
__global__ void roi_align_fpn_bwd_kernel(GradPyramid pyr,
                                         const float* __restrict__ rois,
                                         const int* __restrict__ frame_idx,
                                         const T* __restrict__ g,
                                         int num_rois, int channels,
                                         float finest_scale, int out_size,
                                         int sampling) {
  __shared__ Axis ys[kMaxSampling];
  __shared__ Axis xs[kMaxOut * kMaxSampling];

  const int i = blockIdx.x % out_size;    // bin row
  const int nr = blockIdx.x / out_size;   // slot * R + RoI
  const int n = nr / num_rois;
  const int frame = frame_idx ? frame_idx[n] : n;
  const int lvl = row_geometry(pyr, rois + 4 * nr, i, finest_scale, out_size,
                               sampling, ys, xs);
  const int h = pyr.h[lvl];
  const int w = pyr.w[lvl];
  __syncthreads();
  // a slot mapped outside the pyramid read nothing forward: nothing flows
  // back from it
  if (frame < 0 || frame >= pyr.num_frames) return;

  const int j = threadIdx.y;
  const T* src = g + (static_cast<int64_t>(nr) * out_size * out_size +
                      static_cast<int64_t>(i) * out_size + j) * channels;
  float* base = pyr.ptr[lvl] + static_cast<int64_t>(frame) * h * w * channels;
  const float scale = 1.0f / static_cast<float>(sampling * sampling);
  const int nvec = channels / VEC;

  for (int cv = threadIdx.x; cv < nvec; cv += blockDim.x) {
    const int64_t c0 = static_cast<int64_t>(cv) * VEC;
    float gv[VEC];
    Vec<T, VEC>::load(src + c0, gv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) gv[e] *= scale;
    for (int sy = 0; sy < sampling; ++sy) {
      const Axis ay = ys[sy];
      if (ay.w_lo == 0.0f && ay.w_hi == 0.0f) continue;
      float* row_lo = base + static_cast<int64_t>(ay.lo) * w * channels + c0;
      float* row_hi = base + static_cast<int64_t>(ay.hi) * w * channels + c0;
      for (int sx = 0; sx < sampling; ++sx) {
        const Axis ax = xs[j * sampling + sx];
        if (ax.w_lo == 0.0f && ax.w_hi == 0.0f) continue;
        const int64_t xl = static_cast<int64_t>(ax.lo) * channels;
        const int64_t xh = static_cast<int64_t>(ax.hi) * channels;
        const float w00 = ay.w_lo * ax.w_lo;
        const float w01 = ay.w_lo * ax.w_hi;
        const float w10 = ay.w_hi * ax.w_lo;
        const float w11 = ay.w_hi * ax.w_hi;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          // a zero weight (the degenerate edge's hi corner) adds nothing
          if (w00 != 0.0f) atomicAdd(row_lo + xl + e, w00 * gv[e]);
          if (w01 != 0.0f) atomicAdd(row_lo + xh + e, w01 * gv[e]);
          if (w10 != 0.0f) atomicAdd(row_hi + xl + e, w10 * gv[e]);
          if (w11 != 0.0f) atomicAdd(row_hi + xh + e, w11 * gv[e]);
        }
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const GradPyramid& pyr, const float* rois,
                   const int* frame_idx, const void* g, int n, int r, int c,
                   float finest_scale, int out_size, int sampling,
                   cudaStream_t stream) {
  const dim3 block = row_block(c, VEC, out_size);
  const dim3 grid(n * r * out_size);
  roi_align_fpn_bwd_kernel<T, VEC><<<grid, block, 0, stream>>>(
      pyr, rois, frame_idx, static_cast<const T*>(g), r, c, finest_scale,
      out_size, sampling);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d0..d3: the per-level f32 gradient buffers (U, H_l, W_l, C), zeroed by
// the caller; the terms are added into them. g: (N, R, out, out, C) in
// dtype 0 = float32 or 1 = bfloat16. vec: 1, or 16 bytes of g per load
// (4 f32 / 8 bf16) when C is a multiple of it and g is 16-byte aligned.
// frame_idx may be NULL (identity form, U == N). Returns the cudaError_t of
// the launch.
int mcg_roi_align_fpn_bwd(float* d0, float* d1, float* d2, float* d3,
                          int h0, int w0, int h1, int w1, int h2, int w2,
                          int h3, int w3, float s0, float s1, float s2,
                          float s3, int num_levels, int num_frames,
                          const float* rois, const int* frame_idx,
                          const void* g, int n, int r, int c, int dtype,
                          int vec, float finest_scale, int out_size,
                          int sampling, void* stream) {
  if (!valid_config(num_levels, out_size, sampling)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || r == 0) return 0;
  const GradPyramid pyr = make_pyramid<float*>(
      d0, d1, d2, d3, h0, w0, h1, w1, h2, w2, h3, w3, s0, s1, s2, s3,
      num_levels, num_frames);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(pyr, rois, frame_idx, g, n, r, c, finest_scale,
                           out_size, sampling, st);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(pyr, rois, frame_idx, g, n, r, c, finest_scale,
                           out_size, sampling, st);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(pyr, rois, frame_idx, g, n, r, c,
                                   finest_scale, out_size, sampling, st);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(pyr, rois, frame_idx, g, n, r, c,
                                   finest_scale, out_size, sampling, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
