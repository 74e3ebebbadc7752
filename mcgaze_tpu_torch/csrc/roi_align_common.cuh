// What the FPN RoIAlign forward (roi_align_fpn.cu) and its transpose
// (roi_align_fpn_bwd.cu) share: the level rule, the sample geometry of one
// bin row, the pyramid descriptor and the vector loads. Both kernels take
// them from here, so the forward and the backward cannot drift apart.
// Each .cu that includes this file is its own shared library (ops/_native.py
// hashes this header into both libraries' names, so a change rebuilds both).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxOut = 16;
constexpr int kMaxSampling = 4;

// P is `const void*` for the forward's feature levels and `float*` for the
// backward's f32 gradient levels.
template <typename P>
struct PyramidT {
  P ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
  int num_levels;
  int num_frames;
};

template <typename P>
PyramidT<P> make_pyramid(P p0, P p1, P p2, P p3, int h0, int w0, int h1,
                         int w1, int h2, int w2, int h3, int w3, float s0,
                         float s1, float s2, float s3, int num_levels,
                         int num_frames) {
  PyramidT<P> pyr;
  const P ptrs[kMaxLevels] = {p0, p1, p2, p3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const float ss[kMaxLevels] = {s0, s1, s2, s3};
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.ptr[l] = ptrs[l];
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.stride[l] = ss[l];
  }
  pyr.num_levels = num_levels;
  pyr.num_frames = num_frames;
  return pyr;
}

struct Axis {
  int lo;
  int hi;
  float w_lo;  // weight of the lo corner, 0 for an invalid sample
  float w_hi;
};

// One axis of one sample: mmcv RoIAlign(aligned=True) bilinear corner rule
// (ops/roi_align.py::_axis_weights). Explicitly rounded arithmetic keeps
// nvcc from contracting the position into an fma, so the coordinates round
// as they do in the plain PyTorch version.
__device__ __forceinline__ Axis axis_sample(float start, float bin, int idx,
                                            int k, int sampling, int size) {
  const float pos = __fadd_rn(static_cast<float>(idx),
                              __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                                        static_cast<float>(sampling)));
  const float v = __fadd_rn(start, __fmul_rn(pos, bin));
  Axis a;
  if (!(v >= -1.0f && v <= static_cast<float>(size))) {
    a.lo = 0;
    a.hi = 0;
    a.w_lo = 0.0f;
    a.w_hi = 0.0f;
    return a;
  }
  const float vc = fmaxf(v, 0.0f);
  float lo = floorf(vc);
  const float max_lo = static_cast<float>(size - 1);
  const bool degenerate = lo >= max_lo;
  lo = fminf(lo, max_lo);
  const float hi = fminf(lo + 1.0f, max_lo);
  const float frac = degenerate ? 0.0f : vc - lo;
  a.lo = static_cast<int>(lo);
  a.hi = static_cast<int>(hi);
  a.w_lo = 1.0f - frac;
  a.w_hi = frac;
  return a;
}

// roi_levels (ops/roi_align.py): the signed area is clipped at 0, so a box
// inverted on both axes routes by its positive area.
__device__ __forceinline__ int roi_level(float x1, float y1, float x2,
                                         float y2, int num_levels,
                                         float finest_scale) {
  const float area = fmaxf(__fmul_rn(x2 - x1, y2 - y1), 0.0f);
  const float v = __fadd_rn(__fdiv_rn(sqrtf(area), finest_scale), 1e-6f);
  int lvl = 0;
  float thresh = 2.0f;
  for (int l = 1; l < num_levels; ++l) {
    lvl += (v >= thresh) ? 1 : 0;
    thresh *= 2.0f;
  }
  return lvl;
}

// The routed level and the sample geometry of bin row i of RoI `box`
// (x1, y1, x2, y2): ys[sy] for the row's `sampling` sample rows, and
// xs[j * sampling + sx] for every bin column. Every thread of the block
// takes part; the caller synchronises before reading ys/xs.
template <typename P>
__device__ __forceinline__ int row_geometry(const PyramidT<P>& pyr,
                                            const float* box, int i,
                                            float finest_scale, int out_size,
                                            int sampling, Axis* ys, Axis* xs) {
  const float x1 = box[0];
  const float y1 = box[1];
  const float x2 = box[2];
  const float y2 = box[3];
  const int lvl = roi_level(x1, y1, x2, y2, pyr.num_levels, finest_scale);
  const int h = pyr.h[lvl];
  const int w = pyr.w[lvl];
  const float stride = pyr.stride[lvl];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int nx = out_size * sampling;
  for (int k = tid; k < sampling + nx; k += nthreads) {
    if (k < sampling) {
      const float ys0 = __fadd_rn(__fdiv_rn(y1, stride), -0.5f);
      const float ye0 = __fadd_rn(__fdiv_rn(y2, stride), -0.5f);
      const float bin = __fdiv_rn(ye0 - ys0, static_cast<float>(out_size));
      ys[k] = axis_sample(ys0, bin, i, k, sampling, h);
    } else {
      const int q = k - sampling;  // j * sampling + sx
      const float xs0 = __fadd_rn(__fdiv_rn(x1, stride), -0.5f);
      const float xe0 = __fadd_rn(__fdiv_rn(x2, stride), -0.5f);
      const float bin = __fdiv_rn(xe0 - xs0, static_cast<float>(out_size));
      xs[q] = axis_sample(xs0, bin, q / sampling, q % sampling, sampling, w);
    }
  }
  return lvl;
}

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* out) { out[0] = *p; }
  __device__ static void store(float* p, const float* in) { *p = in[0]; }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    out[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    *p = __float2bfloat16_rn(in[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(in[2 * k], in[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// Threads of a block: x over channel vectors (at most 64), y over the bin
// columns of the row; one block per (slot, RoI, bin row).
inline dim3 row_block(int channels, int vec, int out_size) {
  const int nvec = channels / vec;
  return dim3(nvec < 64 ? nvec : 64, out_size);
}

inline bool valid_config(int num_levels, int out_size, int sampling) {
  return num_levels >= 1 && num_levels <= kMaxLevels && out_size >= 1 &&
         out_size <= kMaxOut && sampling >= 1 && sampling <= kMaxSampling;
}

}  // namespace

extern "C" {

const char* mcg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
