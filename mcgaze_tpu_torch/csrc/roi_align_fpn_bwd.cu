// Fused FPN RoIAlign backward for Hopper (sm_90a): the feature gradient, as
// a deterministic per-frame gather. Bound through a plain C interface and
// loaded with ctypes (mcgaze_tpu_torch/ops/roi_align_cuda.py,
// RoIAlignFPNFunction).
//
// Replaces the TPU kernel mcgaze_tpu/ops/roi_align_pallas.py::
// roi_align_fpn_pallas_bwd (body _make_bwd_kernel), which _diff_bwd
// dispatches on TPU training. It also covers what the JAX package leaves to
// the matmul transpose: the slot -> unique-frame form (_gdiff_bwd), where
// each slot's terms land in frame frame_idx[n].
//
// What it computes: the exact transpose of roi_align_fpn.cu. With g the
// cotangent (N, R, out, out, C) in the feature dtype and, per level l and
// RoI (n, r) routed to it, the separable weights AY[i][y] and AX[j][x] (each
// the mean over the `sampling` samples of bin i / j of their bilinear
// corner weights on row y / column x),
//   dF_l[f, y, x, c] = sum over (n, r) routed to l with frame(n) = f,
//                      bins (i, j) of AY[i][y] * AX[j][x] * g[n, r, i, j, c].
// Routing and sampling come from roi_align_common.cuh (roi_level, axis_span,
// axis_sample), the code the forward runs, so the two cannot drift apart.
// The rois get no gradient.
//
// What bounds it on the card: bytes. The dense gradient covers every cell of
// the pyramid (4,165 cells x 256 channels per 224 px frame) and has to be
// written once however few cells the RoIs touch; against it each term is one
// multiply-add per channel. The least work is that write and g read once.
//
// Design: the TPU kernel's gather form (per frame and level AY^T (AX^T g)),
// rebuilt for the card. One block per (frame, level, band of kBand rows of
// that level's map), walking the band in tiles of XT columns; threads over
// (16-byte channel vector, column of the tile), each thread holding the
// kBand cells of its column in f32 registers. The block reads the (slot,
// RoI) pairs of its frame (the R RoIs of slot `frame`, or the slots a CSR
// inverse of frame_idx lists), 32 at a time: one warp keeps, in order,
// those routed to its level whose sample span reaches the band, and the
// block builds their AY over the band's rows in shared memory, once for the
// band when the frame has at most 32 pairs; per tile it builds AX over the
// tile's columns for the kept pairs that reach them. Each cell then sums
// its terms in a fixed order (pair, bin row, bin column) and is stored
// once, in g's dtype. A band no pair reaches (most of them: a frame's few
// RoIs touch a few bands) is one contiguous run of the output, which the
// block fills with zeros in 16-byte stores, as a memset would. So every cell of the output is written exactly once by one
// thread: no memset, no atomics, no f32 staging buffer or cast pass in
// bf16, and the result is bitwise the same on every launch.

#include "roi_align_common.cuh"

namespace {

constexpr int kBand = 8;       // rows of a tile: each thread's registers
constexpr int kMaxXT = 32;     // columns of a tile
constexpr int kPairs = 32;     // (slot, RoI) pairs read per round: one warp
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

using GradPyramid = PyramidT<void*>;

// Bands of each level in blockIdx.x: level l owns [first[l], first[l+1]).
struct Tiles {
  int first[kMaxLevels + 1];
};

// The cells [*c0, *c1] of an axis of `size` cells that the samples of
// [start, start + out * bin] (either sign of bin) can weigh on: each sample
// touches floor(v) and floor(v) + 1, clamped to the map. A superset of the
// exact cells (a false hit only costs weights that are all zero); all of
// them for a NaN box (fmaxf and fminf drop the NaN), to which axis_sample
// then gives zero weights, as in the forward. Empty when *c1 < *c0.
__device__ __forceinline__ void span_cells(float start, float bin,
                                           int out_size, int size, int* c0,
                                           int* c1) {
  const float end = start + static_cast<float>(out_size) * bin;
  const float lo = fmaxf(floorf(fminf(start, end)), 0.0f);
  const float hi = fminf(floorf(fmaxf(start, end)) + 1.0f,
                         static_cast<float>(size - 1));
  *c0 = lo <= static_cast<float>(size - 1) ? static_cast<int>(lo) : size;
  *c1 = hi >= 0.0f ? static_cast<int>(hi) : -1;
}

// AY[i][pos] (or AX): the mean over bin i's samples of their corner
// weights on cell `pos`, summed sample by sample in order.
__device__ __forceinline__ float bin_weight(float start, float bin, int i,
                                            int sampling, int size, int pos) {
  float sum = 0.0f;
  for (int k = 0; k < sampling; ++k) {
    const Axis a = axis_sample(start, bin, i, k, sampling, size);
    if (a.lo == pos) sum += a.w_lo;
    if (a.hi == pos) sum += a.w_hi;
  }
  return __fdiv_rn(sum, static_cast<float>(sampling));
}

// bf16 x 8 holds 64 f32 sums a thread: 128 registers, two blocks an SM
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, VEC == 8 ? 2 : 3)
    roi_align_fpn_bwd_kernel(GradPyramid pyr, Tiles tiles,
                             const float* __restrict__ rois,
                             const int* __restrict__ offsets,
                             const int* __restrict__ slots,
                             const T* __restrict__ g, int num_rois,
                             int channels, float finest_scale, int out_size,
                             int sampling) {
  extern __shared__ float wts[];
  __shared__ int pair_row[kPairs];  // slot * R + RoI of each kept pair
  __shared__ int pair_x0[kPairs];   // the columns its samples can reach
  __shared__ int pair_x1[kPairs];
  __shared__ int n_kept;

  const int xt = blockDim.y;
  float* ay = wts;                                  // [pair][i][kBand]
  float* ax = wts + kPairs * out_size * kBand;      // [pair][j][xt]

  int lvl = 0;
  while (lvl + 1 < pyr.num_levels &&
         static_cast<int>(blockIdx.x) >= tiles.first[lvl + 1]) {
    ++lvl;
  }
  const int y0 = (blockIdx.x - tiles.first[lvl]) * kBand;
  const int h = pyr.h[lvl];
  const int w = pyr.w[lvl];
  const float stride = pyr.stride[lvl];
  const int frame = blockIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int nvec = channels / VEC;
  const int64_t bin_stride = static_cast<int64_t>(channels);
  const int64_t pair_stride =
      static_cast<int64_t>(out_size) * out_size * channels;

  // the pairs of this frame: slot `frame`'s R RoIs, or those of the slots
  // the inverse map lists for it (ascending slot order)
  const int first = slots ? offsets[frame] : frame;
  const int n_pairs =
      slots ? (offsets[frame + 1] - first) * num_rois : num_rois;
  const bool one_round = n_pairs <= kPairs;

  T* base = static_cast<T*>(pyr.ptr[lvl]) +
            static_cast<int64_t>(frame) * h * w * channels;

  // 1. one warp keeps, in order, the pairs [p0, p0 + 32) routed to this
  //    level whose samples reach the band, with their column spans; then
  //    the block builds their AY over the band's rows
  auto keep_pairs = [&](int p0) {
    __syncthreads();  // nobody reads the previous list any more
    if (tid < 32) {
      const int p = p0 + tid;
      bool keep = false;
      int row = 0, col0 = 0, col1 = -1;
      if (p < n_pairs) {
        const int slot = slots ? slots[first + p / num_rois] : frame;
        row = slot * num_rois + p % num_rois;
        const float* box = rois + 4 * static_cast<int64_t>(row);
        if (roi_level(box[0], box[1], box[2], box[3], pyr.num_levels,
                      finest_scale) == lvl) {
          float start, bin;
          int r0, r1;
          axis_span(box[1], box[3], stride, out_size, &start, &bin);
          span_cells(start, bin, out_size, h, &r0, &r1);
          axis_span(box[0], box[2], stride, out_size, &start, &bin);
          span_cells(start, bin, out_size, w, &col0, &col1);
          keep = r1 >= y0 && r0 < y0 + kBand && col0 <= col1;
        }
      }
      const unsigned kept = __ballot_sync(kFull, keep);
      if (keep) {
        const int k = __popc(kept & ((1u << tid) - 1u));
        pair_row[k] = row;
        pair_x0[k] = col0;
        pair_x1[k] = col1;
      }
      if (tid == 0) n_kept = __popc(kept);
    }
    __syncthreads();
    const int ny = n_kept * out_size * kBand;
    for (int e = tid; e < ny; e += nthreads) {
      const int k = e / (out_size * kBand);
      const int rem = e - k * out_size * kBand;
      const float* box = rois + 4 * static_cast<int64_t>(pair_row[k]);
      float start, bin;
      axis_span(box[1], box[3], stride, out_size, &start, &bin);
      ay[e] = bin_weight(start, bin, rem / kBand, sampling, h,
                         y0 + rem % kBand);
    }
  };

  // with one round of pairs the kept list and AY hold for the whole band;
  // a band no pair reaches is one contiguous run of zeros
  if (one_round) {
    if (n_pairs > 0) keep_pairs(0);
    if (n_pairs == 0 || n_kept == 0) {
      T* band = base + static_cast<int64_t>(y0) * w * channels;
      const int64_t n_vec =
          static_cast<int64_t>(min(kBand, h - y0)) * w * channels / VEC;
      float zero[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) zero[e] = 0.0f;
      for (int64_t e = tid; e < n_vec; e += nthreads) {
        Vec<T, VEC>::store(band + e * VEC, zero);
      }
      return;
    }
  }

  for (int cv0 = 0; cv0 < nvec; cv0 += blockDim.x) {
    const int cv = cv0 + threadIdx.x;
    for (int x0 = 0; x0 < w; x0 += xt) {
      const int x = x0 + threadIdx.y;
      const bool on = cv < nvec && x < w;
      float acc[kBand][VEC];
#pragma unroll
      for (int yy = 0; yy < kBand; ++yy) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[yy][e] = 0.0f;
      }

      for (int p0 = 0; p0 < n_pairs; p0 += kPairs) {
        if (!one_round) keep_pairs(p0);
        const int nk = n_kept;
        if (nk == 0) continue;
        // 2. AX over this tile's columns, per kept pair that reaches them
        for (int e = tid; e < nk * out_size * xt; e += nthreads) {
          const int k = e / (out_size * xt);
          if (pair_x1[k] < x0 || pair_x0[k] >= x0 + xt) continue;
          const int rem = e - k * out_size * xt;
          const float* box = rois + 4 * static_cast<int64_t>(pair_row[k]);
          float start, bin;
          axis_span(box[0], box[2], stride, out_size, &start, &bin);
          ax[e] = bin_weight(start, bin, rem / xt, sampling, w,
                             x0 + rem % xt);
        }
        __syncthreads();
        // 3. each cell adds its terms: pair, then bin row, then bin column
        if (on) {
          for (int k = 0; k < nk; ++k) {
            if (pair_x1[k] < x0 || pair_x0[k] >= x0 + xt) continue;
            const T* gp = g + pair_row[k] * pair_stride +
                          static_cast<int64_t>(cv) * VEC;
            const float* ayk = ay + k * out_size * kBand;
            const float* axk = ax + k * out_size * xt + threadIdx.y;
            for (int i = 0; i < out_size; ++i) {
              float wy[kBand];
              bool any = false;
#pragma unroll
              for (int yy = 0; yy < kBand; ++yy) {
                wy[yy] = ayk[i * kBand + yy];
                any |= wy[yy] != 0.0f;
              }
              if (!any) continue;
              for (int j = 0; j < out_size; ++j) {
                const float wx = axk[j * xt];
                if (wx == 0.0f) continue;
                float gv[VEC];
                Vec<T, VEC>::load(gp + (i * out_size + j) * bin_stride, gv);
#pragma unroll
                for (int yy = 0; yy < kBand; ++yy) {
                  const float wgt = wy[yy] * wx;
#pragma unroll
                  for (int e = 0; e < VEC; ++e) {
                    acc[yy][e] = fmaf(wgt, gv[e], acc[yy][e]);
                  }
                }
              }
            }
          }
        }
        __syncthreads();  // AX is rewritten for the next tile or round
      }

      // 4. every cell of the tile, touched or not, stored once
      if (on) {
        T* col = base + static_cast<int64_t>(x) * channels +
                 static_cast<int64_t>(cv) * VEC;
#pragma unroll
        for (int yy = 0; yy < kBand; ++yy) {
          if (y0 + yy < h) {
            Vec<T, VEC>::store(
                col + static_cast<int64_t>(y0 + yy) * w * channels, acc[yy]);
          }
        }
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const GradPyramid& pyr, const float* rois,
                   const int* offsets, const int* slots, const void* g,
                   int r, int c, float finest_scale, int out_size,
                   int sampling, cudaStream_t stream) {
  // threads: x over channel vectors (up to the whole block), y over the
  // tile's columns
  const int nvec = c / VEC;
  const int tx = nvec < kThreads ? nvec : kThreads;
  int xt = kThreads / tx;
  if (xt > kMaxXT) xt = kMaxXT;
  Tiles tiles;
  tiles.first[0] = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int bands = l < pyr.num_levels ? (pyr.h[l] + kBand - 1) / kBand : 0;
    tiles.first[l + 1] = tiles.first[l] + bands;
  }
  const int n_tiles = tiles.first[pyr.num_levels];
  if (n_tiles == 0 || pyr.num_frames == 0) return cudaSuccess;
  if (pyr.num_frames > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(kPairs) * out_size * (kBand + xt) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_align_fpn_bwd_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_tiles, pyr.num_frames);
  roi_align_fpn_bwd_kernel<T, VEC><<<grid, dim3(tx, xt), smem, stream>>>(
      pyr, tiles, rois, offsets, slots, static_cast<const T*>(g), r, c,
      finest_scale, out_size, sampling);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d0..d3: the per-level gradients (U, H_l, W_l, C) in g's dtype; every
// element is written. g: (N, R, out, out, C) in dtype 0 = float32 or 1 =
// bfloat16. vec: 1, or 16 bytes per load and store (4 f32 / 8 bf16) when C
// is a multiple of it and g and every level are 16-byte aligned. offsets
// (U + 1) and slots (N), both NULL in the identity form (U == N): frame f's
// slots are slots[offsets[f] .. offsets[f + 1]). Returns the cudaError_t
// of the launch.
int mcg_roi_align_fpn_bwd(void* d0, void* d1, void* d2, void* d3, int h0,
                          int w0, int h1, int w1, int h2, int w2, int h3,
                          int w3, float s0, float s1, float s2, float s3,
                          int num_levels, int num_frames, const float* rois,
                          const int* offsets, const int* slots, const void* g,
                          int r, int c, int dtype, int vec,
                          float finest_scale, int out_size, int sampling,
                          void* stream) {
  if (!valid_config(num_levels, out_size, sampling) || c <= 0 ||
      (offsets == nullptr) != (slots == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GradPyramid pyr = make_pyramid<void*>(
      d0, d1, d2, d3, h0, w0, h1, w1, h2, w2, h3, w3, s0, s1, s2, s3,
      num_levels, num_frames);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(pyr, rois, offsets, slots, g, r, c, finest_scale,
                           out_size, sampling, st);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(pyr, rois, offsets, slots, g, r, c, finest_scale,
                           out_size, sampling, st);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(pyr, rois, offsets, slots, g, r, c,
                                   finest_scale, out_size, sampling, st);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(pyr, rois, offsets, slots, g, r, c,
                                   finest_scale, out_size, sampling, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
