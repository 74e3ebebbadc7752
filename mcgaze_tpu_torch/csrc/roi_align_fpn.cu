// Fused FPN RoIAlign forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (mcgaze_tpu_torch/ops/roi_align_cuda.py).
//
// Replaces the TPU kernel mcgaze_tpu/ops/roi_align_pallas.py::
// roi_align_fpn_pallas (bodies _make_kernel / _make_kernel_vec), in both of
// its forms: the identity form reached through roi_align_fpn_pallas_diff and
// the slot -> unique-frame form reached through
// roi_align_fpn_pallas_gather_diff. Here frame_idx is one load per RoI, not
// a second kernel.
//
// What it computes, per output out[n, r, i, j, c] (n < N slots, r < R RoIs,
// an out_size x out_size bin grid, C channels): the RoI rois[n, r] is routed
// to one FPN level l (roi_levels: floor(log2(sqrt(area)/finest + 1e-6))
// clipped to [0, L-1], as power-of-two comparisons on the clipped SIGNED
// area), and the bin is the mean of sampling_ratio^2 aligned bilinear
// samples of level l of frame f = frame_idx[n] (or n). Coordinates are
// x / stride - 0.5; a sample is valid iff it lies in [-1, size]; corners are
// clamped with mmcv's degenerate-edge rule. The sum is accumulated in f32
// and cast once to the feature dtype. A slot whose frame lies outside the
// pyramid comes out NaN.
//
// What bounds it on the card: bytes. Each output element costs 16 fused
// multiply-adds (4 samples x 4 corners) against up to 16 reads, far below
// the H100's ~20 flop/byte balance point, so the floor is moving the output
// plus the pyramid cells the RoIs touch once. The TPU kernel brought each
// frame's whole pyramid into VMEM and contracted it with one-hot matrices on
// the MXU; on the card that would read the whole pyramid for three RoIs.
//
// Design: a persistent grid of one block per SM. A block's warps have
// three roles around a ring of shared memory (ring_bytes, ~218 KB on an
// H100) that holds up to kEntries chunks, each with a `full` and an
// `empty` mbarrier:
//   - The planner warp takes RoIs in slot order: its first by block index,
//     the rest from a counter in global memory (so a block that drew large
//     RoIs takes fewer; slot order keeps the RoIs in flight at once on
//     neighbouring frames, which meet in the L2). For each RoI it computes
//     the level and the 2 x out_size * sampling sample axes once and the
//     chunk shape, into a plan ring of kPlans entries.
//   - The copier warp cuts each planned RoI into chunks, allocates each
//     chunk from the ring (bytes reclaimed in order), writes its head and
//     its samples as element offsets, and stages its footprint -- the rows
//     [y0, y0 + nrows) x columns [x0, x0 + ncols) of the routed level that
//     the chunk's valid samples touch -- with one cp.async.bulk per row (in
//     NHWC a row span is one contiguous run of ncols * C * itemsize bytes),
//     completing on the chunk's `full` barrier. So a touched cell crosses
//     from the L2 to the SM once per chunk, and the 16 corner reads of a
//     bin and the overlaps between bins come from shared memory. Small
//     RoIs take only their bytes, so many are in flight at once.
//   - The consumer warps take the chunks in order, all on each chunk, one
//     thread per (bin, 16-byte channel vector): the bin's f32 sum from
//     shared memory, scaled once and written with a 16-byte store (a RoI's
//     output is 49 x C contiguous); then they release the chunk.
//   While the consumers sum one chunk, the next chunks' copies are in
//   flight, and the planner works RoIs ahead.
// Chunks: a chunk is a band of bin rows x a band of bin columns. The k bins
// of a band reach at most ceil((k - 1/sampling) * |bin|) + 2 cells of their
// axis (span_bound), so the planner takes the widest column band whose one
// bin row fits a chunk, then the tallest row band that fits beside it, both
// evened out over the RoI. The ring is what the block's shared memory
// holds beside kSideBytes (ops/roi_align_cuda.py::ring_plan); a chunk holds
// at most half of it, on an H100 111,872 bytes: 218 cells of C = 256 in
// bf16, 109 in f32. A square box (its bins 2-4 cells on their level) is then 7 chunks of
// one bin row in bf16 and 14 in f32 (two column bands). The worst case is a
// bin whose own footprint exceeds a chunk: more than ~18 cells per bin on
// both axes, ~4.5x its level's routing size, which only the clip at the
// last level or a box far off the image leaves. Such a RoI, and every RoI
// of the scalar path (vec == 1: odd C or an unaligned pointer, which bulk
// copies cannot take), is one chunk with nothing staged whose consumers
// read the corners from global memory.
// PERF.md records its time against its bytes bound. Beside the copies, each
// consumer warp spends per bin in bf16 16 shared-memory reads of 512 bytes,
// their widening and 128 FMAs, and the planner and copier are single warps
// that share the SM's warp schedulers with the consumers.
// Numerics are those of the plain version: routing and sampling come from
// roi_align_common.cuh, which the backward (roi_align_fpn_bwd.cu) includes
// as well; every path sums a bin's 16 corner terms in one fixed order.

#include <climits>

#include "roi_align_common.cuh"

namespace {

using Pyramid = PyramidT<const void*>;

// The block's shape: a planner warp, a copier warp and 12 consumer warps
// around a ring that holds up to kEntries chunks, each of at most half the
// ring's bytes (on the H100, more consumer warps or chunks did not pay, and
// smaller chunks cost the single planner and copier more per byte).
constexpr int kConsumerWarps = 12;
constexpr int kThreads = 32 * (2 + kConsumerWarps);
constexpr int kEntries = 4;                   // chunks in flight
constexpr int kPlans = 4;                     // RoIs planned ahead
constexpr int kMaxAxis = kMaxOut * kMaxSampling;

enum Mode : int { kStaged = 0, kDirect = 1, kNaN = 2 };

// A RoI as the planner hands it to the copier.
struct Plan {
  int unit;                 // slot * R + RoI; -1 ends the walk
  int mode;
  int lvl;
  int frame;
  int kr, kc;               // bin rows and columns per chunk
  Axis ys[kMaxAxis];        // every sample of the RoI, absolute indices
  Axis xs[kMaxAxis];
};

// The head of a chunk in the ring, followed by the RoI's 2 * ns samples
// (as `scaled` puts them) and, from byte head_bytes(ns) on, its
// footprint's rows.
struct ChunkHead {
  int unit;                 // slot * R + RoI; -1: the walk is done
  int mode;
  int lvl;
  int frame;
  int i0, i1, j0, j1;       // the chunk's bins
  int nrows;                // rows staged; 0 with mode kStaged: all zero
};

__host__ __device__ constexpr int head_bytes(int ns) {
  return (static_cast<int>(sizeof(ChunkHead)) +
          2 * ns * static_cast<int>(sizeof(Axis)) + 127) / 128 * 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One contiguous run of global memory into shared memory; completes on bar.
// dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool valid(const Axis& a) {
  return !(a.w_lo == 0.0f && a.w_hi == 0.0f);
}

// At most how many cells of an axis of `size` cells the valid samples of k
// consecutive bins of width `bin` reach: the first and last sample lie
// (k - 1/sampling) * |bin| apart, and a corner pair adds up to two cells.
// The 1e-3 covers the rounding of the sample positions.
__device__ __forceinline__ int span_bound(int k, float bin, int sampling,
                                          int size) {
  const float ext = (static_cast<float>(k) - 1.0f / sampling) * fabsf(bin);
  return static_cast<int>(fminf(ceilf(ext + 1e-3f) + 2.0f,
                                static_cast<float>(size)));
}

// One 16-byte channel vector as floats. bf16 widens with one integer op
// per element: a bf16 is the high half of the f32 of the same value.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  Vec<T, VEC>::load(p, out);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// The sum of a bin over one channel vector at `base`. Each of its samples
// (ys, xs) holds its corners as element offsets from `base` and their
// weights; an invalid sample has offsets 0 and weights 0, which adds
// exactly 0 to a finite sum. Every path sums a bin in this one order.
template <typename T, int VEC, int S>
__device__ __forceinline__ void bin_sum(const T* base, const Axis* ys,
                                        const Axis* xs, int sampling,
                                        float* acc) {
  const int n = S > 0 ? S : sampling;
#pragma unroll
  for (int sy = 0; sy < n; ++sy) {
    const Axis ay = ys[sy];
#pragma unroll
    for (int sx = 0; sx < n; ++sx) {
      const Axis ax = xs[sx];
      float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
      load_vec<T, VEC>(base + ay.lo + ax.lo, v00);
      load_vec<T, VEC>(base + ay.lo + ax.hi, v01);
      load_vec<T, VEC>(base + ay.hi + ax.lo, v10);
      load_vec<T, VEC>(base + ay.hi + ax.hi, v11);
      const float w00 = __fmul_rn(ay.w_lo, ax.w_lo);
      const float w01 = __fmul_rn(ay.w_lo, ax.w_hi);
      const float w10 = __fmul_rn(ay.w_hi, ax.w_lo);
      const float w11 = __fmul_rn(ay.w_hi, ax.w_hi);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[e] = __fmaf_rn(w00, v00[e], acc[e]);
        acc[e] = __fmaf_rn(w01, v01[e], acc[e]);
        acc[e] = __fmaf_rn(w10, v10[e], acc[e]);
        acc[e] = __fmaf_rn(w11, v11[e], acc[e]);
      }
    }
  }
}

// A sample as the consumers read it: its corners' element offsets from the
// chunk's origin (y0, x0) in rows of `row` elements.
__device__ __forceinline__ Axis scaled(const Axis& a, int origin, int row) {
  if (!valid(a)) return Axis{0, 0, 0.0f, 0.0f};
  return Axis{(a.lo - origin) * row, (a.hi - origin) * row, a.w_lo, a.w_hi};
}

struct Args {
  Pyramid pyr;
  const float* rois;
  const int* frame_idx;
  void* out;
  int* work;        // {next RoI, blocks done}: 0 at launch, 0 again at exit
  int units;        // N * R
  int num_rois;     // R
  int channels;
  float finest_scale;
  int out_size;
  int sampling;
  int ring_bytes;   // the circular buffer of chunks
  int chunk_bytes;  // the most one chunk's footprint may take: half of it
};

// Whether the phase of `bar` with this parity has completed; no waiting.
__device__ __forceinline__ bool mbar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

struct Shared {
  unsigned char* ring;
  Plan* plans;
  int* entry_off;     // entry e's chunk starts at ring + entry_off[e]
  uint64_t* full;     // per entry: the copier's arrive and the bytes
  uint64_t* empty;    // per entry: one arrive per consumer warp
  uint64_t* planned;  // per plan: the planner's arrive
  uint64_t* taken;    // per plan: the copier's arrive
};

// The planner warp: takes RoIs in slot order (its first by block index,
// the rest from a shared counter, so a block that drew large RoIs takes
// fewer), computes each RoI's level, sample axes and chunk shape, and
// hands them to the copier through the plan ring.
template <typename T, int VEC, int S>
__device__ __forceinline__ void plan_rois(const Args& a, const Shared& sh) {
  const int lane = threadIdx.x % 32;
  const int out_size = a.out_size;
  const int sampling = S > 0 ? S : a.sampling;
  const int ns = out_size * sampling;
  const int cap = a.chunk_bytes / (a.channels * static_cast<int>(sizeof(T)));

  // RoIs in flight: u0 is planned next; the boxes of u1 and u2 are on their
  // way; two draws are pending, each resolved two RoIs after it was made
  float box0[4], box1[4], box2[4];
  int frame0 = 0, frame1 = 0, frame2 = 0;
  auto fetch = [&](int u, float* b, int* f) {
    if (u >= a.units) return;
    const float* r = a.rois + 4 * static_cast<int64_t>(u);
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = r[e];
    const int n = u / a.num_rois;
    *f = a.frame_idx ? a.frame_idx[n] : n;
  };
  // a draw is the counter's old value, which lane 0 holds until it is
  // resolved: nothing waits for the atomic before then
  auto draw = [&]() { return lane == 0 ? atomicAdd(a.work, 1) : 0; };
  auto resolve = [&](int d) {
    return static_cast<int>(gridDim.x) + __shfl_sync(~0u, d, 0);
  };
  int u0 = blockIdx.x;
  fetch(u0, box0, &frame0);
  int pending0 = draw();
  int pending1 = draw();
  int u1 = resolve(pending0);
  fetch(u1, box1, &frame1);
  int u2 = resolve(pending1);
  fetch(u2, box2, &frame2);
  pending0 = draw();
  pending1 = draw();

  for (int q = 0;; ++q) {
    const int p = q % kPlans;
    Plan& pl = sh.plans[p];
    if (u0 >= a.units) {
      mbar_wait(&sh.taken[p], ((q / kPlans) & 1u) ^ 1u);
      if (lane == 0) {
        pl.unit = -1;
        mbar_arrive(&sh.planned[p]);
      }
      break;
    }
    const float x1 = box0[0], y1 = box0[1], x2 = box0[2], y2 = box0[3];
    const int frame = frame0;
    const int lvl = roi_level(x1, y1, x2, y2, a.pyr.num_levels,
                              a.finest_scale);
    const int h = a.pyr.h[lvl];
    const int w = a.pyr.w[lvl];
    const float stride = a.pyr.stride[lvl];
    float ystart, ybin, xstart, xbin;
    axis_span(y1, y2, stride, out_size, &ystart, &ybin);
    axis_span(x1, x2, stride, out_size, &xstart, &xbin);

    // chunk shape: lane k - 1 asks whether k bins fit; the answers are
    // monotone. The widest column band whose one bin row fits, then the
    // tallest row band beside it, both evened out over the RoI
    int mode = kStaged;
    int kr = out_size, kc = out_size;
    if (frame < 0 || frame >= a.pyr.num_frames) {
      mode = kNaN;
    } else if (VEC == 1) {
      mode = kDirect;
    } else {
      const int k = lane + 1;
      const int r1 = span_bound(1, ybin, sampling, h);
      const unsigned cfit = __ballot_sync(
          ~0u, k <= out_size &&
                   static_cast<int64_t>(span_bound(k, xbin, sampling, w)) *
                           r1 <= cap);
      if (!(cfit & 1u)) {
        mode = kDirect;
      } else {
        kc = 32 - __clz(cfit);
        const int cols = span_bound(kc, xbin, sampling, w);
        const unsigned rfit = __ballot_sync(
            ~0u, k <= out_size &&
                     static_cast<int64_t>(span_bound(k, ybin, sampling, h)) *
                             cols <= cap);
        kr = 32 - __clz(rfit);
        const int nr = (out_size + kr - 1) / kr;
        const int nc = (out_size + kc - 1) / kc;
        kr = (out_size + nr - 1) / nr;
        kc = (out_size + nc - 1) / nc;
      }
    }

    mbar_wait(&sh.taken[p], ((q / kPlans) & 1u) ^ 1u);
    for (int t = lane; t < ns; t += 32) {
      pl.ys[t] = axis_sample(ystart, ybin, t / sampling, t % sampling,
                             sampling, h);
      pl.xs[t] = axis_sample(xstart, xbin, t / sampling, t % sampling,
                             sampling, w);
    }
    if (lane == 0) {
      pl.unit = u0;
      pl.mode = mode;
      pl.lvl = lvl;
      pl.frame = frame;
      pl.kr = kr;
      pl.kc = kc;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.planned[p]);

    u0 = u1;
    u1 = u2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      box0[e] = box1[e];
      box1[e] = box2[e];
    }
    frame0 = frame1;
    frame1 = frame2;
    u2 = resolve(pending0);
    fetch(u2, box2, &frame2);
    pending0 = pending1;
    pending1 = u2 < a.units ? draw() : a.units;  // later draws: past the end
  }
  // the last block out leaves the counter at 0 for the next launch; every
  // block has drawn its last RoI before it counts itself done
  if (lane == 0) {
    __threadfence();
    if (atomicAdd(a.work + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      a.work[0] = 0;
      a.work[1] = 0;
    }
  }
}

// The copier warp: cuts each planned RoI into chunks, puts each chunk (its
// head, the RoI's samples and its footprint) in the ring and stages the
// footprint with one bulk copy per row. Chunk k takes entry k % entries;
// the ring's bytes are reclaimed in order.
template <typename T, int VEC, int S>
__device__ __forceinline__ void copy_chunks(const Args& a, const Shared& sh) {
  const int lane = threadIdx.x % 32;
  const int out_size = a.out_size;
  const int sampling = S > 0 ? S : a.sampling;
  const int ns = out_size * sampling;
  const int hb = head_bytes(ns);
  const int cell_bytes = a.channels * static_cast<int>(sizeof(T));
  const int cap = a.chunk_bytes / cell_bytes;
  constexpr int entries = kEntries;

  int k = 0;           // chunks posted
  int oldest = 0;      // the oldest chunk whose bytes are not reclaimed
  int head = 0;        // where the next chunk goes
  int in_use = 0;      // bytes from the oldest chunk to head, gaps included
  int span = 0;        // lane e: the bytes entry e holds
  // room for `bytes` at the head of the ring and a free entry: returns the
  // chunk's offset
  auto alloc = [&](int bytes) {
    while (true) {
      while (oldest < k) {
        const int e = oldest % entries;
        if (!mbar_done(&sh.empty[e], (oldest / entries) & 1u)) break;
        in_use -= __shfl_sync(~0u, span, e);
        ++oldest;
      }
      if (in_use == 0) head = 0;
      const int gap = head + bytes > a.ring_bytes ? a.ring_bytes - head : 0;
      if (k - oldest < entries && in_use + gap + bytes <= a.ring_bytes) {
        const int off = gap > 0 ? 0 : head;
        head = off + bytes;
        in_use += gap + bytes;
        if (lane == k % entries) span = gap + bytes;
        return off;
      }
    }
  };
  auto post = [&](int off, uint32_t tx) {
    const int e = k % entries;
    if (lane == 0) {
      sh.entry_off[e] = off;
      mbar_expect_tx(&sh.full[e], tx);
    }
    __syncwarp();
    ++k;
    return e;
  };

  for (int q = 0;; ++q) {
    const int p = q % kPlans;
    const Plan& pl = sh.plans[p];
    mbar_wait(&sh.planned[p], (q / kPlans) & 1u);
    const int unit = pl.unit;
    if (unit < 0) break;
    const int mode = pl.mode;
    const int lvl = pl.lvl;
    const int frame = pl.frame;
    const int kr = pl.kr, kc = pl.kc;
    Axis ay[2], ax[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = lane + 32 * r;
      ay[r] = t < ns ? pl.ys[t] : Axis{0, 0, 0.0f, 0.0f};
      ax[r] = t < ns ? pl.xs[t] : Axis{0, 0, 0.0f, 0.0f};
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.taken[p]);
    const int h = a.pyr.h[lvl];
    const int w = a.pyr.w[lvl];

    for (int j0 = 0; j0 < out_size; j0 += kc) {
      const int j1 = min(out_size, j0 + kc);
      for (int i0 = 0; i0 < out_size; i0 += kr) {
        const int i1 = min(out_size, i0 + kr);
        // the footprint of the chunk's valid samples
        int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int bin = (lane + 32 * r) / sampling;
          if (valid(ay[r]) && bin >= i0 && bin < i1) {
            ylo = min(ylo, ay[r].lo);
            yhi = max(yhi, ay[r].hi);
          }
          if (valid(ax[r]) && bin >= j0 && bin < j1) {
            xlo = min(xlo, ax[r].lo);
            xhi = max(xhi, ax[r].hi);
          }
        }
        ylo = __reduce_min_sync(~0u, ylo);
        yhi = __reduce_max_sync(~0u, yhi);
        xlo = __reduce_min_sync(~0u, xlo);
        xhi = __reduce_max_sync(~0u, xhi);
        bool any = mode == kStaged && yhi >= 0 && xhi >= 0;
        int chunk_mode = mode;
        if (any &&
            static_cast<int64_t>(yhi - ylo + 1) * (xhi - xlo + 1) > cap) {
          // span_bound's slack is below the rounding of a box far off its
          // level: never overrun the chunk
          chunk_mode = kDirect;
          any = false;
        }
        const int nrows = any ? yhi - ylo + 1 : 0;
        const int ncols = any ? xhi - xlo + 1 : 0;
        const uint32_t row_bytes = static_cast<uint32_t>(ncols) * cell_bytes;
        const int bytes =
            hb + (static_cast<int>(nrows * row_bytes) + 127) / 128 * 128;

        const int off = alloc(bytes);
        unsigned char* base = sh.ring + off;
        ChunkHead* ch = reinterpret_cast<ChunkHead*>(base);
        Axis* axes = reinterpret_cast<Axis*>(base + sizeof(ChunkHead));
        // staged: offsets into the footprint; direct: into the frame
        const int oy = any ? ylo : 0, ox = any ? xlo : 0;
        const int row = (any ? ncols : w) * a.channels;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = lane + 32 * r;
          if (t < ns) {
            axes[t] = scaled(ay[r], oy, row);
            axes[ns + t] = scaled(ax[r], ox, a.channels);
          }
        }
        if (lane == 0) {
          ch->unit = unit;
          ch->mode = chunk_mode;
          ch->lvl = lvl;
          ch->frame = frame;
          ch->i0 = i0;
          ch->i1 = i1;
          ch->j0 = j0;
          ch->j1 = j1;
          ch->nrows = nrows;
        }
        __syncwarp();
        const int e = post(off, nrows * row_bytes);
        if (nrows > 0) {
          const T* src = static_cast<const T*>(a.pyr.ptr[lvl]) +
                         ((static_cast<int64_t>(frame) * h + ylo) * w + xlo) *
                             a.channels;
          for (int y = lane; y < nrows; y += 32) {
            bulk_copy(base + hb + static_cast<int64_t>(y) * row_bytes,
                      src + static_cast<int64_t>(y) * w * a.channels,
                      row_bytes, &sh.full[e]);
          }
        }
      }
    }
  }
  // the end of the walk
  const int off = alloc(128);
  if (lane == 0) reinterpret_cast<ChunkHead*>(sh.ring + off)->unit = -1;
  __syncwarp();
  post(off, 0);
}

// The consumer warps: one thread per (bin, channel vector) of each chunk,
// all warps on every chunk. A chunk's bins go to the threads that follow
// the previous chunk's, so chunks with few bins do not all land on the
// same warps.
template <typename T, int VEC, int S>
__device__ __forceinline__ void consume(const Args& a, const Shared& sh) {
  const int ct = threadIdx.x - 64;
  constexpr int nct = 32 * kConsumerWarps;
  const int nvec = a.channels / VEC;
  const int groups = max(1, nct / nvec);  // bins summed at once
  const int g = ct / nvec;                // this thread's group
  const int cv0 = ct - g * nvec;
  const int out_size = a.out_size;
  const int sampling = S > 0 ? S : a.sampling;
  const int ns = out_size * sampling;
  const int hb = head_bytes(ns);
  const float scale = 1.0f / static_cast<float>(sampling * sampling);
  T* out = static_cast<T*>(a.out);
  int first = 0;  // the group that takes the chunk's first bin
  for (int k = 0;; ++k) {
    const int e = k % kEntries;
    mbar_wait(&sh.full[e], (k / kEntries) & 1u);
    const unsigned char* base = sh.ring + sh.entry_off[e];
    const ChunkHead& c = *reinterpret_cast<const ChunkHead*>(base);
    const int unit = c.unit;
    if (unit < 0) break;
    const Axis* axes = reinterpret_cast<const Axis*>(base + sizeof(ChunkHead));
    const int mode = c.mode;
    const int i0 = c.i0, j0 = c.j0;
    const int nj = c.j1 - j0;
    const int nbins = (c.i1 - i0) * nj;
    const bool staged = mode == kStaged && c.nrows > 0;
    const T* footprint = reinterpret_cast<const T*>(base + hb);
    const int lvl = c.lvl;
    const T* frame = static_cast<const T*>(a.pyr.ptr[lvl]) +
                     static_cast<int64_t>(c.frame) * a.pyr.h[lvl] *
                         a.pyr.w[lvl] * a.channels;
    if (g < groups) {
      int b = g - first;
      if (b < 0) b += groups;
      for (; b < nbins; b += groups) {
        const int bi = b / nj;
        const int i = i0 + bi;
        const int j = j0 + b - bi * nj;
        const Axis* ys = axes + i * sampling;
        const Axis* xs = axes + ns + j * sampling;
        for (int cv = cv0; cv < nvec; cv += nct) {
          float acc[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[v] = mode == kNaN ? __int_as_float(0x7fc00000) : 0.0f;
          }
          // two calls, so the staged one reads shared memory as such
          if (staged) {
            bin_sum<T, VEC, S>(footprint + cv * VEC, ys, xs, sampling, acc);
          } else if (mode == kDirect) {
            bin_sum<T, VEC, S>(frame + cv * VEC, ys, xs, sampling, acc);
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] *= scale;
          Vec<T, VEC>::store(
              out + ((static_cast<int64_t>(unit) * out_size + i) * out_size +
                     j) * a.channels + cv * VEC,
              acc);
        }
      }
    }
    first += nbins % groups;
    if (first >= groups) first -= groups;
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&sh.empty[e]);
  }
}

// Shared memory beside the ring: the plans, the entries' offsets and the
// barriers.
constexpr int kSideBytes = kPlans * static_cast<int>(sizeof(Plan)) +
                           kEntries * 4 + (2 * kEntries + 2 * kPlans) * 8;

template <typename T, int VEC, int S>
__global__ void __launch_bounds__(kThreads)
    roi_align_fpn_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Shared sh;
  sh.ring = smem;
  sh.plans = reinterpret_cast<Plan*>(smem + a.ring_bytes);
  sh.entry_off = reinterpret_cast<int*>(sh.plans + kPlans);
  sh.full = reinterpret_cast<uint64_t*>(sh.entry_off + kEntries);
  sh.empty = sh.full + kEntries;
  sh.planned = sh.empty + kEntries;
  sh.taken = sh.planned + kPlans;
  if (threadIdx.x == 0) {
    for (int e = 0; e < kEntries; ++e) {
      mbar_init(&sh.full[e], 1);               // the copier's arrive
      mbar_init(&sh.empty[e], kConsumerWarps);  // one per consumer warp
    }
    for (int p = 0; p < kPlans; ++p) {
      mbar_init(&sh.planned[p], 1);
      mbar_init(&sh.taken[p], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    plan_rois<T, VEC, S>(a, sh);
  } else if (threadIdx.x < 64) {
    copy_chunks<T, VEC, S>(a, sh);
  } else {
    consume<T, VEC, S>(a, sh);
  }
}

template <typename T, int VEC, int S>
cudaError_t launch_s(const Args& a, int grid, cudaStream_t stream) {
  const int smem = a.ring_bytes + kSideBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      roi_align_fpn_kernel<T, VEC, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  roi_align_fpn_kernel<T, VEC, S><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// sampling 2 (the model's) gets the unrolled body
template <typename T, int VEC>
cudaError_t launch(const Args& a, int grid, cudaStream_t stream) {
  return a.sampling == 2 ? launch_s<T, VEC, 2>(a, grid, stream)
                         : launch_s<T, VEC, 0>(a, grid, stream);
}

}  // namespace

extern "C" {

// What the wrapper plans the ring from: the SM count and the opt-in shared
// memory of a block on `device`, and the bytes a block needs beside its
// ring (plans, entries, barriers).
int mcg_roi_align_fpn_limits(int device, int* sms, int* smem_block,
                             int* side_bytes) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  *side_bytes = kSideBytes;
  return static_cast<int>(err);
}

// The launch's arguments, packed by the wrapper into one buffer
// (ops/roi_align_cuda.py::_K1_ARGS) so that a call marshals one pointer:
// every field 8 bytes, in this order, no padding. dtype: 0 = float32,
// 1 = bfloat16. vec: 1 for scalar loads, or 16 bytes of channels per load
// (4 f32 / 8 bf16), which the caller may pick only when C is a multiple of
// it and every pointer is 16-byte aligned. frame_idx may be NULL (identity
// form, U == N). work: two ints, 0 at the launch, which the launch leaves 0
// again (one buffer per stream). grid blocks, each around a ring of
// ring_bytes (a multiple of 128; the wrapper gives what the block's shared
// memory holds beside kSideBytes).
struct LaunchArgs {
  const void* feats[4];
  int64_t hw[8];             // H, W of each level
  double strides[4];
  int64_t num_levels, num_frames;
  const float* rois;
  const int* frame_idx;
  void* out;
  int* work;
  int64_t n, r, c, dtype, vec, grid, ring_bytes;
  double finest_scale;
  int64_t out_size, sampling;
  void* stream;
};
static_assert(sizeof(LaunchArgs) == 33 * 8, "LaunchArgs is 33 8-byte fields");

// Returns the cudaError_t of the launch.
int mcg_roi_align_fpn_fwd(const LaunchArgs* p) {
  const int n = static_cast<int>(p->n), r = static_cast<int>(p->r);
  const int c = static_cast<int>(p->c), vec = static_cast<int>(p->vec);
  const int grid = static_cast<int>(p->grid);
  const int ring_bytes = static_cast<int>(p->ring_bytes);
  const int out_size = static_cast<int>(p->out_size);
  const int sampling = static_cast<int>(p->sampling);
  const int num_levels = static_cast<int>(p->num_levels);
  const int chunk_bytes = ring_bytes / 2 / 128 * 128;
  if (!valid_config(num_levels, out_size, sampling) || ring_bytes % 128 != 0 ||
      chunk_bytes < 128 ||
      chunk_bytes + head_bytes(out_size * sampling) > ring_bytes || grid < 1 ||
      p->work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || r == 0) return 0;
  Args a;
  a.pyr = make_pyramid<const void*>(
      p->feats[0], p->feats[1], p->feats[2], p->feats[3],
      static_cast<int>(p->hw[0]), static_cast<int>(p->hw[1]),
      static_cast<int>(p->hw[2]), static_cast<int>(p->hw[3]),
      static_cast<int>(p->hw[4]), static_cast<int>(p->hw[5]),
      static_cast<int>(p->hw[6]), static_cast<int>(p->hw[7]),
      static_cast<float>(p->strides[0]), static_cast<float>(p->strides[1]),
      static_cast<float>(p->strides[2]), static_cast<float>(p->strides[3]),
      num_levels, static_cast<int>(p->num_frames));
  a.rois = p->rois;
  a.frame_idx = p->frame_idx;
  a.out = p->out;
  a.work = p->work;
  a.units = n * r;
  a.num_rois = r;
  a.channels = c;
  a.finest_scale = static_cast<float>(p->finest_scale);
  a.out_size = out_size;
  a.sampling = sampling;
  a.ring_bytes = ring_bytes;
  a.chunk_bytes = chunk_bytes;
  const int dtype = static_cast<int>(p->dtype);
  cudaStream_t st = static_cast<cudaStream_t>(p->stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(a, grid, st);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(a, grid, st);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(a, grid, st);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(a, grid, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
