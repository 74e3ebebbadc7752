// Fused ResNet bottleneck chain for Hopper (sm_90a): one implicit-GEMM
// convolution with a fused epilogue, launched once per convolution of the
// chain; bound through a plain C interface and loaded with ctypes
// (mcgaze_tpu_torch/ops/fused_bottleneck.py).
//
// Replaces the TPU kernel mcgaze_tpu/ops/fused_bottleneck.py::
// fused_bottleneck_chain (bodies _make_kernel / _conv3x3_rows), which runs
// every stride-1 bottleneck of one ResNet stage for one frame in VMEM. The
// weights come folded with the frozen BN (fold_block_params): A (K, Cout)
// in the model dtype, rows ordered (dy, dx, cin) for the 3x3, and an f32
// bias (Cout).
//
// What it computes, per launch: out[m, n] = epilogue(sum_k A_op[m, k] *
// A[k, n]) over rows m = the N*H*W pixels of the NHWC activations (C
// contiguous) and columns n = the output channels. For a 1x1, A_op is x
// itself (K = Cin). For the 3x3, A_op[m, (dy*3+dx)*Cin + c] is channel c of
// pixel (y+dy-1, x+dx-1) of the same frame, 0 outside the frame: the
// zero-padding convolution that the TPU kernel builds from row shifts and
// x-edge masks, gathered here on the fly (K = 9*Cin). The epilogue adds the
// f32 bias; with an identity it rounds that to the dtype, adds the identity
// (x, or the downsample's rounded output) as the JAX block does in the
// dtype; ReLU where asked; then one rounding to the dtype. Products
// accumulate in f32 on the tensor cores (wgmma): bf16 as it is, f32 in
// three TF32 passes (3xTF32, below), which hold the plain version with TF32
// off to f32 rounding.
//
// What bounds it on the card. The whole chain is ~747 GFLOP at the gaze
// eval shape (131 frames at 224 px, bf16): 0.755 ms at the bf16 peak, if
// y1 and y2 stayed on chip. They cannot: a stage of one frame (layer1:
// 56*56*256 bf16 = 1.6 MB) does not fit the 227 KB a block can hold, so the
// TPU's whole-chain-in-VMEM program does not carry over, and each launch
// moves its input, its output and the identity through device memory. That
// per-launch floor is ~1.76 ms summed (kernel_bounds.k5_launch_floor):
// layer1's thin N=64 convolutions are bound by bytes, the rest mostly by
// how often a tile's operands come back from L2 (~5 TB/s on the H100).
//
// The bf16 design:
//   * wgmma.mma_async (m64nBNk16, f32 accumulators in registers): two
//     consumer warpgroups, each owning MT slabs of 64 rows of a 128 MT x BN
//     tile; BN = 128 where Cout allows it, else 64 (layer1's N=64
//     convolutions); K steps of 64 bf16 = 128 bytes, so every operand tile
//     sits in shared memory in the 128-byte swizzle that the wgmma
//     descriptors name. A is K-major, the weights (K, Cout) are read as they
//     lie, MN-major (the transpose bit of B). MT = 2 halves the weights'
//     re-reads from L2; the launch keeps MT = 1 for a convolution with an
//     identity, and where 256-row tiles would leave more of the card idle
//     in the last round of tiles.
//   * One producer thread (of a warp beside the two consumer warpgroups,
//     288 threads) keeps a ring of STAGES operand tiles in flight by
//     TMA, each stage with a `full` and an `empty` mbarrier, so the loads of
//     later K steps overlap the products of this one and the epilogue of
//     the last tile. The weights and the A operand of a 1x1 are plain
//     row-major matrices (cp.async.bulk.tensor.2d; rows past m read as
//     zeros). The 3x3's A operand comes from TMA's im2col mode over the
//     (N, H, W, C) activations: the map's walk starts one pixel before the
//     tile's first on both axes, the tap (dx, dy) is the instruction's
//     offset, and reads outside the frame give the zero padding (a gather
//     by cp.async, 16 bytes a thread, ran the 3x3s ~1.6x slower).
//   * Persistent: one block per SM walks the tiles (the N tiles of one row
//     tile next to each other, so they share A in L2).
//   * The epilogue runs on the accumulator fragments: bias (f32), the
//     identity, ReLU, and the roundings above. Each warpgroup has a 64 x BN
//     slab in shared memory whose 16-byte chunks are swizzled by row: the
//     identity lands there by 16-byte cp.async copies while the products
//     run, is read at the fragment's own column pairs and overwritten with
//     the result, and the slab's rows go out in 16-byte coalesced stores,
//     masked past the last row.
//
// The f32 design (3xTF32). The tensor cores take f32 only as TF32 (10
// mantissa bits), ~1e-3 relative a product, which the plain version with
// TF32 off does not allow. So each operand v splits into hi = v rounded to
// the nearest TF32 (cvt.rna, its low 13 mantissa bits zero: the hardware
// truncates what it reads, so hi must already be exact) and lo = v - hi
// (exact in f32), and every K step adds lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
// (wgmma m64nBNk8 .tf32); the dropped lo_a*lo_b and lo's own truncation
// leave ~2^-21 of a product.
//   * wgmma reads TF32 operands K-major only (the transpose bits are for
//     16-bit types). The activations are K-major as they lie (channels
//     contiguous), for the 3x3 too through the im2col map. The folded
//     weights (K, Cout) are not: the wrapper hands this body the (2, Cout,
//     K) pair (hi, lo) that ops/fused_bottleneck.py::tf32_split makes from
//     them on every call, hi already TF32-exact, one TMA map over its 2
//     Cout rows, each stage taking a BN x 32 box of hi and one of lo.
//   * The activations split in registers: each consumer thread reads its
//     A fragment (rows g, g + 8 and K columns q, q + 4 of each 8-wide K
//     step of its warp's 16 rows) from the swizzled stage with plain
//     shared loads, splits it, and issues the three products with A from
//     registers and B (hi or lo) from shared memory by descriptor. No
//     second copy of A sits in shared memory.
//   * The tensor cores' own f32 accumulation truncates: summed over K =
//     2,304 in one accumulator the chains read up to 2.3e-5 of max|out|
//     from float64 (cuBLAS's f32: 4e-7). So each stage (K = 32, twelve
//     products) sums into a fresh partial accumulator that is added to
//     the tile's f32 accumulator with ordinary adds once the stage has
//     retired: 0.65-1.0e-6, for ~9% of the time (PR 16's probes on an
//     H100). Within a stage one wgmma group (three products) a K step of 8
//     stays in flight while the next step's fragment is read and split.
//   * 128 x BN tiles only, BN = 128 where Cout allows it, else 64; four
//     stages of 48 KB (six of 32 KB at BN = 64); the ring, the producer
//     thread and the persistent grid are the bf16 body's. 256-row tiles
//     made ptxas serialize the wgmmas (C7512, too few registers for 128
//     accumulators and two steps' fragments) and ran slower.
//   * The epilogue stores each accumulator pair as 8 bytes straight from
//     the fragment (four lanes fill one 32-byte sector of a row): f32 needs
//     no staging slab. A row's identity loads all issue before its first
//     store (one after another, they cost the identity convolutions 3x
//     their bytes' time).
// What bounds it: 3 TF32 passes at 495 TFLOP/s, 165 TFLOP/s of f32
// products: 4.53 ms for the four chains at the eval shape, 5.58 ms taken
// launch by launch (kernel_bounds, key float32_3xtf32; layer1's N = 64
// convolutions are bound by bytes). The split weights double B's bytes
// from L2.
//
// Constraints the wrapper checks: Cin a multiple of 64 (the K step, so a K
// tile never straddles two 3x3 taps), Cout a multiple of 64 (the smallest N
// tile), 16-byte aligned contiguous tensors (TMA's rule too), fewer than
// 2^31 rows.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime (cudaGetDriverEntryPoint), no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Conv {
  const void* x;      // (m, cin): NHWC pixels of frames of h x w
  const void* a;      // (ksize * ksize * cin, cout)
  const float* bias;  // (cout,)
  const void* idn;    // (m, cout) added before the ReLU, or null
  void* out;          // (m, cout)
  int m, h, w, cin, cout, ksize, relu;
};

__device__ __forceinline__ float round_to(float v, bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, float*) { return v; }

// The epilogue of one element, before the final rounding to T.
template <typename T>
__device__ __forceinline__ float finish(float acc, float bias, bool has_idn,
                                        float idn, bool relu) {
  float v = acc + bias;
  if (has_idn) v = round_to(v, static_cast<T*>(nullptr)) + idn;
  return relu ? fmaxf(v, 0.0f) : v;
}

// ------------------------------------------- bf16: wgmma fed by TMA/cp.async

constexpr int kBK = 64;            // K step: 64 bf16 = one 128-byte row
constexpr int kRowBytes = kBK * 2;
constexpr int kThreads = 288;      // 2 consumer warpgroups + a producer warp
constexpr int kConsumerWarps = 8;

// A 128 MT x BN tile: each consumer warpgroup owns MT slabs of 64 rows.
template <int BN, int MT, int STAGES>
struct Tile {
  static constexpr int kBM = 128 * MT;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBChunk = kBK * 64 * 2;          // 64 K rows x 64 N
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStage = kABytes + kBBytes;      // multiple of 1 KB
  static constexpr int kOutBytes = 2 * 64 * BN * 2;     // a slab per group
  static constexpr int kBars = 2 * STAGES * 8;
  // + 1 KB to align the ring to the 1024 bytes the swizzle repeats over
  static constexpr int kSmem = 1024 + STAGES * kStage + kOutBytes + kBars;
};

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

// One TMA box of a 2-D map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The im2col box of a 4-D (N, H, W, C) map: channels [c, c + 64) of the
// pixels the map's walk visits from (n, y, x), each displaced by the tap
// (dx, dy); zeros outside the frame. Completes on `bar`.
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int x,
                                                int y, int n, uint16_t dx,
                                                uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(x), "r"(y), "r"(n), "h"(dx), "h"(dy)
      : "memory");
}

// 16 bytes global -> shared; zeros where !valid (source size 0, no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

#define MCG_ACC8(b)                                                        \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),          \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d += A (64 x 16, K-major) * B (16 x BN, MN-major), one warpgroup (the
// scale-d predicate is set: the tile's accumulators start at zero).
template <int BN>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n\t}"
      : MCG_ACC8(0), MCG_ACC8(8), MCG_ACC8(16), MCG_ACC8(24)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n\t}"
      : MCG_ACC8(0), MCG_ACC8(8), MCG_ACC8(16), MCG_ACC8(24), MCG_ACC8(32),
        MCG_ACC8(40), MCG_ACC8(48), MCG_ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}

// d = (add ? d : 0) + A (64 x 8 TF32 from registers, a[0..3] the
// fragment) * B (8 x BN, K-major in shared memory), one warpgroup.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db, int add);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                               uint64_t db, int add) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
      : MCG_ACC8(0), MCG_ACC8(8), MCG_ACC8(16), MCG_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a,
                                                uint64_t db, int add) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : MCG_ACC8(0), MCG_ACC8(8), MCG_ACC8(16), MCG_ACC8(24), MCG_ACC8(32),
        MCG_ACC8(40), MCG_ACC8(48), MCG_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

#undef MCG_ACC8

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

template <int BN, int MT, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gemm_bf16(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_a, Conv p) {
  using T = Tile<BN, MT, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  bf16* stage_out = reinterpret_cast<bf16*>(smem + STAGES * T::kStage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * T::kStage + T::kOutBytes);
  uint64_t* empty = full + STAGES;

  const bool im2col = p.ksize == 3;
  const int n_tiles = p.cout / BN;
  const int tiles = (p.m + T::kBM - 1) / T::kBM * n_tiles;
  const int k_steps = p.ksize * p.ksize * p.cin / kBK;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);  // the TMA thread's arrive
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if (t != 0) return;
    const int kpt = p.cin / kBK;  // K steps per 3x3 tap
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * T::kBM;
      const int n0 = tile % n_tiles * BN;
      // 3x3: the tile's first pixel less the padding, where the im2col
      // walk of tap (0, 0) starts
      const int frame = im2col ? m0 / (p.h * p.w) : 0;
      const int y0 = im2col ? m0 % (p.h * p.w) / p.w - 1 : 0;
      const int x0 = im2col ? m0 % p.w - 1 : 0;
      for (int kt = 0; kt < k_steps; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        unsigned char* st = ring + s * T::kStage;
        mbar_expect_tx(&full[s], T::kABytes + T::kBBytes);
        if (im2col) {
          const int tap = kt / kpt;
          tma_load_im2col(st, &tm_x, &full[s], (kt - tap * kpt) * kBK, x0, y0,
                          frame, tap % 3, tap / 3);
        } else {
          tma_load(st, &tm_x, &full[s], kt * kBK, m0);
        }
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          tma_load(st + T::kABytes + c * T::kBChunk, &tm_a, &full[s],
                   n0 + c * 64, kt * kBK);
        }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int c = wg;  // rows [64 MT c, 64 MT (c + 1)) of the tile
  const int warp = t / 32;
  const int lane = t % 32;
  const int frag_row = warp * 16 + lane / 4;  // and + 8, of each 64-row slab
  const int frag_col = (lane % 4) * 2;        // + 8j, j < BN / 8
  bf16* outs = stage_out + c * 64 * BN;  // one 64-row slab at a time
  // identity convolutions run with MT = 1 (the launch picks it): `outs`
  // holds one slab, and the identity's copies into it start with the tile
  const bf16* idn = MT == 1 ? static_cast<const bf16*>(p.idn) : nullptr;
  bf16* out = static_cast<bf16*>(p.out);
  int s = 0;
  uint32_t phase = 0;
  float acc[MT][BN / 2];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * T::kBM + c * 64 * MT;  // this slab's
    const int n0 = tile % n_tiles * BN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.0f;
    }
    if (idn) {
      // the identity's slab into `outs` now, 16-byte copies that overlap
      // the products; the epilogue reads it at the fragment's own columns
      named_sync(1 + c);  // the previous tile's stores have read `outs`
#pragma unroll
      for (int i = 0; i < 64 * BN / 8 / 128; ++i) {
        const int q = t + i * 128;
        const int r = q / (BN / 8);
        const int cc = q % (BN / 8);
        const bool ok = m0 + r < p.m;
        cp_async16(outs + r * BN + ((cc ^ (r % 8)) << 3),
                   ok ? idn + static_cast<int64_t>(m0 + r) * p.cout + n0 +
                            cc * 8
                      : idn,
                   ok);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    int prev = -1;
    for (int kt = 0; kt < k_steps; ++kt) {
      mbar_wait(&full[s], phase);
      const uint32_t st = smem_u32(ring + s * T::kStage);
      fence_acc<MT * BN / 2>(&acc[0][0]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: +32 bytes per 16 K inside the swizzled row; B: +16 K rows
        const uint64_t db =
            sw128_desc(st + T::kABytes + kk * 16 * 128, T::kBChunk, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wgmma<BN>(acc[mt],
                    sw128_desc(st + (c * MT + mt) * 64 * kRowBytes + kk * 32,
                               16, 1024),
                    db);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc<MT * BN / 2>(&acc[0][0]);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc<MT * BN / 2>(&acc[0][0]);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue, slab by slab: bias, rounded identity, ReLU, rounding;
    // through `outs`, whose 16-byte chunks are swizzled by row (c ^ r % 8)
    // so that neither the fragments' accesses nor the rows' conflict
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // the identity has landed / the previous slab's stores have read
      if (idn) asm volatile("cp.async.wait_group 0;" ::: "memory");
      named_sync(1 + c);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 b =
            *reinterpret_cast<const float2*>(p.bias + n0 + j * 8 + frag_col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = frag_row + 8 * h;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              outs + r * BN + ((j ^ (r % 8)) << 3) + frag_col);
          const float2 id = idn ? __bfloat1622float2(*o) : make_float2(0, 0);
          const float lo = finish<bf16>(acc[mt][4 * j + 2 * h], b.x,
                                        idn != nullptr, id.x, p.relu);
          const float hi = finish<bf16>(acc[mt][4 * j + 2 * h + 1], b.y,
                                        idn != nullptr, id.y, p.relu);
          *o = __floats2bfloat162_rn(lo, hi);
        }
      }
      named_sync(1 + c);
#pragma unroll
      for (int i = 0; i < 64 * BN / 8 / 128; ++i) {
        const int q = t + i * 128;
        const int r = q / (BN / 8);
        const int cc = q % (BN / 8);
        const int row = m0 + mt * 64 + r;
        if (row < p.m) {
          *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * p.cout +
                                    n0 + cc * 8) =
              *reinterpret_cast<const uint4*>(outs + r * BN +
                                              ((cc ^ (r % 8)) << 3));
        }
      }
    }
  }
}

// ------------------------------------------------- f32: 3xTF32 on wgmma

constexpr int kBK32 = 32;  // K step: 32 f32 = one 128-byte row

// A 128 x BN tile: A (128 rows) and the weights' hi and lo (BN rows each)
// of one K step a stage, all K-major in the 128-byte swizzle.
template <int BN, int STAGES>
struct Tile32 {
  static constexpr int kBM = 128;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;        // hi, and again lo
  static constexpr int kStage = kABytes + 2 * kBBytes;  // multiple of 1 KB
  static constexpr int kBars = 2 * STAGES * 8;
  static constexpr int kSmem = 1024 + STAGES * kStage + kBars;
};

// v = hi + lo: hi the nearest TF32 (ties away from zero, low 13 mantissa
// bits zero), lo the exact f32 remainder (the tensor cores read its top
// 10 mantissa bits).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gemm_tf32x3(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b, Conv p) {
  using T = Tile32<BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * T::kStage);
  uint64_t* empty = full + STAGES;

  const bool im2col = p.ksize == 3;
  const int n_tiles = p.cout / BN;
  const int tiles = (p.m + T::kBM - 1) / T::kBM * n_tiles;
  const int k_steps = p.ksize * p.ksize * p.cin / kBK32;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);  // the TMA thread's arrive
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if (t != 0) return;
    const int kpt = p.cin / kBK32;  // K steps per 3x3 tap
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * T::kBM;
      const int n0 = tile % n_tiles * BN;
      const int frame = im2col ? m0 / (p.h * p.w) : 0;
      const int y0 = im2col ? m0 % (p.h * p.w) / p.w - 1 : 0;
      const int x0 = im2col ? m0 % p.w - 1 : 0;
      for (int kt = 0; kt < k_steps; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        unsigned char* st = ring + s * T::kStage;
        mbar_expect_tx(&full[s], T::kABytes + 2 * T::kBBytes);
        if (im2col) {
          const int tap = kt / kpt;
          tma_load_im2col(st, &tm_x, &full[s], (kt - tap * kpt) * kBK32, x0,
                          y0, frame, tap % 3, tap / 3);
        } else {
          tma_load(st, &tm_x, &full[s], kt * kBK32, m0);
        }
        // rows [0, cout) of the weights' map are hi, [cout, 2 cout) lo
        tma_load(st + T::kABytes, &tm_b, &full[s], kt * kBK32, n0);
        tma_load(st + T::kABytes + T::kBBytes, &tm_b, &full[s], kt * kBK32,
                 p.cout + n0);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;  // the fragment's rows g and g + 8 of the warp's
  const int q = lane % 4;  // 16; its K columns q and q + 4 of each step
  const int frag_row = wg * 64 + warp * 16 + g;  // of the tile
  const int frag_col = q * 2;  // accumulator columns, + 8j
  const float* __restrict__ idn = static_cast<const float*>(p.idn);
  const float* __restrict__ bias = p.bias;
  float* __restrict__ out = static_cast<float*>(p.out);
  int s = 0;
  uint32_t phase = 0;
  float acc[BN / 2];
  float part[BN / 2];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * T::kBM;
    const int n0 = tile % n_tiles * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < k_steps; ++kt) {
      mbar_wait(&full[s], phase);
      unsigned char* st = ring + s * T::kStage;
      const float* row = reinterpret_cast<const float*>(st) + frag_row * 32;
      const uint32_t b_hi = smem_u32(st + T::kABytes);
#pragma unroll
      for (int kk = 0; kk < kBK32 / 8; ++kk) {
        // the fragment from the swizzled rows: 16-byte chunk j of row r
        // sits at chunk j ^ (r % 8), and r % 8 == g for both rows here
        const int c0 = ((2 * kk) ^ g) * 4 + q;
        const int c1 = ((2 * kk + 1) ^ g) * 4 + q;
        uint32_t hi[4], lo[4];
        split_tf32(row[c0], hi[0], lo[0]);
        split_tf32(row[8 * 32 + c0], hi[1], lo[1]);
        split_tf32(row[c1], hi[2], lo[2]);
        split_tf32(row[8 * 32 + c1], hi[3], lo[3]);
        // B: +32 bytes per 8 K inside the swizzled rows, as A's in bf16
        const uint64_t dh = sw128_desc(b_hi + kk * 32, 16, 1024);
        const uint64_t dl = sw128_desc(b_hi + T::kBBytes + kk * 32, 16, 1024);
        // the stage's products into `part`, overwritten by its first
        fence_acc<BN / 2>(part);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        wgmma_tf32<BN>(part, lo, dh, kk > 0);
        wgmma_tf32<BN>(part, hi, dl, 1);
        wgmma_tf32<BN>(part, hi, dh, 1);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc<BN / 2>(part);
      }
      // the stage has retired: its slot back to the producer, its partial
      // sum into the tile's with f32 adds
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc<BN / 2>(part);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }

    // epilogue straight from the fragments: bias, identity, ReLU; 8 bytes
    // a thread, four lanes to one 32-byte sector of a row. A row's
    // identity loads all issue before its first store.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + frag_row + 8 * h;
      if (r >= p.m) continue;
      const int64_t base = static_cast<int64_t>(r) * p.cout + n0 + frag_col;
      float2 id[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        id[j] = idn ? __ldg(reinterpret_cast<const float2*>(idn + base +
                                                            j * 8))
                    : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 b = __ldg(
            reinterpret_cast<const float2*>(bias + n0 + j * 8 + frag_col));
        *reinterpret_cast<float2*>(out + base + j * 8) = make_float2(
            finish<float>(acc[4 * j + 2 * h], b.x, idn != nullptr, id[j].x,
                          p.relu),
            finish<float>(acc[4 * j + 2 * h + 1], b.y, idn != nullptr,
                          id[j].y, p.relu));
      }
    }
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A driver function through the runtime, so the library needs no -lcuda.
void* driver_fn(const char* name) {
  void* sym = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion(name, &sym, 12000, cudaEnableDefault,
                                   &found);
#else
  cudaGetDriverEntryPoint(name, &sym, cudaEnableDefault, &found);
#endif
  return found == cudaDriverEntryPointSuccess ? sym : nullptr;
}

// The map's element type: bf16 (itemsize 2) or f32 (4).
CUtensorMapDataType map_type(int itemsize) {
  return itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// A (rows, cols) row-major matrix of bf16 or f32 as a TMA map of box_rows
// x 128-byte boxes in the 128-byte swizzle; reads past the last row give
// zeros.
bool encode(CUtensorMap* map, const void* base, int cols, int rows,
            int box_rows, int itemsize) {
  static const auto enc =
      reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * itemsize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / itemsize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, map_type(itemsize), 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3x3's operand: the (m / (h w), h, w, cin) activations as an im2col
// map whose walk over each frame starts one pixel before it on both axes
// and ends one pixel before its last (pad 1, 3 taps), `rows` pixels x
// 128 bytes of channels per box in the 128-byte swizzle; the taps' reads
// outside the frame give the zero padding.
bool encode_im2col(CUtensorMap* map, const Conv& p, int rows, int itemsize) {
  static const auto enc =
      reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
  if (enc == nullptr) return false;
  const cuuint64_t c = p.cin, w = p.w, h = p.h, e = itemsize;
  const cuuint64_t dims[4] = {c, w, h, static_cast<cuuint64_t>(p.m) / (h * w)};
  const cuuint64_t strides[3] = {c * e, w * c * e, h * w * c * e};
  const int lower[2] = {-1, -1};
  const int upper[2] = {-1, -1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, map_type(itemsize), 4, const_cast<void*>(p.x), dims,
             strides, lower, upper, kRowBytes / itemsize,
             static_cast<cuuint32_t>(rows), elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int MT, int STAGES>
cudaError_t launch_bf16(const Conv& p, cudaStream_t st, int sms) {
  using T = Tile<BN, MT, STAGES>;
  CUtensorMap tm_x{}, tm_a{};
  if (!(p.ksize == 3 ? encode_im2col(&tm_x, p, T::kBM, 2)
                     : encode(&tm_x, p.x, p.cin, p.m, T::kBM, 2)) ||
      !encode(&tm_a, p.a, p.cout, p.ksize * p.ksize * p.cin, kBK, 2)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      conv_gemm_bf16<BN, MT, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.m + T::kBM - 1) / T::kBM * (p.cout / BN);
  const int grid = tiles < sms ? tiles : sms;
  conv_gemm_bf16<BN, MT, STAGES><<<grid, kThreads, T::kSmem, st>>>(tm_x, tm_a,
                                                                   p);
  return cudaGetLastError();
}

// The share of the persistent blocks' last round of tiles that has work,
// with `rows`-row tiles.
double filled(const Conv& p, int rows, int bn, int sms) {
  const int tiles = (p.m + rows - 1) / rows * (p.cout / bn);
  const int rounds = (tiles + sms - 1) / sms;
  return static_cast<double>(tiles) / (static_cast<double>(rounds) * sms);
}

// 256-row tiles halve the re-reads of the weights from L2, where the
// registers allow them: a convolution with an identity keeps 128-row
// tiles, whose staging slab holds the identity. So do the others where the
// coarser tiles would leave more than 5% more of the card idle in the last
// round (layer2 at 131 frames: 401 tiles of 256 rows on 132 SMs, 3.04
// rounds).
template <int BN>
cudaError_t launch_bf16(const Conv& p, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  if (p.idn == nullptr &&
      filled(p, 256, BN, sms) + 0.05 >= filled(p, 128, BN, sms)) {
    return launch_bf16<BN, 2, BN == 128 ? 4 : 5>(p, st, sms);
  }
  return launch_bf16<BN, 1, BN == 128 ? 5 : 6>(p, st, sms);
}

template <int BN, int STAGES>
cudaError_t launch_f32(const Conv& p, cudaStream_t st, int sms) {
  using T = Tile32<BN, STAGES>;
  CUtensorMap tm_x{}, tm_b{};
  // p.a: the (2, cout, K) split weights, one (2 cout, K) map
  if (!(p.ksize == 3 ? encode_im2col(&tm_x, p, T::kBM, 4)
                     : encode(&tm_x, p.x, p.cin, p.m, T::kBM, 4)) ||
      !encode(&tm_b, p.a, p.ksize * p.ksize * p.cin, 2 * p.cout, BN, 4)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      conv_gemm_tf32x3<BN, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.m + T::kBM - 1) / T::kBM * (p.cout / BN);
  const int grid = tiles < sms ? tiles : sms;
  conv_gemm_tf32x3<BN, STAGES><<<grid, kThreads, T::kSmem, st>>>(tm_x, tm_b,
                                                                  p);
  return cudaGetLastError();
}

// 128 x BN tiles, a persistent grid of one block an SM. Four stages of 48
// KB at BN = 128, six of 32 KB at 64.
template <int BN>
cudaError_t launch_f32(const Conv& p, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  return launch_f32<BN, BN == 128 ? 4 : 6>(p, st, sms);
}

}  // namespace

extern "C" {

const char* mcg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One convolution of the chain on `stream`. dtype: 0 = float32, 1 =
// bfloat16 (x, idn and out; bias is always f32). a: bf16, the folded
// (K, cout) weights; float32, their (2, cout, K) split into TF32 hi and
// lo (tf32_split). ksize 1 or 3; idn may be NULL. Returns the cudaError_t
// of the launch.
int mcg_conv_gemm(const void* x, const void* a, const float* bias,
                  const void* idn, void* out, int m, int h, int w, int cin,
                  int cout, int ksize, int relu, int dtype, void* stream) {
  if ((ksize != 1 && ksize != 3) || cin <= 0 || cin % kBK != 0 ||
      cout <= 0 || cout % 64 != 0 || m < 0 ||
      (ksize == 3 && (h <= 0 || w <= 0 || m % (h * w) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const Conv p{x, a, bias, idn, out, m, h, w, cin, cout, ksize, relu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(cout % 128 == 0 ? launch_bf16<128>(p, st)
                                            : launch_bf16<64>(p, st));
  }
  if (dtype == 0) {
    return static_cast<int>(cout % 128 == 0 ? launch_f32<128>(p, st)
                                            : launch_f32<64>(p, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
