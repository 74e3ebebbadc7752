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
// accumulate in f32: bf16 on the tensor cores (WMMA, 16x16x16 tiles), f32
// by FMA (no TF32, so it holds the plain version with TF32 off).
//
// What bounds it on the card: operations. At the gaze eval shape (131
// frames at 224 px, bf16) a chain is ~747 GFLOP against ~0.5 GB of
// activations moved, far above the H100's ~295 flop/byte bf16 balance
// point. This first design keeps every intermediate (y1, y2, the
// downsample) in device memory, stages tiles through shared memory without
// a pipeline, and reaches the tensor cores through WMMA, not wgmma: a
// stage of one frame (layer1: 56*56*256 bf16 = 1.6 MB) does not fit the
// 227 KB a block can hold, so the TPU's whole-chain-in-VMEM program does
// not carry over. TMA, wgmma, cp.async pipelining and fusing a whole block
// are later work.
//
// Constraints the wrapper checks: Cin a multiple of 32 (the K step, so a K
// tile never straddles two 3x3 taps), Cout a multiple of 64 (the N tile),
// 16-byte aligned contiguous tensors, fewer than 2^31 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// The input channels [k, k + vector) of implicit-GEMM row `row`, or null
// past the last row and where the 3x3 reads the zero padding.
template <typename T>
__device__ __forceinline__ const T* a_src(const Conv& p, int row, int k) {
  if (row >= p.m) return nullptr;
  const T* x = static_cast<const T*>(p.x);
  if (p.ksize == 1) return x + static_cast<int64_t>(row) * p.cin + k;
  const int tap = k / p.cin;  // dy * 3 + dx
  const int c = k - tap * p.cin;
  const int dy = tap / 3;
  const int dx = tap - 3 * dy;
  const int hw = p.h * p.w;
  const int frame = row / hw;
  const int pix = row - frame * hw;
  const int py = pix / p.w;
  const int sy = py + dy - 1;
  const int sx = pix - py * p.w + dx - 1;
  if (sy < 0 || sy >= p.h || sx < 0 || sx >= p.w) return nullptr;
  return x + (static_cast<int64_t>(frame) * hw + sy * p.w + sx) * p.cin + c;
}

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

// ------------------------------------------------- bf16, tensor cores (WMMA)

constexpr int kBM = 128;  // rows of a block tile
constexpr int kBN = 64;   // output channels of a block tile
constexpr int kBK = 32;   // K step
constexpr int kWarps = 4;  // each 32 rows x 64 channels: 2 x 4 WMMA tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kLdA = kBK + 8;  // bf16; rows stay 16-byte aligned
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;  // f32
constexpr int kSmemA = kBM * kLdA * 2;
constexpr int kSmemB = kBK * kLdB * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmem = (kSmemA + kSmemB > kSmemC) ? kSmemA + kSmemB : kSmemC;

__global__ void __launch_bounds__(kThreads) conv_gemm_bf16(Conv p) {
  using namespace nvcuda;
  // the A and B tiles during the K loop, then the f32 accumulators
  __shared__ __align__(128) unsigned char smem[kSmem];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + kSmemA);
  float* sc = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kdim = p.ksize * p.ksize * p.cin;
  const bf16* a = static_cast<const bf16*>(p.a);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    // A: kBM rows x kBK channels, in 16-byte chunks of 8
#pragma unroll
    for (int it = 0; it < kBM * kBK / 8 / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / (kBK / 8);
      const int c = (idx % (kBK / 8)) * 8;
      const bf16* src = a_src<bf16>(p, m0 + r, k0 + c);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src) v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(sa + r * kLdA + c) = v;
    }
    // B: kBK rows x kBN columns of the weight matrix
#pragma unroll
    for (int it = 0; it < kBK * kBN / 8 / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / (kBN / 8);
      const int c = (idx % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(sb + r * kLdB + c) =
          *reinterpret_cast<const uint4*>(
              a + static_cast<int64_t>(k0 + r) * p.cout + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], sa + (warp * 32 + i * 16) * kLdA + kk,
                               kLdA);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sb + kk * kLdB + j * 16, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc + (warp * 32 + i * 16) * kLdC + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
    }
  }
  __syncthreads();

  const bf16* idn = static_cast<const bf16*>(p.idn);
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int it = 0; it < kBM * kBN / 8 / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / (kBN / 8);
    const int c = (idx % (kBN / 8)) * 8;
    const int row = m0 + r;
    if (row >= p.m) continue;
    const int64_t off = static_cast<int64_t>(row) * p.cout + n0 + c;
    uint4 iv = make_uint4(0u, 0u, 0u, 0u);
    if (idn) iv = *reinterpret_cast<const uint4*>(idn + off);
    const __nv_bfloat162* ih = reinterpret_cast<const __nv_bfloat162*>(&iv);
    uint4 ov;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 id = __bfloat1622float2(ih[e]);
      const float lo = finish<bf16>(sc[r * kLdC + c + 2 * e],
                                    p.bias[n0 + c + 2 * e], idn != nullptr,
                                    id.x, p.relu);
      const float hi = finish<bf16>(sc[r * kLdC + c + 2 * e + 1],
                                    p.bias[n0 + c + 2 * e + 1],
                                    idn != nullptr, id.y, p.relu);
      oh[e] = __floats2bfloat162_rn(lo, hi);
    }
    *reinterpret_cast<uint4*>(out + off) = ov;
  }
}

// ------------------------------------------------------------ f32, by FMA

constexpr int kFM = 64;  // rows of a block tile
constexpr int kFN = 64;  // output channels of a block tile
constexpr int kFK = 16;  // K step
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFThreads) conv_gemm_f32(Conv p) {
  __shared__ __align__(16) float sa[kFK][kFM + 4];  // A tile, K-major
  __shared__ __align__(16) float sb[kFK][kFN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int kdim = p.ksize * p.ksize * p.cin;
  const float* a = static_cast<const float*>(p.a);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < kdim; k0 += kFK) {
    {  // A: kFM rows x kFK channels, one 16-byte chunk per thread
      const int r = tid / (kFK / 4);
      const int c = (tid % (kFK / 4)) * 4;
      const float* src = a_src<float>(p, m0 + r, k0 + c);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (src) v = *reinterpret_cast<const float4*>(src);
      sa[c][r] = v.x;
      sa[c + 1][r] = v.y;
      sa[c + 2][r] = v.z;
      sa[c + 3][r] = v.w;
    }
    {  // B: kFK rows x kFN columns
      const int r = tid / (kFN / 4);
      const int c = (tid % (kFN / 4)) * 4;
      *reinterpret_cast<float4*>(&sb[r][c]) = *reinterpret_cast<const float4*>(
          a + static_cast<int64_t>(k0 + r) * p.cout + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const float* idn = static_cast<const float*>(p.idn);
  float* out = static_cast<float*>(p.out);
  const int col = n0 + tx * 4;
  const float4 bias = *reinterpret_cast<const float4*>(p.bias + col);
  const float bs[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= p.m) continue;
    const int64_t off = static_cast<int64_t>(row) * p.cout + col;
    float4 iv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (idn) iv = *reinterpret_cast<const float4*>(idn + off);
    const float id[4] = {iv.x, iv.y, iv.z, iv.w};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = finish<float>(acc[i][j], bs[j], idn != nullptr, id[j], p.relu);
    }
    *reinterpret_cast<float4*>(out + off) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

extern "C" {

const char* mcg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One convolution of the chain on `stream`. dtype: 0 = float32, 1 =
// bfloat16 (x, a, idn and out; bias is always f32). ksize 1 or 3; idn may
// be NULL. Returns the cudaError_t of the launch.
int mcg_conv_gemm(const void* x, const void* a, const float* bias,
                  const void* idn, void* out, int m, int h, int w, int cin,
                  int cout, int ksize, int relu, int dtype, void* stream) {
  if ((ksize != 1 && ksize != 3) || cin <= 0 || cin % kBK != 0 ||
      cout <= 0 || cout % kBN != 0 || m < 0 ||
      (ksize == 3 && (h <= 0 || w <= 0 || m % (h * w) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const Conv p{x, a, bias, idn, out, m, h, w, cin, cout, ksize, relu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((m + kBM - 1) / kBM, cout / kBN);
    conv_gemm_bf16<<<grid, kThreads, 0, st>>>(p);
  } else if (dtype == 0) {
    const dim3 grid((m + kFM - 1) / kFM, cout / kFN);
    conv_gemm_f32<<<grid, kFThreads, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
