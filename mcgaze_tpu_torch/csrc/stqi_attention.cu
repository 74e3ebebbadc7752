// Fused clue x frame attention of the STQI head for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (mcgaze_tpu_torch/ops/stqi_attention.py).
//
// Replaces the TPU kernel mcgaze_tpu/ops/stqi_attention.py::
// fused_stqi_attention (bodies _kernel / _masked_attention). Per clip of T
// frames x Q clue tokens (t-major, q-minor), in f32 throughout:
//   x = LN(x + out_proj(MHA(x) over the Q tokens of each frame))
//   x = LN(x + out_proj(MHA(x) over the T tokens of each clue))
// with one set of packed qkv (C, 3C) / out (C, C) weights and one LN
// (mean, biased variance, eps 1e-5) shared by both passes. Logits are
// scaled by 1/sqrt(hd); the JAX kernel's -1e9 additive mask gives the
// tokens outside a pass's set a weight of exactly 0, so the softmax here
// runs over the allowed tokens only.
//
// What bounds it on the card: at the gaze eval shape (32 clips x 21 tokens,
// C 256) ~714 MFLOP of f32 against ~2 MB of tokens and weights, so
// operations (~0.011 ms at 67 TFLOP/s). Design: one CTA per clip, the
// clip's tokens, their qkv and the attention output in shared memory
// (~120 KB at C 256, above the 48 KB default, so the launch raises the
// limit); the projections inside the kernel, each thread owning up to 3
// output columns and 24 tokens of f32 accumulators, the weights streamed
// from L2 once per CTA and pass; one warp per (head, token) for the
// attention, a lane per channel of the head (hd <= 32). The TPU kernel's
// lane masks and clip packing (its answer to the MXU's 128-wide tiles) do
// not carry over. A CTA per clip leaves most SMs idle at 32 clips: a
// split of the projections across CTAs is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 24;  // token rows per group of register accumulators
constexpr int kMaxCols = 3;  // output columns per thread: 3C <= 3 * kThreads
constexpr float kLnEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* wqkv;  // (C, 3C)
  const float* bqkv;  // (3C,)
  const float* wout;  // (C, C)
  const float* bout;  // (C,)
  const float* ln_scale;
  const float* ln_bias;
  int t, q, c, heads;
  float scale;  // 1 / sqrt(C / heads)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// dst[s, j] (+)= b[j] + sum_k in[s, k] * w[k, j] for s < rows (a multiple
// of kGroup) and j < cout; thread tid owns columns tid + i * kThreads. With
// `residual` it adds to what dst holds (each element is read and written by
// its one owner, so in-place is safe while `in` is another buffer).
template <int kCols>
__device__ __forceinline__ void project(const float* in, int rows, int cin,
                                        const float* __restrict__ w,
                                        const float* __restrict__ b, int cout,
                                        float* dst, bool residual) {
  const int tid = threadIdx.x;
  for (int s0 = 0; s0 < rows; s0 += kGroup) {
    float acc[kCols][kGroup];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) acc[i][g] = 0.0f;
    }
    for (int k = 0; k < cin; k += 4) {
      float wv[4][kCols];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int j = tid + i * kThreads;
          wv[kk][i] = j < cout ? w[static_cast<int64_t>(k + kk) * cout + j]
                               : 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float4 xv =
            *reinterpret_cast<const float4*>(in + (s0 + g) * cin + k);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc[i][g] = fmaf(xv.x, wv[0][i], acc[i][g]);
          acc[i][g] = fmaf(xv.y, wv[1][i], acc[i][g]);
          acc[i][g] = fmaf(xv.z, wv[2][i], acc[i][g]);
          acc[i][g] = fmaf(xv.w, wv[3][i], acc[i][g]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int j = tid + i * kThreads;
      if (j >= cout) continue;
      const float bj = b[j];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        float* d = dst + (s0 + g) * cout + j;
        const float v = acc[i][g] + bj;
        *d = residual ? *d + v : v;
      }
    }
  }
}

// o[s, head h] = softmax over the allowed tokens u of (q_s . k_u) * scale,
// applied to v_u; one warp per (head, token), lane d on channel d of the
// head. spatial: u runs over the Q tokens of s's frame; else over the T
// tokens of s's clue.
__device__ __forceinline__ void attend(const float* qkv, float* o,
                                       const Params& p, bool spatial) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = p.c;
  const int hd = c / p.heads;
  const int tokens = p.t * p.q;
  const int n_allowed = spatial ? p.q : p.t;
  const bool on = lane < hd;
  for (int pair = warp; pair < p.heads * tokens; pair += kWarps) {
    const int h = pair / tokens;
    const int s = pair - h * tokens;
    const int first = spatial ? (s / p.q) * p.q : s % p.q;
    const int step = spatial ? 1 : p.q;
    const float qd = on ? qkv[s * 3 * c + h * hd + lane] : 0.0f;
    float logit = -INFINITY;  // lane u keeps the logit of allowed token u
    for (int u = 0; u < n_allowed; ++u) {
      const int tok = first + u * step;
      const float kd = on ? qkv[tok * 3 * c + c + h * hd + lane] : 0.0f;
      const float dot = warp_sum(qd * kd);
      if (lane == u) logit = dot * p.scale;
    }
    const float mx = warp_max(logit);
    const float e = lane < n_allowed ? expf(logit - mx) : 0.0f;
    const float a = e / warp_sum(e);
    float acc = 0.0f;
    for (int u = 0; u < n_allowed; ++u) {
      const int tok = first + u * step;
      const float au = __shfl_sync(kFull, a, u);
      if (on) acc = fmaf(au, qkv[tok * 3 * c + 2 * c + h * hd + lane], acc);
    }
    if (on) o[s * c + h * hd + lane] = acc;
  }
}

// In place over the first `tokens` rows: (x - mean) * rsqrt(var + eps) *
// scale + bias, one warp per token.
__device__ __forceinline__ void layer_norm(float* x, int tokens,
                                           const Params& p) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = p.c;
  for (int s = warp; s < tokens; s += kWarps) {
    float* r = x + s * c;
    float sum = 0.0f;
    for (int k = lane; k < c; k += 32) sum += r[k];
    const float mu = warp_sum(sum) / static_cast<float>(c);
    float sq = 0.0f;
    for (int k = lane; k < c; k += 32) {
      const float d = r[k] - mu;
      sq = fmaf(d, d, sq);
    }
    const float inv = rsqrtf(warp_sum(sq) / static_cast<float>(c) + kLnEps);
    for (int k = lane; k < c; k += 32) {
      r[k] = (r[k] - mu) * inv * p.ln_scale[k] + p.ln_bias[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    stqi_attention_kernel(const float* __restrict__ query,
                          float* __restrict__ out, Params p, int rows) {
  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);  // (rows, C) tokens
  float* qkv = x + rows * p.c;                 // (rows, 3C)
  float* o = qkv + rows * 3 * p.c;             // (rows, C) attention output
  const int tokens = p.t * p.q;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tokens * p.c;

  for (int i = threadIdx.x; i < rows * 5 * p.c; i += kThreads) {
    x[i] = i < tokens * p.c ? query[base + i] : 0.0f;
  }
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    project<kMaxCols>(x, rows, p.c, p.wqkv, p.bqkv, 3 * p.c, qkv, false);
    __syncthreads();
    attend(qkv, o, p, pass == 0);
    __syncthreads();
    project<1>(o, rows, p.c, p.wout, p.bout, p.c, x, true);
    __syncthreads();
    layer_norm(x, tokens, p);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tokens * p.c; i += kThreads) {
    out[base + i] = x[i];
  }
}

}  // namespace

extern "C" {

const char* mcg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// query, out: (clips * t, q, c) f32; the weights as in Params. Returns the
// cudaError_t of the launch (or of raising the shared-memory limit).
int mcg_stqi_attention(const float* query, const float* wqkv,
                       const float* bqkv, const float* wout, const float* bout,
                       const float* ln_scale, const float* ln_bias, float* out,
                       int clips, int t, int q, int c, int heads, float scale,
                       void* stream) {
  if (t <= 0 || q <= 0 || t * q > 32 || c <= 0 || c % 4 != 0 ||
      c > kThreads || heads <= 0 || c % heads != 0 || c / heads > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (clips == 0) return 0;
  const int rows = (t * q + kGroup - 1) / kGroup * kGroup;
  const int smem = rows * 5 * c * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      stqi_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{wqkv, bqkv, wout, bout, ln_scale, ln_bias,
                 t,    q,    c,    heads, scale};
  stqi_attention_kernel<<<clips, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(query, out, p,
                                                               rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
