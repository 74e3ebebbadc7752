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
// operations (~0.011 ms at 67 TFLOP/s). A clip alone is ~25 MFLOP done in
// a chain of dependent steps, so one CTA per clip left 100 of 132 SMs idle
// and ran its projections at the latency of the weight loads.
//
// Design: a thread-block cluster of G CTAs per clip, split by heads (G
// divides `heads`: 4 at 8 heads, 2 heads and 64 channels a CTA; 128 CTAs at
// 32 clips). CTA g holds the clip's full tokens x in shared memory and, in
// each pass:
//   1. projects the q, k and v columns of its own heads (3C/G columns);
//   2. attends for its heads, locally (one thread per (head, token), the
//      softmax taken online over the allowed keys);
//   3. after a cluster barrier, gathers the peers' attention outputs through
//      distributed shared memory and computes its C/G output columns of
//      out_proj, plus bias and residual;
//   4. LayerNorm: per-token partial sums over its columns, exchanged through
//      distributed shared memory in two rounds (the mean, then the centred
//      sum of squares: the reference's formula), summed in rank order so
//      every CTA holds the same statistics; it normalises its columns;
//   5. gathers the full normalised rows from its peers for the next pass,
//      or after the last pass writes its columns of the output.
// The weight columns a CTA needs stream through a 4-stage cp.async ring in
// shared memory, in one schedule across both projections of both passes, so
// the next chunks load while a chunk's FMAs run (and out_proj's first
// chunks while the attention runs). The projections are f32 FMA, each
// thread holding a tile of up to 3 columns x 8 tokens in registers; they
// are bound by the SM's shared-memory loads (per 4 rows of K, 6 broadcast
// 16-byte loads of x and 12 weight loads for 72 FMAs) with 8 warps to hide
// their latency. (3xTF32 mma.sync was slower here and held the tolerance
// only just.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColLanes = 64;                      // threads across columns
constexpr int kStages = 4;                          // weight ring depth
constexpr int kMaxCluster = 8;                      // portable cluster size
constexpr int kMaxRows = 32;
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
  int cluster;  // G: CTAs per clip
  int cpc;      // C / G: the channels (heads * hd) of one CTA
  int kc;       // weight rows per ring stage
  int rows;     // token rows, padded to a multiple of 8
  float scale;  // 1 / sqrt(C / heads)
};

__host__ __device__ inline int ring_stage_floats(const Params& p) {
  return p.kc * 3 * p.cpc;
}

// A row of q | k | v in shared memory, padded to an odd length so the
// attention's thread-per-token loads of 32 rows fall in 32 banks.
__host__ __device__ inline int qkv_stride(const Params& p) {
  return 3 * p.cpc + 1;
}

__host__ __device__ inline int smem_floats(const Params& p) {
  const int qs = qkv_stride(p);
  return p.rows * p.c                              // x
         + p.rows * (qs > p.c ? qs : p.c)          // qkv, then o gathered
         + 2 * p.rows * p.cpc                      // own o, own y
         + 4 * kMaxRows                            // LN partials and stats
         + kStages * ring_stage_floats(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The 16-byte copies a thread makes of one weight chunk: at most
// kMaxCopies, each its row within the chunk, its offset in the source
// (from the chunk's first row) and in the ring stage. The same for every
// chunk of a projection, so worked out once.
constexpr int kMaxCopies = 3;  // kc * 3 * cpc <= 3072 floats a chunk

struct Copies {
  int kk[kMaxCopies];
  int src[kMaxCopies];
  int dst[kMaxCopies];
};

__device__ __forceinline__ Copies chunk_copies(const Params& p, bool is_out,
                                               int rank) {
  const int ncols = is_out ? p.cpc : 3 * p.cpc;
  const int row_len = is_out ? p.c : 3 * p.c;
  const int vecs = ncols / 4;
  Copies cp;
#pragma unroll
  for (int j = 0; j < kMaxCopies; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int kk = e / vecs;
    const int m = (e - kk * vecs) * 4;
    // qkv: segment m / cpc of q, k, v, the CTA's columns within it
    const int col = is_out ? rank * p.cpc + m
                           : (m / p.cpc) * p.c + rank * p.cpc + m % p.cpc;
    cp.kk[j] = e < p.kc * vecs ? kk : p.kc;  // p.kc: no copy
    cp.src[j] = kk * row_len + col;
    cp.dst[j] = kk * ncols + m;
  }
  return cp;
}

// The weight chunks in the order the CTA consumes them: per pass, C/kc
// chunks of its qkv columns, then C/kc of its out_proj columns. Chunk idx
// goes to ring stage idx % kStages as a [kr][ncols] block.
__device__ __forceinline__ void issue_chunk(const Params& p, float* ring,
                                            int idx, const Copies& qkv,
                                            const Copies& out) {
  const int nk = (p.c + p.kc - 1) / p.kc;
  if (idx >= 4 * nk) return;
  const int within = idx % (2 * nk);
  const bool is_out = within >= nk;
  const int k0 = (within % nk) * p.kc;
  const int kr = min(p.kc, p.c - k0);
  const Copies& cp = is_out ? out : qkv;
  const float* src =
      (is_out ? p.wout : p.wqkv) + static_cast<int64_t>(k0) *
                                       (is_out ? p.c : 3 * p.c);
  float* dst = ring + (idx % kStages) * ring_stage_floats(p);
#pragma unroll
  for (int j = 0; j < kMaxCopies; ++j) {
    if (cp.kk[j] < kr) cp_async16(dst + cp.dst[j], src + cp.src[j]);
  }
}

// acc[i][e] = sum_k in[s0 + e, k] * w[k, lane + 64 i] over the C rows of
// the CTA's weight columns (ncols of them), read chunk by chunk from the
// ring; `idx` is the schedule's next chunk. Thread (lane, token group)
// holds a tile of MC columns x TPG tokens.
template <int MC, int TPG>
__device__ __forceinline__ void project(const Params& p, float* ring,
                                        int& idx, const Copies& qkv,
                                        const Copies& out, const float* in,
                                        int ncols, float (&acc)[MC][TPG]) {
  const int lane = threadIdx.x % kColLanes;
  const int s0 = (threadIdx.x / kColLanes) * TPG;
#pragma unroll
  for (int i = 0; i < MC; ++i) {
#pragma unroll
    for (int e = 0; e < TPG; ++e) acc[i][e] = 0.0f;
  }
  const int nk = (p.c + p.kc - 1) / p.kc;
  for (int kci = 0; kci < nk; ++kci, ++idx) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk idx landed; stage (idx - 1) % kStages is free
    issue_chunk(p, ring, idx + kStages - 1, qkv, out);
    cp_async_commit();
    const float* w = ring + (idx % kStages) * ring_stage_floats(p);
    const int k0 = kci * p.kc;
    const int kr = min(p.kc, p.c - k0);
    // unrolled, so the next step's loads are issued under this step's FMAs
#pragma unroll 4
    for (int kk = 0; kk < kr; kk += 4) {
      float4 xv[TPG];
#pragma unroll
      for (int e = 0; e < TPG; ++e) {
        xv[e] = *reinterpret_cast<const float4*>(in + (s0 + e) * p.c + k0 +
                                                 kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < MC; ++i) {
          const int m = lane + i * kColLanes;
          const float wv = m < ncols ? w[(kk + u) * ncols + m] : 0.0f;
#pragma unroll
          for (int e = 0; e < TPG; ++e) {
            const float xe = u == 0 ? xv[e].x
                             : u == 1 ? xv[e].y
                             : u == 2 ? xv[e].z
                                      : xv[e].w;
            acc[i][e] = fmaf(xe, wv, acc[i][e]);
          }
        }
      }
    }
  }
}

// o[s, head hl] = softmax over the allowed tokens u of (q_s . k_u) * scale,
// applied to v_u, for the CTA's heads; qkv rows are [q | k | v] of its
// cpc channels each, row stride qkv_stride. One thread per (head, token),
// its q and its output row (hd <= 32 channels) in registers, the softmax
// taken online over the allowed keys in order. spatial: u runs over the Q
// tokens of s's frame; else over the T tokens of s's clue.
__device__ __forceinline__ void attend(const float* qkv, float* o,
                                       const Params& p, bool spatial) {
  const int hd = p.c / p.heads;
  const int hpc = p.cpc / hd;
  const int ld = qkv_stride(p);
  const int tokens = p.t * p.q;
  const int n_allowed = spatial ? p.q : p.t;
  for (int pair = threadIdx.x; pair < hpc * tokens; pair += kThreads) {
    const int h = pair / tokens;
    const int s = pair - h * tokens;
    const int first = spatial ? (s / p.q) * p.q : s % p.q;
    const int step = spatial ? 1 : p.q;
    const float* qs = qkv + s * ld + h * hd;
    float q[32], acc[32];
#pragma unroll
    for (int d = 0; d < 32; ++d) {
      q[d] = d < hd ? qs[d] : 0.0f;
      acc[d] = 0.0f;
    }
    float mx = -INFINITY, sum = 0.0f;
    for (int u = 0; u < n_allowed; ++u) {
      const float* row = qkv + (first + u * step) * ld + h * hd;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        if (d < hd) dot = fmaf(q[d], row[p.cpc + d], dot);
      }
      const float logit = dot * p.scale;
      const float m_new = fmaxf(mx, logit);
      const float keep = expf(mx - m_new);  // 0 for the first key
      const float wgt = expf(logit - m_new);
      sum = sum * keep + wgt;
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        if (d < hd) acc[d] = fmaf(wgt, row[2 * p.cpc + d], acc[d] * keep);
      }
      mx = m_new;
    }
    const float inv_sum = 1.0f / sum;
#pragma unroll
    for (int d = 0; d < 32; ++d) {
      if (d < hd) o[s * p.cpc + h * hd + d] = acc[d] * inv_sum;
    }
  }
}

// part[s] = the sum over the CTA's columns of f(y[s, m]), one warp per
// token, lanes strided over the columns: a fixed order.
template <typename F>
__device__ __forceinline__ void row_partials(const float* y, int tokens,
                                             int cpc, float* part, F f) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int s = warp; s < tokens; s += kWarps) {
    float v = 0.0f;
    for (int m = lane; m < cpc; m += 32) v += f(s, y[s * cpc + m]);
    v = warp_sum(v);
    if (lane == 0) part[s] = v;
  }
}

// The sum over the cluster's CTAs, in rank order, of part[s]: the remote
// loads are issued together, then added.
__device__ __forceinline__ float cluster_total(cg::cluster_group& cluster,
                                               float* part, int s, int size) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    v[r] = r < size ? cluster.map_shared_rank(part, r)[s] : 0.0f;
  }
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < size) total += v[r];
  }
  return total;
}

// Copies of up to kMaxRows x 256 f32 by 16-byte vectors: at most kMaxVecs
// per thread, all loads issued before the stores.
constexpr int kMaxVecs = kMaxRows * 256 / 4 / kThreads;

// dst[s, :] (row stride c) = the CTAs' src[s, :] (row stride cpc) side by
// side, rank r's at columns [r * cpc, (r + 1) * cpc), for every padded row.
__device__ __forceinline__ void gather_rows(cg::cluster_group& cluster,
                                            float* src, float* dst,
                                            const Params& p) {
  const int vecs = p.c / 4;
  float4 v[kMaxVecs];
#pragma unroll
  for (int u = 0; u < kMaxVecs; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e < p.rows * vecs) {
      const int s = e / vecs;
      const int col = (e - s * vecs) * 4;
      const float* peer = cluster.map_shared_rank(src, col / p.cpc);
      v[u] = *reinterpret_cast<const float4*>(peer + s * p.cpc +
                                              col % p.cpc);
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxVecs; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e < p.rows * vecs) reinterpret_cast<float4*>(dst)[e] = v[u];
  }
}

// Two CTAs share an SM at the gaze shape (128 registers a thread); the
// wide tile (MCQ 12, C/G > 64) runs one CTA an SM.
template <int MCQ, int TPG>
__global__ void __launch_bounds__(kThreads, MCQ == 3 ? 2 : 1)
    stqi_attention_kernel(const float* __restrict__ query,
                          float* __restrict__ out, Params p) {
  constexpr int MCO = MCQ / 3;  // out_proj: C/G columns, a third of qkv's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int clip = blockIdx.x / p.cluster;
  const int tokens = p.t * p.q;
  const int ncols = 3 * p.cpc;
  const int qs = qkv_stride(p);
  const int lane_c = threadIdx.x % kColLanes;
  const int s0 = (threadIdx.x / kColLanes) * TPG;

  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);      // [rows][C]
  float* work = x + p.rows * p.c;                  // qkv [rows][qs], then
                                                   // gathered o [rows][C]
  float* o_own = work + p.rows * (qs > p.c ? qs : p.c);  // [rows][cpc]
  float* y_own = o_own + p.rows * p.cpc;           // [rows][cpc]
  float* part_sum = y_own + p.rows * p.cpc;        // [kMaxRows]
  float* part_sq = part_sum + kMaxRows;
  float* mean = part_sq + kMaxRows;
  float* inv = mean + kMaxRows;
  float* ring = inv + kMaxRows;

  const Copies qkv_copies = chunk_copies(p, false, rank);
  const Copies out_copies = chunk_copies(p, true, rank);
  int idx = 0;
  for (int s = 0; s < kStages - 1; ++s) {
    issue_chunk(p, ring, s, qkv_copies, out_copies);
    cp_async_commit();
  }
  const int64_t base = static_cast<int64_t>(clip) * tokens * p.c;
  {
    float4 v[kMaxVecs];
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int e = threadIdx.x + u * kThreads;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e * 4 < tokens * p.c) {
        v[u] = reinterpret_cast<const float4*>(query + base)[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < p.rows * p.c / 4) reinterpret_cast<float4*>(x)[e] = v[u];
    }
  }
  for (int e = threadIdx.x; e < p.rows * p.cpc; e += kThreads) o_own[e] = 0.0f;

  for (int pass = 0; pass < 2; ++pass) {
    // 1. q, k, v of the CTA's heads
    {
      float acc[MCQ][TPG];
      project<MCQ, TPG>(p, ring, idx, qkv_copies, out_copies, x, ncols, acc);
#pragma unroll
      for (int i = 0; i < MCQ; ++i) {
        const int m = lane_c + i * kColLanes;
        if (m >= ncols) continue;
        const float b = p.bqkv[(m / p.cpc) * p.c + rank * p.cpc + m % p.cpc];
#pragma unroll
        for (int e = 0; e < TPG; ++e) work[(s0 + e) * qs + m] = acc[i][e] + b;
      }
    }
    __syncthreads();
    // 2. attention of its heads
    attend(work, o_own, p, pass == 0);
    cluster.sync();  // every CTA's o is complete
    // 3. the full attention output, then its out_proj columns
    gather_rows(cluster, o_own, work, p);
    {
      float acc[MCO][TPG];
      project<MCO, TPG>(p, ring, idx, qkv_copies, out_copies, work, p.cpc,
                        acc);
#pragma unroll
      for (int i = 0; i < MCO; ++i) {
        const int m = lane_c + i * kColLanes;
        if (m >= p.cpc) continue;
        const int col = rank * p.cpc + m;
        const float b = p.bout[col];
#pragma unroll
        for (int e = 0; e < TPG; ++e) {
          const int s = s0 + e;
          y_own[s * p.cpc + m] = x[s * p.c + col] + (acc[i][e] + b);
        }
      }
    }
    __syncthreads();
    // 4. LayerNorm over the full rows: the mean, then the centred sum of
    //    squares, each exchanged across the cluster
    row_partials(y_own, tokens, p.cpc, part_sum,
                 [](int, float v) { return v; });
    cluster.sync();
    const float inv_c = 1.0f / static_cast<float>(p.c);
    for (int s = threadIdx.x; s < tokens; s += kThreads) {
      mean[s] = cluster_total(cluster, part_sum, s, p.cluster) * inv_c;
    }
    __syncthreads();
    row_partials(y_own, tokens, p.cpc, part_sq, [&](int s, float v) {
      const float d = v - mean[s];
      return d * d;
    });
    cluster.sync();
    for (int s = threadIdx.x; s < tokens; s += kThreads) {
      inv[s] = rsqrtf(cluster_total(cluster, part_sq, s, p.cluster) * inv_c +
                      kLnEps);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tokens * p.cpc; e += kThreads) {
      const int s = e / p.cpc;
      const int col = rank * p.cpc + (e - s * p.cpc);
      y_own[e] = (y_own[e] - mean[s]) * inv[s] * p.ln_scale[col] +
                 p.ln_bias[col];
    }
    cluster.sync();  // every CTA's rows are normalised; no peer reads the
                     // LN partials any more
    // 5. the next pass's tokens, or this CTA's columns of the output
    if (pass == 0) {
      gather_rows(cluster, y_own, x, p);
    } else {
      for (int e = threadIdx.x; e < tokens * p.cpc / 4; e += kThreads) {
        const int s = (e * 4) / p.cpc;
        const int m = e * 4 - s * p.cpc;
        *reinterpret_cast<float4*>(out + base + s * p.c + rank * p.cpc + m) =
            *reinterpret_cast<const float4*>(y_own + s * p.cpc + m);
      }
    }
  }
}

template <int MCQ, int TPG>
cudaError_t launch(const float* query, float* out, const Params& p, int clips,
                   cudaStream_t stream) {
  const auto kernel = stqi_attention_kernel<MCQ, TPG>;
  const int smem = smem_floats(p) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clips * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, query, out, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tile a thread holds: MCQ columns of the qkv projection (3 for C/G
// <= 64, else 12) by TPG = rows / 4 tokens.
template <int MCQ>
cudaError_t launch_rows(const float* query, float* out, const Params& p,
                        int clips, cudaStream_t stream) {
  switch (p.rows / 4) {
    case 2:
      return launch<MCQ, 2>(query, out, p, clips, stream);
    case 4:
      return launch<MCQ, 4>(query, out, p, clips, stream);
    case 6:
      return launch<MCQ, 6>(query, out, p, clips, stream);
    case 8:
      return launch<MCQ, 8>(query, out, p, clips, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const float* query, float* out, const Params& p,
                     int clips, cudaStream_t stream) {
  const int tokens = p.t * p.q;
  const int hd = p.heads > 0 ? p.c / p.heads : 0;
  if (p.t <= 0 || p.q <= 0 || tokens > kMaxRows || p.c <= 0 ||
      p.c % 4 != 0 || p.c > 256 || p.heads <= 0 || p.c % p.heads != 0 ||
      hd > 32 || p.cluster < 1 || p.cluster > kMaxCluster ||
      p.heads % p.cluster != 0 || p.cpc * p.cluster != p.c ||
      p.cpc % 4 != 0 || p.kc <= 0 || p.kc % 4 != 0 ||
      p.kc * 3 * p.cpc > kMaxCopies * 4 * kThreads || p.rows < tokens ||
      p.rows > kMaxRows || p.rows % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  // columns a thread: 3 cover 3 C/G <= 192 over 64 lanes, 12 cover 768
  if (3 * p.cpc <= 3 * kColLanes) {
    return launch_rows<3>(query, out, p, clips, stream);
  }
  return launch_rows<12>(query, out, p, clips, stream);
}

}  // namespace

extern "C" {

const char* mcg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// query, out: (clips * t, q, c) f32, 16-byte aligned; the weights as in
// Params. cluster, kc and rows: the plan of ops/stqi_attention.py::
// cluster_plan. Returns the cudaError_t of the launch (or of raising the
// shared-memory limit).
int mcg_stqi_attention(const float* query, const float* wqkv,
                       const float* bqkv, const float* wout, const float* bout,
                       const float* ln_scale, const float* ln_bias, float* out,
                       int clips, int t, int q, int c, int heads, int cluster,
                       int kc, int rows, float scale, void* stream) {
  const int cpc = cluster > 0 ? c / cluster : 0;
  const Params p{wqkv, bqkv,  wout,    bout, ln_scale, ln_bias, t,    q,
                 c,    heads, cluster, cpc,  kc,       rows,    scale};
  if (clips == 0) return 0;
  return static_cast<int>(dispatch(query, out, p, clips,
                                   static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
