// Per-channel batch statistics of a bfloat16 norm site, and their gradient,
// for Hopper (sm_90a).
//
// No TPU kernel: the JAX package's norm sites leave
// jnp.var(x.astype(float32)) to XLA.  In PyTorch the same reduction,
// torch.var_mean(x.float()), writes a float32 copy of x, reads it in a
// Welford pass and keeps it for the backward, whose autograd is a chain of
// seven broadcast float32 passes.  These kernels replace both.
//
// x is (M, C) bfloat16, contiguous: the NHWC view of a channels_last
// (N, C, H, W) activation, M = N H W.
//
// Forward: the biased variance and the mean of each channel over the M
// rows, in float32, from one read of x and no copy.
//   * batch_stats_welford_kernel: a block of THREADS threads covers CT * V
//     channels (a slab) of one chunk of rows; each thread owns V consecutive
//     channels (V = 8, one 16-byte load a row; V = 1 where C or x's address
//     does not allow vectors) and keeps (count, mean, M2) in float32 over
//     every RP-th row of the chunk, RP = THREADS / CT: GROUP rows at a time,
//     whose own mean and M2 come from registers in two passes and join the
//     running statistics by Chan's formula (one division a group, and no
//     chain of dependent updates from row to row), the last rows by
//     Welford's update.  The RP threads that share channels then merge in
//     shared memory with Chan's formula, in a fixed tree, and one (mean, M2)
//     per chunk and channel goes to `partial` (the chunk's count is its
//     number of rows).  The grid is one wave of FWD_MIN_BLOCKS blocks per
//     SM (ops/batch_stats.chunking).
//   * batch_stats_merge_kernel: per channel, the chunks merged with Chan's
//     formula in a fixed order (MERGE_LANES strided lanes, then a tree);
//     var = M2 / M.  No atomics: the same x gives the same bits.
// A one-pass sum and sum of squares would cancel catastrophically where
// |mean| >> std; Welford's update and Chan's merge keep the error near
// float32's own.
//
// Backward: from (gvar, gmean), the gradients of (var, mean),
//   dx = a_c x + b_c,  a_c = gvar_c (2 / M),
//   b_c = gmean_c (1 / M) - a_c mean_c
// in float32, each product and sum rounded on its own (no FMA
// contraction), stored once in bfloat16: one read of x, one write of dx.
// The plain version, ops/batch_stats.batch_stats_backward_reference,
// rounds the same way.
//
// What bounds both: the bytes, 2 per element forward, 4 backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The launch shapes, from timings of the 18 site shapes on an H100 (the
// forward prefers few long-running blocks, the backward more waves):
constexpr int THREADS = 256;
constexpr int FWD_MIN_BLOCKS = 2;  // resident forward blocks per SM
constexpr int GROUP = 8;           // rows a forward thread reads at a time
constexpr int BWD_MIN_BLOCKS = 4;  // resident backward blocks per SM
constexpr int UNROLL = 4;          // rows a backward thread reads at a time
constexpr int MAX_CT = 128;        // thread columns of a block
constexpr int MERGE_CH = 32;       // channels per block of the merge
constexpr int MERGE_LANES = 16;    // lanes per channel of the merge

// V consecutive bfloat16 values as loaded: one 16-byte vector (V = 8) or
// one value.  They stay packed in registers until each is used.
template <int V>
struct Raw {
  uint4 u;
};
template <>
struct Raw<1> {
  unsigned short h;
};

template <int V>
__device__ __forceinline__ Raw<V> load_raw(const __nv_bfloat16* p) {
  Raw<V> r;
  if constexpr (V == 8)
    r.u = *reinterpret_cast<const uint4*>(p);
  else
    r.h = *reinterpret_cast<const unsigned short*>(p);
  return r;
}

// Value k of a raw load, widened to float32 (exact).
template <int V>
__device__ __forceinline__ float widen(const Raw<V>& r, int k) {
  if constexpr (V == 8) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&r.u)[k >> 1];
    return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
  } else {
    return __uint_as_float((uint32_t)r.h << 16);
  }
}

// V float32 values to bfloat16 at p, round to nearest even.
template <int V>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Chan's formula: (na, ma, m2a) becomes the statistics of both sets.
__device__ __forceinline__ void chan(float& na, float& ma, float& m2a,
                                     float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb;
    ma = mb;
    m2a = m2b;
    return;
  }
  const float n = na + nb;
  const float f = nb / n;
  const float d = mb - ma;
  ma += d * f;
  m2a += m2b + d * d * na * f;
  na = n;
}

template <int V>
__global__ void __launch_bounds__(THREADS, FWD_MIN_BLOCKS)
batch_stats_welford_kernel(const __nv_bfloat16* __restrict__ x,
                           float* __restrict__ partial, long long M, int C,
                           int ct, long long rows_per_chunk) {
  __shared__ float s_n[THREADS];
  __shared__ float s_mean[V][THREADS];
  __shared__ float s_m2[V][THREADS];
  const int tid = threadIdx.x;
  const int rp = THREADS / ct;
  const int tc = tid % ct, tr = tid / ct;
  const int c0 = (blockIdx.x * ct + tc) * V;
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(M, r0 + rows_per_chunk);

  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
  if (c0 < C) {
    long long r = r0 + tr;
    // GROUP rows at a time: their own mean and M2 from registers (two
    // passes), merged into the running statistics by Chan's formula
    for (; r + (GROUP - 1) * rp < r1; r += (long long)rp * GROUP) {
      Raw<V> raw[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u)
        raw[u] = load_raw<V>(x + (r + u * rp) * C + c0);
      const float f = (float)GROUP / (n + (float)GROUP);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float v[GROUP], sum = 0.f;
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          v[u] = widen<V>(raw[u], k);
          sum += v[u];
        }
        const float mg = sum * (1.f / GROUP);
        float q = 0.f;
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const float d = v[u] - mg;
          q = fmaf(d, d, q);
        }
        const float d = mg - mean[k];
        mean[k] = fmaf(d, f, mean[k]);
        m2[k] += q + d * d * n * f;
      }
      n += (float)GROUP;
    }
    // the rest, one row at a time (Welford's update)
    for (; r < r1; r += rp) {
      const Raw<V> raw = load_raw<V>(x + r * C + c0);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = widen<V>(raw, k);
        const float d = v - mean[k];
        mean[k] += d * inv;
        m2[k] += d * (v - mean[k]);
      }
    }
  }
  s_n[tid] = n;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_mean[k][tid] = mean[k];
    s_m2[k][tid] = m2[k];
  }
  __syncthreads();
  for (int s = rp / 2; s >= 1; s /= 2) {
    if (tr < s) {
      const int o = tid + s * ct;
      const float na = s_n[tid];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float nk = na;
        chan(nk, s_mean[k][tid], s_m2[k][tid], s_n[o], s_mean[k][o],
             s_m2[k][o]);
      }
      s_n[tid] = na + s_n[o];
    }
    __syncthreads();
  }
  if (tr == 0 && c0 < C) {
    float* out = partial + (long long)blockIdx.y * 2 * C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (c0 + k < C) {
        out[c0 + k] = s_mean[k][tid];
        out[C + c0 + k] = s_m2[k][tid];
      }
    }
  }
}

__global__ void __launch_bounds__(MERGE_CH * MERGE_LANES)
batch_stats_merge_kernel(const float* __restrict__ partial,
                         float* __restrict__ var, float* __restrict__ mean,
                         long long M, int C, long long rows_per_chunk,
                         int chunks) {
  __shared__ float s[3][MERGE_LANES][MERGE_CH];
  const int cx = threadIdx.x, lane = threadIdx.y;
  const int c = blockIdx.x * MERGE_CH + cx;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  if (c < C) {
    for (int k = lane; k < chunks; k += MERGE_LANES) {
      const float nb =
          (float)min(rows_per_chunk, M - (long long)k * rows_per_chunk);
      const float* p = partial + (long long)k * 2 * C;
      chan(n, mu, m2, nb, p[c], p[C + c]);
    }
  }
  s[0][lane][cx] = n;
  s[1][lane][cx] = mu;
  s[2][lane][cx] = m2;
  __syncthreads();
  for (int h = MERGE_LANES / 2; h >= 1; h /= 2) {
    if (lane < h) {
      float na = s[0][lane][cx], ma = s[1][lane][cx], m2a = s[2][lane][cx];
      chan(na, ma, m2a, s[0][lane + h][cx], s[1][lane + h][cx],
           s[2][lane + h][cx]);
      s[0][lane][cx] = na;
      s[1][lane][cx] = ma;
      s[2][lane][cx] = m2a;
    }
    __syncthreads();
  }
  if (lane == 0 && c < C) {
    mean[c] = s[1][0][cx];
    var[c] = s[2][0][cx] / (float)M;
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
batch_stats_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ gvar,
                       const float* __restrict__ gmean,
                       __nv_bfloat16* __restrict__ dx, long long M, int C,
                       int ct, long long rows_per_chunk, float two_over_m,
                       float inv_m) {
  const int tid = threadIdx.x;
  const int rp = THREADS / ct;
  const int tc = tid % ct, tr = tid / ct;
  const int c0 = (blockIdx.x * ct + tc) * V;
  if (c0 >= C) return;
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(M, r0 + rows_per_chunk);
  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = __fmul_rn(gvar[c0 + k], two_over_m);
    b[k] = __fsub_rn(__fmul_rn(gmean[c0 + k], inv_m),
                     __fmul_rn(a[k], mean[c0 + k]));
  }
  for (long long r = r0 + tr; r < r1; r += (long long)rp * UNROLL) {
    Raw<V> raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * rp < r1) raw[u] = load_raw<V>(x + (r + u * rp) * C + c0);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * rp >= r1) break;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = __fadd_rn(__fmul_rn(a[k], widen<V>(raw[u], k)), b[k]);
      store_row<V>(dx + (r + u * rp) * C + c0, o);
    }
  }
}

// The block layout for C channels at V per thread: CT thread columns (a
// power of two, at most MAX_CT), and the slabs of CT * V channels.
struct Layout {
  int ct, slabs;
  Layout(int C, int V) {
    const int cols = (C + V - 1) / V;
    ct = 1;
    while (ct < cols && ct < MAX_CT) ct *= 2;
    slabs = (cols + ct - 1) / ct;
  }
};

bool valid(long long M, int C, long long rows_per_chunk, int chunks) {
  return M > 0 && C > 0 && rows_per_chunk > 0 && chunks > 0 &&
         chunks <= 65535 && (long long)chunks * rows_per_chunk >= M &&
         (long long)(chunks - 1) * rows_per_chunk < M;
}

}  // namespace

extern "C" {

// x: (M, C) bfloat16 contiguous; partial: (chunks, 2, C) float32 scratch;
// var, mean: (C,) float32.  chunks = ceil(M / rows_per_chunk).
int batch_stats_fwd_bf16_sm90(int device, const void* x, void* partial,
                              void* var, void* mean, long long M, int C,
                              long long rows_per_chunk, int chunks,
                              void* stream) {
  if (!valid(M, C, rows_per_chunk, chunks)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* part = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 == 0 && ((uintptr_t)x & 15) == 0) {
    const Layout l(C, 8);
    batch_stats_welford_kernel<8><<<dim3(l.slabs, chunks), THREADS, 0, s>>>(
        xb, part, M, C, l.ct, rows_per_chunk);
  } else {
    const Layout l(C, 1);
    batch_stats_welford_kernel<1><<<dim3(l.slabs, chunks), THREADS, 0, s>>>(
        xb, part, M, C, l.ct, rows_per_chunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  batch_stats_merge_kernel<<<(C + MERGE_CH - 1) / MERGE_CH,
                             dim3(MERGE_CH, MERGE_LANES), 0, s>>>(
      part, static_cast<float*>(var), static_cast<float*>(mean), M, C,
      rows_per_chunk, chunks);
  return (int)cudaGetLastError();
}

// x, dx: (M, C) bfloat16 contiguous; mean, gvar, gmean: (C,) float32.
int batch_stats_bwd_bf16_sm90(int device, const void* x, const void* mean,
                              const void* gvar, const void* gmean, void* dx,
                              long long M, int C, long long rows_per_chunk,
                              int chunks, void* stream) {
  if (!valid(M, C, rows_per_chunk, chunks)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float two_over_m = (float)(2.0 / (double)M);
  const float inv_m = (float)(1.0 / (double)M);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* db = static_cast<__nv_bfloat16*>(dx);
  const auto* mu = static_cast<const float*>(mean);
  const auto* gv = static_cast<const float*>(gvar);
  const auto* gm = static_cast<const float*>(gmean);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 == 0 && (((uintptr_t)x | (uintptr_t)dx) & 15) == 0) {
    const Layout l(C, 8);
    batch_stats_bwd_kernel<8><<<dim3(l.slabs, chunks), THREADS, 0, s>>>(
        xb, mu, gv, gm, db, M, C, l.ct, rows_per_chunk, two_over_m, inv_m);
  } else {
    const Layout l(C, 1);
    batch_stats_bwd_kernel<1><<<dim3(l.slabs, chunks), THREADS, 0, s>>>(
        xb, mu, gv, gm, db, M, C, l.ct, rows_per_chunk, two_over_m, inv_m);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
