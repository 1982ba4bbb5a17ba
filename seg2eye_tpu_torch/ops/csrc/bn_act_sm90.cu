// Eval-mode batch norm, residual add and ReLU in one pass, for Hopper
// (sm_90a).
//
// No TPU kernel: XLA fuses the JAX package's BN, add and ReLU.  In PyTorch
// the same chain is three passes (F.batch_norm on the running statistics,
// the add, torch.relu), each reading and writing its tensor in bfloat16.
// This kernel computes
//
//   y = relu( x s + t  [ + r  |  + r s2 + t2 ] ),
//   s = w / sqrt(var + eps),  t = b - mean s   (s2, t2 of r's own BN)
//
// in float32 from one read of x and of r, and writes y once, rounded once
// to bfloat16.  s and t come from the BN's four float32 (C,) vectors, in
// each thread for its own channels, so no launch computes them first.
//
// Two layouts of an (N, C, H, W) bfloat16 tensor, x, r and y in the same
// one, every pointer 16-byte aligned (ops/bn_act.planes says which; it
// raises on anything else):
//
//   rows (bn_act_kernel): channels_last, seen as (M, C) with M = N H W and
//   C a multiple of 8.  A block of THREADS threads covers CT * 8 channels (a
//   slab) of RP = THREADS / CT rows at a time; each thread owns 8
//   consecutive channels (one 16-byte vector a row), keeps their s and t in
//   registers and walks the rows with a grid stride, UNROLL rows' loads in
//   flight before any store.
//
//   planes (bn_act_kernel_planes): contiguous NCHW, seen as N C planes of
//   L = H W elements, plane p of channel p % C.  A warp walks one plane at
//   a time with a grid stride over the planes, the plane's s and t in
//   registers: in 16-byte vectors, UNROLL a lane in flight, where L is a
//   multiple of 8 (every plane then 16-byte aligned), else element by
//   element.
//
// The grid is at most BLOCKS_PER_SM resident blocks per SM.
//
// What bounds it: the bytes, 2 per element read of x, of r where there is
// one, and 2 written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2048 resident threads per SM
constexpr int UNROLL = 4;          // rows a thread loads before it stores
constexpr int V = 8;               // channels a thread owns: one uint4

// what is added before the ReLU
constexpr int RES_NONE = 0;        // nothing
constexpr int RES_PLAIN = 1;       // r
constexpr int RES_AFFINE = 2;      // r s2 + t2, r's own BN

// Value k of 8 packed bfloat16, widened to float32 (exact).
__device__ __forceinline__ float widen(const uint4& u, int k) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(&u)[k >> 1];
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ uint4 pack(const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return u;
}

// s and t of channels c0 .. c0 + n - 1 from a BN's float32 vectors.
template <int n>
__device__ __forceinline__ void affine(const float* __restrict__ w,
                                       const float* __restrict__ b,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ var,
                                       float eps, int c0, float* s,
                                       float* t) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    s[k] = __fdiv_rn(w[c0 + k], __fsqrt_rn(__fadd_rn(var[c0 + k], eps)));
    t[k] = __fsub_rn(b[c0 + k], __fmul_rn(mean[c0 + k], s[k]));
  }
}

// relu(x s + t [+ r | + r s2 + t2]) of one element, in float32; NaN stays
// NaN, as torch.relu leaves it.
template <int RES>
__device__ __forceinline__ float act(float x, float r, float s, float t,
                                     float s2, float t2) {
  float v = fmaf(x, s, t);
  if constexpr (RES == RES_PLAIN) v += r;
  if constexpr (RES == RES_AFFINE) v += fmaf(r, s2, t2);
  return v < 0.f ? 0.f : v;
}

template <int RES>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ r,
              const float* __restrict__ w, const float* __restrict__ b,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ mean2,
              const float* __restrict__ var2, __nv_bfloat16* __restrict__ y,
              long long M, int C, int ct, float eps, float eps2) {
  const int rp = THREADS / ct;
  const int tc = threadIdx.x % ct, tr = threadIdx.x / ct;
  const int c0 = (blockIdx.y * ct + tc) * V;
  if (tr >= rp || c0 >= C) return;
  float s[V], t[V], s2[V], t2[V];
  affine<V>(w, b, mean, var, eps, c0, s, t);
  if constexpr (RES == RES_AFFINE)
    affine<V>(w2, b2, mean2, var2, eps2, c0, s2, t2);
  const long long stride = (long long)gridDim.x * rp;
  for (long long row = (long long)blockIdx.x * rp + tr; row < M;
       row += stride * UNROLL) {
    uint4 xv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = row + u * stride;
      if (i < M) {
        xv[u] = *reinterpret_cast<const uint4*>(x + i * C + c0);
        if constexpr (RES != RES_NONE)
          rv[u] = *reinterpret_cast<const uint4*>(r + i * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = row + u * stride;
      if (i >= M) break;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = act<RES>(widen(xv[u], k),
                        RES == RES_NONE ? 0.f : widen(rv[u], k), s[k], t[k],
                        RES == RES_AFFINE ? s2[k] : 0.f,
                        RES == RES_AFFINE ? t2[k] : 0.f);
      *reinterpret_cast<uint4*>(y + i * C + c0) = pack(o);
    }
  }
}

template <int RES>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel_planes(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ w, const float* __restrict__ b,
                     const float* __restrict__ mean,
                     const float* __restrict__ var,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ mean2,
                     const float* __restrict__ var2,
                     __nv_bfloat16* __restrict__ y, long long P, int C,
                     long long L, float eps, float eps2) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long p = (long long)blockIdx.x * WARPS + threadIdx.x / 32; p < P;
       p += warps) {
    const int c = (int)(p % C);
    float s, t, s2 = 0.f, t2 = 0.f;
    affine<1>(w, b, mean, var, eps, c, &s, &t);
    if constexpr (RES == RES_AFFINE)
      affine<1>(w2, b2, mean2, var2, eps2, c, &s2, &t2);
    const __nv_bfloat16* xp = x + p * L;
    const __nv_bfloat16* rp = r + (RES == RES_NONE ? 0 : p * L);
    __nv_bfloat16* yp = y + p * L;
    if (L % V) {
      for (long long i = lane; i < L; i += 32) {
        const float rv = RES == RES_NONE ? 0.f : __bfloat162float(rp[i]);
        yp[i] = __float2bfloat16_rn(
            act<RES>(__bfloat162float(xp[i]), rv, s, t, s2, t2));
      }
      continue;
    }
    const long long nv = L / V;
    for (long long v = lane; v < nv; v += 32 * UNROLL) {
      uint4 xv[UNROLL], rv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = v + u * 32;
        if (i < nv) {
          xv[u] = reinterpret_cast<const uint4*>(xp)[i];
          if constexpr (RES != RES_NONE)
            rv[u] = reinterpret_cast<const uint4*>(rp)[i];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = v + u * 32;
        if (i >= nv) break;
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k)
          o[k] = act<RES>(widen(xv[u], k),
                          RES == RES_NONE ? 0.f : widen(rv[u], k), s, t, s2,
                          t2);
        reinterpret_cast<uint4*>(yp)[i] = pack(o);
      }
    }
  }
}

template <int RES>
void launch(cudaStream_t s, int sms, const __nv_bfloat16* x,
            const __nv_bfloat16* r, const float* const* p, __nv_bfloat16* y,
            long long M, int C, long long L, float eps, float eps2) {
  const long long resident = (long long)sms * BLOCKS_PER_SM;
  if (L) {                                            // planes
    constexpr int WARPS = THREADS / 32;
    const long long gx = std::min((M + WARPS - 1) / WARPS, resident);
    bn_act_kernel_planes<RES><<<(unsigned)gx, THREADS, 0, s>>>(
        x, r, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], y, M, C, L,
        eps, eps2);
    return;
  }
  const int cols = C / V;                             // rows
  const int ct = std::min(cols, THREADS);
  const int slabs = (cols + ct - 1) / ct;
  const long long rp = THREADS / ct;
  const long long row_blocks = (M + rp * UNROLL - 1) / (rp * UNROLL);
  const long long gx = std::max(1LL, std::min(resident / slabs, row_blocks));
  bn_act_kernel<RES><<<dim3((unsigned)gx, (unsigned)slabs), THREADS, 0, s>>>(
      x, r, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], y, M, C, ct, eps,
      eps2);
}

}  // namespace

extern "C" {

// The launch's integers in one int64 array a (ctypes converts each
// argument of a call on its own, and this launch is all the host does at a
// site): a[0] device; a[1] x, a[2] r (0: no residual), a[3..6] w, b, mean,
// var of x's BN, a[7..10] those of r's BN (all 0: r added as it is),
// a[11] y; a[12] M, a[13] C, a[14] the card's SM count, a[15] the
// stream, a[16] L.  x, r, y bfloat16 contiguous: (M, C) rows where L is 0
// (C a multiple of 8), else M planes of L elements, plane p of channel
// p % C; the BN vectors (C,) float32.
int bn_act_bf16_sm90(const long long* a, float eps, float eps2) {
  const void* x = reinterpret_cast<const void*>(a[1]);
  const void* r = reinterpret_cast<const void*>(a[2]);
  void* y = reinterpret_cast<void*>(a[11]);
  const long long M = a[12], L = a[16];
  const int C = (int)a[13], sms = (int)a[14];
  if (M <= 0 || C <= 0 || L < 0 || (!L && C % V != 0) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)r | (uintptr_t)y;
  if (ptrs & 15) return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice((int)a[0]);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a[15]);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const float* p[8];
  for (int k = 0; k < 8; ++k) p[k] = reinterpret_cast<const float*>(a[3 + k]);
  const int res = r == nullptr ? RES_NONE
                  : p[4] == nullptr ? RES_PLAIN
                                    : RES_AFFINE;
  if (res == RES_NONE)
    launch<RES_NONE>(s, sms, xb, rb, p, yb, M, C, L, eps, eps2);
  else if (res == RES_PLAIN)
    launch<RES_PLAIN>(s, sms, xb, rb, p, yb, M, C, L, eps, eps2);
  else
    launch<RES_AFFINE>(s, sms, xb, rb, p, yb, M, C, L, eps, eps2);
  return (int)cudaGetLastError();
}

}  // extern "C"
