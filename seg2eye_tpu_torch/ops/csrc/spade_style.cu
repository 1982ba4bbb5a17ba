// Fused SPADE+Style norm for Hopper (sm_90a), forward, float32.
//
// Replaces the Pallas TPU kernel seg2eye_tpu/ops/pallas/spade_style.py
// (_kernel, launched by _fused_forward) for float32; bfloat16 runs on the
// tensor cores in spade_style_sm90.cu.  One launch computes one norm site:
//
//   gamma|beta = sum over the 3x3 taps of actv[y+dy-1, x+dx-1, :128] @ wcat[dy,dx]
//                + bcat                        (f32 accumulation, zero padding)
//   out = ((x - mean) * rsqrt(var + eps) * (1 + gamma) + beta
//          + x * (s0 + 1) + s1) / 2           (f32)
//
// with actv = relu(conv3x3(seg)) computed outside the kernel (as on the TPU).
// gamma and beta never reach device memory.
//
// What bounds it on this card: the gamma|beta products, 2*H*W*1152*2C flops
// per image and site, about 233 GFLOP per 320x256 image over the generator's
// 18 sites, against a few hundred MB of x/out/actv traffic per image: far
// above the balance point, so compute.  In float32 the tensor cores would
// mean TF32, not the JAX package's float32, so this kernel stays on the
// FP32 pipes (FFMA, 67 TFLOP/s peak) as an implicit GEMM.
//
// Design:
//   * one block per (pixel tile TH x TW, channel tile of CT channels, n);
//   * each k-step stages KC of the 128 actv channels for the haloed
//     (TH+2) x (TW+2) tile, and the matching 9 x KC x 2CT weight slice, in
//     shared memory.  Halo loads outside the image read as zero,
//     which is torch's conv zero padding; there is no padded copy of actv;
//   * each thread owns PX neighbouring pixels of one row and CX channels,
//     and both gamma[c] and beta[c] of each, so the epilogue runs on its
//     registers;
//   * ragged tiles (any H, W, C) are masked.
// Shared memory is 80 KB a block, above the 48 KB default, so each launch
// opts in with cudaFuncSetAttribute.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NHIDDEN = 128;          // SPADE hidden width (actv channels)
constexpr int TH = 8, TW = 8;         // pixel tile
constexpr int CT = 64;                // channels per block (128 GEMM columns)
constexpr int KC = 16;                // actv channels staged per k-step
constexpr int THREADS = 256;          // 16 channel groups x 16 pixel groups
constexpr int PX = 4;                 // pixels per thread, along W
constexpr int CX = 4;                 // channels per thread
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int WCOLS = 2 * CT;         // gamma|beta columns per k row
constexpr int W_SMEM = 9 * KC * WCOLS;
constexpr int A_SMEM = KC * HALO_H * HALO_W;
constexpr size_t SMEM_BYTES = (W_SMEM + A_SMEM) * sizeof(float);

static_assert(THREADS == (CT / CX) * (TH * TW / PX), "thread map");
static_assert(TW == 2 * PX, "two pixel groups per tile row");

// Shared-memory slot of gamma|beta column j (= 2 * local channel + half) in
// a k row.  Thread t owns local channels 4t..4t+3: their (gamma, beta) pairs
// for channels 4t, 4t+1 sit at 4t..4t+3 and for 4t+2, 4t+3 at 64+4t..64+4t+3,
// so each thread reads two float4s and eight neighbouring threads read 128
// contiguous bytes (no bank conflicts).
__device__ __forceinline__ int wslot(int j) {
  const int lc = j >> 1, half = j & 1;
  const int t = lc / CX, ci = lc % CX;
  return (ci < 2) ? (t * 4 + ci * 2 + half) : (CT + t * 4 + (ci - 2) * 2 + half);
}

// actv, x, out: (N, H, W, 128|C|C) f32 contiguous.  style: (N, 2C) f32 [s0|s1].
// mean, var: (N, C) f32.  wcat: (3, 3, 128, C, 2) [gamma|beta interleaved].
// bcat: (C, 2) f32.
__global__ void __launch_bounds__(THREADS)
spade_style_kernel(const float* __restrict__ actv, const float* __restrict__ x,
                   const float* __restrict__ style,
                   const float* __restrict__ mean,
                   const float* __restrict__ var,
                   const float* __restrict__ wcat,
                   const float* __restrict__ bcat, float* __restrict__ out,
                   int H, int W, int C, int tiles_w, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                  // [9][KC][WCOLS], slots per wslot()
  float* asm_ = smem + W_SMEM;        // [KC][HALO_H][HALO_W]

  const int n = blockIdx.z;
  const int c_base = blockIdx.y * CT;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;

  const int tid = threadIdx.x;
  const int tx = tid % (CT / CX);     // channel group
  const int ty = tid / (CT / CX);     // pixel group
  const int py = ty >> 1;             // tile row
  const int px0 = (ty & 1) * PX;      // first tile column

  float acc[PX][CX][2];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < CX; ++c) acc[p][c][0] = acc[p][c][1] = 0.f;

  for (int k0 = 0; k0 < NHIDDEN; k0 += KC) {
    __syncthreads();                  // the previous k-step is consumed
    for (int i = tid; i < W_SMEM; i += THREADS) {
      const int j = i % WCOLS;
      const int r = i / WCOLS;        // tap * KC + k
      const int k = r % KC, tap = r / KC;
      const int c = c_base + (j >> 1);
      float v = 0.f;
      if (c < C)
        v = wcat[((size_t)(tap * NHIDDEN + k0 + k) * C + c) * 2 + (j & 1)];
      wsm[r * WCOLS + wslot(j)] = v;
    }
    for (int i = tid; i < A_SMEM; i += THREADS) {
      const int k = i % KC;
      const int pix = i / KC;
      const int xx = pix % HALO_W, yy = pix / HALO_W;
      const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = actv[(((size_t)n * H + gy) * W + gx) * NHIDDEN + k0 + k];
      asm_[(k * HALO_H + yy) * HALO_W + xx] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* arow = asm_ + (k * HALO_H + py + dy) * HALO_W + px0;
        float a[PX + 2];
#pragma unroll
        for (int q = 0; q < PX + 2; ++q) a[q] = arow[q];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wrow = wsm + ((dy * 3 + dx) * KC + k) * WCOLS;
          const float4 w0 = reinterpret_cast<const float4*>(wrow)[tx];
          const float4 w1 = reinterpret_cast<const float4*>(wrow + CT)[tx];
          const float wv[2 * CX] = {w0.x, w0.y, w0.z, w0.w,
                                    w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int c = 0; c < CX; ++c) {
              acc[p][c][0] = fmaf(a[p + dx], wv[2 * c], acc[p][c][0]);
              acc[p][c][1] = fmaf(a[p + dx], wv[2 * c + 1], acc[p][c][1]);
            }
        }
      }
    }
  }

  const int gy = y0 + py;
  if (gy >= H) return;
#pragma unroll
  for (int c = 0; c < CX; ++c) {
    const int ch = c_base + tx * CX + c;
    if (ch >= C) continue;
    const float m = mean[(size_t)n * C + ch];
    const float rstd = rsqrtf(var[(size_t)n * C + ch] + eps);
    const float s0 = style[(size_t)n * 2 * C + ch];
    const float s1 = style[(size_t)n * 2 * C + C + ch];
    const float bg = bcat[2 * ch], bb = bcat[2 * ch + 1];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int gx = x0 + px0 + p;
      if (gx >= W) continue;
      const size_t idx = (((size_t)n * H + gy) * W + gx) * C + ch;
      const float xv = x[idx];
      const float gamma = acc[p][c][0] + bg;
      const float beta = acc[p][c][1] + bb;
      const float spade = (xv - m) * rstd * (1.f + gamma) + beta;
      const float adain = xv * (s0 + 1.f) + s1;
      out[idx] = (spade + adain) * 0.5f;
    }
  }
}

}  // namespace

extern "C" {

int spade_style_fwd_f32(int device, const void* actv, const void* x,
                        const void* style, const void* mean, const void* var,
                        const void* wcat, const void* bcat, void* out, int N,
                        int H, int W, int C, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(spade_style_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (C + CT - 1) / CT, N);
  spade_style_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)actv, (const float*)x, (const float*)style,
      (const float*)mean, (const float*)var, (const float*)wcat,
      (const float*)bcat, (float*)out, H, W, C, tiles_w, eps);
  return (int)cudaGetLastError();
}

// Error codes of every entry point of the library: CUDA runtime errors, and
// the negative codes of spade_style_fwd_bf16_sm90's tensor-map encoding.
const char* seg2eye_cuda_error_string(int err) {
  if (err == -1)
    return "cuTensorMapEncodeTiled is not available (TMA needs CUDA 12 or "
           "later)";
  if (err == -2) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
