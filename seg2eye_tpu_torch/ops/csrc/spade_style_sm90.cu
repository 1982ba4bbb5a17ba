// Fused SPADE+Style norm for Hopper (sm_90a), forward, bfloat16, on the
// tensor cores (wgmma) with TMA loads.
//
// Replaces the Pallas TPU kernel seg2eye_tpu/ops/pallas/spade_style.py
// (_kernel, launched by _fused_forward) for bfloat16, the default compute
// dtype; float32 stays on the FFMA kernel of spade_style.cu, since tensor
// cores in float32 would mean TF32.  One launch computes one norm site:
//
//   gamma|beta = sum over the 9 taps of actv[y+dy-1, x+dx-1, :128] @ W[tap]
//                + bcat                        (f32 accumulation, zero padding)
//   out = ((x - mean) * rsqrt(var + eps) * (1 + gamma) + beta
//          + x * (s0 + 1) + s1) / 2           (f32, stored as bf16)
//
// gamma and beta never reach device memory.
//
// What bounds it on this card: 2 * 1152 * 2C flops per pixel against
// (2C + 128) * 2 bytes of x, out and actv, far above the H100's balance
// point in bf16 (about 295 flops per byte), so the tensor cores.
//
// Design, one block = 128 output pixels x BN / 2 channels of one sample:
//   * GEMM view: M = 128 pixels laid out as a TH x TW tile (TW = 8 or 16,
//     TH = 128 / TW), N = BN columns of interleaved (gamma_c, beta_c),
//     K = 9 taps x 128 actv channels.  BN = 256 (128 channels), or 128
//     where 2C <= 128, so that the C = 64 site fills its N tile.
//   * A, the haloed actv tile (TH+2) x (TW+2) x 128, is loaded once by TMA
//     from a 4-D tensor map over actv (N,H,W,128): two 64-channel boxes
//     with the 128-byte swizzle.  TMA fills the box elements outside the
//     image (negative coordinates included) with zeros, which is torch's
//     zero padding, with no padded copy.  A tap is the same tile shifted by
//     (dy, dx) pixels; a one-pixel shift breaks wgmma's 8-row core matrices
//     in shared memory, so A goes through registers: ldmatrix.x4 takes one
//     row address per lane, and each lane points at its shifted pixel
//     (un-swizzling the address).
//   * B, one tap's weights for 64 of the 128 k (64 x BN bf16, 32 KB at
//     BN = 256), streams by TMA through a ring of STAGES stages with
//     full/empty mbarriers, from pack_weights' K-major (9, 2C_pad, 128)
//     layout with the 128-byte swizzle.  The whole weight tensor (at most
//     4.7 MB) stays in the 50 MB L2 across blocks.
//   * wgmma.m64nBNk16 (f32 += bf16 x bf16, A from registers): two consumer
//     warpgroups of 64 rows each, and a producer warpgroup of which one
//     thread issues the TMA loads.  setmaxnreg moves registers from the
//     producer (40) to the consumers (232), which hold BN / 2 accumulators
//     and two sets of A fragments.  One k-step's wgmmas stay in flight
//     while the next step's A fragments are loaded and its wgmmas issued.
//   * Epilogue on the accumulators: wgmma gives each thread the column pair
//     (2j, 2j+1) of its rows, which is (gamma_c, beta_c) of one channel, so
//     the epilogue of spade_style.cu runs on registers.  While the
//     consumers run the mainloop, three idle warps of the producer
//     warpgroup stage the x tile (128 pixels x BN / 2 channels, 16-byte
//     loads) and the per-channel mean, rstd, style and bias in shared
//     memory.  The consumers compute out in place over the x tile, then
//     write it with 16-byte stores: a quad of threads holds 4 neighbouring
//     channels of 8 pixels, whose 2-byte accesses straight to device
//     memory would coalesce badly.  Ragged pixels and channels are masked
//     (2-byte accesses where C is not a multiple of 8).
// Any H, W and C work.  One block per SM (384 threads at up to 168
// registers each; 212 KB of shared memory at BN = 256, 131 KB at 128); a
// persistent grid that overlaps one tile's epilogue with the next tile's
// mainloop is later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NHIDDEN = 128;                 // SPADE hidden width (actv channels)
constexpr int BM = 128;                      // output pixels per block
constexpr int BK = 64;                       // k per stage: one 128-byte row
constexpr int KSTEPS = 9 * NHIDDEN / BK;     // 18: (tap, half of the k)
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPGROUPS = 2;       // 64 rows each
constexpr int CONSUMER_WARPS = 4 * CONSUMER_WARPGROUPS;
constexpr int THREADS = 128 * (CONSUMER_WARPGROUPS + 1);   // + the producer
constexpr int STAGERS = 96;      // producer threads that stage x and params
// registers per thread after setmaxnreg: 128 * 40 + 256 * 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROW_BYTES = BK * 2;            // one swizzled 128-byte row

static_assert(BM == 64 * CONSUMER_WARPGROUPS, "one warpgroup per 64 rows");

__host__ __device__ constexpr uint32_t halo_box_bytes(int tw_log2) {
  return (uint32_t)((BM >> tw_log2) + 2) * ((1 << tw_log2) + 2) * ROW_BYTES;
}
__host__ __device__ constexpr uint32_t align1024(uint32_t v) {
  return (v + 1023u) & ~1023u;
}
__host__ __device__ constexpr uint32_t b_stage_bytes(int bn) {
  return (uint32_t)bn * BK * 2;
}
// a row of the x/out tile: BN / 2 bf16 channels plus 16 bytes, so that the
// 8 rows a warp touches at once fall in different banks
__host__ __device__ constexpr uint32_t x_row_bytes(int bn) {
  return (uint32_t)bn + 16;
}
constexpr int NPARAMS = 6;       // per channel: mean, rstd, s0 + 1, s1, bg, bb
// B stages, the two halo boxes, the x/out tile, the per-channel params and
// the mbarriers, plus the slack that aligns the start to 1024 bytes (the
// 128-byte swizzle's period).
__host__ __device__ constexpr uint32_t smem_bytes(int tw_log2, int bn) {
  return STAGES * b_stage_bytes(bn) +
         2 * align1024(halo_box_bytes(tw_log2)) + BM * x_row_bytes(bn) +
         NPARAMS * (bn / 2) * 4 + 8 * (2 * STAGES + 2) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused in this mode.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Barrier 1 over the two consumer warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * CONSUMER_WARPS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most `pending` committed wgmma groups are in flight.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(pending) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it cannot see that the registers change later).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32, this thread's 128) += a (64 x 16 bf16, registers) @ B
// (16 x 256 bf16, K-major in shared memory at `desc`).
__device__ __forceinline__ void wgmma(float (&d)[128], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131},"
      " %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The same with N = 128: d is 64 x 128 f32, this thread's 64.
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67},"
      " %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// tm_actv: actv (N, H, W, 128) bf16, box (64, TW+2, TH+2, 1).
// tm_w: pack_weights' (9 * np_cols, 128) bf16, box (64, BN): row
// tap * np_cols + j holds column j of that tap, j = 2c + (0 gamma | 1 beta).
// x, out: (N, H, W, C) bf16.  style: (N, 2C) f32 [s0|s1].  mean, var:
// (N, C) f32.  bcat: (C, 2) f32.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
spade_style_sm90_kernel(const __grid_constant__ CUtensorMap tm_actv,
                        const __grid_constant__ CUtensorMap tm_w,
                        const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ style,
                        const float* __restrict__ mean,
                        const float* __restrict__ var,
                        const float* __restrict__ bcat,
                        __nv_bfloat16* __restrict__ out, int H, int W, int C,
                        int np_cols, int tw_log2, int tiles_w, float eps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // generic
  const int tw = 1 << tw_log2;
  const int halo_w = tw + 2;
  const uint32_t halo_bytes = halo_box_bytes(tw_log2);
  const uint32_t halo_stride = align1024(halo_bytes);
  constexpr uint32_t B_STAGE_BYTES = b_stage_bytes(BN);
  const uint32_t b_smem = base;                         // STAGES x B stage
  const uint32_t a_smem = base + STAGES * B_STAGE_BYTES;   // 2 halo boxes
  constexpr uint32_t X_ROW = x_row_bytes(BN);
  constexpr int COLS = BN / 2;                  // channels in the tile
  uint8_t* const x_tile = gbase + (a_smem - base) + 2 * halo_stride;
  float* const params = reinterpret_cast<float*>(x_tile + BM * X_ROW);
  const uint32_t bars = smem_u32(params + NPARAMS * COLS);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t halo_bar = bars + 16 * STAGES;
  const uint32_t x_bar = halo_bar + 8;

  const int n = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_w) * (BM >> tw_log2);
  const int x0 = (blockIdx.x % tiles_w) * tw;
  const int col0 = blockIdx.y * BN;
  const int c_base = col0 / 2;                  // first channel of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // x and out in 16-byte vectors of 8 channels where rows allow it
  const bool vec = (C & 7) == 0 &&
                   (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  // device-memory element of tile row m, channel c_base + c; -1 outside
  auto elem = [&](int m, int c) -> long long {
    const int gy = y0 + (m >> tw_log2), gx = x0 + (m & (tw - 1));
    if (gy >= H || gx >= W || c_base + c >= C) return -1;
    return (((long long)n * H + gy) * W + gx) * C + c_base + c;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMER_WARPS);
    }
    mbar_init(halo_bar, 1);
    mbar_init(x_bar, STAGERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {                 // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp > CONSUMER_WARPS) {                // stage x and the params
      const int t = threadIdx.x - 32 * (CONSUMER_WARPS + 1);
      if (vec) {
        for (int v = t; v < BM * COLS / 8; v += STAGERS) {
          const int m = v / (COLS / 8), c = 8 * (v % (COLS / 8));
          const long long e = elem(m, c);
          const uint4 val = e < 0 ? make_uint4(0, 0, 0, 0)
                                  : __ldg(reinterpret_cast<const uint4*>(x + e));
          *reinterpret_cast<uint4*>(x_tile + m * X_ROW + 2 * c) = val;
        }
      } else {
        for (int v = t; v < BM * COLS; v += STAGERS) {
          const int m = v / COLS, c = v % COLS;
          const long long e = elem(m, c);
          reinterpret_cast<__nv_bfloat16*>(x_tile + m * X_ROW)[c] =
              e < 0 ? __float2bfloat16(0.f) : x[e];
        }
      }
      for (int c = t; c < COLS; c += STAGERS) {
        const int ch = c_base + c;
        const bool in = ch < C;
        const size_t nc = (size_t)n * C + ch, ns = (size_t)n * 2 * C + ch;
        params[0 * COLS + c] = in ? mean[nc] : 0.f;
        params[1 * COLS + c] = in ? rsqrtf(var[nc] + eps) : 0.f;
        params[2 * COLS + c] = in ? style[ns] + 1.f : 0.f;
        params[3 * COLS + c] = in ? style[ns + C] : 0.f;
        params[4 * COLS + c] = in ? bcat[2 * ch] : 0.f;
        params[5 * COLS + c] = in ? bcat[2 * ch + 1] : 0.f;
      }
      mbar_arrive(x_bar);
    } else if (threadIdx.x == 32 * CONSUMER_WARPS) {   // the TMA issuer
      mbar_expect_tx(halo_bar, 2 * halo_bytes);
      for (int h = 0; h < 2; ++h)
        tma_load_4d(a_smem + h * halo_stride, &tm_actv, halo_bar, h * BK,
                    x0 - 1, y0 - 1, n);
      for (int s = 0; s < KSTEPS; ++s) {
        const int st = s % STAGES;
        if (s >= STAGES) mbar_wait(empty_bar(st), ((s / STAGES) - 1) & 1);
        mbar_expect_tx(full_bar(st), B_STAGE_BYTES);
        tma_load_2d(b_smem + st * B_STAGE_BYTES, &tm_w, full_bar(st),
                    (s & 1) * BK, (s >> 1) * np_cols + col0);
      }
    }
  } else {                                      // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    // warpgroup wg owns tile rows 64 wg .. 64 wg + 63
    const int wg = warp / 4;
    // the A row this lane addresses for ldmatrix, and its 8-k half
    const int m_lane = wg * 64 + (warp % 4) * 16 + (lane & 15);
    const int a_row0 = (m_lane >> tw_log2) * halo_w + (m_lane & (tw - 1));
    const int kc = lane >> 4;

    // A fragments of k-step s: tap s / 2 (dy, dx) over the 64 channels of
    // halo box s % 2, four 16-wide k slices
    auto load_a = [&](uint32_t (&a)[4][4], int s) {
      const int tap = s >> 1;
      const int r = a_row0 + (tap / 3) * halo_w + tap % 3;
      const uint32_t row = a_smem + (s & 1) * halo_stride + r * ROW_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(a[kk], row + (((2 * kk + kc) ^ (r & 7)) << 4));
    };

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    uint32_t a[2][4][4];
    mbar_wait(halo_bar, 0);
    load_a(a[0], 0);
    // step s: issue its wgmmas, then wait for step s - 1's, release its B
    // stage and load step s + 1's A into the registers step s - 1 read
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const int st = s % STAGES;
      mbar_wait(full_bar(st), (s / STAGES) & 1);
      fence_acc(acc);
      wgmma_fence();
      const uint64_t desc = sw128_desc(b_smem + st * B_STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)      // 16 k = 32 bytes = 2 desc units
        wgmma(acc, a[s & 1][kk], desc + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (s > 0 && lane == 0) mbar_arrive(empty_bar((s - 1) % STAGES));
      if (s + 1 < KSTEPS) load_a(a[(s + 1) & 1], s + 1);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: acc[4i + 2h + j] is row (lane / 4) + 8h of this warp's 16,
    // column col0 + 8i + 2 (lane % 4) + j, i.e. tile channel
    // 4i + lane % 4, gamma for j = 0 and beta for j = 1; out is written
    // over x in the tile
    const int m0 = wg * 64 + (warp % 4) * 16 + (lane >> 2);
    mbar_wait(x_bar, 0);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 4 * i + (lane & 3);
      const float m = params[c], rstd = params[COLS + c];
      const float s0p1 = params[2 * COLS + c], s1 = params[3 * COLS + c];
      const float bg = params[4 * COLS + c], bb = params[5 * COLS + c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* const p =
            reinterpret_cast<__nv_bfloat16*>(x_tile + (m0 + 8 * h) * X_ROW) + c;
        const float xv = __bfloat162float(*p);
        const float gamma = acc[4 * i + 2 * h] + bg;
        const float beta = acc[4 * i + 2 * h + 1] + bb;
        const float spade = (xv - m) * rstd * (1.f + gamma) + beta;
        const float adain = xv * s0p1 + s1;
        *p = __float2bfloat16((spade + adain) * 0.5f);
      }
    }
    consumer_sync();
    const int t = threadIdx.x;
    if (vec) {
      for (int v = t; v < BM * COLS / 8; v += 32 * CONSUMER_WARPS) {
        const int m = v / (COLS / 8), c = 8 * (v % (COLS / 8));
        const long long e = elem(m, c);
        if (e >= 0)
          *reinterpret_cast<uint4*>(out + e) =
              *reinterpret_cast<const uint4*>(x_tile + m * X_ROW + 2 * c);
      }
    } else {
      for (int v = t; v < BM * COLS; v += 32 * CONSUMER_WARPS) {
        const int m = v / COLS, c = v % COLS;
        const long long e = elem(m, c);
        if (e >= 0)
          out[e] = reinterpret_cast<const __nv_bfloat16*>(x_tile + m * X_ROW)[c];
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library does not link against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

constexpr int ERR_NO_TENSOR_MAP = -1;    // see seg2eye_cuda_error_string
constexpr int ERR_TENSOR_MAP = -2;

}  // namespace

extern "C" {

// actv, x, out: (N, H, W, 128|C|C) bf16 contiguous, actv 16-byte aligned.
// wcat: (9, np_cols, 128) bf16 with np_cols = 2C rounded up to the N tile.
int spade_style_fwd_bf16_sm90(int device, const void* actv, const void* x,
                              const void* style, const void* mean,
                              const void* var, const void* wcat,
                              const void* bcat, void* out, int N, int H,
                              int W, int C, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_TENSOR_MAP;

  // the N tile: 128 columns where 2C fits in them, else 256; the packed
  // weights' columns are 2C rounded up to it (pack_weights does the same)
  const int bn = 2 * C <= 128 ? 128 : 256;
  const int np_cols = (2 * C + bn - 1) / bn * bn;
  const int tw_log2 = W <= 8 ? 3 : 4;
  const int tw = 1 << tw_log2, th = BM >> tw_log2;
  const cuuint32_t ones[4] = {1, 1, 1, 1};

  CUtensorMap tm_actv, tm_w;
  const cuuint64_t a_dim[4] = {NHIDDEN, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t a_stride[3] = {NHIDDEN * 2, (cuuint64_t)W * NHIDDEN * 2,
                                  (cuuint64_t)H * W * NHIDDEN * 2};
  const cuuint32_t a_box[4] = {BK, (cuuint32_t)tw + 2, (cuuint32_t)th + 2, 1};
  if (encode(&tm_actv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(actv), a_dim, a_stride, a_box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  const cuuint64_t w_dim[2] = {NHIDDEN, (cuuint64_t)9 * np_cols};
  const cuuint64_t w_stride[1] = {NHIDDEN * 2};
  const cuuint32_t w_box[2] = {BK, (cuuint32_t)bn};
  if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(wcat), w_dim, w_stride, w_box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;

  auto kernel = bn == 128 ? spade_style_sm90_kernel<128>
                          : spade_style_sm90_kernel<256>;
  const uint32_t smem = smem_bytes(tw_log2, bn);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + tw - 1) / tw;
  const int tiles_h = (H + th - 1) / th;
  const dim3 grid(tiles_h * tiles_w, np_cols / bn, N);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tm_actv, tm_w, (const __nv_bfloat16*)x, (const float*)style,
      (const float*)mean, (const float*)var, (const float*)bcat,
      (__nv_bfloat16*)out, H, W, C, np_cols, tw_log2, tiles_w, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
