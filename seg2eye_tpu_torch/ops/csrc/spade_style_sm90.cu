// Fused SPADE+Style norm for Hopper (sm_90a), forward, on the tensor cores
// (wgmma) with TMA loads, in bfloat16 and in float32 (3xTF32).
//
// Replaces the Pallas TPU kernel seg2eye_tpu/ops/pallas/spade_style.py:83
// (_kernel, launched by _fused_forward) in both compute dtypes.  One launch
// computes one norm site:
//
//   gamma|beta = sum over the 9 taps of actv[y+dy-1, x+dx-1, :128] @ W[tap]
//                + bcat                        (f32 accumulation, zero padding)
//   out = ((x - mean) * rsqrt(var + eps) * (1 + gamma) + beta
//          + x * (s0 + 1) + s1) / 2           (f32, stored in x's dtype)
//
// gamma and beta never reach device memory.
//
// The same kernels, instantiated without the style term (STYLE = false,
// the *_nostyle kernels), compute plain SPADE for GauGAN's norm sites:
//
//   out = (x - mean) * rsqrt(var + eps) * (1 + gamma) + beta
//
// with no AdaIN term and no halving, and their backward with h = dout (no
// s0 term in dx).  The mainloop, the packed weights and the launch are the
// SPADE+Style kernels'; only the epilogues differ, at compile time.
//
// What bounds it on this card: 2 * 1152 * 2C flops per pixel against
// (2C + 128) elements of x, out and actv, far above the H100's balance
// point in either dtype, so the tensor cores: 989 TFLOP/s in bfloat16, and
// in float32 495 / 3 = 165 TFLOP/s, since each product takes three TF32
// passes.
//
// Why 3xTF32 in float32 and not one pass: a TF32 operand keeps 10 of
// float32's 23 mantissa bits, so one TF32 product is off by about 2^-11
// relative, some 1e-3 at gamma after 1152 terms, where the JAX package's
// float32 reference is exact to about 1e-6.  Each operand is split into
// hi = tf32(a) and lo = tf32(a - hi) (cvt.rna: round to nearest, ties away),
// and hi*hi + hi*lo + lo*hi is summed in float32; the dropped lo*lo and the
// rounding of lo are about 2^-22 relative, float32's own accuracy.  The
// weights are split once on the host (pack_weights), actv in registers
// after ldmatrix.  An unrounded float32 is not an option: the tensor core
// drops its low 13 bits, which would truncate hi and lose lo's precision.
// One more source of error remains: each wgmma adds its products to the
// accumulator with less than round-to-nearest float32 accuracy, and 432
// wgmmas into one accumulator drift by several float32 ulps of gamma
// (on an H100, 4 to 5 times the error of a full-float32 sum).  So each
// tap's 48 wgmmas start a fresh accumulator (scale-d = 0), which is then
// added to a float32 total with FADD (TF32_FLUSH_TAPS below;
// tools/tf32_flush_study.py measures the choice).
//
// Design, one block = 128 output pixels x BN / 2 channels of one sample,
// shared by the two dtypes through an operand trait (Bf16Operand,
// Tf32x3Operand):
//   * GEMM view: M = 128 pixels laid out as a TH x TW tile (TW = 8 or 16,
//     TH = 128 / TW), N = BN columns of interleaved (gamma_c, beta_c),
//     K = 9 taps x 128 actv channels.  bfloat16: BN = 256 (128 channels),
//     or 128 where 2C <= 128, so that the C = 64 site fills its N tile.
//     float32: BN = 128 always (shared memory, below).
//   * A, the haloed actv tile (TH+2) x (TW+2) x 128, is loaded once by TMA
//     from a 4-D tensor map over actv (N,H,W,128), in boxes of one 128-byte
//     row of channels (64 bf16 or 32 f32) with the 128-byte swizzle.  TMA
//     fills the box elements outside the image (negative coordinates
//     included) with zeros, which is torch's zero padding, with no padded
//     copy.  A tap is the same tile shifted by (dy, dx) pixels; a one-pixel
//     shift breaks wgmma's 8-row core matrices in shared memory, so A goes
//     through registers: ldmatrix.x4 takes one row address per lane, and
//     each lane points at its shifted pixel (un-swizzling the address).
//     The A fragment of wgmma k16 bf16 and of k8 tf32 is the same four 8x8
//     b16 matrices (rows g, g+8 by 16-byte k chunks), so one addressing
//     serves both; float32 then splits each value into hi and lo.
//   * B, one tap's weights for one 128-byte row of k (BN rows), streams by
//     TMA through a ring of STAGES stages with full/empty mbarriers, from
//     pack_weights' K-major layout with the 128-byte swizzle: bfloat16
//     (9, cols, 128), float32 (2, 9, cols, 128) holding hi then lo, both
//     loaded into one stage.  The whole weight tensor (at most 4.7 MB in
//     bfloat16, 18.9 MB in float32) stays in the 50 MB L2 across blocks.
//   * wgmma (f32 += A from registers x B from shared memory): bfloat16
//     m64nBNk16, one per 16 k; float32 m64n128k8, three per 8 k (hi*hi,
//     hi*lo, lo*hi).  Two consumer warpgroups of 64 rows each, and a
//     producer warpgroup of which one thread issues the TMA loads.
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232), which hold BN / 2 accumulators and two k-steps of A fragments.
//     One k-step's wgmmas stay in flight while the next step's A fragments
//     are loaded and its wgmmas issued.  The bfloat16 k loop (18 steps) is
//     unrolled; the float32 one (36 steps, 432 wgmmas per warpgroup) runs
//     one tap (4 steps) per trip, which keeps the build short, and waits
//     for all its wgmmas at the end of the trip to add the tap's sum to
//     the total (above).
//   * Epilogue on the accumulators: wgmma gives each thread the column pair
//     (2j, 2j+1) of its rows, which is (gamma_c, beta_c) of one channel.
//     While the consumers run the mainloop, three idle warps of the
//     producer warpgroup stage the x tile (128 pixels x BN / 2 channels,
//     16-byte loads) and the per-channel mean, rstd, style and bias in
//     shared memory.  The consumers compute out in place over the x tile,
//     then write it with 16-byte stores: a quad of threads holds 4
//     neighbouring channels of 8 pixels, whose narrow accesses straight to
//     device memory would coalesce badly.  Ragged pixels and channels are
//     masked (element accesses where C is not a multiple of 16 bytes).
//   * Shared memory: bfloat16 at BN = 256, 4 stages x 32 KB of B + 2 x 23
//     KB of halo + 34 KB of x tile = 212 KB; float32, 3 stages x 32 KB
//     (hi + lo at BN = 128) + 4 x 23 KB of halo + 34 KB of x tile = 225 KB,
//     within the 227 KB a block may use.  BN = 256 or a fourth stage would
//     not fit in float32.
// Any H, W and C work.  One block per SM (384 threads); a persistent grid
// that overlaps one tile's epilogue with the next tile's mainloop is later
// work.
//
// Backward, bfloat16 (spade_style_sm90_kernel_bwd).  It replaces no TPU
// kernel: the Pallas kernel's custom VJP rematerialises through the plain
// version, and so did the port, whose plain recompute (a dozen float32
// elementwise passes over every site's map and as many for their
// gradients) took 47% of a bf16 training step's device time on an H100.
// One launch per site, with h = dout / 2:
//
//   gamma = the forward's product with the gamma columns alone (beta's
//           value enters no gradient), in registers
//   dx     = h * ((1 + gamma) * rstd + s0 + 1)          -> x's dtype
//   dgamma = h * (x - mean) * rstd, dbeta = h           -> [dgamma | dbeta]
//   per block and channel, over its pixels (float32):  sum h, sum h (x - mean),
//   sum h (1 + gamma), sum h (1 + gamma) (x - mean)
//
// from which the wrapper forms the style, mean, var and bias gradients
// after a sum over the blocks (no atomics: the same order every run), and
// cuDNN the convs' dgrad and wgrad from [dgamma | dbeta].  What bounds it:
// 2 * 1152 * C flops per pixel against 128 + 5C bf16 values of actv, x,
// dout, dx and [dgamma | dbeta], so the memory.  Design: the forward's
// TMA + wgmma mainloop over the gamma-only packed weights (BN = C columns,
// 128, or 64 where C <= 64), while the producer's three idle warps stage the
// x and dout tiles by cp.async (16 bytes each, zero-filled outside the map)
// and write dbeta from the dout tile straight away.  The consumers then
// overwrite x with dx and dout with dgamma in shared memory, fold their
// sums over the rows with 7 shuffles per 8 channel pairs (a butterfly
// reduce-scatter), and write both tiles with 16-byte stores.  Shared
// memory at BN = 128: 4 stages x 16 KB of B + 2 x 23 KB of halo + 2 x 34 KB
// of tiles + 16 KB of per-warp sums = 197 KB.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NHIDDEN = 128;                 // SPADE hidden width (actv channels)
constexpr int BM = 128;                      // output pixels per block
constexpr int CONSUMER_WARPGROUPS = 2;       // 64 rows each
constexpr int CONSUMER_WARPS = 4 * CONSUMER_WARPGROUPS;
constexpr int THREADS = 128 * (CONSUMER_WARPGROUPS + 1);   // + the producer
constexpr int STAGERS = 96;      // producer threads that stage x and params
// registers per thread after setmaxnreg: 128 * 40 + 256 * 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROW_BYTES = 128;               // one swizzled row of k
constexpr int NPARAMS = 6;       // per channel: mean, rstd, s0 + 1, s1, bg, bb
// backward: per channel mean, rstd, s0 + 1, bg; sums per channel and block
constexpr int BWD_PARAMS = 4, BWD_SUMS = 4;
// float32: taps summed in one accumulator before it is added to the total
constexpr int TF32_FLUSH_TAPS = 1;
static_assert(9 % TF32_FLUSH_TAPS == 0, "the flush period divides the 9 taps");

static_assert(BM == 64 * CONSUMER_WARPGROUPS, "one warpgroup per 64 rows");

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

// 16 bytes from device to shared memory, asynchronously; the bytes past
// `src_bytes` (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// Waits for every cp.async of this thread.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
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

// The same with N = 64: d is 64 x 64 f32, this thread's 32.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35},"
      " %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128 f32, this thread's 64) = a (64 x 8 tf32, registers) @ B
// (8 x 128 tf32, K-major in shared memory at `desc`), + d unless
// `accumulate` is 0.  TF32 takes no transpose operand.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67},"
      " %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// float32 -> TF32 rounded to nearest, ties away from zero; the low 13 bits
// of the result are zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// What differs between the two dtypes.  BK: k per 128-byte row; PARTS: B
// tiles per stage and A fragments per k slice; mma: the wgmmas of one k
// slice (16 bf16 or 8 tf32 k, 32 bytes) into d, with B's first part at
// `desc` and the second at `desc_lo`; FLUSH_TAPS: taps summed in d before
// d is added to the total (0: d is the total).
struct Bf16Operand {
  using T = __nv_bfloat16;
  static constexpr int BK = 64;
  static constexpr int STAGES = 4;
  static constexpr int PARTS = 1;
  static constexpr int FLUSH_TAPS = 0;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ float to_float(T v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ T from_float(float v) {
    return __float2bfloat16(v);
  }
  // ldmatrix gives the bf16 A fragment as it is
  static __device__ __forceinline__ void split(uint32_t (&)[PARTS][4]) {}
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N],
                                             const uint32_t (&a)[PARTS][4],
                                             uint64_t desc, uint64_t, bool) {
    wgmma(d, a[0], desc);
  }
};

struct Tf32x3Operand {
  using T = float;
  static constexpr int BK = 32;
  static constexpr int STAGES = 3;
  static constexpr int PARTS = 2;              // hi, lo
  static constexpr int FLUSH_TAPS = TF32_FLUSH_TAPS;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static __device__ __forceinline__ float to_float(T v) { return v; }
  static __device__ __forceinline__ T from_float(float v) { return v; }
  // a[0] holds the float32 bits from ldmatrix -> a[0] = hi, a[1] = lo
  static __device__ __forceinline__ void split(uint32_t (&a)[PARTS][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = __uint_as_float(a[0][i]);
      const uint32_t hi = tf32_rna(v);
      a[1][i] = tf32_rna(v - __uint_as_float(hi));
      a[0][i] = hi;
    }
  }
  // `fresh`: the first wgmma overwrites d
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[PARTS][4],
                                             uint64_t desc_hi,
                                             uint64_t desc_lo, bool fresh) {
    wgmma_tf32(d, a[0], desc_hi, !fresh);
    wgmma_tf32(d, a[0], desc_lo, 1);
    wgmma_tf32(d, a[1], desc_hi, 1);
  }
};

__host__ __device__ constexpr uint32_t align1024(uint32_t v) {
  return (v + 1023u) & ~1023u;
}
__host__ __device__ constexpr uint32_t halo_box_bytes(int tw_log2) {
  return (uint32_t)((BM >> tw_log2) + 2) * ((1 << tw_log2) + 2) * ROW_BYTES;
}

// Tile constants and the shared-memory layout of one (operand, BN).
template <class Op, int BN>
struct Tile {
  static constexpr int NBOX = NHIDDEN / Op::BK;   // halo boxes, one row each
  static constexpr int KSTEPS = 9 * NBOX;         // (tap, box)
  static constexpr int COLS = BN / 2;             // channels in the tile
  static constexpr int VEC = 16 / (int)sizeof(typename Op::T);
  static constexpr uint32_t B_TILE = (uint32_t)BN * ROW_BYTES;
  static constexpr uint32_t B_STAGE = Op::PARTS * B_TILE;
  // a row of the x/out tile, plus 16 bytes, so that the 8 rows a warp
  // touches at once fall in different banks
  static constexpr uint32_t X_ROW = COLS * sizeof(typename Op::T) + 16;
  // B stages, the halo boxes, the x/out tile, the per-channel params and
  // the mbarriers, plus the slack that aligns the start to 1024 bytes (the
  // 128-byte swizzle's period)
  static __host__ __device__ constexpr uint32_t smem_bytes(int tw_log2) {
    return Op::STAGES * B_STAGE + NBOX * align1024(halo_box_bytes(tw_log2)) +
           BM * X_ROW + NPARAMS * COLS * 4 + 8 * (2 * Op::STAGES + 2) + 1024;
  }
  static_assert(NBOX % 2 == 0, "a tap's steps alternate the A buffers");
};

static_assert(Tile<Tf32x3Operand, 128>::smem_bytes(4) <= 232448,
              "float32 tile exceeds a block's shared memory");
static_assert(Tile<Bf16Operand, 256>::smem_bytes(4) <= 232448,
              "bfloat16 tile exceeds a block's shared memory");

// The mbarriers after a block's buffers: full[STAGES] and empty[STAGES] of
// the B ring, the halo's, and the staged tiles' (x_bar).
template <int STAGES>
struct Bars {
  uint32_t base;
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 * (STAGES + s); }
  __device__ uint32_t halo() const { return base + 16 * STAGES; }
  __device__ uint32_t x() const { return base + 16 * STAGES + 8; }
  // by thread 0; `stagers`: the arrivals that complete x_bar
  __device__ void init(uint32_t stagers) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), CONSUMER_WARPS);
      }
      mbar_init(halo(), 1);
      mbar_init(x(), stagers);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
};

// The TMA issuer's loads of one block: the NBOX halo boxes of actv around
// the tile at (x0, y0) of sample n, then every k-step's B stage, columns
// col0 .. col0 + BN - 1 of the packed weights (np_cols columns per tap).
template <class Op, int BN>
__device__ __forceinline__ void load_operands(
    const CUtensorMap* tm_actv, const CUtensorMap* tm_w, uint32_t a_smem,
    uint32_t halo_stride, uint32_t halo_bytes, uint32_t b_smem,
    Bars<Op::STAGES> bars, int x0, int y0, int n, int col0, int np_cols) {
  using L = Tile<Op, BN>;
  constexpr int STAGES = Op::STAGES;
  mbar_expect_tx(bars.halo(), L::NBOX * halo_bytes);
  for (int h = 0; h < L::NBOX; ++h)
    tma_load_4d(a_smem + h * halo_stride, tm_actv, bars.halo(), h * Op::BK,
                x0 - 1, y0 - 1, n);
  // k-step s: tap s / NBOX, k from (s % NBOX) * BK; the parts of one
  // stage (float32: hi, lo) are 9 * np_cols rows apart
  for (int s = 0; s < L::KSTEPS; ++s) {
    const int st = s % STAGES;
    if (s >= STAGES) mbar_wait(bars.empty(st), ((s / STAGES) - 1) & 1);
    mbar_expect_tx(bars.full(st), L::B_STAGE);
    for (int p = 0; p < Op::PARTS; ++p)
      tma_load_2d(b_smem + st * L::B_STAGE + p * L::B_TILE, tm_w,
                  bars.full(st), (s % L::NBOX) * Op::BK,
                  (p * 9 + s / L::NBOX) * np_cols + col0);
  }
}

// The consumer warpgroups' mainloop: acc = this thread's BN / 2 of its
// warpgroup's 64 rows x BN columns of the 9-tap product of the halo tile
// with the B stages that load_operands streams in.
template <class Op, int BN>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2], uint32_t a_smem,
                                         uint32_t halo_stride, uint32_t b_smem,
                                         Bars<Op::STAGES> bars, int tw_log2) {
  using L = Tile<Op, BN>;
  constexpr int STAGES = Op::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tw = 1 << tw_log2;
  const int halo_w = tw + 2;
  // warpgroup wg owns tile rows 64 wg .. 64 wg + 63
  const int wg = warp / 4;
  // the A row this lane addresses for ldmatrix, and its 16-byte k chunk
  const int m_lane = wg * 64 + (warp % 4) * 16 + (lane & 15);
  const int a_row0 = (m_lane >> tw_log2) * halo_w + (m_lane & (tw - 1));
  const int kc = lane >> 4;

  // A fragments of k-step s: tap s / NBOX (dy, dx) over the channels of
  // halo box s % NBOX, four 32-byte k slices
  auto load_a = [&](uint32_t (&a)[4][Op::PARTS][4], int s) {
    const int tap = s / L::NBOX;
    const int r = a_row0 + (tap / 3) * halo_w + tap % 3;
    const uint32_t row = a_smem + (s % L::NBOX) * halo_stride + r * ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4(a[kk][0], row + (((2 * kk + kc) ^ (r & 7)) << 4));
      Op::split(a[kk]);
    }
  };

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // step s: issue its wgmmas from a (the first one overwrites acc when
  // `fresh`), then wait for step s - 1's (for all, step s's too, when
  // `last`), release step s - 1's B stage and load step s + 1's A into
  // `next`, which step s - 1 read
  auto step = [&](int s, const uint32_t (&a)[4][Op::PARTS][4],
                  uint32_t (&next)[4][Op::PARTS][4], bool fresh, bool last) {
    const int st = s % STAGES;
    mbar_wait(bars.full(st), (s / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
    const uint32_t b = b_smem + st * L::B_STAGE;
    const uint64_t desc = sw128_desc(b), desc_lo = sw128_desc(b + L::B_TILE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)      // 32 bytes = 2 descriptor units
      Op::mma(acc, a[kk], desc + 2 * kk, desc_lo + 2 * kk, fresh && kk == 0);
    wgmma_commit();
    if (last)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();
    fence_acc(acc);
    if (s > 0 && lane == 0) mbar_arrive(bars.empty((s - 1) % STAGES));
    if (s + 1 < L::KSTEPS) load_a(next, s + 1);
  };
  uint32_t a[2][4][Op::PARTS][4];
  mbar_wait(bars.halo(), 0);
  load_a(a[0], 0);
  if constexpr (Op::FLUSH_TAPS == 0) {
#pragma unroll
    for (int s = 0; s < L::KSTEPS; ++s)
      step(s, a[s & 1], a[(s + 1) & 1], false, false);
    wgmma_wait<0>();
    fence_acc(acc);
  } else {
    // one tap per trip; every FLUSH_TAPS taps, acc is added to the total
    float total[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const bool fresh = tap % Op::FLUSH_TAPS == 0;
      const bool last = (tap + 1) % Op::FLUSH_TAPS == 0;
#pragma unroll
      for (int j = 0; j < L::NBOX; ++j)
        step(tap * L::NBOX + j, a[j & 1], a[(j + 1) & 1], fresh && j == 0,
             last && j == L::NBOX - 1);
      if (last) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) total[i] += acc[i];
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = total[i];
  }
}

// One block of one site.  tm_actv: actv (N, H, W, 128), box (BK, TW+2,
// TH+2, 1).  tm_w: pack_weights' (PARTS * 9 * np_cols, 128), box (BK, BN):
// row (part * 9 + tap) * np_cols + j holds column j of that tap, j = 2c +
// (0 gamma | 1 beta).  x, out: (N, H, W, C).  style: (N, 2C) f32 [s0|s1].
// mean, var: (N, C) f32.  bcat: (C, 2) f32.  STYLE false: plain SPADE,
// style is not read (it may be null).
template <class Op, int BN, bool STYLE>
__device__ __forceinline__ void spade_style_sm90(
    const CUtensorMap* tm_actv, const CUtensorMap* tm_w,
    const typename Op::T* __restrict__ x, const float* __restrict__ style,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ bcat, typename Op::T* __restrict__ out, int H,
    int W, int C, int np_cols, int tw_log2, int tiles_w, float eps) {
  using T = typename Op::T;
  using L = Tile<Op, BN>;
  constexpr int STAGES = Op::STAGES;
  constexpr int COLS = L::COLS, VEC = L::VEC;
  constexpr uint32_t X_ROW = L::X_ROW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // generic
  const int tw = 1 << tw_log2;
  const uint32_t halo_bytes = halo_box_bytes(tw_log2);
  const uint32_t halo_stride = align1024(halo_bytes);
  const uint32_t b_smem = base;                         // STAGES x B stage
  const uint32_t a_smem = base + STAGES * L::B_STAGE;   // NBOX halo boxes
  uint8_t* const x_tile = gbase + (a_smem - base) + L::NBOX * halo_stride;
  float* const params = reinterpret_cast<float*>(x_tile + BM * X_ROW);
  const Bars<STAGES> bars{smem_u32(params + NPARAMS * COLS)};

  const int n = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_w) * (BM >> tw_log2);
  const int x0 = (blockIdx.x % tiles_w) * tw;
  const int col0 = blockIdx.y * BN;
  const int c_base = col0 / 2;                  // first channel of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // x and out in 16-byte vectors where rows allow it
  const bool vec = C % VEC == 0 &&
                   (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  // device-memory element of tile row m, channel c_base + c; -1 outside
  auto elem = [&](int m, int c) -> long long {
    const int gy = y0 + (m >> tw_log2), gx = x0 + (m & (tw - 1));
    if (gy >= H || gx >= W || c_base + c >= C) return -1;
    return (((long long)n * H + gy) * W + gx) * C + c_base + c;
  };

  bars.init(STAGERS);
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {                 // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp > CONSUMER_WARPS) {                // stage x and the params
      const int t = threadIdx.x - 32 * (CONSUMER_WARPS + 1);
      if (vec) {
        for (int v = t; v < BM * COLS / VEC; v += STAGERS) {
          const int m = v / (COLS / VEC), c = VEC * (v % (COLS / VEC));
          const long long e = elem(m, c);
          const uint4 val = e < 0 ? make_uint4(0, 0, 0, 0)
                                  : __ldg(reinterpret_cast<const uint4*>(x + e));
          *reinterpret_cast<uint4*>(x_tile + m * X_ROW + sizeof(T) * c) = val;
        }
      } else {
        for (int v = t; v < BM * COLS; v += STAGERS) {
          const int m = v / COLS, c = v % COLS;
          const long long e = elem(m, c);
          reinterpret_cast<T*>(x_tile + m * X_ROW)[c] =
              e < 0 ? Op::from_float(0.f) : x[e];
        }
      }
      for (int c = t; c < COLS; c += STAGERS) {
        const int ch = c_base + c;
        const bool in = ch < C;
        const size_t nc = (size_t)n * C + ch, ns = (size_t)n * 2 * C + ch;
        params[0 * COLS + c] = in ? mean[nc] : 0.f;
        params[1 * COLS + c] = in ? rsqrtf(var[nc] + eps) : 0.f;
        if constexpr (STYLE) {
          params[2 * COLS + c] = in ? style[ns] + 1.f : 0.f;
          params[3 * COLS + c] = in ? style[ns + C] : 0.f;
        }
        params[4 * COLS + c] = in ? bcat[2 * ch] : 0.f;
        params[5 * COLS + c] = in ? bcat[2 * ch + 1] : 0.f;
      }
      mbar_arrive(bars.x());
    } else if (threadIdx.x == 32 * CONSUMER_WARPS) {   // the TMA issuer
      load_operands<Op, BN>(tm_actv, tm_w, a_smem, halo_stride, halo_bytes,
                            b_smem, bars, x0, y0, n, col0, np_cols);
    }
  } else {                                      // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    float acc[BN / 2];
    mainloop<Op, BN>(acc, a_smem, halo_stride, b_smem, bars, tw_log2);

    // epilogue: acc[4i + 2h + j] is row (lane / 4) + 8h of this warp's 16,
    // column col0 + 8i + 2 (lane % 4) + j, i.e. tile channel
    // 4i + lane % 4, gamma for j = 0 and beta for j = 1; out is written
    // over x in the tile
    const int m0 = (warp / 4) * 64 + (warp % 4) * 16 + (lane >> 2);
    mbar_wait(bars.x(), 0);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 4 * i + (lane & 3);
      const float m = params[c], rstd = params[COLS + c];
      const float bg = params[4 * COLS + c], bb = params[5 * COLS + c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T* const p = reinterpret_cast<T*>(x_tile + (m0 + 8 * h) * X_ROW) + c;
        const float xv = Op::to_float(*p);
        const float gamma = acc[4 * i + 2 * h] + bg;
        const float beta = acc[4 * i + 2 * h + 1] + bb;
        const float spade = (xv - m) * rstd * (1.f + gamma) + beta;
        if constexpr (STYLE) {
          const float s0p1 = params[2 * COLS + c], s1 = params[3 * COLS + c];
          const float adain = xv * s0p1 + s1;
          *p = Op::from_float((spade + adain) * 0.5f);
        } else {
          *p = Op::from_float(spade);
        }
      }
    }
    consumer_sync();
    const int t = threadIdx.x;
    if (vec) {
      for (int v = t; v < BM * COLS / VEC; v += 32 * CONSUMER_WARPS) {
        const int m = v / (COLS / VEC), c = VEC * (v % (COLS / VEC));
        const long long e = elem(m, c);
        if (e >= 0)
          *reinterpret_cast<uint4*>(out + e) =
              *reinterpret_cast<const uint4*>(x_tile + m * X_ROW +
                                              sizeof(T) * c);
      }
    } else {
      for (int v = t; v < BM * COLS; v += 32 * CONSUMER_WARPS) {
        const int m = v / COLS, c = v % COLS;
        const long long e = elem(m, c);
        if (e >= 0) out[e] = reinterpret_cast<const T*>(x_tile + m * X_ROW)[c];
      }
    }
  }
}

// The backward's shared-memory layout at BN gamma columns (bfloat16): B
// stages, halo boxes, the x (then dx) and dout (then dgamma) tiles with
// rows padded by 16 bytes as the forward's, the per-channel params, each
// consumer warp's sums, the mbarriers, and the 1024-byte alignment slack.
template <int BN>
struct BwdTile {
  using L = Tile<Bf16Operand, BN>;
  static constexpr int VEC = 8;                 // bfloat16 per 16 bytes
  static constexpr uint32_t X_ROW = BN * 2 + 16;
  static __host__ __device__ constexpr uint32_t smem_bytes(int tw_log2) {
    return Bf16Operand::STAGES * L::B_STAGE +
           L::NBOX * align1024(halo_box_bytes(tw_log2)) + 2 * BM * X_ROW +
           (BWD_PARAMS + CONSUMER_WARPS * BWD_SUMS) * BN * 4 +
           8 * (2 * Bf16Operand::STAGES + 2) + 1024;
  }
};

static_assert(BwdTile<128>::smem_bytes(4) <= 232448,
              "backward tile exceeds a block's shared memory");

// One block of one site's backward, bfloat16, BN gamma columns = channels
// c_base .. c_base + BN - 1.  tm_actv as the forward's; tm_w: the gamma-only
// packed weights (9 * np_cols, 128), row tap * np_cols + c holding wg[c, :,
// tap].  x, dout, dx: (N, H, W, C); dgb: (N, H, W, 2C), [dgamma | dbeta].
// style: (N, 2C) f32; mean, var: (N, C) f32; bcat: (C, 2) f32.  partial:
// (N, tiles, BWD_SUMS, C) f32, this block's sums at [n, blockIdx.x].
// STYLE false: plain SPADE's backward, h = dout, no s0 term in dx and
// dbeta = dout; style is not read (it may be null).
template <int BN, bool STYLE>
__device__ __forceinline__ void spade_style_bwd_sm90(
    const CUtensorMap* tm_actv, const CUtensorMap* tm_w,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ style, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ bcat,
    __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ dgb,
    float* __restrict__ partial, int H, int W, int C, int np_cols,
    int tw_log2, int tiles_w, int tiles, float eps) {
  using Op = Bf16Operand;
  using T = __nv_bfloat16;
  using L = Tile<Op, BN>;
  constexpr int STAGES = Op::STAGES, VEC = BwdTile<BN>::VEC;
  constexpr int PER_ROW = BN / VEC;             // 16-byte vectors per row
  constexpr uint32_t X_ROW = BwdTile<BN>::X_ROW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // generic
  const int tw = 1 << tw_log2;
  const uint32_t halo_bytes = halo_box_bytes(tw_log2);
  const uint32_t halo_stride = align1024(halo_bytes);
  const uint32_t b_smem = base;
  const uint32_t a_smem = base + STAGES * L::B_STAGE;
  uint8_t* const x_tile = gbase + (a_smem - base) + L::NBOX * halo_stride;
  uint8_t* const d_tile = x_tile + BM * X_ROW;
  // mean, rstd, s0 + 1, bg; then sums[warp][q][c]
  float* const params = reinterpret_cast<float*>(d_tile + BM * X_ROW);
  float* const sums = params + BWD_PARAMS * BN;
  const Bars<STAGES> bars{smem_u32(sums + CONSUMER_WARPS * BWD_SUMS * BN)};

  const int n = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_w) * (BM >> tw_log2);
  const int x0 = (blockIdx.x % tiles_w) * tw;
  const int c_base = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long C2 = 2LL * C;
  const bool vec = C % VEC == 0 && (((uintptr_t)x | (uintptr_t)dout |
                                     (uintptr_t)dx | (uintptr_t)dgb) & 15) == 0;
  // pixel (index into N x H x W) of tile row m; -1 outside the map
  auto pixel = [&](int m) -> long long {
    const int gy = y0 + (m >> tw_log2), gx = x0 + (m & (tw - 1));
    if (gy >= H || gx >= W) return -1;
    return ((long long)n * H + gy) * W + gx;
  };

  bars.init(STAGERS);
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {                 // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp > CONSUMER_WARPS) {                // stage x, dout and params
      const int t = threadIdx.x - 32 * (CONSUMER_WARPS + 1);
      if (vec) {
        for (int v = t; v < BM * PER_ROW; v += STAGERS) {
          const int m = v / PER_ROW, c = VEC * (v % PER_ROW);
          const long long p = pixel(m);
          const bool in = p >= 0 && c_base + c < C;
          const long long e = in ? p * C + c_base + c : 0;
          cp_async16(smem_u32(x_tile + m * X_ROW + 2 * c), x + e, in ? 16 : 0);
          cp_async16(smem_u32(d_tile + m * X_ROW + 2 * c), dout + e,
                     in ? 16 : 0);
        }
        cp_async_wait_all();
        // dbeta = dout / 2 (exact in bfloat16; plain SPADE: dout), from the
        // vectors this thread copied
        for (int v = t; v < BM * PER_ROW; v += STAGERS) {
          const int m = v / PER_ROW, c = VEC * (v % PER_ROW);
          const long long p = pixel(m);
          if (p < 0 || c_base + c >= C) continue;
          uint4 val = *reinterpret_cast<const uint4*>(d_tile + m * X_ROW +
                                                       2 * c);
          if constexpr (STYLE) {
            __nv_bfloat162* const pair =
                reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = __bfloat1622float2(pair[k]);
              pair[k] = __floats2bfloat162_rn(0.5f * f.x, 0.5f * f.y);
            }
          }
          *reinterpret_cast<uint4*>(dgb + p * C2 + C + c_base + c) = val;
        }
      } else {
        for (int v = t; v < BM * BN; v += STAGERS) {
          const int m = v / BN, c = v % BN;
          const long long p = pixel(m);
          const bool in = p >= 0 && c_base + c < C;
          const T xv = in ? x[p * C + c_base + c] : __float2bfloat16(0.f);
          const T dv = in ? dout[p * C + c_base + c] : __float2bfloat16(0.f);
          reinterpret_cast<T*>(x_tile + m * X_ROW)[c] = xv;
          reinterpret_cast<T*>(d_tile + m * X_ROW)[c] = dv;
          if (in)
            dgb[p * C2 + C + c_base + c] =
                STYLE ? __float2bfloat16(0.5f * __bfloat162float(dv)) : dv;
        }
      }
      for (int c = t; c < BN; c += STAGERS) {
        const int ch = c_base + c;
        const bool in = ch < C;
        const size_t nc = (size_t)n * C + ch;
        params[c] = in ? mean[nc] : 0.f;
        params[BN + c] = in ? rsqrtf(var[nc] + eps) : 0.f;
        if constexpr (STYLE)
          params[2 * BN + c] = in ? style[(size_t)n * 2 * C + ch] + 1.f : 0.f;
        params[3 * BN + c] = in ? bcat[2 * ch] : 0.f;
      }
      mbar_arrive(bars.x());
    } else if (threadIdx.x == 32 * CONSUMER_WARPS) {   // the TMA issuer
      load_operands<Op, BN>(tm_actv, tm_w, a_smem, halo_stride, halo_bytes,
                            b_smem, bars, x0, y0, n, c_base, np_cols);
    }
  } else {                                      // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    float acc[BN / 2];
    mainloop<Op, BN>(acc, a_smem, halo_stride, b_smem, bars, tw_log2);

    // epilogue: acc[4i + 2h + j] is gamma - bg at row m0 + 8h, tile channel
    // c0 + j with c0 = 8i + 2 (lane % 4); dx is written over x and dgamma
    // over dout in the tiles
    const int m0 = (warp / 4) * 64 + (warp % 4) * 16 + (lane >> 2);
    const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
    mbar_wait(bars.x(), 0);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c0 = 8 * i + 2 * (lane & 3);
      // v[2q + j]: sum q of channel c0 + j over this thread's two rows
      float v[2 * BWD_SUMS];
#pragma unroll
      for (int k = 0; k < 2 * BWD_SUMS; ++k) v[k] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* const px = reinterpret_cast<__nv_bfloat162*>(
            x_tile + (m0 + 8 * h) * X_ROW + 2 * c0);
        __nv_bfloat162* const pd = reinterpret_cast<__nv_bfloat162*>(
            d_tile + (m0 + 8 * h) * X_ROW + 2 * c0);
        const float2 xv = __bfloat1622float2(*px), dv = __bfloat1622float2(*pd);
        float dxo[2], dgo[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + j;
          const float hv = STYLE ? 0.5f * (j ? dv.y : dv.x) : (j ? dv.y : dv.x);
          const float xm = (j ? xv.y : xv.x) - params[c];
          const float rstd = params[BN + c];
          const float g1 = 1.f + (acc[4 * i + 2 * h + j] + params[3 * BN + c]);
          dgo[j] = hv * (xm * rstd);
          dxo[j] = STYLE ? hv * (g1 * rstd + params[2 * BN + c])
                         : hv * (g1 * rstd);
          v[j] += hv;
          v[2 + j] += hv * xm;
          v[4 + j] += hv * g1;
          v[6 + j] += hv * g1 * xm;
        }
        *px = __floats2bfloat162_rn(dxo[0], dxo[1]);
        *pd = __floats2bfloat162_rn(dgo[0], dgo[1]);
      }
      // reduce-scatter over the warp's 8 row groups (lane bits 2-4): each
      // step keeps half of the values and adds the partner's copy of them;
      // lane then holds v[lane / 4] summed over the warp's 16 rows
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float send = b16 ? v[k] : v[k + 4];
        v[k] = (b16 ? v[k + 4] : v[k]) + __shfl_xor_sync(~0u, send, 16);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float send = b8 ? v[k] : v[k + 2];
        v[k] = (b8 ? v[k + 2] : v[k]) + __shfl_xor_sync(~0u, send, 8);
      }
      const float send = b4 ? v[0] : v[1];
      v[0] = (b4 ? v[1] : v[0]) + __shfl_xor_sync(~0u, send, 4);
      const int k = lane >> 2;
      sums[(warp * BWD_SUMS + k / 2) * BN + c0 + (k & 1)] = v[0];
    }
    consumer_sync();
    const int t = threadIdx.x;
    if (vec) {
      for (int v = t; v < BM * PER_ROW; v += 32 * CONSUMER_WARPS) {
        const int m = v / PER_ROW, c = VEC * (v % PER_ROW);
        const long long p = pixel(m);
        if (p < 0 || c_base + c >= C) continue;
        *reinterpret_cast<uint4*>(dx + p * C + c_base + c) =
            *reinterpret_cast<const uint4*>(x_tile + m * X_ROW + 2 * c);
        *reinterpret_cast<uint4*>(dgb + p * C2 + c_base + c) =
            *reinterpret_cast<const uint4*>(d_tile + m * X_ROW + 2 * c);
      }
    } else {
      for (int v = t; v < BM * BN; v += 32 * CONSUMER_WARPS) {
        const int m = v / BN, c = v % BN;
        const long long p = pixel(m);
        if (p < 0 || c_base + c >= C) continue;
        dx[p * C + c_base + c] = reinterpret_cast<const T*>(x_tile + m * X_ROW)[c];
        dgb[p * C2 + c_base + c] =
            reinterpret_cast<const T*>(d_tile + m * X_ROW)[c];
      }
    }
    // the block's sums, over the warps in a fixed order
    for (int v = t; v < BWD_SUMS * BN; v += 32 * CONSUMER_WARPS) {
      const int q = v / BN, c = v % BN;
      if (c_base + c >= C) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMER_WARPS; ++w)
        s += sums[(w * BWD_SUMS + q) * BN + c];
      partial[(((long long)n * tiles + blockIdx.x) * BWD_SUMS + q) * C +
              c_base + c] = s;
    }
  }
}

// bfloat16, BN = 128 or 256.
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
  spade_style_sm90<Bf16Operand, BN, true>(&tm_actv, &tm_w, x, style, mean,
                                          var, bcat, out, H, W, C, np_cols,
                                          tw_log2, tiles_w, eps);
}

// plain SPADE, bfloat16, BN = 128 or 256.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
spade_style_sm90_kernel_nostyle(const __grid_constant__ CUtensorMap tm_actv,
                                const __grid_constant__ CUtensorMap tm_w,
                                const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ style,
                                const float* __restrict__ mean,
                                const float* __restrict__ var,
                                const float* __restrict__ bcat,
                                __nv_bfloat16* __restrict__ out, int H, int W,
                                int C, int np_cols, int tw_log2, int tiles_w,
                                float eps) {
  spade_style_sm90<Bf16Operand, BN, false>(&tm_actv, &tm_w, x, style, mean,
                                           var, bcat, out, H, W, C, np_cols,
                                           tw_log2, tiles_w, eps);
}

// float32 (3xTF32), BN = 128.
__global__ void __launch_bounds__(THREADS, 1)
spade_style_3xtf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_actv,
                               const __grid_constant__ CUtensorMap tm_w,
                               const float* __restrict__ x,
                               const float* __restrict__ style,
                               const float* __restrict__ mean,
                               const float* __restrict__ var,
                               const float* __restrict__ bcat,
                               float* __restrict__ out, int H, int W, int C,
                               int np_cols, int tw_log2, int tiles_w,
                               float eps) {
  spade_style_sm90<Tf32x3Operand, 128, true>(&tm_actv, &tm_w, x, style,
                                             mean, var, bcat, out, H, W, C,
                                             np_cols, tw_log2, tiles_w, eps);
}

// plain SPADE, float32 (3xTF32), BN = 128.
__global__ void __launch_bounds__(THREADS, 1)
spade_style_3xtf32_sm90_kernel_nostyle(
    const __grid_constant__ CUtensorMap tm_actv,
    const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ x,
    const float* __restrict__ style, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ bcat,
    float* __restrict__ out, int H, int W, int C, int np_cols, int tw_log2,
    int tiles_w, float eps) {
  spade_style_sm90<Tf32x3Operand, 128, false>(&tm_actv, &tm_w, x, style,
                                              mean, var, bcat, out, H, W, C,
                                              np_cols, tw_log2, tiles_w, eps);
}

// The backward, bfloat16, BN = 64 or 128 gamma columns.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
spade_style_sm90_kernel_bwd(const __grid_constant__ CUtensorMap tm_actv,
                            const __grid_constant__ CUtensorMap tm_w,
                            const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ style,
                            const float* __restrict__ mean,
                            const float* __restrict__ var,
                            const float* __restrict__ bcat,
                            __nv_bfloat16* __restrict__ dx,
                            __nv_bfloat16* __restrict__ dgb,
                            float* __restrict__ partial, int H, int W, int C,
                            int np_cols, int tw_log2, int tiles_w, int tiles,
                            float eps) {
  spade_style_bwd_sm90<BN, true>(&tm_actv, &tm_w, x, dout, style, mean, var,
                                 bcat, dx, dgb, partial, H, W, C, np_cols,
                                 tw_log2, tiles_w, tiles, eps);
}

// plain SPADE's backward, bfloat16, BN = 64 or 128 gamma columns.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
spade_style_sm90_kernel_bwd_nostyle(
    const __grid_constant__ CUtensorMap tm_actv,
    const __grid_constant__ CUtensorMap tm_w,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ style, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ bcat,
    __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ dgb,
    float* __restrict__ partial, int H, int W, int C, int np_cols,
    int tw_log2, int tiles_w, int tiles, float eps) {
  spade_style_bwd_sm90<BN, false>(&tm_actv, &tm_w, x, dout, style, mean, var,
                                  bcat, dx, dgb, partial, H, W, C, np_cols,
                                  tw_log2, tiles_w, tiles, eps);
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
constexpr int ERR_TILES = -3;

// The arguments of every forward entry point.
struct Site {
  int device;
  const void *actv, *x, *style, *mean, *var, *wcat, *bcat;
  void* out;
  int N, H, W, C;
  float eps;
  void* stream;
};

// The pixel tiling of an (H, W) map: TW = 8 where W <= 8, else 16; TH =
// BM / TW.
struct Tiling {
  int tw_log2, tw, th, tiles_w, tiles_h;
  Tiling(int H, int W)
      : tw_log2(W <= 8 ? 3 : 4), tw(1 << tw_log2), th(BM >> tw_log2),
        tiles_w((W + tw - 1) / tw), tiles_h((H + th - 1) / th) {}
};

// Encodes the two tensor maps of a block of (Op, BN): the haloed actv (N, H,
// W, 128) and packed weights of w_rows rows of 128.
template <class Op, int BN>
int encode_maps(CUtensorMap* tm_actv, CUtensorMap* tm_w, const void* actv,
                const void* w, int N, int H, int W, int w_rows,
                const Tiling& t) {
  constexpr cuuint64_t E = sizeof(typename Op::T);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_TENSOR_MAP;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t a_dim[4] = {NHIDDEN, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t a_stride[3] = {NHIDDEN * E, (cuuint64_t)W * NHIDDEN * E,
                                  (cuuint64_t)H * W * NHIDDEN * E};
  const cuuint32_t a_box[4] = {Op::BK, (cuuint32_t)t.tw + 2,
                               (cuuint32_t)t.th + 2, 1};
  if (encode(tm_actv, Op::TMA_TYPE, 4, const_cast<void*>(actv), a_dim,
             a_stride, a_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  const cuuint64_t w_dim[2] = {NHIDDEN, (cuuint64_t)w_rows};
  const cuuint64_t w_stride[1] = {NHIDDEN * E};
  const cuuint32_t w_box[2] = {Op::BK, BN};
  if (encode(tm_w, Op::TMA_TYPE, 2, const_cast<void*>(w), w_dim, w_stride,
             w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  return 0;
}

// Encodes the two tensor maps and launches `kernel`, the (Op, BN) block.
template <class Op, int BN, class Kernel>
int launch(Kernel kernel, const Site& a) {
  using T = typename Op::T;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;

  // the packed weights' columns: 2C rounded up to 128 where 2C <= 128, else
  // to 256 (pack_weights does the same); BN divides it
  const int cols_tile = 2 * a.C <= 128 ? 128 : 256;
  const int np_cols = (2 * a.C + cols_tile - 1) / cols_tile * cols_tile;
  const Tiling t(a.H, a.W);
  CUtensorMap tm_actv, tm_w;
  const int enc = encode_maps<Op, BN>(&tm_actv, &tm_w, a.actv, a.wcat, a.N,
                                      a.H, a.W, Op::PARTS * 9 * np_cols, t);
  if (enc != 0) return enc;

  const uint32_t smem = Tile<Op, BN>::smem_bytes(t.tw_log2);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(t.tiles_h * t.tiles_w, np_cols / BN, a.N);
  kernel<<<grid, THREADS, smem, (cudaStream_t)a.stream>>>(
      tm_actv, tm_w, (const T*)a.x, (const float*)a.style,
      (const float*)a.mean, (const float*)a.var, (const float*)a.bcat,
      (T*)a.out, a.H, a.W, a.C, np_cols, t.tw_log2, t.tiles_w, a.eps);
  return (int)cudaGetLastError();
}

// The arguments of the backward entry point.
struct BwdSite {
  int device;
  const void *actv, *x, *dout, *style, *mean, *var, *wgam, *bcat;
  void *dx, *dgb, *partial;
  int N, H, W, C, tiles;
  float eps;
  void* stream;
};

// The backward's launch of `kernel` at BN gamma columns; `tiles` must be the
// pixel tiles per sample that the partial sums were allocated for.
template <int BN, class Kernel>
int launch_bwd(Kernel kernel, const BwdSite& a) {
  using T = __nv_bfloat16;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  const Tiling t(a.H, a.W);
  if (a.tiles != t.tiles_h * t.tiles_w) return ERR_TILES;
  // the gamma-only layout's columns: C rounded up to BN (pack_gamma_weights)
  const int np_cols = (a.C + BN - 1) / BN * BN;
  CUtensorMap tm_actv, tm_w;
  const int enc = encode_maps<Bf16Operand, BN>(&tm_actv, &tm_w, a.actv,
                                               a.wgam, a.N, a.H, a.W,
                                               9 * np_cols, t);
  if (enc != 0) return enc;

  const uint32_t smem = BwdTile<BN>::smem_bytes(t.tw_log2);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.tiles, np_cols / BN, a.N);
  kernel<<<grid, THREADS, smem, (cudaStream_t)a.stream>>>(
      tm_actv, tm_w, (const T*)a.x, (const T*)a.dout, (const float*)a.style,
      (const float*)a.mean, (const float*)a.var, (const float*)a.bcat,
      (T*)a.dx, (T*)a.dgb, (float*)a.partial, a.H, a.W, a.C, np_cols,
      t.tw_log2, t.tiles_w, a.tiles, a.eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// actv, x, out: (N, H, W, 128|C|C) bf16 contiguous, actv 16-byte aligned.
// wcat: (9, np_cols, 128) bf16 with np_cols = 2C rounded up to 128 or 256.
int spade_style_fwd_bf16_sm90(int device, const void* actv, const void* x,
                              const void* style, const void* mean,
                              const void* var, const void* wcat,
                              const void* bcat, void* out, int N, int H,
                              int W, int C, float eps, void* stream) {
  const Site a{device, actv, x, style, mean, var, wcat, bcat, out,
               N, H, W, C, eps, stream};
  if (2 * C <= 128)
    return launch<Bf16Operand, 128>(spade_style_sm90_kernel<128>, a);
  return launch<Bf16Operand, 256>(spade_style_sm90_kernel<256>, a);
}

// actv, x, out: (N, H, W, 128|C|C) f32 contiguous, actv 16-byte aligned.
// wcat: (2, 9, np_cols, 128) f32, TF32 hi then lo, np_cols as above.
int spade_style_fwd_f32_3xtf32_sm90(int device, const void* actv,
                                    const void* x, const void* style,
                                    const void* mean, const void* var,
                                    const void* wcat, const void* bcat,
                                    void* out, int N, int H, int W, int C,
                                    float eps, void* stream) {
  const Site a{device, actv, x, style, mean, var, wcat, bcat, out,
               N, H, W, C, eps, stream};
  return launch<Tf32x3Operand, 128>(spade_style_3xtf32_sm90_kernel, a);
}

// The backward of one site, bfloat16.  actv, x, dout, dx: (N, H, W,
// 128|C|C|C) contiguous, actv 16-byte aligned; dgb: (N, H, W, 2C).  wgam:
// (9, np_cols, 128) with np_cols = C rounded up to 64 where C <= 64, else to
// 128.  bcat as the forward's; partial: (N, tiles, 4, C) f32, tiles = the
// map's pixel tiles per sample.
int spade_style_bwd_bf16_sm90(int device, const void* actv, const void* x,
                              const void* dout, const void* style,
                              const void* mean, const void* var,
                              const void* wgam, const void* bcat, void* dx,
                              void* dgb, void* partial, int N, int H, int W,
                              int C, int tiles, float eps, void* stream) {
  const BwdSite a{device, actv, x, dout, style, mean, var, wgam, bcat,
                  dx, dgb, partial, N, H, W, C, tiles, eps, stream};
  return C <= 64 ? launch_bwd<64>(spade_style_sm90_kernel_bwd<64>, a)
                 : launch_bwd<128>(spade_style_sm90_kernel_bwd<128>, a);
}

// The plain-SPADE kernels: the arguments of the three entry points above,
// style unread (it may be null).
int spade_fwd_bf16_sm90(int device, const void* actv, const void* x,
                        const void* style, const void* mean, const void* var,
                        const void* wcat, const void* bcat, void* out, int N,
                        int H, int W, int C, float eps, void* stream) {
  const Site a{device, actv, x, style, mean, var, wcat, bcat, out,
               N, H, W, C, eps, stream};
  if (2 * C <= 128)
    return launch<Bf16Operand, 128>(spade_style_sm90_kernel_nostyle<128>, a);
  return launch<Bf16Operand, 256>(spade_style_sm90_kernel_nostyle<256>, a);
}

int spade_fwd_f32_3xtf32_sm90(int device, const void* actv, const void* x,
                              const void* style, const void* mean,
                              const void* var, const void* wcat,
                              const void* bcat, void* out, int N, int H,
                              int W, int C, float eps, void* stream) {
  const Site a{device, actv, x, style, mean, var, wcat, bcat, out,
               N, H, W, C, eps, stream};
  return launch<Tf32x3Operand, 128>(spade_style_3xtf32_sm90_kernel_nostyle, a);
}

int spade_bwd_bf16_sm90(int device, const void* actv, const void* x,
                        const void* dout, const void* style, const void* mean,
                        const void* var, const void* wgam, const void* bcat,
                        void* dx, void* dgb, void* partial, int N, int H,
                        int W, int C, int tiles, float eps, void* stream) {
  const BwdSite a{device, actv, x, dout, style, mean, var, wgam, bcat,
                  dx, dgb, partial, N, H, W, C, tiles, eps, stream};
  return C <= 64
             ? launch_bwd<64>(spade_style_sm90_kernel_bwd_nostyle<64>, a)
             : launch_bwd<128>(spade_style_sm90_kernel_bwd_nostyle<128>, a);
}

// Error codes of every entry point of the library: CUDA runtime errors, and
// the negative codes of the tensor-map encoding.
const char* seg2eye_cuda_error_string(int err) {
  if (err == ERR_NO_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is not available (TMA needs CUDA 12 or "
           "later)";
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused a tensor map";
  if (err == ERR_TILES)
    return "the partial sums were allocated for another number of tiles";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
