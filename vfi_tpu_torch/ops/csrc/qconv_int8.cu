// int8 serving convolution for sm_90a (H100): the activation quantize fused
// into an int8 x int8 -> int32 'same' convolution with its dequantizing
// epilogue, one launch per conv call.
//
// Replaces what XLA computes for vfi_tpu's int8 serving mode (VFI_INT8=1/2),
// vfi_tpu/nn/quant.py:96-123: q = clip(round(x / x_scale), -127, 127),
// lax.conv_general_dilated(q, wq, preferred_element_type=int32), then
// y = float(acc) * (x_scale * w_scale[c]) + b, cast to x's dtype.  vfi_tpu
// wrote no Pallas for it; PyTorch has no int8 convolution on CUDA.
//
// Arithmetic (as the plain versions in ops/qconv.py): q is
// round_half_even(fl(x / s)) clamped to +-127, s read from a device float32
// scalar so that a dynamic scale costs no host sync (computed as x * fl(1/s),
// with the IEEE division wherever that product lies near a rounding
// boundary: see `quantize_fast`); the sum over k*k*Cp is exact in int32 (|acc| <=
// 127^2 * 49 * 1024 < 2^31); the epilogue is __fadd_rn(__fmul_rn(
// __int2float_rn(acc), scale[c]), bias[c]) in float32, scale[c] = x_scale *
// w_scale[c] formed by the caller, written NCHW in float32 or bfloat16, or
// the int32 sums as they are (the exact check).  Stride 1, zero padding k/2,
// odd k in {1, 3, 5, 7}, any C_in and C_out.
//
// Design.  An implicit GEMM (M = output pixels, N = output channels, K =
// k*k*Cp) on wgmma.mma_async m64nNk32 .s32.s8.s8, both operands K-major in
// shared memory, no swizzle.  N is one of 8, 32, 64, 128, 256 (the smallest
// that covers C_out, 256 above).  A persistent block (one per SM) is two
// consumer warpgroups and a producer warpgroup; it walks work items of
// 2 * MT m64 tiles and one N tile.  An m64 tile is 8 x 8 output pixels of one
// image, so an 8x8 map is covered exactly and no map pays for a wider patch;
// each consumer warpgroup owns MT of them (MT = 1 at N = 256, else 2).
//  - A, from its own halo buffers, no im2col.  Per 32-channel chunk a
//    warpgroup stages each tile's halo, (8+k-1)^2 positions, as [k-half][halo
//    row][halo col][16 B]: 8 neighbouring output pixels of a row at one tap
//    are then one 8 x 16 B core matrix, the tile's 8 rows sit one halo row
//    apart (SBO), the two k-halves one half-buffer apart (LBO), and a tap
//    (ky, kx) is only a shift of the descriptor's start address by
//    (ky*(8+k-1) + kx) * 16 B; the halo is read by all k*k taps.
//  - The staging is the quantize: the warpgroup's threads read x (NCHW
//    float32 or bfloat16, any element strides; zeros off the image and past
//    C), quantize, and write the int8 bytes into the layout above, so the
//    int8 activation never lands in device memory.  Where x's rows are
//    contiguous and 16-byte aligned (W a multiple of 8) a thread reads one
//    channel's halo row as 16-byte loads, 4 (bfloat16) or 2 (float32) rows in
//    flight, and writes its k+7 bytes 16 bytes apart; else it reads 16
//    channels of one position with scalar loads.  The next chunk (or the next
//    item's first) is staged into the warpgroup's second buffer at the
//    chunk's second step, while two wgmma groups run.
//  - B, the weights, repacked once per weight by the wrapper as
//    [Cp/32][k*k][Co_pad/8][2][8][16 B] (an N tile of one tap is one run of
//    N*32 bytes in core-matrix order: LBO 128 B, SBO 256 B), reach a ring of
//    `depth` stages, one kernel row (k taps) each, by cp.async.bulk copies
//    that one producer thread issues against mbarriers; the consumers give a
//    stage back once the wgmma group that read it has completed
//    (wgmma.wait_group 1).  The producer warpgroup gives its registers to the
//    consumers (setmaxnreg 40 / 232).
//  - The epilogue passes 32 output channels at a time through shared memory,
//    so that each thread writes 8 neighbouring pixels of one row with 16-byte
//    stores along x.
//
// Bound (chip_smoke.qconv_bound_ms): 2 * MAC of the unpadded channels over
// 1979 TOP/s of dense int8, or x, wq and the output once over 3.35 TB/s.
// What holds it back, as built (PERF.md): the staging, which runs in the
// consumer warps between their wgmma groups and shows most where the N tile
// is small (C_out <= 64 at 128x128); channels padded to 32 (C_in = 1 costs
// 32 times its work); at small batches, too few items.
// TMA tensor copies of the halo (cp.async.bulk.tensor) raised
// cudaErrorIllegalInstruction on the H100 of PERF.md's measurements, even
// in a minimal kernel, so the halo is read with plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 32;       // input channels per k-step: the K depth of one wgmma m64nNk32 s8
constexpr int TILE = 8;         // an m64 tile is TILE x TILE output pixels
constexpr int CONSUMERS = 2;    // consumer warpgroups a block
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and one producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg: 128 * 40 + 256 * 232 <= 65536
constexpr int EPI_CH = 32;      // output channels per epilogue pass
constexpr int MAX_DEPTH = 4;    // weight stages in the ring, at most
constexpr int BAR_BYTES = 128;  // the weight ring's 2 * MAX_DEPTH mbarriers, padded
constexpr size_t SMEM_MAX = 232448;  // the most dynamic shared memory a block may use

template <int BN>
struct Tiles {
  static constexpr int MT = BN == 256 ? 1 : 2;  // m64 tiles per consumer warpgroup
  static constexpr int CG = BN < EPI_CH ? BN : EPI_CH;
  static constexpr int RS = 64 * MT + 4;  // epilogue words per channel: 4 spare, no bank conflicts
};

// Shared memory: [mbarriers][weight ring][halo buffers][epilogue];
// ops/qconv.py:qconv_tiles computes the same sizes for the CPU emulation.
struct Layout {
  int halo_w, halo;
  size_t stage, ring, tile, a, epi, total;
};

__host__ __device__ inline Layout layout(int bn, int mt, int cg, int k, int depth) {
  Layout l;
  l.halo_w = TILE + k - 1;
  l.halo = l.halo_w * l.halo_w;
  l.stage = size_t(k) * bn * CHUNK;
  l.ring = l.stage * depth;
  l.tile = size_t(2) * l.halo * 16;  // one m64 tile's halo of one chunk, both k-halves
  l.a = 2 * CONSUMERS * mt * l.tile;  // each warpgroup's two halo buffers
  l.epi = size_t(CONSUMERS) * cg * (64 * mt + 4) * 4;
  l.total = BAR_BYTES + l.ring + l.a + l.epi;
  return l;
}

struct Params {
  const void* x;
  const float* x_scale;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  long long sn, sc, sy, sx;
  int C, H, W, Co, co_pad, k, chunks, tiles_x, tiles_y, m_total, n_tiles, items, depth, in_bf16, out_dtype;
  bool vec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One contiguous global -> shared copy by the bulk-copy engine, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Generic-proxy stores to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: start address, LBO
// (between the two 16-byte k-halves of a core matrix row), SBO (between
// groups of 8 rows), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

// d += a * b over k = 32: A 64 x 32 and B N x 32 s8, K-major in shared memory;
// d is the warpgroup's m64nN s32 fragment (N/2 registers a thread).
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
      "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}


// q = clamp(round_half_even(fl(v / s)), -127, 127), bit for bit, without a
// division per value: r = v * fl(1/s) is within 2.3e-5 of fl(v / s) while
// |v / s| < 128.5 (two roundings of 2^-24 each), so both round to the same
// integer unless r lies within 4e-5 of a half-integer.  `quantize_fast`
// clamps r (clamping commutes with rounding to an integer, 127 being one),
// rounds it half to even by adding 1.5 * 2^23, whose float then holds q's
// two's-complement byte in its low byte, and flags r near a half-integer;
// flagged values, and all values where fl(1/s) is not a normal number
// (`exact`), are redone by `quantize_exact` with the IEEE division, outside
// the loop of fast ones.
__device__ __forceinline__ unsigned quantize_fast(float v, float inv, bool& near) {
  constexpr float ROUND = 12582912.f;  // 1.5 * 2^23
  const float r = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  const float t = __fadd_rn(r, ROUND);
  near = fabsf(__fsub_rn(r, __fsub_rn(t, ROUND))) > 0.49996f;
  return __float_as_uint(t) & 0xffu;
}

__device__ __forceinline__ unsigned quantize_exact(float v, float s) {
  return unsigned(min(127, max(-127, __float2int_rn(__fdiv_rn(v, s))))) & 0xffu;
}

// Eight neighbouring outputs of one row: the int32 sums as they are, or
// dequantized to float32 / bfloat16; 16-byte stores where W is a multiple of 8.
__device__ __forceinline__ void store_row(const Params& p, const int* src, int co, long long o, int valid) {
  const int4 lo = *reinterpret_cast<const int4*>(src), hi = *reinterpret_cast<const int4*>(src + 4);
  const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const bool vec = valid == 8 && (p.W & 7) == 0;
  if (p.out_dtype == 0) {
    int* dst = static_cast<int*>(p.out) + o;
    if (vec) {
      reinterpret_cast<int4*>(dst)[0] = lo;
      reinterpret_cast<int4*>(dst)[1] = hi;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < valid) dst[i] = v[i];
    }
    return;
  }
  const float s = p.scale[co], b = p.bias[co];
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __fadd_rn(__fmul_rn(__int2float_rn(v[i]), s), b);
  if (p.out_dtype == 1) {
    float* dst = static_cast<float*>(p.out) + o;
    if (vec) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < valid) dst[i] = f[i];
    }
    return;
  }
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + o;
  if (vec) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // .x at the lower address
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < valid) dst[i] = __float2bfloat16_rn(f[i]);
  }
}

// The m64 tiles of one work item: tile i of item `item` is m = mgroup * MTB
// + i over (image, tile row, tile column); the first tile's coordinates,
// the others reached by stepping, without divisions.
struct TileWalk {
  int n, ty, tx, m;
  __device__ __forceinline__ void step(const Params& p) {
    ++m;
    if (++tx == p.tiles_x) {
      tx = 0;
      if (++ty == p.tiles_y) {
        ty = 0;
        ++n;
      }
    }
  }
};

__device__ __forceinline__ TileWalk first_tile(const Params& p, int item, int mtb) {
  TileWalk t;
  t.m = item / p.n_tiles * mtb;
  t.tx = t.m % p.tiles_x;
  t.ty = t.m / p.tiles_x % p.tiles_y;
  t.n = t.m / (p.tiles_x * p.tiles_y);
  return t;
}

__device__ __forceinline__ unsigned word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// The vector path's units wtid, wtid + 128, ..., G at a time: the loads of
// G units in flight together, then their bytes.
template <int K, int MT, int G, bool BF16>
__device__ __forceinline__ void stage_rows(const Params& p, TileWalk t0, TileWalk t1, unsigned char* a, int chunk,
                                           int wtid, float s, float inv, bool exact) {
  constexpr int PAD = K / 2, HW = TILE + K - 1, HALO = HW * HW, LOADS = BF16 ? 3 : 6, UNITS = MT * HW * CHUNK;
  for (int ub = wtid; ub < UNITS; ub += G * 128) {
    uint4 w[G][LOADS];  // [x0-8, x0+16) of each unit: 3 loads of 8 bfloat16 or 6 of 4 float32
    int8_t* dst[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int u = ub + gi * 128;
      const int cl = u & (CHUNK - 1), r = u / CHUNK, hy = r % HW, mt = r / HW;
      const bool m1 = MT > 1 && mt;
      const int c = chunk * CHUNK + cl, y = (m1 ? t1.ty : t0.ty) * TILE - PAD + hy, x0 = (m1 ? t1.tx : t0.tx) * TILE;
      const bool ok = u < UNITS && (m1 ? t1.m : t0.m) < p.m_total && c < p.C && y >= 0 && y < p.H;
      const long long row =
          (long long)(m1 ? t1.n : t0.n) * p.sn + (long long)c * p.sc + (long long)y * p.sy + x0 - 8;
      const uint4* src = reinterpret_cast<const uint4*>(static_cast<const char*>(p.x) + row * (BF16 ? 2 : 4));
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int xq = x0 - 8 + (BF16 ? 8 : 4) * q;
        w[gi][q] = ok && xq >= 0 && xq < p.W ? __ldg(src + q) : make_uint4(0, 0, 0, 0);
      }
      dst[gi] = u < UNITS ? reinterpret_cast<int8_t*>(a) + (mt * 2 + (cl >> 4)) * HALO * 16 + hy * HW * 16 + (cl & 15)
                          : nullptr;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (dst[gi] == nullptr) continue;
      auto value = [&](int hx) {  // halo column hx's value: its place in [x0-8, x0+16) is 8 - PAD + hx
        const int e = 8 - PAD + hx;
        if (BF16) {
          const unsigned word = word_of(w[gi][e / 8], (e / 2) % 4);
          return __uint_as_float(e % 2 ? word & 0xffff0000u : word << 16);
        }
        return __uint_as_float(word_of(w[gi][e / 4], e % 4));
      };
      unsigned redo = exact ? (1u << HW) - 1 : 0u;
#pragma unroll
      for (int hx = 0; hx < HW; ++hx) {
        bool near;
        dst[gi][hx * 16] = int8_t(quantize_fast(value(hx), inv, near));
        redo |= unsigned(near) << hx;
      }
      if (redo) {
#pragma unroll
        for (int hx = 0; hx < HW; ++hx)
          if (redo >> hx & 1) dst[gi][hx * 16] = int8_t(quantize_exact(value(hx), s));
      }
    }
  }
}

template <int K, int MT>
__device__ __forceinline__ void stage_chunk(const Params& p, TileWalk t0, TileWalk t1, unsigned char* a, int chunk,
                                            int wtid, float s, float inv, bool exact) {
  constexpr int PAD = K / 2, HW = TILE + K - 1, HALO = HW * HW;
  if (p.vec) {
    if (p.in_bf16)
      stage_rows<K, MT, 4, true>(p, t0, t1, a, chunk, wtid, s, inv, exact);
    else
      stage_rows<K, MT, 2, false>(p, t0, t1, a, chunk, wtid, s, inv, exact);
    return;
  }
  for (int u = wtid; u < MT * 2 * HALO; u += 128) {
    const int mt = u / (2 * HALO), r = u - mt * 2 * HALO, h = r / HALO, pos = r - h * HALO;
    const int hy = pos / HW, hx = pos - hy * HW;
    const bool m1 = MT > 1 && mt;
    const int y = (m1 ? t1.ty : t0.ty) * TILE - PAD + hy, xx = (m1 ? t1.tx : t0.tx) * TILE - PAD + hx;
    const bool ok = (m1 ? t1.m : t0.m) < p.m_total && y >= 0 && y < p.H && xx >= 0 && xx < p.W;
    const long long base = (long long)(m1 ? t1.n : t0.n) * p.sn + (long long)y * p.sy + (long long)xx * p.sx;
    const int c0 = chunk * CHUNK + h * 16;
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.f;
    if (ok) {
      if (p.in_bf16) {
        const unsigned short* src = static_cast<const unsigned short*>(p.x) + base;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (c0 + j < p.C) v[j] = __uint_as_float(unsigned(__ldg(src + (long long)(c0 + j) * p.sc)) << 16);
      } else {
        const float* src = static_cast<const float*>(p.x) + base;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (c0 + j < p.C) v[j] = __ldg(src + (long long)(c0 + j) * p.sc);
      }
    }
    unsigned w[4] = {0, 0, 0, 0}, redo = exact ? 0xffffu : 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bool near;
      w[j >> 2] |= quantize_fast(v[j], inv, near) << (8 * (j & 3));
      redo |= unsigned(near) << j;
    }
    if (redo) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (redo >> j & 1)
          w[j >> 2] = (w[j >> 2] & ~(0xffu << (8 * (j & 3)))) | quantize_exact(v[j], s) << (8 * (j & 3));
    }
    *reinterpret_cast<uint4*>(a + size_t(mt * 2 + h) * HALO * 16 + pos * 16) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A warpgroup's first tile in item `item` (its second is the next one).
template <int MT>
__device__ __forceinline__ TileWalk tile_of(const Params& p, int item, int wg) {
  TileWalk t = first_tile(p, item, CONSUMERS * MT);
  for (int j = 0; j < wg * MT; ++j) t.step(p);
  return t;
}

// Work items are (m-group, N tile) pairs, N tile fastest; a persistent block
// takes items blockIdx.x, blockIdx.x + gridDim.x, ...; its chunks, item
// after item, are numbered g = 0, 1, ...  Warps 0-7: the two consumer
// warpgroups; warps 8-11: the producer warpgroup, whose one thread fills the
// weight ring.
template <int BN, int K>
__global__ void __launch_bounds__(THREADS, 1) qconv_int8_kernel(const Params p) {
  using TL = Tiles<BN>;
  constexpr int MT = TL::MT, HW = TILE + K - 1, HALO = HW * HW;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(BN, MT, TL::CG, K, p.depth);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* w_empty = w_full + MAX_DEPTH;
  unsigned char* ring = smem + BAR_BYTES;
  unsigned char* abase = ring + L.ring;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int items = p.items;
  const int my_chunks = (items - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x) * p.chunks;

  if (tid == 0) {
    for (int i = 0; i < p.depth; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup: one thread keeps the weight ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      constexpr uint32_t row_bytes = uint32_t(BN) * CHUNK;
      int T = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int co0 = item % p.n_tiles * BN;
        for (int t = 0; t < p.chunks * K; ++t, ++T) {
          const int slot = T % p.depth;
          if (T >= p.depth) mbar_wait(&w_empty[slot], (T / p.depth - 1) & 1);
          const int c = t / K, ky = t - c * K;
          mbar_expect_tx(&w_full[slot], row_bytes * K);
          const int8_t* src = p.w + ((long long)(c * K + ky) * K * p.co_pad + co0) * CHUNK;
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
            bulk_copy(ring + slot * L.stage + kx * row_bytes, src + (long long)kx * p.co_pad * CHUNK, row_bytes,
                      &w_full[slot]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2, wtid = tid & 127, wi = warp & 3, g = lane >> 2, tq = lane & 3;
  const float s = *p.x_scale, inv = __frcp_rn(s);
  const bool exact = !(inv >= 1.17549435e-38f && inv <= 3.40282347e38f);
  unsigned char* ahalo = abase + size_t(wg) * MT * L.tile;  // + buffer * CONSUMERS * MT * L.tile
  const size_t buf_bytes = size_t(CONSUMERS) * MT * L.tile;
  const uint32_t a_addr = smem_u32(ahalo), ring_addr = smem_u32(ring);
  int* epi = reinterpret_cast<int*>(abase + L.a) + wg * TL::CG * TL::RS;

  // Stage chunk gn's halo (of the tiles s0, s1) into buffer gn & 1.
  TileWalk s0 = tile_of<MT>(p, blockIdx.x, wg), s1 = s0;
  s1.step(p);
  auto stage = [&](int gn) {
    stage_chunk<K, MT>(p, s0, s1, ahalo + (gn & 1) * buf_bytes, gn % p.chunks, wtid, s, inv, exact);
  };

  stage(0);
  fence_proxy_async();
  warpgroup_sync(wg);
  int T = 0, gc = 0;
  int acc[MT][BN / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int co0 = item % p.n_tiles * BN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0;
    for (int c = 0; c < p.chunks; ++c, ++gc) {
      const uint32_t a0 = a_addr + uint32_t((gc & 1) * buf_bytes);
      const bool next = gc + 1 < my_chunks;
      if (next && c + 1 == p.chunks) {  // the next chunk is the next item's first
        s0 = tile_of<MT>(p, item + gridDim.x, wg);
        s1 = s0;
        s1.step(p);
      }
#pragma unroll
      for (int ky = 0; ky < K; ++ky, ++T) {
        const int slot = T % p.depth;
        mbar_wait(&w_full[slot], (T / p.depth) & 1);
        __syncwarp();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const uint64_t db = make_desc(ring_addr + uint32_t(slot * L.stage + kx * BN * CHUNK), 128, 256);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t at = a0 + uint32_t(mt * L.tile + (ky * HW + kx) * 16);
            wgmma_s8<BN>(acc[mt], make_desc(at, uint32_t(HALO * 16), uint32_t(HW * 16)), db);
          }
        }
        wgmma_commit();
        // The next chunk is quantized into the other halo buffer at step 1,
        // while this step's and the previous step's groups run (they read
        // this chunk's buffer); with K = 1 at step 0 after the wait, which
        // completes the last group that read the other one.
        const bool stage_now = next && ky == (K > 1 ? 1 : 0);
        if (ky > 0 && stage_now) stage(gc + 1);
        __syncwarp();     // wgmma.wait_group is .aligned: the warp converged
        wgmma_wait<1>();  // every group but this step's has completed
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        if (c > 0 || ky > 0) {  // an item's first step follows a step given back at the item's end
          if (lane == 0) mbar_arrive(&w_empty[(T - 1) % p.depth]);
        }
        if (ky == 0 && stage_now) stage(gc + 1);
      }
      fence_proxy_async();
      warpgroup_sync(wg);
    }
    __syncwarp();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (lane == 0) mbar_arrive(&w_empty[(T - 1) % p.depth]);

    // Epilogue, EPI_CH output channels a pass: fragments -> [channel][pixel]
    // in shared memory, then 8 pixels of one row a thread.
    const TileWalk t0 = tile_of<MT>(p, item, wg);
    TileWalk t1 = t0;
    t1.step(p);
#pragma unroll
    for (int pass = 0; pass < BN / TL::CG; ++pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < TL::CG / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * wi + g + 8 * (e >> 1), ch = jj * 8 + 2 * tq + (e & 1);
            epi[ch * TL::RS + mt * 64 + row] = acc[mt][(pass * (TL::CG / 8) + jj) * 4 + e];
          }
      warpgroup_sync(wg);
      for (int u = wtid; u < TL::CG * MT * TILE; u += 128) {
        const int ch = u / (MT * TILE), r = u - ch * MT * TILE, mt = r / TILE, row = r - mt * TILE;
        const int co = co0 + pass * TL::CG + ch;
        const bool m1 = MT > 1 && mt;
        const int y = (m1 ? t1.ty : t0.ty) * TILE + row, x0 = (m1 ? t1.tx : t0.tx) * TILE;
        if ((m1 ? t1.m : t0.m) >= p.m_total || co >= p.Co || y >= p.H) continue;
        const long long o = (((long long)(m1 ? t1.n : t0.n) * p.Co + co) * p.H + y) * (long long)p.W + x0;
        store_row(p, epi + ch * TL::RS + mt * 64 + row * TILE, co, o, min(TILE, p.W - x0));
      }
      warpgroup_sync(wg);
    }
  }
}

// The weight ring takes as many stages of one kernel row as fit beside the
// halo and epilogue buffers, at most MAX_DEPTH; fewer than two are refused.
template <int BN, int K>
cudaError_t launch_qconv(Params p, cudaStream_t stream) {
  using TL = Tiles<BN>;
  static size_t opted = 0;  // dynamic shared memory this instantiation is opted into
  p.depth = MAX_DEPTH;
  while (p.depth > 2 && layout(BN, TL::MT, TL::CG, K, p.depth).total > SMEM_MAX) --p.depth;
  const Layout L = layout(BN, TL::MT, TL::CG, K, p.depth);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  if (L.total > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(qconv_int8_kernel<BN, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (err != cudaSuccess) return err;
    opted = L.total;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = p.items < sms ? p.items : sms;
  qconv_int8_kernel<BN, K><<<blocks, THREADS, L.total, stream>>>(p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_k(const Params& p, cudaStream_t stream) {
  switch (p.k) {
    case 1: return launch_qconv<BN, 1>(p, stream);
    case 3: return launch_qconv<BN, 3>(p, stream);
    case 5: return launch_qconv<BN, 5>(p, stream);
    case 7: return launch_qconv<BN, 7>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [N, C, H, W] float32 (in_dtype 0) or bfloat16 (1), element strides sn,
// sc, sy, sx; x_scale a device float32 scalar; w the weights repacked as
// [ceil(C/32)][k*k][Co_pad/8][2][8][16] int8 (Co_pad = Co rounded up to bn);
// scale and bias [Co] float32 (unused for int32 output); out [N, Co, H, W]
// contiguous.  bn, the N tile the weights were repacked for, in {8, 32, 64,
// 128, 256}.  out_dtype: 0 = int32 (the sums, no epilogue), 1 = float32,
// 2 = bfloat16.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int qconv_int8(const void* x, const void* x_scale, const void* w, const void* scale, const void* bias,
                          void* out, long long sn, long long sc, long long sy, long long sx, int N, int C, int H,
                          int W, int Co, int k, int bn, int in_dtype, int out_dtype, void* stream) {
  if (k < 1 || k > 7 || (k & 1) == 0 || C <= 0 || Co <= 0 || N <= 0 || H <= 0 || W <= 0 ||
      (in_dtype != 0 && in_dtype != 1) || out_dtype < 0 || out_dtype > 2 ||
      (out_dtype != 0 && (scale == nullptr || bias == nullptr)))
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.x_scale = static_cast<const float*>(x_scale);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.sn = sn;
  p.sc = sc;
  p.sy = sy;
  p.sx = sx;
  p.C = C;
  p.H = H;
  p.W = W;
  p.Co = Co;
  p.co_pad = (Co + bn - 1) / bn * bn;
  p.k = k;
  p.chunks = (C + CHUNK - 1) / CHUNK;
  p.tiles_x = (W + TILE - 1) / TILE;
  p.tiles_y = (H + TILE - 1) / TILE;
  const long long m_total = (long long)N * p.tiles_x * p.tiles_y;
  const int mt = bn == 256 ? 1 : 2;
  const long long items = (m_total + CONSUMERS * mt - 1) / (CONSUMERS * mt) * (p.co_pad / bn);
  if (items > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  p.m_total = int(m_total);
  p.n_tiles = p.co_pad / bn;
  p.items = int(items);
  p.in_bf16 = in_dtype;
  p.out_dtype = out_dtype;
  // The vector path reads rows of x with 16-byte loads: unit x stride, W a
  // multiple of 8, and the base and every row start 16-byte aligned.
  const long long per16 = in_dtype ? 8 : 4;  // values in 16 bytes
  p.vec = sx == 1 && W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && sn % per16 == 0 &&
          sc % per16 == 0 && sy % per16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8: return int(launch_k<8>(p, st));
    case 32: return int(launch_k<32>(p, st));
    case 64: return int(launch_k<64>(p, st));
    case 128: return int(launch_k<128>(p, st));
    case 256: return int(launch_k<256>(p, st));
  }
  return int(cudaErrorInvalidValue);
}

extern "C" const char* qconv_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
