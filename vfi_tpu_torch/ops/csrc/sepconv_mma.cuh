// Tensor-core and asynchronous-copy helpers shared by the banded sepconv
// kernels (the banded forward and both adjoints), for sm_90a.
#pragma once

#include <cstdint>

#include "sepconv_common.cuh"

namespace sepconv {

// Write a (exact in bf16 for bf16 operands) as hi, and for float32 its
// remainder as lo.
template <bool SPLIT>
__device__ __forceinline__ void put_split(__nv_bfloat16* hi, __nv_bfloat16* lo, size_t i, float a) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a);
  hi[i] = ah;
  if (SPLIT) lo[i] = __float2bfloat16_rn(a - __bfloat162float(ah));
}

// Two floats as a packed bf16 pair (a in the low half, as a fragment holds
// its lower column), rounded to nearest, with their remainders as the lo pair.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - back.x, b - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// D += A * B, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l%8 of matrix l/8 (16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same from a shared-memory address.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Four 8x8 bf16 matrices, transposed, from shared memory: lane l gives the
// address of row l%8 of matrix l/8 (16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes from device to shared memory without passing through registers.
// Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void to_smem(float* p, float a) { *p = a; }
__device__ __forceinline__ void to_smem(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// The input slab of a banded kernel's block, every channel, as bf16 (hi and,
// for float32, lo parts xpart apart): xs[(c*rows + r)*rs + u] = x[y0+r, x0+u, c]
// for u < ku inside the padded image, else 0, for u < kpad.  Each of the
// NT threads keeps U loads in flight.
template <typename T, int C, int NT, int U>
__device__ __forceinline__ void stage_slab(__nv_bfloat16* xs, size_t xpart, const T* xb, Strides sx, int y0,
                                           int x0, int rows, int kpad, int rs, int ku, int Hp, int Wp, int tid) {
  constexpr bool SPLIT = sizeof(T) == 4;
  const int n_slab = C * rows * kpad;
  for (int base = tid; base < n_slab; base += U * NT) {
    float a[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = base + k * NT;
      const int c = i / (rows * kpad);
      const int gy = y0 + (i / kpad) % rows;
      const int u = i % kpad;
      const int gx = x0 + u;
      a[k] = (i < n_slab && u < ku && gy < Hp && gx < Wp) ? to_float(xb[gy * sx.y + gx * sx.x + c * sx.last]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = base + k * NT;
      if (i < n_slab) put_split<SPLIT>(xs, xs + xpart, size_t(i / kpad) * rs + i % kpad, a[k]);
    }
  }
}

// Stage `rows` rows of n elements along x of a rank-4 operand into shared
// memory: dst[r*dst_stride + i] = src[r*row_stride + (x0+i)*x_stride] for
// 0 <= x0+i < W.  Elements outside [0, W) are not written: the caller zeroes
// them once, since a block's columns stay where they are from row to row.
// Where the operand allows it (`async`: unit x stride, every other stride and
// the base 16-byte aligned; see async_ok) whole in-range 16-byte chunks go by
// cp.async and only a chunk cut by the image edge by scalar loads; x0, n and
// dst_stride must then be multiples of the chunk.  Scalar loads walk the
// index with unit stride fastest.  NT threads share the work.
template <typename T, int NT>
__device__ __forceinline__ void stage_rows(T* dst, int dst_stride, const T* src, long long row_stride,
                                           long long x_stride, int rows, int x0, int n, int W, bool async,
                                           int tid) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  if (async) {
    const int nc = n / V;
    const int dr = NT / nc, dc = NT % nc;  // the walk over (row, chunk), without a division per step
    for (int r = tid / nc, c = tid % nc; r < rows;) {
      const int i = c * V;
      const int x = x0 + i;
      T* d = dst + r * dst_stride + i;
      const T* s = src + r * row_stride;
      if (x >= 0 && x + V <= W) {
        cp_async16(d, s + x);
      } else if (x + V > 0 && x < W) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (x + k >= 0 && x + k < W) to_smem(d + k, to_float(s[x + k]));
      }
      r += dr;
      c += dc;
      if (c >= nc) {
        c -= nc;
        ++r;
      }
    }
  } else {
    const bool rows_fastest = row_stride == 1;
    for (int idx = tid; idx < rows * n; idx += NT) {
      const int r = rows_fastest ? idx % rows : idx / n;
      const int i = rows_fastest ? idx / rows : idx % n;
      const int x = x0 + i;
      if (x >= 0 && x < W) to_smem(dst + r * dst_stride + i, to_float(src[r * row_stride + x * x_stride]));
    }
  }
}

// Zero n bytes of shared memory (a multiple of 16, 16-byte aligned), NT threads.
template <int NT>
__device__ __forceinline__ void zero_smem(void* p, size_t n, int tid) {
  uint4* q = static_cast<uint4*>(p);
  for (size_t i = tid; i < n / 16; i += NT) q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The banded kernels' horizontal pass for one output row and one n-tile of 8
// output columns n0..n0+7 of a column tile (the forward's inner product, and
// bwd_vh's grad_v before g):
//
//   inner_c[f, n0+n] = sum_u slab_c[yy+f, u] * S[u, n0+n],  S[u, x] = h[x, u-x] (0 <= u-x < ks)
//
// for f < 16*BAND_MT (taps past ks repeat slab row ks-1; their sums are
// finite and the caller drops them).  xs is the block's slab ([C][rows][rs]
// bf16, the lo parts xpart further on for float32); hs the row's staged h,
// tap-major with row stride hrs (column x of the tile at hs[j*hrs + x]).  S's
// fragments are formed in registers from hs, only on the k-chunks of 16 that
// the n-tile's band meets (4-5 at ks=51), rounded as bf16 hi (and, SPLIT, lo)
// pairs; A comes by ldmatrix.  The products are mma.sync m16n8k16, bf16 in,
// f32 sums: hi*hi, then for SPLIT lo*hi and hi*lo.  For each channel c,
// epi(c, acc) gets the f32 fragments: acc[mt][0..1] hold inner_c[16*mt+gr,
// n0+2*tq+{0,1}], acc[mt][2..3] the same for tap 16*mt+gr+8 (gr = lane/4,
// tq = lane%4).  Warp-wide; ks <= 16*BAND_MT.
constexpr int BAND_MT = 4;   // m-tiles of 16 taps
constexpr int BAND_NCH = 5;  // k-chunks of 16 one n-tile's band can meet

template <bool SPLIT, int C, typename T, typename Epilogue>
__device__ __forceinline__ void banded_horizontal_pass(const __nv_bfloat16* xs, size_t xpart, int rows, int rs,
                                                       const T* hs, int hrs, int n0, int yy, int ks, int lane,
                                                       Epilogue epi) {
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int kbase = 16 * (n0 >> 4);
  const int nch = (n0 + ks + 6 - kbase) / 16 + 1;
  // B = S on the band's k-chunks: bf[kc] = (hi b0, hi b1, lo b0, lo b1).
  uint32_t bf[BAND_NCH][4];
  const T* hx = hs + n0 + gr;  // column n0 + gr of the staged taps
#pragma unroll
  for (int kc = 0; kc < BAND_NCH; ++kc) {
    const int j = kbase + 16 * kc + 2 * tq - (n0 + gr);
    float e[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int jt = j + (t & 1) + 8 * (t >> 1);
      e[t] = (kc < nch && jt >= 0 && jt < ks) ? to_float(hx[jt * hrs]) : 0.f;
    }
    split_pair(e[0], e[1], bf[kc][0], bf[kc][2]);
    split_pair(e[2], e[3], bf[kc][1], bf[kc][3]);
  }
  // ldmatrix rows: lane l gives row (l%8) + 8*((l/8)%2) of the m-tile, columns
  // k + 8*(l/16), so that the four matrices are the fragment's a0..a3.
  // Shared-memory byte addresses, 32 bits.
  // Every m-tile runs, also past ks (a few idle products at small ks, one
  // register less); the addresses move to the next channel's slab as it
  // starts.
  const uint32_t xs0 = static_cast<uint32_t>(__cvta_generic_to_shared(xs)) + 2 * (8 * (lane >> 4) + kbase);
  uint32_t arow[BAND_MT];
#pragma unroll
  for (int mt = 0; mt < BAND_MT; ++mt)
    arow[mt] = xs0 + 2 * (yy + min(16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1), ks - 1)) * rs;
  const uint32_t lo_ofs = 2 * uint32_t(xpart);
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    if (c > 0) {
#pragma unroll
      for (int mt = 0; mt < BAND_MT; ++mt) arow[mt] += 2 * rows * rs;
    }
    float acc[BAND_MT][4] = {};
#pragma unroll
    for (int kc = 0; kc < BAND_NCH; ++kc) {
      if (kc >= nch) break;
#pragma unroll
      for (int mt = 0; mt < BAND_MT; ++mt) {
        const uint32_t ar = arow[mt] + 32 * kc;
        uint32_t a[4];
        ldmatrix_x4(a, ar);
        mma_bf16(acc[mt], a[0], a[1], a[2], a[3], bf[kc][0], bf[kc][1]);
        if (SPLIT) {
          uint32_t l[4];
          ldmatrix_x4(l, ar + lo_ofs);
          mma_bf16(acc[mt], l[0], l[1], l[2], l[3], bf[kc][0], bf[kc][1]);
          mma_bf16(acc[mt], a[0], a[1], a[2], a[3], bf[kc][2], bf[kc][3]);
        }
      }
    }
    epi(c, acc);
  }
}

// True when cp.async may stage rows of this operand (see stage_rows): x has
// unit stride, and the base and the other strides are 16-byte aligned.  A
// one-channel operand's channel stride is never used (pass C).
inline bool async_ok(const void* p, Strides s, int elem_bytes, int rows_used = 2) {
  const long long v = 16 / elem_bytes;
  return s.x == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % v == 0 && s.y % v == 0 &&
         (rows_used == 1 || s.last % v == 0);
}

}  // namespace sepconv
