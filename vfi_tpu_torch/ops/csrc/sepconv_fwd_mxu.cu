// Adaptive separable convolution, forward, banded tensor-core form, for sm_90a (H100).
//
//   out[b,y,x,c] = sum_f v[b,y,x,f] * inner[f,x],
//   inner[f,x]   = sum_u x[b,y+f,u,c] * S_y[u,x],   S_y[u,x] = h[b,y,x,u-x] (0 <= u-x < ks, else 0)
//
// Replaces vfi_tpu's Pallas kernel _sepconv_pallas_mxu_raw
// (vfi_tpu/ops/sepconv.py:317-484), which builds the banded matrix S in VMEM
// and runs one [ks, TW+ks-1] x [TW+ks-1, TW] MXU product per output row,
// column-tiled at TW=128, with f32 as a bf16 hi/lo three-product split.
//
// What bounds it on the H100: the per-pixel kernels.  At the bi-TAI serving
// shape (B*T=320, 128x128, ks=51, C=1) v and h are 535 MB each in bf16 while
// x and out are 20 MB and 10 MB: 1.1 GB, 0.33 ms at 3.35 TB/s in bf16, twice
// that in f32.  The banded products are 2*ks*(TW+ks-1)*TW flops per output
// row and channel before the band is skipped, about 0.1 ms of bf16 tensor-core
// time at that shape, so the call is bounded by bytes.
//
// What this design does about it: every element of v and h is read from
// device memory once, coalesced along x (the heads' layout has tap stride
// H*W), and never repeated per channel.  One block of 16 warps takes one
// image, a tile of TH output rows and a column tile of TW=128 outputs (one
// n-tile of 8 columns per warp).  It stages the input slab (TH+ks-1 rows of
// TW+ks-1 columns, every channel) once, zeroes S once (the band sits at the
// same place in every row), then for each output row writes the row's TW*ks
// band values into S and its vertical taps into shared memory, and runs the
// horizontal pass as mma.sync m16n8k16 bf16 products with f32 accumulation:
// A is the slab (ks tap rows, padded to a multiple of 16 by repeating the
// last row, whose products meet v=0), B is S.  S is kept per n-tile, holding
// only the k-chunks of 16 that meet that tile's band (4-5 of 12 at ks=51), so
// each warp skips the rest and S takes 22 KB instead of 51 KB.  The tap
// reduction sum_f inner[f,x]*v[y,x,f] runs in f32 on the accumulator
// fragments, then a warp shuffle across the fragment rows.  float32 operands
// are split as hi + lo bf16 pairs and multiplied as hi*hi + lo*hi + hi*lo
// (the TPU kernel's split); the slab and S then take twice the shared
// memory, so the row tile shrinks to fit.  Sums are f32; the result is
// rounded once.
//
// This is the simple tensor-core kernel: plain 32-bit shared loads for the
// fragments, two barriers per output row, no wgmma, TMA or pipelining.  On
// the H100 its per-row staging of h and v and its products take about the
// same time and do not overlap (scripts/time_sepconv_fwd_mxu_variants.py):
// staging them through cp.async or TMA into a second buffer while the
// products of the previous row run is the next step.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "sepconv_mma.cuh"

namespace {

using sepconv::ld2;
using sepconv::ld32;
using sepconv::mma_bf16;
using sepconv::put_split;
using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;
using sepconv::to_smem;

constexpr int TW = 128;  // output columns per block (the TPU kernel's column tile)
constexpr int WARPS = 16;  // one n-tile each
constexpr int THREADS = WARPS * 32;
constexpr int NTILES = TW / 8;  // n-tiles of 8 columns, NTILES / WARPS per warp
constexpr int MT_MAX = 4;       // m-tiles of 16 taps: ks <= 64
constexpr int VRS = TW + 8;     // row stride of the staged v (conflict-free fragment reads)
constexpr size_t SMEM_MAX = 232448;     // the most dynamic shared memory a block may use
constexpr size_t SMEM_TWO_PER_SM = 115712;  // at most this, two blocks fit on one SM

struct Geometry {
  int ks, kpad, rs, sk, srs, th, rows;
};

__host__ __device__ inline Geometry geometry(int ks, int th) {
  Geometry g;
  g.ks = ks;
  g.kpad = (TW + ks - 1 + 15) / 16 * 16;  // K of the products, padded to 16
  g.rs = g.kpad + 8;                      // slab row stride: (rs/2) % 32 in {4,12,20,28}
  g.sk = ((ks + 14) / 16 + 1) * 16;       // k-chunks one n-tile's band can meet, times 16
  g.srs = g.sk + 8;                       // S row stride, conflict-free as rs
  g.th = th;
  g.rows = th + ks - 1;
  return g;
}

template <typename T, int C>
size_t smem_bytes(const Geometry& g) {
  constexpr int parts = std::is_same<T, float>::value ? 2 : 1;  // hi (and lo)
  return sizeof(__nv_bfloat16) * parts * (size_t(C) * g.rows * g.rs + size_t(NTILES) * 8 * g.srs) +
         sizeof(T) * size_t(g.ks) * VRS;
}

// Tap j and column xl of element i of a row's TW x ks kernel values, walked
// so that the index with unit stride in memory varies fastest across threads.
__device__ __forceinline__ void tap_col(int i, int ks, bool tap_unit_stride, int& j, int& xl) {
  if (tap_unit_stride) {
    j = i % ks;
    xl = i / ks;
  } else {
    j = i / TW;
    xl = i % TW;
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
sepconv_fwd_mxu_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ h,
                       T* __restrict__ out, Strides sx, Strides sv, Strides sh, Strides so,
                       int H, int W, int ks, int th, int tiles_y, int tiles_x) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int PARTS = SPLIT ? 2 : 1;
  // Loads each thread keeps in flight while staging (the fastest of 1, 4, 8
  // and 16 on the H100 at the serving shapes: 4 for bf16, 16 for f32).
  constexpr int U = SPLIT ? 16 : 4;
  const Geometry g = geometry(ks, th);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [PARTS][C][rows][rs]
  const size_t xpart = size_t(C) * g.rows * g.rs;
  __nv_bfloat16* ss = xs + PARTS * xpart;  // [PARTS][NTILES][8][srs]
  const size_t spart = size_t(NTILES) * 8 * g.srs;
  T* vs = reinterpret_cast<T*>(ss + PARTS * spart);  // [ks][VRS]

  const int per_image = tiles_y * tiles_x;
  const int b = blockIdx.x / per_image;
  const int y0 = (blockIdx.x % per_image) / tiles_x * th;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int tid = threadIdx.x;
  const int Hp = H + ks - 1;
  const int Wp = W + ks - 1;
  const int ku = TW + ks - 1;  // slab columns that carry data

  // The input slab, every channel; columns past the slab's TW+ks-1 and rows
  // or columns past the padded image are zero.
  sepconv::stage_slab<T, C, THREADS, U>(xs, xpart, x + b * sx.b, sx, y0, x0, g.rows, g.kpad, g.rs, ku, Hp, Wp,
                                        tid);
  const int s_words = int(PARTS * spart / 2);
  for (int i = tid; i < s_words; i += THREADS) reinterpret_cast<uint32_t*>(ss)[i] = 0u;

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // fragment column pair
  const int mts = (ks + 15) / 16;

  const T* hb = h + b * sh.b;
  const T* vb = v + b * sv.b;
  const int n_band = TW * ks;
  for (int yy = 0; yy < th; ++yy) {
    const int y = y0 + yy;
    if (y >= H) break;
    __syncthreads();  // the slab and zeroed S are in place; the previous row's products are done

    // The row's band of S (column xl of tile xl/8 holds h[y, x0+xl, :] from
    // k = xl - kbase on) and its vertical taps; columns past W are zero.
    // U loads of each in flight per thread.
    for (int base = tid; base < n_band; base += U * THREADS) {
      float a[U], w[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = base + k * THREADS;
        int j, xl;
        tap_col(i, ks, sh.last == 1, j, xl);
        a[k] = (i < n_band && x0 + xl < W) ? to_float(hb[y * sh.y + (x0 + xl) * sh.x + j * sh.last]) : 0.f;
        tap_col(i, ks, sv.last == 1, j, xl);
        w[k] = (i < n_band && x0 + xl < W) ? to_float(vb[y * sv.y + (x0 + xl) * sv.x + j * sv.last]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = base + k * THREADS;
        if (i < n_band) {
          int j, xl;
          tap_col(i, ks, sh.last == 1, j, xl);
          put_split<SPLIT>(ss, ss + spart, size_t(xl) * g.srs + xl + j - 16 * (xl >> 4), a[k]);
          tap_col(i, ks, sv.last == 1, j, xl);
          to_smem(vs + j * VRS + xl, w[k]);
        }
      }
    }
    __syncthreads();

    for (int q = 0; q < NTILES / WARPS; ++q) {
      const int nt = warp * (NTILES / WARPS) + q;
      const int n0 = nt * 8;
      if (x0 + n0 >= W) break;  // warp-uniform: this tile and the next are past the image
      const int kbase = 16 * (nt >> 1);
      const int nch = (n0 + ks + 6 - kbase) / 16 + 1;  // k-chunks that meet the band
      const __nv_bfloat16* sb = ss + size_t(n0 + gr) * g.srs + 2 * tq;

      // Slab rows of this thread's fragment rows f = 16*mt + gr (+8); taps
      // past ks repeat row ks-1 (finite, and their sums meet v = 0).
      int r0[MT_MAX], r1[MT_MAX];
#pragma unroll
      for (int mt = 0; mt < MT_MAX; ++mt) {
        r0[mt] = (yy + min(16 * mt + gr, ks - 1)) * g.rs + 2 * tq;
        r1[mt] = (yy + min(16 * mt + gr + 8, ks - 1)) * g.rs + 2 * tq;
      }

      for (int c = 0; c < C; ++c) {
        const __nv_bfloat16* xa = xs + size_t(c) * g.rows * g.rs;
        float acc[MT_MAX][4];
#pragma unroll
        for (int mt = 0; mt < MT_MAX; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

        for (int kc = 0; kc < nch; ++kc) {
          const int k = kbase + 16 * kc;
          const uint32_t b0 = ld32(sb + 16 * kc), b1 = ld32(sb + 16 * kc + 8);
          uint32_t bl0 = 0, bl1 = 0;
          if (SPLIT) {
            bl0 = ld32(sb + spart + 16 * kc);
            bl1 = ld32(sb + spart + 16 * kc + 8);
          }
#pragma unroll
          for (int mt = 0; mt < MT_MAX; ++mt) {
            if (mt >= mts) continue;
            const __nv_bfloat16* p0 = xa + r0[mt] + k;
            const __nv_bfloat16* p1 = xa + r1[mt] + k;
            const uint32_t a0 = ld32(p0), a1 = ld32(p1), a2 = ld32(p0 + 8), a3 = ld32(p1 + 8);
            mma_bf16(acc[mt], a0, a1, a2, a3, b0, b1);
            if (SPLIT) {
              const uint32_t l0 = ld32(p0 + xpart), l1 = ld32(p1 + xpart);
              const uint32_t l2 = ld32(p0 + xpart + 8), l3 = ld32(p1 + xpart + 8);
              mma_bf16(acc[mt], l0, l1, l2, l3, b0, b1);
              mma_bf16(acc[mt], a0, a1, a2, a3, bl0, bl1);
            }
          }
        }

        // Tap reduction: this thread holds inner[f, n0+2tq+{0,1}] for
        // f = 16*mt + gr and 16*mt + gr + 8.
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT_MAX; ++mt) {
          if (mt >= mts) continue;
          const int f0 = 16 * mt + gr;
          const int f1 = f0 + 8;
          if (f0 < ks) {
            const float2 w = ld2(vs + f0 * VRS + n0 + 2 * tq);
            s0 = fmaf(acc[mt][0], w.x, s0);
            s1 = fmaf(acc[mt][1], w.y, s1);
          }
          if (f1 < ks) {
            const float2 w = ld2(vs + f1 * VRS + n0 + 2 * tq);
            s0 = fmaf(acc[mt][2], w.x, s0);
            s1 = fmaf(acc[mt][3], w.y, s1);
          }
        }
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, m);
          s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        }
        if (gr == 0) {
          const int gx = x0 + n0 + 2 * tq;
          T* op = out + b * so.b + y * so.y + c * so.last;
          if (gx < W) store(op + gx * so.x, s0);
          if (gx + 1 < W) store(op + (gx + 1) * so.x, s1);
        }
      }
    }
  }
}

struct FwdMxu {
  template <typename T, int C>
  static cudaError_t run(const void* x, const void* v, const void* h, void* out, Strides sx, Strides sv,
                         Strides sh, Strides so, int B, int H, int W, int ks, cudaStream_t stream) {
    if (ks > 16 * MT_MAX) return cudaErrorInvalidValue;
    // The row tile: the largest of 16 and 8 that lets two blocks share an
    // SM, else the largest that fits a block's shared memory at all.
    int th = 0;
    for (int t : {16, 8}) {
      if (smem_bytes<T, C>(geometry(ks, t)) <= SMEM_TWO_PER_SM) {
        th = t;
        break;
      }
    }
    if (th == 0) {
      for (int t : {16, 8, 4, 2, 1}) {
        if (smem_bytes<T, C>(geometry(ks, t)) <= SMEM_MAX) {
          th = t;
          break;
        }
      }
    }
    if (th == 0) return cudaErrorInvalidValue;  // float32 with 4 channels at large ks
    const int tiles_x = (W + TW - 1) / TW;
    const int tiles_y = (H + th - 1) / th;
    return sepconv::launch_kernel(sepconv_fwd_mxu_kernel<T, C>, (long long)B * tiles_y * tiles_x, THREADS,
                                  smem_bytes<T, C>(geometry(ks, th)), stream, static_cast<const T*>(x),
                                  static_cast<const T*>(v), static_cast<const T*>(h), static_cast<T*>(out), sx,
                                  sv, sh, so, H, W, ks, th, tiles_y, tiles_x);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int sepconv_fwd_mxu(const void* x, const void* v, const void* h, void* out,
                               long long sxb, long long sxy, long long sxx, long long sxc,
                               long long svb, long long svy, long long svx, long long svf,
                               long long shb, long long shy, long long shx, long long shf,
                               long long sob, long long soy, long long sox, long long soc,
                               int B, int H, int W, int C, int ks, int dtype, void* stream) {
  const Strides sx{sxb, sxy, sxx, sxc}, sv{svb, svy, svx, svf};
  const Strides sh{shb, shy, shx, shf}, so{sob, soy, sox, soc};
  return int(sepconv::dispatch<FwdMxu>(dtype, C, x, v, h, out, sx, sv, sh, so, B, H, W, ks,
                                       static_cast<cudaStream_t>(stream)));
}

extern "C" const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
