// Adaptive separable convolution, adjoint for the per-pixel kernels, banded
// tensor-core form, for sm_90a (H100).
//
//   grad_v[b,y,x,f] = sum_c g[b,y,x,c] * inner_c[f,x],  inner_c[f,x] = sum_u x[b,y+f,u,c] * S_y[u,x]
//   grad_h[b,y,x,j] = sum_c g[b,y,x,c] * P_c[x,x+j],    P_c[x,u]     = sum_f v[b,y,x,f] * x[b,y+f,u,c]
//
// with S_y[u,x] = h[b,y,x,u-x] (0 <= u-x < ks, else 0), the forward's banded matrix.
//
// Replaces vfi_tpu's Pallas kernel _sepconv_pallas_bwd_vh_raw
// (vfi_tpu/ops/sepconv.py:487-635), which runs the same two MXU products per
// output row (the forward's horizontal pass against S for grad_v, the
// vertical pass v @ slab unskewed for grad_h) per (image, channel), and sums
// the channels outside the call.
//
// What bounds it on the H100: bytes.  At the bi-TAI training shape (B*T=40,
// 128x128, ks=51, C=1) it reads v and h and writes grad_v and grad_h, 33 M
// elements each, while x and g are 1.3 M and 0.7 M: 0.27 GB in bf16, 0.08 ms
// at 3.35 TB/s (twice that in f32).  The two banded products are about
// 4*ks*(TW+ks-1) flops per output pixel and channel before the band is
// skipped, tens of microseconds of bf16 tensor-core time.
//
// What this design does about it: every element of v, h, grad_v and grad_h
// crosses device memory once, and the channel sum happens inside the kernel.
// One block of 16 warps takes one image, TH output rows and a column tile of
// TW=128 (the forward's tile).  It stages the input slab (TH+ks-1 rows of
// TW+ks-1 columns, every channel, as bf16 or a bf16 hi/lo pair) once.  Per
// output row it stages h, v (tap-major, [ks][TW]) and g by cp.async 16-byte
// copies into one of two buffers while the previous row's products run, so
// there is one barrier per row.  grad_v: each warp takes an n-tile of 8
// columns and runs the forward's horizontal pass, the function the banded
// forward calls too (sepconv_mma.cuh, banded_horizontal_pass: mma.sync
// m16n8k16, A the slab rows f by ldmatrix, padded to 64 by repeating the
// last row; B = S_y formed in registers straight from the staged h, only on
// the 4-5 k-chunks of 16 its band meets); g multiplies the f32 accumulators
// per channel.  grad_h: each warp
// takes an m-tile of 16 columns x and half of the 9 n-tiles of 8 input
// columns u in [x0, x0+ks+15) that its band needs (A = v from the staged
// taps, K = f padded to 64 with zeros; B = the slab by ldmatrix.trans); g
// again multiplies the accumulators, and the result is unskewed (j = u-x)
// through a shared [ks][TW] buffer, double-buffered like the inputs, so that
// stores stay coalesced along x.  float32 operands multiply as the bf16 split
// hi*hi + lo*hi + hi*lo (the TPU kernel's split); their tiles take twice the
// shared memory, so the row tile shrinks, and with 3-4 channels only one
// staging buffer fits (two barriers per row).  Operands come with element
// strides (the heads' NCHW outputs permuted to [B,H,W,ks], contiguous NHWC, a
// cotangent expanded with stride 0); rows that cp.async cannot copy (x not
// unit-stride, or not 16-byte aligned) take scalar loads.  Sums are f32;
// each output is rounded once.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "sepconv_mma.cuh"

namespace {

using sepconv::mma_bf16;
using sepconv::split_pair;
using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;
using sepconv::to_smem;

constexpr int TW = 128;  // output columns per block
constexpr int WARPS = 16;  // grad_v: one n-tile of 8 columns each; grad_h: half an m-tile of 16
constexpr int THREADS = WARPS * 32;
constexpr int KC_MAX = sepconv::BAND_MT;  // k-chunks (grad_h) and m-tiles (grad_v) of 16 taps: ks <= 64
constexpr int NQ = 5;       // grad_h n-tiles per warp: ceil(ceil((ks+15)/8) / 2)
constexpr size_t SMEM_MAX = 232448;

// Row stride of the staged [ks][TW] rows: conflict-free fragment loads, 16-byte rows.
template <typename T>
__host__ __device__ constexpr int row_stride() {
  return sizeof(T) == 2 ? TW + 8 : TW + 4;
}

struct Geometry {
  int ks, nth, kpad, rs, th, rows, nbuf;
};

__host__ __device__ inline Geometry geometry(int ks, int th, int nbuf) {
  Geometry g;
  g.ks = ks;
  g.nth = (ks + 22) / 8;  // grad_h n-tiles: u in [x0m, x0m + 8*nth) covers [x0m, x0m+ks+15)
  const int k1 = (TW + ks - 1 + 15) / 16 * 16;       // grad_v's k-chunks (the forward's K)
  const int k2 = (TW - 16 + 8 * g.nth + 15) / 16 * 16;  // grad_h's last n-tile
  g.kpad = k1 > k2 ? k1 : k2;
  g.rs = g.kpad + 8;  // slab row stride: conflict-free 32-bit and ldmatrix reads
  g.th = th;
  g.rows = th + ks - 1;
  g.nbuf = nbuf;
  return g;
}

// One staging buffer: h, v (tap-major [ks][row_stride]), g ([C][TW]) and the
// unskewed grad_h ([ks][row_stride]), all of type T.
template <typename T, int C>
__host__ __device__ inline size_t buffer_elems(int ks) {
  return size_t(3) * ks * row_stride<T>() + size_t(C) * TW;
}

template <typename T, int C>
size_t smem_bytes(const Geometry& g) {
  constexpr int parts = sizeof(T) == 4 ? 2 : 1;
  return sizeof(__nv_bfloat16) * parts * size_t(C) * g.rows * g.rs + sizeof(T) * g.nbuf * buffer_elems<T, C>(g.ks);
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
sepconv_bwd_vh_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ h,
                      const T* __restrict__ g, T* __restrict__ gv, T* __restrict__ gh, Strides sx, Strides sv,
                      Strides sh, Strides sg, Strides sgv, Strides sgh, int H, int W, int ks, int th, int nbuf,
                      int tiles_y, int tiles_x, bool v_async, bool h_async, bool g_async) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int PARTS = SPLIT ? 2 : 1;
  constexpr int U = SPLIT ? 16 : 4;  // slab loads in flight per thread (the forward's choice)
  constexpr int HRS = row_stride<T>();
  const Geometry geo = geometry(ks, th, nbuf);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [PARTS][C][rows][rs]
  const size_t xpart = size_t(C) * geo.rows * geo.rs;
  T* bufs = reinterpret_cast<T*>(xs + PARTS * xpart);
  const size_t buf_elems = buffer_elems<T, C>(ks);

  const int per_image = tiles_y * tiles_x;
  const int b = blockIdx.x / per_image;
  const int y0 = (blockIdx.x % per_image) / tiles_x * th;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // fragment column pair
  const int n_rows = min(th, H - y0);

  sepconv::stage_slab<T, C, THREADS, U>(xs, xpart, x + b * sx.b, sx, y0, x0, geo.rows, geo.kpad, geo.rs,
                                        TW + ks - 1, H + ks - 1, W + ks - 1, tid);

  auto hbuf = [&](int i) { return bufs + i * buf_elems; };
  auto vbuf = [&](int i) { return bufs + i * buf_elems + ks * HRS; };
  auto ghbuf = [&](int i) { return bufs + i * buf_elems + 2 * ks * HRS; };
  auto gbuf = [&](int i) { return bufs + i * buf_elems + 3 * ks * HRS; };

  // Row yy's h, v and g into buffer i (cp.async where the operand allows).
  auto stage = [&](int yy, int i) {
    const int y = y0 + yy;
    sepconv::stage_rows<T, THREADS>(hbuf(i), HRS, h + b * sh.b + y * sh.y, sh.last, sh.x, ks, x0, TW, W, h_async,
                                    tid);
    sepconv::stage_rows<T, THREADS>(vbuf(i), HRS, v + b * sv.b + y * sv.y, sv.last, sv.x, ks, x0, TW, W, v_async,
                                    tid);
    sepconv::stage_rows<T, THREADS>(gbuf(i), TW, g + b * sg.b + y * sg.y, sg.last, sg.x, C, x0, TW, W, g_async,
                                    tid);
    sepconv::cp_async_commit();
  };

  // Row yy's unskewed grad_h from buffer i to device memory, the index with
  // unit stride fastest across threads.
  auto store_gh = [&](int yy, int i) {
    const T* src = ghbuf(i);
    T* dst = gh + b * sgh.b + (y0 + yy) * sgh.y;
    const bool tap_fastest = sgh.last == 1;
    for (int e = tid; e < ks * TW; e += THREADS) {
      const int j = tap_fastest ? e % ks : e / TW;
      const int xl = tap_fastest ? e / ks : e % TW;
      if (x0 + xl < W) store(dst + (x0 + xl) * sgh.x + j * sgh.last, to_float(src[j * HRS + xl]));
    }
  };

  // Columns past W stay zero in every buffer.
  sepconv::zero_smem<THREADS>(bufs, nbuf * buf_elems * sizeof(T), tid);
  __syncthreads();
  if (nbuf == 2) stage(0, 0);
  for (int yy = 0; yy < n_rows; ++yy) {
    const int cur = nbuf == 2 ? yy & 1 : 0;
    if (nbuf == 1) stage(yy, 0);
    sepconv::cp_async_wait_all();
    __syncthreads();  // row yy is staged; every warp is done with row yy-1 (and yy-2's grad_h buffer)
    if (nbuf == 2) {
      if (yy + 1 < n_rows) stage(yy + 1, (yy + 1) & 1);
      if (yy > 0) store_gh(yy - 1, (yy - 1) & 1);
    }
    const T* hb = hbuf(cur);
    const T* vb = vbuf(cur);
    const T* gb = gbuf(cur);
    const int y = y0 + yy;

    // grad_v: n-tile n0 of this warp, every channel (the forward's horizontal
    // pass, sepconv::banded_horizontal_pass), g applied to its f32 sums.
    {
      const int n0 = warp * 8;
      if (x0 + n0 < W) {
        float out[KC_MAX][4] = {};
        sepconv::banded_horizontal_pass<SPLIT, C>(
            xs, xpart, geo.rows, geo.rs, hb, HRS, n0, yy, ks, lane, [&](int c, const float (&acc)[KC_MAX][4]) {
              const float g0 = to_float(gb[c * TW + n0 + 2 * tq]);
              const float g1 = to_float(gb[c * TW + n0 + 2 * tq + 1]);
#pragma unroll
              for (int mt = 0; mt < KC_MAX; ++mt) {
                out[mt][0] = fmaf(g0, acc[mt][0], out[mt][0]);
                out[mt][1] = fmaf(g1, acc[mt][1], out[mt][1]);
                out[mt][2] = fmaf(g0, acc[mt][2], out[mt][2]);
                out[mt][3] = fmaf(g1, acc[mt][3], out[mt][3]);
              }
            });
        const int gx = x0 + n0 + 2 * tq;
        T* op = gv + b * sgv.b + y * sgv.y + gx * sgv.x;
#pragma unroll
        for (int mt = 0; mt < KC_MAX; ++mt) {
          const int f0 = 16 * mt + gr;
          const int f1 = f0 + 8;
          if (f0 < ks && gx < W) store(op + f0 * sgv.last, out[mt][0]);
          if (f0 < ks && gx + 1 < W) store(op + sgv.x + f0 * sgv.last, out[mt][1]);
          if (f1 < ks && gx < W) store(op + f1 * sgv.last, out[mt][2]);
          if (f1 < ks && gx + 1 < W) store(op + sgv.x + f1 * sgv.last, out[mt][3]);
        }
      }
    }

    // grad_h: m-tile m0 (16 columns x) of this warp, n-tiles (warp & 1) + 2q.
    {
      const int m0 = 16 * (warp >> 1);
      if (x0 + m0 < W) {
        const int kcs = (ks + 15) / 16;
        // A = v[x][f] on k-chunks of 16 taps (zero past ks): (hi a0..a3, lo a0..a3).
        uint32_t af[KC_MAX][8];
#pragma unroll
        for (int kc = 0; kc < KC_MAX; ++kc) {
          float e[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            // fragment register t/2 (a0: row gr, k 2tq; a1: row gr+8; a2: k+8; a3: both), element t%2
            const int r = t >> 1;
            const int f = 16 * kc + 2 * tq + (t & 1) + 8 * (r >> 1);
            const int xl = m0 + gr + 8 * (r & 1);
            e[t] = (kc < kcs && f < ks) ? to_float(vb[f * HRS + xl]) : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) split_pair(e[2 * r], e[2 * r + 1], af[kc][r], af[kc][4 + r]);
        }
        const int i8 = lane >> 3;  // ldmatrix: this lane's row address is row lane%8 of matrix lane/8
        int frow[KC_MAX / 2];
#pragma unroll
        for (int p = 0; p < KC_MAX / 2; ++p) frow[p] = (yy + min(32 * p + 8 * i8 + (lane & 7), ks - 1)) * geo.rs;
        float ph[NQ][4] = {};
        for (int c = 0; c < C; ++c) {
          const __nv_bfloat16* xa = xs + size_t(c) * geo.rows * geo.rs;
          const float g0 = to_float(gb[c * TW + m0 + gr]);
          const float g1 = to_float(gb[c * TW + m0 + gr + 8]);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int nt = (warp & 1) + 2 * q;
            if (nt >= geo.nth) break;
            const int un = m0 + 8 * nt;
            float acc[4] = {};
#pragma unroll
            for (int p = 0; p < KC_MAX / 2; ++p) {
              if (2 * p >= kcs) break;
              uint32_t bh[4];
              sepconv::ldmatrix_x4_trans(bh, xa + frow[p] + un);
              const uint32_t* a = af[2 * p];
              const uint32_t* a2 = af[2 * p + 1];
              mma_bf16(acc, a[0], a[1], a[2], a[3], bh[0], bh[1]);
              if (2 * p + 1 < kcs) mma_bf16(acc, a2[0], a2[1], a2[2], a2[3], bh[2], bh[3]);
              if (SPLIT) {
                uint32_t bl[4];
                sepconv::ldmatrix_x4_trans(bl, xa + xpart + frow[p] + un);
                mma_bf16(acc, a[4], a[5], a[6], a[7], bh[0], bh[1]);
                mma_bf16(acc, a[0], a[1], a[2], a[3], bl[0], bl[1]);
                if (2 * p + 1 < kcs) {
                  mma_bf16(acc, a2[4], a2[5], a2[6], a2[7], bh[2], bh[3]);
                  mma_bf16(acc, a2[0], a2[1], a2[2], a2[3], bl[2], bl[3]);
                }
              }
            }
            ph[q][0] = fmaf(g0, acc[0], ph[q][0]);
            ph[q][1] = fmaf(g0, acc[1], ph[q][1]);
            ph[q][2] = fmaf(g1, acc[2], ph[q][2]);
            ph[q][3] = fmaf(g1, acc[3], ph[q][3]);
          }
        }
        // Unskew: P[x][u] is grad_h[x][j = u - x].
        T* gd = ghbuf(cur);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nt = (warp & 1) + 2 * q;
          if (nt >= geo.nth) break;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int xl = m0 + gr + 8 * (t >> 1);
            const int j = m0 + 8 * nt + 2 * tq + (t & 1) - xl;
            if (j >= 0 && j < ks) to_smem(gd + j * HRS + xl, ph[q][t]);
          }
        }
      }
    }
    if (nbuf == 1) {
      __syncthreads();  // row yy's grad_h is in its buffer
      store_gh(yy, 0);
    }
  }
  if (nbuf == 2 && n_rows > 0) {
    __syncthreads();
    store_gh(n_rows - 1, (n_rows - 1) & 1);
  }
}

struct BwdVH {
  template <typename T, int C>
  static cudaError_t run(const void* x, const void* v, const void* h, const void* g, void* gv, void* gh,
                         Strides sx, Strides sv, Strides sh, Strides sg, Strides sgv, Strides sgh, int B, int H,
                         int W, int ks, cudaStream_t stream) {
    if (ks > 16 * KC_MAX) return cudaErrorInvalidValue;
    // Two staging buffers at the largest row tile that fits, else one.
    Geometry geo{};
    bool found = false;
    for (int nbuf : {2, 1}) {
      for (int th : {16, 8, 4, 2, 1}) {
        if (!found && smem_bytes<T, C>(geometry(ks, th, nbuf)) <= SMEM_MAX) {
          geo = geometry(ks, th, nbuf);
          found = true;
        }
      }
    }
    if (!found) return cudaErrorInvalidValue;  // float32 with 4 channels at large ks
    const int tiles_x = (W + TW - 1) / TW;
    const int tiles_y = (H + geo.th - 1) / geo.th;
    const int eb = sizeof(T);
    return sepconv::launch_kernel(
        sepconv_bwd_vh_kernel<T, C>, (long long)B * tiles_y * tiles_x, THREADS, smem_bytes<T, C>(geo), stream,
        static_cast<const T*>(x), static_cast<const T*>(v), static_cast<const T*>(h), static_cast<const T*>(g),
        static_cast<T*>(gv), static_cast<T*>(gh), sx, sv, sh, sg, sgv, sgh, H, W, ks, geo.th, geo.nbuf, tiles_y,
        tiles_x, sepconv::async_ok(v, sv, eb), sepconv::async_ok(h, sh, eb), sepconv::async_ok(g, sg, eb, C));
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int sepconv_bwd_vh(const void* x, const void* v, const void* h, const void* g, void* gv, void* gh,
                              long long sxb, long long sxy, long long sxx, long long sxc,
                              long long svb, long long svy, long long svx, long long svf,
                              long long shb, long long shy, long long shx, long long shf,
                              long long sgb, long long sgy, long long sgx, long long sgc,
                              long long sgvb, long long sgvy, long long sgvx, long long sgvf,
                              long long sghb, long long sghy, long long sghx, long long sghf,
                              int B, int H, int W, int C, int ks, int dtype, void* stream) {
  const Strides sx{sxb, sxy, sxx, sxc}, sv{svb, svy, svx, svf}, sh{shb, shy, shx, shf};
  const Strides sg{sgb, sgy, sgx, sgc}, sgv{sgvb, sgvy, sgvx, sgvf}, sgh{sghb, sghy, sghx, sghf};
  return int(sepconv::dispatch<BwdVH>(dtype, C, x, v, h, g, gv, gh, sx, sv, sh, sg, sgv, sgh, B, H, W, ks,
                                      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
