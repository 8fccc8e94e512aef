// Adaptive separable convolution, adjoint for the padded input, banded
// tensor-core form, for sm_90a (H100).
//
//   grad_x[b,s,u,c] = sum_y sum_x A_y[s,x] * B_y[x,u],
//   A_y[s,x] = v[b,y,x,s-y] (0 <= s-y < ks),   B_y[x,u] = g[b,y,x,c] * h[b,y,x,u-x] (0 <= u-x < ks)
//
// over the output pixels (y, x) inside [0,H) x [0,W).
//
// Replaces vfi_tpu's Pallas kernel _sepconv_pallas_bwd_x_raw
// (vfi_tpu/ops/sepconv.py:638-755), which multiplies g*v against the banded
// matrix S per output row on the MXU, emits one overlapping slab per tile,
// and adds the slabs together outside the call.
//
// What bounds it on the H100: bytes.  At the bi-TAI training shape
// (B*T=40, 128x128, ks=51, C=1) it reads v and h, 33 M elements each, and g
// (0.7 M), and writes grad_x (1.3 M): about 0.14 GB in bf16, 0.04 ms at
// 3.35 TB/s (twice that in f32).  The banded products are tens of
// microseconds of bf16 tensor-core time.
//
// What this design does about it: one GEMM per input tile, accumulated in
// registers over the output rows that reach it, with no slabs, no atomics
// and grad_x written once.  One block of 16 warps owns an input tile of
// TS=64 rows s and TU=128 columns u of the padded grid, every channel.  It
// walks the output rows y in [s0-ks+1, s0+TS) and for each accumulates
// A_y @ B_y as mma.sync m16n8k16 (M = s, four m-tiles, skipped where s-y
// leaves [0, ks); N = u, one n-tile of 8 per warp; K = x, only the 4-5
// k-chunks of 16 that meet the n-tile's band).  A is v, staged tap-major for
// the TS tap rows the tile meets; B is formed in registers from the staged h
// and g.  g*h is split into a bf16 hi/lo pair in both dtypes (two products
// for bf16 operands, whose v is exact; three, with v split too, for
// float32), so rounding g*h to bf16 never costs the bf16 result its last
// bit.  Each row's v, h and g are staged by cp.async 16-byte copies into one
// of two buffers while the previous row's products run, one barrier per row.
// The staged x window starts at u0-ks+1 rounded down to a 16-byte boundary;
// rows that cp.async cannot copy (x not unit-stride, or not 16-byte aligned)
// take scalar loads.  Each v or h row is staged by about (TS+ks-1)/TS *
// (TU+ks-1)/TU = 2.5 blocks; blocks that share rows run side by side.
// Operands come with element strides (the heads' NCHW outputs permuted to
// [B,H,W,ks], contiguous NHWC, a cotangent expanded with stride 0).  Sums
// are f32; each output is rounded once.

#include <cstdint>
#include <type_traits>

#include "sepconv_mma.cuh"

namespace {

using sepconv::ld2;
using sepconv::mma_bf16;
using sepconv::split_pair;
using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;

constexpr int TS = 64;   // input rows per block: TS/16 m-tiles
constexpr int TU = 128;  // input columns per block: one n-tile of 8 per warp
constexpr int WARPS = TU / 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT = TS / 16;

// Staged columns x in [xw, xw + xwin): every k-chunk any warp's band meets.
__host__ __device__ inline int window(int ks) { return (TU + ks + 6 + 15) / 16 * 16; }
// Row stride of the staged rows: conflict-free fragment loads, 16-byte rows.
__host__ __device__ inline int row_stride(int ks) { return window(ks) + 8; }

template <typename T, int C>
size_t smem_bytes(int ks) {
  return 2 * sizeof(T) * size_t(TS + ks + C) * row_stride(ks);  // two buffers of v, h, g rows
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 && C == 1 ? 2 : 1)  // one channel bf16: 2 blocks/SM
sepconv_bwd_x_kernel(const T* __restrict__ v, const T* __restrict__ h, const T* __restrict__ g,
                     T* __restrict__ gx, Strides sv, Strides sh, Strides sg, Strides sgx, int H, int W, int ks,
                     int tiles_s, int tiles_u, bool v_async, bool h_async, bool g_async) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  // Channels whose B fragments are held together: all of them where the
  // registers allow (bf16 up to 3, float32 up to 2), else one at a time, so
  // that no instantiation spills.
  constexpr int CB = C <= (SPLIT ? 2 : 3) ? C : 1;
  const int xwin = window(ks);
  const int rs = row_stride(ks);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);  // [2][TS + ks + C][rs]: v rows s, h taps j, g channels
  const size_t buf_elems = size_t(TS + ks + C) * rs;

  const int per_image = tiles_s * tiles_u;
  const int b = blockIdx.x / per_image;
  const int s0 = (blockIdx.x % per_image) / tiles_u * TS;
  const int u0 = (blockIdx.x % tiles_u) * TU;
  // Window start: u0-ks+1 rounded down to a multiple of 8 elements, 16 bytes in
  // bf16 (the arithmetic shift floors negatives).
  const int xw = ((u0 - ks + 1) >> 3) << 3;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;

  const int ylo = max(0, s0 - ks + 1);
  const int yhi = min(H - 1, s0 + TS - 1);

  // Output row y's v (the tap rows f = s - y of the tile's rows s), h and g
  // into buffer i.
  auto stage = [&](int y, int i) {
    T* vb = bufs + i * buf_elems;
    T* hb = vb + TS * rs;
    T* gb = hb + ks * rs;
    const int lo = max(0, y - s0);           // first local row s0+lo with tap s-y >= 0
    const int hi = min(TS, y - s0 + ks);     // past the last with tap < ks
    if (hi > lo)
      sepconv::stage_rows<T, THREADS>(vb + lo * rs, rs, v + b * sv.b + y * sv.y + (s0 + lo - y) * sv.last, sv.last,
                                      sv.x, hi - lo, xw, xwin, W, v_async, tid);
    sepconv::stage_rows<T, THREADS>(hb, rs, h + b * sh.b + y * sh.y, sh.last, sh.x, ks, xw, xwin, W, h_async, tid);
    sepconv::stage_rows<T, THREADS>(gb, rs, g + b * sg.b + y * sg.y, sg.last, sg.x, C, xw, xwin, W, g_async, tid);
    sepconv::cp_async_commit();
  };

  // This warp's n-tile: columns u0 + nl + [0, 8); window columns xl = x - xw.
  const int nl = 8 * warp;
  const int d = u0 - xw;
  const int kbase = (d + nl - ks + 1) / 16 * 16;  // d >= ks - 1, so non-negative
  const int nch = (d + nl + 7 - kbase) / 16 + 1;

  float acc[C][MT][4] = {};
  // Window columns outside the image stay zero in both buffers.
  sepconv::zero_smem<THREADS>(bufs, 2 * buf_elems * sizeof(T), tid);
  __syncthreads();
  if (ylo <= yhi) stage(ylo, 0);
  for (int y = ylo; y <= yhi; ++y) {
    const int cur = (y - ylo) & 1;
    sepconv::cp_async_wait_all();
    __syncthreads();  // row y is staged; every warp is done with row y-1's buffer
    if (y < yhi) stage(y + 1, cur ^ 1);
    const T* vb = bufs + cur * buf_elems;
    const T* hb = vb + TS * rs;
    const T* gb = hb + ks * rs;

    for (int kc = 0; kc < nch; ++kc) {
      const int k = kbase + 16 * kc;
      // B = g*h on this chunk: rows x = k + 2tq (+1, +8, +9), column u = nl + gr + d (window units).
      float hv[4];
      int xs[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        xs[t] = k + 2 * tq + (t & 1) + 8 * (t >> 1);
        const int j = d + nl + gr - xs[t];
        hv[t] = (j >= 0 && j < ks) ? to_float(hb[j * rs + xs[t]]) : 0.f;
      }
      // Channels in groups of CB: B_c = g_c*h (bf16 hi and lo pairs b0, b1) of a
      // group is held while the m-tiles run.
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += CB) {
        uint32_t bf[CB][4];
#pragma unroll
        for (int cc = 0; cc < CB; ++cc) {
          const T* gc = gb + (c0 + cc) * rs;
          split_pair(hv[0] * to_float(gc[xs[0]]), hv[1] * to_float(gc[xs[1]]), bf[cc][0], bf[cc][2]);
          split_pair(hv[2] * to_float(gc[xs[2]]), hv[3] * to_float(gc[xs[3]]), bf[cc][1], bf[cc][3]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // Rows s = s0 + 16mt + [0, 16) take taps f = s - y; skip the m-tile if none is in [0, ks).
          const int f0 = s0 + 16 * mt - y;
          if (f0 + 15 < 0 || f0 >= ks) continue;
          const bool in0 = f0 + gr >= 0 && f0 + gr < ks;          // fragment row gr
          const bool in1 = f0 + gr + 8 >= 0 && f0 + gr + 8 < ks;  // fragment row gr + 8
          // A = v[s][x]: a0 (row gr, k 2tq), a1 (row gr+8), a2 (k+8), a3 (both); rows
          // outside the taps are stale in the buffer and zeroed here.
          uint32_t ah[4], al[4] = {};
          if (SPLIT) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const bool in = (t & 1) ? in1 : in0;
              const float2 p = in ? ld2(vb + (16 * mt + gr + 8 * (t & 1)) * rs + k + 2 * tq + 8 * (t >> 1))
                                  : make_float2(0.f, 0.f);
              split_pair(p.x, p.y, ah[t], al[t]);
            }
          } else {
            sepconv::ldmatrix_x4(ah, reinterpret_cast<const __nv_bfloat16*>(vb) +
                                         (16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1)) * rs + k + 8 * (lane >> 4));
            if (!in0) ah[0] = ah[2] = 0u;
            if (!in1) ah[1] = ah[3] = 0u;
          }
#pragma unroll
          for (int cc = 0; cc < CB; ++cc) {
            float(&d)[4] = acc[c0 + cc][mt];
            mma_bf16(d, ah[0], ah[1], ah[2], ah[3], bf[cc][0], bf[cc][1]);
            mma_bf16(d, ah[0], ah[1], ah[2], ah[3], bf[cc][2], bf[cc][3]);
            if (SPLIT) mma_bf16(d, al[0], al[1], al[2], al[3], bf[cc][0], bf[cc][1]);
          }
        }
      }
    }
  }

  // acc[c][mt]: rows s0 + 16mt + gr (+8), columns u0 + nl + 2tq (+1).
  const int Hp = H + ks - 1;
  const int Wp = W + ks - 1;
  const int u = u0 + nl + 2 * tq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int s = s0 + 16 * mt + gr + 8 * (t >> 1);
      const int uu = u + (t & 1);
      if (s < Hp && uu < Wp) {
        T* op = gx + b * sgx.b + s * sgx.y + uu * sgx.x;
#pragma unroll
        for (int c = 0; c < C; ++c) store(op + c * sgx.last, acc[c][mt][t]);
      }
    }
  }
}

struct BwdX {
  template <typename T, int C>
  static cudaError_t run(const void* v, const void* h, const void* g, void* gx, Strides sv, Strides sh,
                         Strides sg, Strides sgx, int B, int H, int W, int ks, cudaStream_t stream) {
    if (smem_bytes<T, C>(ks) > 232448) return cudaErrorInvalidValue;  // float32, 4 channels, ks > 59
    const int tiles_s = (H + ks - 1 + TS - 1) / TS;
    const int tiles_u = (W + ks - 1 + TU - 1) / TU;
    const int eb = sizeof(T);
    return sepconv::launch_kernel(sepconv_bwd_x_kernel<T, C>, (long long)B * tiles_s * tiles_u, THREADS,
                                  smem_bytes<T, C>(ks), stream, static_cast<const T*>(v), static_cast<const T*>(h),
                                  static_cast<const T*>(g), static_cast<T*>(gx), sv, sh, sg, sgx, H, W, ks, tiles_s,
                                  tiles_u, sepconv::async_ok(v, sv, eb), sepconv::async_ok(h, sh, eb),
                                  sepconv::async_ok(g, sg, eb, C));
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int sepconv_bwd_x(const void* v, const void* h, const void* g, void* gx,
                             long long svb, long long svy, long long svx, long long svf,
                             long long shb, long long shy, long long shx, long long shf,
                             long long sgb, long long sgy, long long sgx, long long sgc,
                             long long sob, long long soy, long long sox, long long soc,
                             int B, int H, int W, int C, int ks, int dtype, void* stream) {
  const Strides sv{svb, svy, svx, svf}, sh{shb, shy, shx, shf};
  const Strides sg{sgb, sgy, sgx, sgc}, so{sob, soy, sox, soc};
  return int(sepconv::dispatch<BwdX>(dtype, C, v, h, g, gx, sv, sh, sg, so, B, H, W, ks,
                                     static_cast<cudaStream_t>(stream)));
}

extern "C" const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
