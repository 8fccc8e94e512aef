// Adaptive separable convolution, forward, direct accumulation, for sm_90a (H100).
//
//   out[b,y,x,c] = sum_fy v[b,y,x,fy] * sum_fx x[b,y+fy,x+fx,c] * h[b,y,x,fx]
//
// Replaces vfi_tpu's Pallas kernel _sepconv_pallas_raw
// (vfi_tpu/ops/sepconv.py:197-276), which accumulates the ks x ks taps of
// each output pixel on the VPU, with row tiles of the padded input, both
// kernel stacks and the accumulator in VMEM (impl="pallas").  The banded
// tensor-core form of _sepconv_pallas_mxu_raw, the default, is
// sepconv_fwd_mxu.cu; this kernel is its cross-check on the card.
//
// What bounds it on the H100: the per-pixel kernels.  At the bi-TAI serving
// shape (B*T=320, 128x128, ks=51, C=1) v and h are 535 MB each in bf16 while
// x and out are 20 MB and 10 MB, and the separable form needs only
// 2*ks*(ks+1) flops per output value, so the call is memory-bound: about
// 1.1 GB, 0.33 ms at 3.35 TB/s in bf16, twice that in f32.
//
// What this design does about it: every element of v and h is read from
// device memory exactly once.  One block computes a TILE_H x TILE_W tile of
// one image with one thread per output pixel.  The block stages the input
// patch (TILE_H+ks-1) x (TILE_W+ks-1) x C and the tile's horizontal kernels
// in shared memory; the vertical kernels are read from device memory once
// per tap, each by the thread that owns the pixel.  v and h are applied to
// every channel, never repeated per channel.  All operands come with element
// strides, so a kernel head's NCHW output viewed as [B,H,W,ks] goes in
// without a copy (tap stride H*W: neighbouring threads read neighbouring
// addresses).  Sums are f32; bf16 operands are widened on load and the
// result is rounded once on store.
//
// This is the simple CUDA-core kernel: each multiply-add costs a shared-memory
// read of the patch and of h, so it runs well above the memory bound.

#include "sepconv_common.cuh"

namespace {

using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;

constexpr int TILE_W = 32;  // one warp per tile row: coalesced loads, no bank conflicts
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
sepconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ h,
                   T* __restrict__ out, Strides sx, Strides sv, Strides sh, Strides so,
                   int H, int W, int ks, int tiles_x, int tiles_y) {
  extern __shared__ float smem[];
  const int PH = TILE_H + ks - 1;
  const int PW = TILE_W + ks - 1;
  float* patch = smem;                // [C][PH][PW]
  float* htile = smem + C * PH * PW;  // [ks][THREADS]

  const int tiles = tiles_x * tiles_y;
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int y0 = (t / tiles_x) * TILE_H;
  const int x0 = (t % tiles_x) * TILE_W;
  const int tid = threadIdx.x;
  const int ty = tid / TILE_W;
  const int tx = tid % TILE_W;
  const int Hp = H + ks - 1;
  const int Wp = W + ks - 1;

  const T* xb = x + b * sx.b;
  for (int i = tid; i < C * PH * PW; i += THREADS) {
    const int c = i / (PH * PW);
    const int r = (i / PW) % PH;
    const int col = i % PW;
    const int gy = y0 + r;
    const int gx = x0 + col;
    patch[i] = (gy < Hp && gx < Wp) ? to_float(xb[gy * sx.y + gx * sx.x + c * sx.last]) : 0.f;
  }

  const T* hb = h + b * sh.b;
  for (int i = tid; i < ks * THREADS; i += THREADS) {
    // Let the index with unit stride vary fastest across threads.
    int f, p;
    if (sh.last == 1) {
      f = i % ks;
      p = i / ks;
    } else {
      f = i / THREADS;
      p = i % THREADS;
    }
    const int gy = y0 + p / TILE_W;
    const int gx = x0 + p % TILE_W;
    htile[f * THREADS + p] = (gy < H && gx < W) ? to_float(hb[gy * sh.y + gx * sh.x + f * sh.last]) : 0.f;
  }
  __syncthreads();

  const int y = y0 + ty;
  const int xx = x0 + tx;
  if (y >= H || xx >= W) return;

  const T* vp = v + b * sv.b + y * sv.y + xx * sv.x;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int fy = 0; fy < ks; ++fy) {
    const float* prow = patch + (ty + fy) * PW + tx;
    float inner[C];
#pragma unroll
    for (int c = 0; c < C; ++c) inner[c] = 0.f;
#pragma unroll 4
    for (int fx = 0; fx < ks; ++fx) {
      const float hv = htile[fx * THREADS + tid];
#pragma unroll
      for (int c = 0; c < C; ++c) inner[c] = fmaf(prow[c * PH * PW + fx], hv, inner[c]);
    }
    const float vv = to_float(vp[fy * sv.last]);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(inner[c], vv, acc[c]);
  }

  T* op = out + b * so.b + y * so.y + xx * so.x;
#pragma unroll
  for (int c = 0; c < C; ++c) store(op + c * so.last, acc[c]);
}

struct Fwd {
  template <typename T, int C>
  static cudaError_t run(const void* x, const void* v, const void* h, void* out, Strides sx, Strides sv,
                         Strides sh, Strides so, int B, int H, int W, int ks, cudaStream_t stream) {
    const int tiles_x = (W + TILE_W - 1) / TILE_W;
    const int tiles_y = (H + TILE_H - 1) / TILE_H;
    const size_t smem =
        sizeof(float) * (size_t(C) * (TILE_H + ks - 1) * (TILE_W + ks - 1) + size_t(ks) * THREADS);
    return sepconv::launch_kernel(sepconv_fwd_kernel<T, C>, (long long)B * tiles_x * tiles_y, THREADS, smem,
                                  stream, static_cast<const T*>(x), static_cast<const T*>(v),
                                  static_cast<const T*>(h), static_cast<T*>(out), sx, sv, sh, so, H, W, ks,
                                  tiles_x, tiles_y);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int sepconv_fwd(const void* x, const void* v, const void* h, void* out,
                           long long sxb, long long sxy, long long sxx, long long sxc,
                           long long svb, long long svy, long long svx, long long svf,
                           long long shb, long long shy, long long shx, long long shf,
                           long long sob, long long soy, long long sox, long long soc,
                           int B, int H, int W, int C, int ks, int dtype, void* stream) {
  const Strides sx{sxb, sxy, sxx, sxc}, sv{svb, svy, svx, svf};
  const Strides sh{shb, shy, shx, shf}, so{sob, soy, sox, soc};
  return int(sepconv::dispatch<Fwd>(dtype, C, x, v, h, out, sx, sv, sh, so, B, H, W, ks,
                                    static_cast<cudaStream_t>(stream)));
}

extern "C" const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
