// Adaptive separable convolution, adjoint for the per-pixel kernels, for sm_90a (H100).
//
//   P[b,y,x,f,j] = sum_c g[b,y,x,c] * x[b,y+f,x+j,c]
//   grad_v[b,y,x,f] = sum_j P[b,y,x,f,j] * h[b,y,x,j]
//   grad_h[b,y,x,j] = sum_f P[b,y,x,f,j] * v[b,y,x,f]
//
// Replaces vfi_tpu's Pallas kernel _sepconv_pallas_bwd_vh_raw
// (vfi_tpu/ops/sepconv.py:487-635), which recomputes the forward's
// horizontal pass against the banded matrix S for grad_v and unskews the
// vertical pass A[y][x,u] = sum_f v*x for grad_h, per (image, channel), and
// sums the channels outside the call.
//
// What bounds it on the H100: bytes.  At the bi-TAI training shape
// (B*T=40, 128x128, ks=51, C=1) it reads v and h and writes grad_v and
// grad_h, 33 M elements each, while x and g are 1.3 M and 0.7 M: about
// 0.27 GB in bf16, 0.08 ms at 3.35 TB/s (twice that in f32), against
// 4*ks*(ks+1) flops per output pixel and channel.
//
// What this design does about it: every element of v, h, grad_v and
// grad_h crosses device memory exactly once, and the channel sum happens
// inside the kernel (v and h are never repeated per channel).  One block
// owns a TILE_H x TILE_W tile of output pixels of one image, one thread per
// pixel.  The block stages the input patch (TILE_H+ks-1) x (TILE_W+ks-1) x C
// and the tile's v and h taps in shared memory.  Each thread makes two
// passes over its window: f-major against h for grad_v (the forward's
// horizontal pass, then times g), j-major against v for grad_h (the
// vertical pass, then times g).  Each pass computes BLOCK outputs at once,
// so one tap read from shared memory feeds BLOCK*C multiply-adds and the
// pass reads shared memory (1 + BLOCK*C)/(BLOCK*C) times per multiply-add
// instead of twice; each output is one register sum stored once.  Operands
// come with element strides: the kernel heads' NCHW outputs permuted to
// [B,H,W,ks], gradients allocated like them, and a cotangent expanded with
// stride 0 all go in without a copy.  Sums are f32; bf16 operands are
// widened on load and each output is rounded once.
//
// This is a CUDA-core kernel bound by shared-memory reads; it runs above
// its byte bound.  TILE_H is 4 so that the staged taps (2*ks*128 floats)
// and the patch fit a block's 227 KB for every ks <= 64 and C <= 4.

#include "sepconv_common.cuh"

namespace {

using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;

constexpr int TILE_W = 32;  // one warp per tile row: coalesced loads, no bank conflicts
constexpr int TILE_H = 4;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int BLOCK = 4;  // output taps per pass of a thread over its window

template <typename T>
__device__ __forceinline__ void stage_taps(float* tile, const T* base, Strides s, int y0, int x0, int H,
                                           int W, int ks, int tid) {
  for (int i = tid; i < ks * THREADS; i += THREADS) {
    int f, p;
    if (s.last == 1) {  // let the index with unit stride vary fastest across threads
      f = i % ks;
      p = i / ks;
    } else {
      f = i / THREADS;
      p = i % THREADS;
    }
    const int gy = y0 + p / TILE_W;
    const int gx = x0 + p % TILE_W;
    tile[f * THREADS + p] = (gy < H && gx < W) ? to_float(base[gy * s.y + gx * s.x + f * s.last]) : 0.f;
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
sepconv_bwd_vh_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ h,
                      const T* __restrict__ g, T* __restrict__ gv, T* __restrict__ gh, Strides sx,
                      Strides sv, Strides sh, Strides sg, Strides sgv, Strides sgh, int H, int W, int ks,
                      int tiles_x, int tiles_y) {
  extern __shared__ float smem[];
  const int PH = TILE_H + ks - 1;
  const int PW = TILE_W + ks - 1;
  float* patch = smem;                  // [C][PH][PW]
  float* htile = patch + C * PH * PW;   // [ks][THREADS]
  float* vtile = htile + ks * THREADS;  // [ks][THREADS]

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
  stage_taps(htile, h + b * sh.b, sh, y0, x0, H, W, ks, tid);
  stage_taps(vtile, v + b * sv.b, sv, y0, x0, H, W, ks, tid);
  __syncthreads();

  const int y = y0 + ty;
  const int xx = x0 + tx;
  if (y >= H || xx >= W) return;

  float gc[C];
  const T* gp = g + b * sg.b + y * sg.y + xx * sg.x;
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = to_float(gp[c * sg.last]);

  // grad_v[f] = sum_c g[c] * sum_j x[c][y+f][x+j] * h[j], BLOCK rows f at a
  // time so that each h[j] read from shared memory feeds BLOCK*C products.
  T* gvp = gv + b * sgv.b + y * sgv.y + xx * sgv.x;
  for (int f0 = 0; f0 < ks; f0 += BLOCK) {
    const float* rows[BLOCK];
#pragma unroll
    for (int r = 0; r < BLOCK; ++r) rows[r] = patch + (ty + min(f0 + r, ks - 1)) * PW + tx;
    float acc[BLOCK][C] = {};
#pragma unroll 2
    for (int j = 0; j < ks; ++j) {
      const float hv = htile[j * THREADS + tid];
#pragma unroll
      for (int r = 0; r < BLOCK; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(rows[r][c * PH * PW + j], hv, acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < BLOCK; ++r) {
      if (f0 + r >= ks) break;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) sum = fmaf(gc[c], acc[r][c], sum);
      store(gvp + (f0 + r) * sgv.last, sum);
    }
  }

  // grad_h[j] = sum_c g[c] * sum_f v[f] * x[c][y+f][x+j], BLOCK taps j at a
  // time so that each v[f] read feeds BLOCK*C products.
  T* ghp = gh + b * sgh.b + y * sgh.y + xx * sgh.x;
  for (int j0 = 0; j0 < ks; j0 += BLOCK) {
    const float* cols[BLOCK];
#pragma unroll
    for (int r = 0; r < BLOCK; ++r) cols[r] = patch + ty * PW + tx + min(j0 + r, ks - 1);
    float acc[BLOCK][C] = {};
#pragma unroll 2
    for (int f = 0; f < ks; ++f) {
      const float vv = vtile[f * THREADS + tid];
#pragma unroll
      for (int r = 0; r < BLOCK; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(cols[r][c * PH * PW + f * PW], vv, acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < BLOCK; ++r) {
      if (j0 + r >= ks) break;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) sum = fmaf(gc[c], acc[r][c], sum);
      store(ghp + (j0 + r) * sgh.last, sum);
    }
  }
}

struct BwdVH {
  template <typename T, int C>
  static cudaError_t run(const void* x, const void* v, const void* h, const void* g, void* gv, void* gh,
                         Strides sx, Strides sv, Strides sh, Strides sg, Strides sgv, Strides sgh, int B,
                         int H, int W, int ks, cudaStream_t stream) {
    const int tiles_x = (W + TILE_W - 1) / TILE_W;
    const int tiles_y = (H + TILE_H - 1) / TILE_H;
    const size_t smem =
        sizeof(float) * (size_t(C) * (TILE_H + ks - 1) * (TILE_W + ks - 1) + 2 * size_t(ks) * THREADS);
    return sepconv::launch_kernel(sepconv_bwd_vh_kernel<T, C>, (long long)B * tiles_x * tiles_y, THREADS,
                                  smem, stream, static_cast<const T*>(x), static_cast<const T*>(v),
                                  static_cast<const T*>(h), static_cast<const T*>(g), static_cast<T*>(gv),
                                  static_cast<T*>(gh), sx, sv, sh, sg, sgv, sgh, H, W, ks, tiles_x, tiles_y);
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
