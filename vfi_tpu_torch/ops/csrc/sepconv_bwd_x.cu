// Adaptive separable convolution, adjoint for the padded input, for sm_90a (H100).
//
//   grad_x[b,s,u,c] = sum_{f,j} g[b,s-f,u-j,c] * v[b,s-f,u-j,f] * h[b,s-f,u-j,j]
//
// over the output pixels (s-f, u-j) inside [0,H) x [0,W).
//
// Replaces vfi_tpu's Pallas kernel _sepconv_pallas_bwd_x_raw
// (vfi_tpu/ops/sepconv.py:638-755), which multiplies g*v against the banded
// matrix S per output row, emits one overlapping slab per tile, and adds the
// slabs together outside the call.
//
// What bounds it on the H100: bytes.  At the bi-TAI training shape
// (B*T=40, 128x128, ks=51, C=1) it reads v and h, 33 M elements each, and g
// (0.7 M), and writes grad_x (1.3 M): about 0.14 GB in bf16, 0.04 ms at
// 3.35 TB/s (twice that in f32), against ks*(2*ks+1) flops per output pixel
// and channel.
//
// What this design does about it: a gather, no atomics and no slabs.  One
// block owns a TILE_H x TILE_W tile of input pixels (s, u) of the padded
// [H+ks-1, W+ks-1] grid of one image, and writes each element of grad_x
// once.  Unlike the forward the sum is not separable: the tap row f = s-y
// ties each input row to a different output row y, and the halo of all
// rows' taps does not fit in shared memory at ks=51.  So the block walks
// the output rows y that reach it, [s0-ks+1, s0+TILE_H-1], staging one row
// at a time: g*v[y, x, f] for every channel and h[y, x, j], for the columns
// x in [u0-ks+1, u0+TILE_W) -- about (C+1)*ks*(TILE_W+ks-1) floats, 46 KB at
// C=1 and ks=51.  Staging costs as many instructions as the multiply-adds
// unless it is lean: each thread reads g once per column and walks that
// column's taps by pointer.  Each thread owns ROWS consecutive input rows of
// one column and adds for each the tap row f = s-y:
// sum_j g*v[y, u-j, f] * h[y, u-j, j].  h[y, u-j, j] is the same for all of
// them, so one h read from shared memory feeds ROWS*C multiply-adds
// ((1 + ROWS*C)/(ROWS*C) reads each instead of two); rows whose f falls
// outside [0, ks) read a zero row instead of branching.  A 32 x 64 tile
// stages each output row for about (TILE_H+ks-1)/TILE_H * (TILE_W+ks-1)/
// TILE_W = 4.6 blocks.  Operands come with element strides (NCHW
// kernel-head outputs permuted to [B,H,W,ks], where x has unit stride, and a
// cotangent expanded with stride 0).  Sums are f32; bf16 operands are
// widened on load and each output is rounded once.
//
// This is a CUDA-core kernel bound by shared-memory reads; it runs above its
// byte bound.

#include "sepconv_common.cuh"

namespace {

using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;

constexpr int TILE_W = 64;  // two warps per thread row: coalesced loads, no bank conflicts
constexpr int THREAD_ROWS = 8;
constexpr int ROWS = 4;  // consecutive input rows per thread
constexpr int TILE_H = THREAD_ROWS * ROWS;
constexpr int THREADS = TILE_W * THREAD_ROWS;

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
sepconv_bwd_x_kernel(const T* __restrict__ v, const T* __restrict__ h, const T* __restrict__ g,
                     T* __restrict__ gx, Strides sv, Strides sh, Strides sg, Strides sgx, int H, int W,
                     int ks, int tiles_x, int tiles_y) {
  extern __shared__ float smem[];
  const int RW = TILE_W + ks - 1;           // output columns whose windows reach the tile
  float* gvrow = smem;                      // [C][ks+1][RW]: g[y,x,c] * v[y,x,f]; row ks is zero
  float* hrow = smem + C * (ks + 1) * RW;  // [ks][RW]:     h[y,x,j]

  const int tiles = tiles_x * tiles_y;
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int s0 = (t / tiles_x) * TILE_H;
  const int u0 = (t % tiles_x) * TILE_W;
  const int xbase = u0 - (ks - 1);  // output column of local column 0
  const int ty = threadIdx.x / TILE_W;
  const int tx = threadIdx.x % TILE_W;
  const int s = s0 + ty * ROWS;  // the thread's first input row
  const int u = u0 + tx;

  const T* vb = v + b * sv.b;
  const T* hb = h + b * sh.b;
  const T* gb = g + b * sg.b;
  for (int i = threadIdx.x; i < C * RW; i += THREADS) gvrow[((i / RW) * (ks + 1) + ks) * RW + i % RW] = 0.f;
  float acc[ROWS][C] = {};

  const int ylo = max(0, s0 - ks + 1);
  const int yhi = min(H - 1, s0 + TILE_H - 1);
  for (int y = ylo; y <= yhi; ++y) {
    __syncthreads();  // the previous row's reads are done
    for (int xl = tx; xl < RW; xl += TILE_W) {  // g once per column, then its taps
      const int x = xbase + xl;
      const bool in = x >= 0 && x < W;
      const int xc = in ? x : 0;
      const T* vp = vb + y * sv.y + xc * sv.x;
      const T* hp = hb + y * sh.y + xc * sh.x;
      float gc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) gc[c] = in ? to_float(gb[y * sg.y + xc * sg.x + c * sg.last]) : 0.f;
      for (int f = ty; f < ks; f += THREAD_ROWS) {
        const float vv = in ? to_float(vp[f * sv.last]) : 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) gvrow[(c * (ks + 1) + f) * RW + xl] = vv * gc[c];
        hrow[f * RW + xl] = in ? to_float(hp[f * sh.last]) : 0.f;
      }
    }
    __syncthreads();

    // Row r of the thread takes tap row f = s + r - y; rows outside [0, ks)
    // read the zero row.  The same for a whole warp (one thread row).
    const int f0 = s - y;
    if (f0 + ROWS <= 0 || f0 >= ks) continue;
    const float* gvf[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int f = f0 + r;
      gvf[r] = gvrow + ((f >= 0 && f < ks) ? f : ks) * RW + tx + ks - 1;  // column u-j is local tx+ks-1-j
    }
    const float* hj = hrow + tx + ks - 1;
#pragma unroll 2
    for (int j = 0; j < ks; ++j) {
      const float hv = hj[j * RW - j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(gvf[r][c * (ks + 1) * RW - j], hv, acc[r][c]);
    }
  }

  if (u < W + ks - 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (s + r >= H + ks - 1) break;
      T* op = gx + b * sgx.b + (s + r) * sgx.y + u * sgx.x;
#pragma unroll
      for (int c = 0; c < C; ++c) store(op + c * sgx.last, acc[r][c]);
    }
  }
}

struct BwdX {
  template <typename T, int C>
  static cudaError_t run(const void* v, const void* h, const void* g, void* gx, Strides sv, Strides sh,
                         Strides sg, Strides sgx, int B, int H, int W, int ks, cudaStream_t stream) {
    const int tiles_x = (W + ks - 1 + TILE_W - 1) / TILE_W;
    const int tiles_y = (H + ks - 1 + TILE_H - 1) / TILE_H;
    const size_t smem = sizeof(float) * (size_t(C) * (ks + 1) + ks) * (TILE_W + ks - 1);
    return sepconv::launch_kernel(sepconv_bwd_x_kernel<T, C>, (long long)B * tiles_x * tiles_y, THREADS,
                                  smem, stream, static_cast<const T*>(v), static_cast<const T*>(h),
                                  static_cast<const T*>(g), static_cast<T*>(gx), sv, sh, sg, sgx, H, W, ks,
                                  tiles_x, tiles_y);
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
