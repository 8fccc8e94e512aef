// Adaptive separable convolution, forward, direct accumulation, for sm_90a (H100).
//
//   out[b,y,x,c] = sum_fy v[b,y,x,fy] * sum_fx x[b,y+fy,x+fx,c] * h[b,y,x,fx]
//
// Replaces vfi_tpu's Pallas kernel _sepconv_pallas_raw
// (vfi_tpu/ops/sepconv.py:197-276), which accumulates the ks x ks taps of
// each output pixel on the VPU, with row tiles of the padded input, both
// kernel stacks and the accumulator in VMEM (impl="pallas").  The banded
// tensor-core form of _sepconv_pallas_mxu_raw, the default, is
// sepconv_fwd_mxu.cu; this kernel stays in f32 on CUDA cores, as the TPU
// kernel stays on the VPU, and so shares no arithmetic with the banded
// kernel's bf16 split: it is that kernel's cross-check on the card.
//
// What bounds it on the H100: its FMAs.  The separable form is
// 2*ks*(ks+1) flops per output value (ks+1 multiply-adds per tap row), all
// on CUDA cores: at the bi-TAI serving shape (B*T=320, 128x128, ks=51, C=1)
// 1.4e10 FMAs, 0.415 ms at the f32 rate of 67 TFLOP/s.  That floor is above
// the 0.33 ms its 1.1 GB of v, h, x and out take at 3.35 TB/s in bf16; in
// f32 the bytes take 0.66 ms at one channel, the FMAs 1.56 ms at the
// TAI_color shape (B*T=80, 256x320, C=3).  An SM issues 128
// FMAs per clock but serves only 32 four-byte shared-memory loads, so a
// design that reads one patch value per FMA runs at 1/4 of the rate at best,
// and one that also reads h from shared memory at 1/8.
//
// What this design does about it: registers carry the reuse.  One block of 8
// warps takes one image and a tile of TILE_W=32 columns (one per lane) by
// TILE_H = 8*P rows; each thread owns P=4 output pixels of one column, rows
// yb..yb+P-1.  The block stages its input patch (TILE_H+ks-1 rows of
// TILE_W+ks-1 columns, every channel, widened to f32) in shared memory once.
// The horizontal taps go in chunks of J=17 (51 = 3*17); per chunk a thread
// holds its P pixels' J values of h in registers, loaded once from device
// memory (coalesced along x).  It then walks the ks+P-1 patch rows that its
// pixels meet: per row and channel it loads J patch values, each from 32
// consecutive words across the warp (no bank conflicts), and feeds each to P
// FMAs, one per pixel, since pixel p meets patch row yb+r at tap row f = r-p.
// Each row's P partial sums are then scaled by v[f] into the pixels' f32
// accumulators:
//
//   out = sum_chunk sum_f v_f * (sum_{j in chunk} h_j * x[y+f, x+j])
//
// the TPU kernel's f32 sums in another order, with ks*ks/J extra FMAs.  v
// comes through a ring of D=8 rows per warp in shared memory, filled by
// 16-byte cp.async copies 7 rows ahead of their use (one copy per lane and
// row; v is read once per chunk, three times at ks=51, from L2 after the
// first).  Rows P-1 <= r < ks, where every pixel meets a tap row, run
// without a check.  Per chunk and patch row: J*C + P shared loads against
// P*J*C + P*C FMAs, 0.26 loads per FMA at C=1; the edge rows (r < P-1 or
// r >= ks) add (P-1)/ks = 6 % FMAs.  Registers: P*J = 68 for h, 2*P*C for
// the partial and full sums; __launch_bounds__ holds the models' 1 and 3
// channels at 128 a thread, so that two blocks share an SM and one block's
// staging overlaps the other's sums, and the lane's v address waits in
// shared memory, not in a register (ptxas: no spills).  The loop is still
// bound by instruction issue: beside each row's FMAs a thread issues its
// shared loads, the ring's copy and wait and their address arithmetic
// (scripts/time_sepconv_fwd_mxu_variants.py times the alternatives).  All
// operands come with element strides, so a kernel head's NCHW output viewed
// as [B,H,W,ks] goes in without a copy.  bf16 operands are widened on load
// and the result is rounded once on store.

#include <type_traits>

#include "sepconv_mma.cuh"

namespace {

using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;

constexpr int TILE_W = 32;  // one column per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int P = 4;   // output rows per thread
constexpr int J = 17;  // horizontal taps per chunk
constexpr int TILE_H = WARPS * P;
constexpr int U = 4;  // patch loads each thread keeps in flight while staging
constexpr int D = 8;  // rows of v each warp keeps in flight (its ring of staged v rows)
// Blocks per SM the registers leave room for: two (128 registers a thread)
// for the models' 1 and 3 channels, which fit them without spilling; 2 and 4
// channels take what they need at one block per SM.
template <int C>
constexpr int min_blocks() {
  return C % 2 == 1 ? 2 : 1;
}

struct Geometry {
  int ph, pw;  // patch rows; patch row stride, TILE_W-1 plus the taps rounded up to whole chunks
  size_t ring; // byte offset of the v rings, after the patch
};

__host__ __device__ inline Geometry geometry(int ks, int C) {
  Geometry g;
  g.ph = TILE_H + ks - 1;
  g.pw = TILE_W + (ks + J - 1) / J * J - 1;
  g.ring = (sizeof(float) * size_t(C) * g.ph * g.pw + 15) / 16 * 16;
  return g;
}

// The patch ([C][ph][pw] f32), then each warp's ring of v rows ([D][P][TILE_W]
// of T), then each thread's v source address.
template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(T) * size_t(WARPS) * D * P * TILE_W;
}
template <typename T, int C>
size_t smem_bytes(int ks) {
  return geometry(ks, C).ring + ring_bytes<T>() + sizeof(unsigned long long) * THREADS;
}

// threadIdx.x and blockIdx.x, read anew: what is derived from them after the
// main loop need not stay in registers through it.
__device__ __forceinline__ int fresh_tid() {
  int r;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ int fresh_ctaid() {
  int r;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(r));
  return r;
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, min_blocks<C>())
sepconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ h,
                   T* __restrict__ out, Strides sx, Strides sv, Strides sh, Strides so,
                   int H, int W, int ks, int tiles_x, int tiles_y, bool v_async) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geometry g = geometry(ks, C);
  float* patch = reinterpret_cast<float*>(smem_raw);  // [C][ph][pw]
  const int tiles = tiles_x * tiles_y;
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int y0 = (t / tiles_x) * TILE_H;
  const int x0 = (t % tiles_x) * TILE_W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hp = H + ks - 1;
  const int Wp = W + ks - 1;

  // The patch, channel fastest across threads (NHWC's unit stride); columns
  // past TILE_W+ks-1 (the last chunk's padding) and past the padded image are zero.
  const T* xb = x + b * sx.b;
  const int n_patch = C * g.ph * g.pw;
  const int cols = TILE_W + ks - 1;
  for (int base = tid; base < n_patch; base += U * THREADS) {
    float a[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = base + k * THREADS;
      const int c = i % C;
      const int col = (i / C) % g.pw;
      const int r = i / (C * g.pw);
      const int gy = y0 + r;
      const int gx = x0 + col;
      a[k] = (i < n_patch && col < cols && gy < Hp && gx < Wp) ? to_float(xb[gy * sx.y + gx * sx.x + c * sx.last])
                                                                : 0.f;
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = base + k * THREADS;
      if (i < n_patch) patch[((i % C) * g.ph + i / (C * g.pw)) * g.pw + (i / C) % g.pw] = a[k];
    }
  }
  __syncthreads();

  const int xx = x0 + lane;  // lanes past W run along (the warp stages v together) and store nothing
  const bool in_w = xx < W;
  const int yb = y0 + warp * P;  // this thread's first output row
  if (yb >= H) return;  // warp-uniform
  const int np = min(P, H - yb);  // its pixels inside the image (warp-uniform)
  const T* hb = h + b * sh.b + yb * sh.y + xx * sh.x;
  const int cstride = g.ph * g.pw;
  const int rows = ks + P - 1;  // patch rows r = p + f that the pixels meet

  // Row r's v into slot r % D of this warp's ring: v[yb+p, x0.., f = r-p]
  // for each pixel p that meets tap row f.  Each lane copies one 16-byte
  // piece of one pixel row (cp.async where the operand allows, scalar loads
  // at the image's edge or otherwise), the same piece in every row, so its
  // addresses are set once and only f moves.
  constexpr int V = 16 / sizeof(T);  // elements per copy
  constexpr int CH = TILE_W / V;     // copies per pixel row
  static_assert(P * CH <= 32, "one copy per lane and row");
  const int sp = lane / CH;        // this lane's pixel row
  const int se = (lane % CH) * V;  // and its first element
  const bool s_on = lane < P * CH && sp < np;
  const bool s_async = v_async && x0 + se + V <= W;
  // The lane's v address lives in shared memory, read as each row is staged:
  // the registers are full of h.
  unsigned long long* s_src = reinterpret_cast<unsigned long long*>(smem_raw + g.ring + ring_bytes<T>()) + tid;
  *s_src = reinterpret_cast<unsigned long long>(v + b * sv.b + (yb + sp) * sv.y + (x0 + se) * sv.x);
  T* ring = reinterpret_cast<T*>(smem_raw + g.ring) + warp * D * P * TILE_W;
  T* s_dst = ring + sp * TILE_W + se;
  auto stage_v = [&](int r) {
    const int f = r - sp;
    if (s_on && f >= 0 && f < ks) {
      T* dst = s_dst + (r % D) * (P * TILE_W);
      const T* src = reinterpret_cast<const T*>(*s_src) + f * sv.last;
      if (s_async) {
        sepconv::cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (x0 + se + e < W) dst[e] = src[e * sv.x];
      }
    }
    sepconv::cp_async_commit();
  };

  float acc[P][C];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[p][c] = 0.f;

  for (int j0 = 0; j0 < ks; j0 += J) {
    float hr[P][J];
    const T* hj = hb + j0 * sh.last;  // tap j0 + j of pixel p at hj + p * sh.y
#pragma unroll
    for (int j = 0; j < J; ++j, hj += sh.last)
#pragma unroll
      for (int p = 0; p < P; ++p) hr[p][j] = (in_w && p < np && j0 + j < ks) ? to_float(hj[p * sh.y]) : 0.f;
#pragma unroll 1
    for (int r = 0; r < D - 1; ++r) stage_v(r);
    const float* prow = patch + warp * P * g.pw + lane + j0;

    // Patch row r: every pixel's partial sum over the chunk, then v[f = r-p]
    // times it into the pixel's sums.  FULL rows (P-1 <= r < ks) are those
    // where every pixel meets a tap row, so they check nothing.
    auto row = [&](int r, auto full) {
      constexpr bool FULL = decltype(full)::value;
      __syncwarp();  // every lane is done with row r-1's slot, which row r+D-1 takes
      stage_v(r + D - 1);
      sepconv::cp_async_wait_group<D - 1>();  // row r's copies are done
      __syncwarp();
      const float* pr = prow + r * g.pw;
      const T* vr = ring + (r % D) * (P * TILE_W) + lane;
      float part[P][C];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < C; ++c) part[p][c] = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float xv = pr[c * cstride + j];
#pragma unroll
          for (int p = 0; p < P; ++p) part[p][c] = fmaf(hr[p][j], xv, part[p][c]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (FULL || (r - p >= 0 && r - p < ks)) {
          const float w = to_float(vr[p * TILE_W]);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[p][c] = fmaf(w, part[p][c], acc[p][c]);
        }
      }
    };
#pragma unroll 1
    for (int r = 0; r < min(P - 1, rows); ++r) row(r, std::false_type{});
#pragma unroll 1
    for (int r = P - 1; r < ks; ++r) row(r, std::true_type{});
#pragma unroll 1
    for (int r = max(ks, P - 1); r < rows; ++r) row(r, std::false_type{});
    sepconv::cp_async_wait_all();  // the ring's trailing groups (rows past the last) are empty
    __syncwarp();                  // every lane is done with the ring before the next chunk refills it
  }

  const int lt = fresh_tid();
  const int lb = fresh_ctaid();
  const int ly = (lb % tiles) / tiles_x * TILE_H + (lt >> 5) * P;
  const int lx = (lb % tiles_x) * TILE_W + (lt & 31);
  T* op = out + (lb / tiles) * so.b + ly * so.y + lx * so.x;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (lx < W && ly + p < H) {
#pragma unroll
      for (int c = 0; c < C; ++c) store(op + p * so.y + c * so.last, acc[p][c]);
    }
  }
}

struct Fwd {
  template <typename T, int C>
  static cudaError_t run(const void* x, const void* v, const void* h, void* out, Strides sx, Strides sv,
                         Strides sh, Strides so, int B, int H, int W, int ks, cudaStream_t stream) {
    const int tiles_x = (W + TILE_W - 1) / TILE_W;
    const int tiles_y = (H + TILE_H - 1) / TILE_H;
    return sepconv::launch_kernel(sepconv_fwd_kernel<T, C>, (long long)B * tiles_x * tiles_y, THREADS,
                                  smem_bytes<T, C>(ks), stream, static_cast<const T*>(x),
                                  static_cast<const T*>(v), static_cast<const T*>(h), static_cast<T*>(out), sx, sv,
                                  sh, so, H, W, ks, tiles_x, tiles_y, sepconv::async_ok(v, sv, sizeof(T)));
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
