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
// What bounds it on the H100: bytes.  At the bi-TAI serving shape (B*T=320,
// 128x128, ks=51, C=1) v and h are 535 MB each in bf16 while x and out are
// 20 MB and 10 MB: 1.1 GB, 0.33 ms at 3.35 TB/s in bf16, twice that in f32.
// The banded products are 2*ks*(TW+ks-1)*TW flops per output row and channel
// before the band is skipped, about 0.1 ms of bf16 tensor-core time at that
// shape (three times that for the f32 split).
//
// What this design does about it: every element of v and h crosses device
// memory once, coalesced along x (the heads' layout has tap stride H*W), and
// is never repeated per channel; the copies of one row overlap the products
// of the row before.  One block of 16 warps takes one image, TH output rows
// and a column tile of TW=128 outputs (one n-tile of 8 columns per warp).  It
// stages the input slab (TH+ks-1 rows of TW+ks-1 columns, every channel, as
// bf16 or a bf16 hi/lo pair) once, while the first row's h and v are already
// in flight.  Per output row it stages h and v, tap-major [ks][TW], by
// 16-byte cp.async copies (sepconv_mma.cuh, stage_rows) into one of two
// buffers while the previous row's products run: one barrier per row.  Each
// warp runs the horizontal pass of its n-tile (banded_horizontal_pass, shared
// with bwd_vh's grad_v): S's fragments are formed in registers straight from
// the staged h, only on the 4-5 k-chunks of 16 its band meets; A is the slab
// (ks tap rows, padded to 64 by repeating the last row, whose sums meet no v)
// by ldmatrix; mma.sync m16n8k16, bf16 in, f32 sums.  The tap reduction
// sum_f inner[f,x]*v[y,x,f] runs in f32 on the accumulator fragments with the
// staged v, then a warp shuffle across the fragment rows.  float32 operands
// stay float32 in the staging buffers and are split in registers as hi + lo
// bf16 pairs, multiplied as hi*hi + lo*hi + hi*lo (the TPU kernel's split).
// bf16 holds 64 registers a thread, so that two blocks share an SM (at 128,
// one block took 0.92 against 0.72 ms at the gray serving shape on an H100
// SXM at 700 W, scripts/time_sepconv_fwd_mxu_variants.py); the
// launcher picks the row tile and the number of buffers from what fits (see
// FwdMxu::run): two buffers and two blocks per SM where they fit (bf16 with
// one channel), else two blocks with one buffer for bf16 and two buffers with
// one block for float32, whose split needs more registers.  Operands come with
// element strides; rows that cp.async cannot copy (x not unit-stride, or not
// 16-byte aligned) take scalar loads.  Sums are f32; the result is rounded
// once.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "sepconv_mma.cuh"

namespace {

using sepconv::ld2;
using sepconv::Strides;
using sepconv::store;
using sepconv::to_float;

constexpr int TW = 128;  // output columns per block (the TPU kernel's column tile)
constexpr int WARPS = TW / 8;  // one n-tile of 8 columns each
constexpr int THREADS = WARPS * 32;
constexpr size_t SMEM_MAX = 232448;     // the most dynamic shared memory a block may use
constexpr size_t SMEM_TWO_PER_SM = 115712;  // at most this, two blocks fit on one SM

// Row stride of the staged [ks][TW] rows: conflict-free fragment loads, 16-byte rows.
template <typename T>
__host__ __device__ constexpr int row_stride() {
  return sizeof(T) == 2 ? TW + 8 : TW + 4;
}

struct Geometry {
  int ks, kpad, rs, th, rows, nbuf;
};

__host__ __device__ inline Geometry geometry(int ks, int th, int nbuf) {
  Geometry g;
  g.ks = ks;
  g.kpad = (TW + ks - 1 + 15) / 16 * 16;  // K of the products, padded to 16
  g.rs = g.kpad + 8;                      // slab row stride: conflict-free ldmatrix rows
  g.th = th;
  g.rows = th + ks - 1;
  g.nbuf = nbuf;
  return g;
}

// The slab ([PARTS][C][rows][rs] bf16) and nbuf buffers of h and v ([ks][row_stride] of T each).
template <typename T, int C>
size_t smem_bytes(const Geometry& g) {
  constexpr int parts = sizeof(T) == 4 ? 2 : 1;
  return sizeof(__nv_bfloat16) * parts * size_t(C) * g.rows * g.rs +
         sizeof(T) * size_t(g.nbuf) * 2 * g.ks * row_stride<T>();
}

// Blocks per SM that the registers must leave room for: at most 64 registers
// a thread lets two bf16 blocks share an SM (where shared memory allows);
// float32's split needs more, and its shared memory allows one block anyway.
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == 2 ? 2 : 1;
}
// Where two staging buffers and two blocks per SM do not both fit: true takes
// two blocks per SM with one buffer first, false two buffers with one block.
// Two blocks where the registers allow them: bf16 with three channels took
// 2.12 ms against 2.71 at the TAI_color serving shape on an H100 SXM at 700 W
// (scripts/time_sepconv_fwd_mxu_variants.py); float32 keeps two buffers.
template <typename T>
constexpr bool occupancy_first() {
  return min_blocks<T>() == 2;
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, min_blocks<T>())
sepconv_fwd_mxu_kernel(const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ h,
                       T* __restrict__ out, Strides sx, Strides sv, Strides sh, Strides so, int H, int W, int ks,
                       int th, int nbuf, int tiles_y, int tiles_x, bool v_async, bool h_async) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int PARTS = SPLIT ? 2 : 1;
  // Slab loads each thread keeps in flight (the fastest of 1, 4, 8 and 16 on
  // the H100 at the serving shapes: 4 for bf16, 16 for f32).
  constexpr int U = SPLIT ? 16 : 4;
  constexpr int HRS = row_stride<T>();
  const Geometry geo = geometry(ks, th, nbuf);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [PARTS][C][rows][rs]
  const size_t xpart = size_t(C) * geo.rows * geo.rs;
  T* bufs = reinterpret_cast<T*>(xs + PARTS * xpart);
  const size_t buf_elems = size_t(2) * ks * HRS;  // h, then v

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
  const int n0 = warp * 8;  // this warp's n-tile

  // Row yy's h and v into buffer i (cp.async where the operand allows).
  auto stage = [&](int yy, int i) {
    const int y = y0 + yy;
    T* hb = bufs + i * buf_elems;
    sepconv::stage_rows<T, THREADS>(hb, HRS, h + b * sh.b + y * sh.y, sh.last, sh.x, ks, x0, TW, W, h_async, tid);
    sepconv::stage_rows<T, THREADS>(hb + ks * HRS, HRS, v + b * sv.b + y * sv.y, sv.last, sv.x, ks, x0, TW, W,
                                    v_async, tid);
    sepconv::cp_async_commit();
  };

  // Columns past W stay zero in every buffer.
  sepconv::zero_smem<THREADS>(bufs, nbuf * buf_elems * sizeof(T), tid);
  __syncthreads();
  if (nbuf == 2) stage(0, 0);
  // The input slab, every channel; columns past the slab's TW+ks-1 and rows
  // or columns past the padded image are zero.
  sepconv::stage_slab<T, C, THREADS, U>(xs, xpart, x + b * sx.b, sx, y0, x0, geo.rows, geo.kpad, geo.rs,
                                        TW + ks - 1, H + ks - 1, W + ks - 1, tid);

  for (int yy = 0; yy < n_rows; ++yy) {
    const int cur = nbuf == 2 ? yy & 1 : 0;
    if (nbuf == 1) {
      if (yy > 0) __syncthreads();  // every warp is done with row yy-1's buffer
      stage(yy, 0);
    }
    sepconv::cp_async_wait_all();
    __syncthreads();  // row yy is staged (and the slab); every warp is done with row yy-1
    if (nbuf == 2 && yy + 1 < n_rows) stage(yy + 1, cur ^ 1);
    if (x0 + n0 >= W) continue;  // warp-uniform: this n-tile is past the image

    const T* hb = bufs + cur * buf_elems;
    const T* vb = hb + ks * HRS;
    T* op = out + b * so.b + (y0 + yy) * so.y;
    const int gx = x0 + n0 + 2 * tq;
    sepconv::banded_horizontal_pass<SPLIT, C>(
        xs, xpart, geo.rows, geo.rs, hb, HRS, n0, yy, ks, lane,
        [&](int c, const float (&acc)[sepconv::BAND_MT][4]) {
          // Tap reduction: this thread holds inner[f, n0+2tq+{0,1}] for
          // f = 16*mt + gr and 16*mt + gr + 8.
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int mt = 0; mt < sepconv::BAND_MT; ++mt) {
            const int f0 = 16 * mt + gr;
            const int f1 = f0 + 8;
            if (f0 < ks) {
              const float2 w = ld2(vb + f0 * HRS + n0 + 2 * tq);
              s0 = fmaf(acc[mt][0], w.x, s0);
              s1 = fmaf(acc[mt][1], w.y, s1);
            }
            if (f1 < ks) {
              const float2 w = ld2(vb + f1 * HRS + n0 + 2 * tq);
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
            if (gx < W) store(op + gx * so.x + c * so.last, s0);
            if (gx + 1 < W) store(op + (gx + 1) * so.x + c * so.last, s1);
          }
        });
  }
}

struct FwdMxu {
  template <typename T, int C>
  static cudaError_t run(const void* x, const void* v, const void* h, void* out, Strides sx, Strides sv,
                         Strides sh, Strides so, int B, int H, int W, int ks, cudaStream_t stream) {
    if (ks > 16 * sepconv::BAND_MT) return cudaErrorInvalidValue;
    // (row tile, staging buffers), in the order they are tried: first two
    // buffers with two blocks per SM, then, as occupancy_first says, two
    // blocks per SM with one buffer and at least 8 rows, or two buffers with
    // one block (occupancy_first), then the largest row tile that fits at all.
    constexpr int CONFIGS[][2] = {{16, 2}, {8, 2}, {16, 1}, {8, 1}, {4, 1}, {2, 1}, {1, 1}};
    Geometry geo{};
    bool found = false;
    auto pick = [&](size_t limit, int nbuf_only, int th_min) {
      for (const auto& cfg : CONFIGS) {
        const Geometry gc = geometry(ks, cfg[0], cfg[1]);
        if (!found && (nbuf_only == 0 || cfg[1] == nbuf_only) && cfg[0] >= th_min &&
            smem_bytes<T, C>(gc) <= limit) {
          geo = gc;
          found = true;
        }
      }
    };
    pick(SMEM_TWO_PER_SM, 2, 1);
    if (occupancy_first<T>()) pick(SMEM_TWO_PER_SM, 0, 8);
    pick(SMEM_MAX, 0, 1);
    if (!found) return cudaErrorInvalidValue;  // float32 with 4 channels and ks > 54
    const int tiles_x = (W + TW - 1) / TW;
    const int tiles_y = (H + geo.th - 1) / geo.th;
    const int eb = sizeof(T);
    return sepconv::launch_kernel(sepconv_fwd_mxu_kernel<T, C>, (long long)B * tiles_y * tiles_x, THREADS,
                                  smem_bytes<T, C>(geo), stream, static_cast<const T*>(x), static_cast<const T*>(v),
                                  static_cast<const T*>(h), static_cast<T*>(out), sx, sv, sh, so, H, W, ks, geo.th,
                                  geo.nbuf, tiles_y, tiles_x, sepconv::async_ok(v, sv, eb),
                                  sepconv::async_ok(h, sh, eb));
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
