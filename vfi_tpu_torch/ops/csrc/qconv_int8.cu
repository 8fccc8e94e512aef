// int8 serving convolution, for sm_90a (H100): the activation quantize and the
// int8 x int8 -> int32 'same' convolution with its dequantizing epilogue.
//
// Replaces what XLA computes for vfi_tpu's int8 serving mode (VFI_INT8=1/2),
// vfi_tpu/nn/quant.py:101-123: the activation quantize
// q = clip(round(x / x_scale), -127, 127) and
// lax.conv_general_dilated(xq, wq, preferred_element_type=int32), then
// y = float(acc) * (x_scale * w_scale[c]) + b, cast to x's dtype.  vfi_tpu
// wrote no Pallas for it; PyTorch has no int8 convolution on CUDA.
//
// quantize_int8: x NCHW (float32 or bfloat16, any element strides) -> xq NHWC
// int8 with the channels zero-padded to Cp (a multiple of 32, the K granule of
// the conv).  The scale is read from a device float32 scalar, so a dynamic
// scale (an amax reduced on the card) costs no host sync.  q is
// __float2int_rn(__fdiv_rn(x, s)) clamped to +-127: IEEE division, round half
// to even, as jnp.round and torch.round.  Each block transposes a tile of 32
// channels x 32 columns of one row through shared memory, so that the reads
// run along x and the writes along the channels.  Bound: bytes (x read once,
// xq written once).
//
// qconv_int8: stride 1, 'same' zero padding, odd k in {1, 3, 5, 7}.  An
// implicit GEMM with M = output pixels, N = output channels and K = k*k*Cp, on
// mma.sync m16n8k32 s8 x s8 -> s32.  A block takes a patch of 128 output
// pixels of one image (8x16, 16x8 or 32x4 as the width allows) and 64 output
// channels; its 8 warps are 4 (pixels) x 2 (channels), each 32 x 32.  Per
// chunk of 32 input channels it stages, by 16-byte cp.async copies with zero
// fill, the patch's input with its halo, (PH+k-1) x (PW+k-1) positions of 32
// bytes (out-of-image taps are zeros), and the chunk's weights of every tap,
// [k*k][64][32 bytes] (output channels past C_out are zeros); two stages, so
// the next chunk's copies overlap this chunk's products.  Every tap then reads
// its A fragments from the staged halo at the tap's offset: the input crosses
// device memory about once per output-channel tile, not k*k times.  Rows of
// 32 bytes swap their two 16-byte halves on bit 2 of the row index, so the 8
// rows a fragment load touches hit distinct banks.  Epilogue in float32,
// __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[c]), bias[c]) with
// scale[c] = x_scale * w_scale[c] formed by the caller, written NCHW in the
// output dtype; or the int32 sums as they are (the exact check).
// |acc| <= 127^2 * k*k * Cp, 7.9e8 at k=7 and Cp=1024: it fits in int32.
//
// Bound, at TAI_gray's shapes: operations for the wide convs (2*MAC over
// 1979 TOP/s of dense int8), bytes for the narrow ones (xq, wq and the output
// over 3.35 TB/s).  This first kernel reads its fragments with 32-bit shared
// loads (16 per 8 mma per warp per tap), which holds it at about half of the
// mma.sync rate at best; wgmma and a quantize fused into the producer's
// epilogue are the next steps (ROADMAP.md queue 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int CHUNK = 32;  // input channels per k-step: the depth of one m16n8k32
constexpr size_t SMEM_MAX = 232448;  // the most dynamic shared memory a block may use

// Byte offset of 16-byte half `h` of 32-byte row `p`, halves swapped on bit 2 of p.
__device__ __forceinline__ int swz(int p, int h) { return (p << 5) + ((h ^ ((p >> 2) & 1)) << 4); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a * b: A 16x32 (row), B 32x8 (col), s8 in, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(__nv_bfloat16 a) { return __bfloat162float(a); }

__device__ __forceinline__ void store(int* p, int acc, float, float) { *p = acc; }
__device__ __forceinline__ void store(float* p, int acc, float s, float b) {
  *p = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int acc, float s, float b) {
  *p = __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), s), b));
}

template <typename T>
__global__ void __launch_bounds__(256)
quantize_int8_kernel(const T* __restrict__ x, const float* __restrict__ scale, int8_t* __restrict__ out,
                     long long sn, long long sc, long long sy, long long sx, int C, int H, int W, int Cp,
                     int tiles_x) {
  __shared__ int8_t tile[32][33];  // [channel][column]
  const int chunks = Cp / 32;
  long long bid = blockIdx.x;
  const int tx = int(bid % tiles_x);
  bid /= tiles_x;
  const int chunk = int(bid % chunks);
  const long long n = bid / chunks;
  const int y = blockIdx.y, x0 = tx * 32, c0 = chunk * 32;
  const float s = *scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cl = threadIdx.y + 8 * i, c = c0 + cl, xx = x0 + threadIdx.x;
    int q = 0;
    if (c < C && xx < W) {
      q = __float2int_rn(__fdiv_rn(to_float(x[n * sn + c * sc + y * sy + xx * sx]), s));
      q = min(127, max(-127, q));
    }
    tile[cl][threadIdx.x] = static_cast<int8_t>(q);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xl = threadIdx.y + 8 * i, xx = x0 + xl;
    if (xx < W) out[((n * H + y) * W + xx) * Cp + c0 + threadIdx.x] = tile[threadIdx.x][xl];
  }
}

struct Patch {
  int pw_log2, ph, halo_w, halo_pos;
};

__host__ __device__ inline Patch patch(int W, int k) {
  Patch p;
  p.pw_log2 = W >= 16 ? 4 : (W > 4 ? 3 : 2);
  p.ph = BM >> p.pw_log2;
  p.halo_w = (1 << p.pw_log2) + k - 1;
  p.halo_pos = (p.ph + k - 1) * p.halo_w;
  return p;
}

__host__ __device__ inline size_t stage_bytes(const Patch& p, int k) {
  return size_t(p.halo_pos + k * k * BN) * 32;
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
qconv_int8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ scale,
                  const float* __restrict__ bias, OutT* __restrict__ out, int H, int W, int Cp, int Co, int k,
                  int tiles_x, int tiles_y, int tiles_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Patch pt = patch(W, k);
  const int PW = 1 << pt.pw_log2;
  const int taps = k * k, pad = k >> 1;
  const size_t sbytes = stage_bytes(pt, k);

  long long bid = blockIdx.x;
  const int tn = int(bid % tiles_n);
  bid /= tiles_n;
  const int tx = int(bid % tiles_x);
  bid /= tiles_x;
  const int ty = int(bid % tiles_y);
  const long long n = bid / tiles_y;
  const int y0 = ty * pt.ph, x0 = tx * PW, co0 = tn * BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* ximg = xq + n * H * W * Cp;

  auto stage = [&](int chunk, int buf) {
    unsigned char* s = smem + buf * sbytes;
    for (int i = tid; i < pt.halo_pos * 2; i += THREADS) {
      const int p = i >> 1, h = i & 1;
      const int hy = p / pt.halo_w, hx = p - hy * pt.halo_w;
      const int yy = y0 - pad + hy, xx = x0 - pad + hx;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const int8_t* src = ok ? ximg + ((long long)yy * W + xx) * Cp + chunk * CHUNK + h * 16 : xq;
      cp_async16(s + swz(p, h), src, ok);
    }
    unsigned char* sw = s + pt.halo_pos * 32;
    for (int i = tid; i < taps * BN * 2; i += THREADS) {
      const int r = i >> 1, h = i & 1;  // r = tap * BN + j
      const int tap = r / BN, co = co0 + (r - tap * BN);
      const bool ok = co < Co;
      const int8_t* src = ok ? wq + ((long long)co * taps + tap) * Cp + chunk * CHUNK + h * 16 : wq;
      cp_async16(sw + swz(r, h), src, ok);
    }
  };

  // Halo positions of this thread's fragment rows g and g+8 in its two m-tiles.
  int pbase[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = (wm * 2 + mi) * 16 + g + hr * 8;
      pbase[mi][hr] = (m >> pt.pw_log2) * pt.halo_w + (m & (PW - 1));
    }
  }

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int nchunks = Cp / CHUNK;
  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* s = smem + (c & 1) * sbytes;
    const unsigned char* sw = s + pt.halo_pos * 32;
    for (int ky = 0; ky < k; ++ky) {
      for (int kx = 0; kx < k; ++kx) {
        const int off = ky * pt.halo_w + kx, tap = ky * k + kx;
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int p0 = pbase[mi][0] + off, p1 = pbase[mi][1] + off;
          a[mi][0] = lds32(s + swz(p0, 0) + 4 * t);  // row g,   k 4t..4t+3
          a[mi][1] = lds32(s + swz(p1, 0) + 4 * t);  // row g+8, k 4t..4t+3
          a[mi][2] = lds32(s + swz(p0, 1) + 4 * t);  // row g,   k 16+4t..
          a[mi][3] = lds32(s + swz(p1, 1) + 4 * t);  // row g+8, k 16+4t..
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int r = tap * BN + wn * 32 + ni * 8 + g;  // column g of the n-tile
          const unsigned b0 = lds32(sw + swz(r, 0) + 4 * t);
          const unsigned b1 = lds32(sw + swz(r, 1) + 4 * t);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = (wm * 2 + mi) * 16 + g + (e >> 1) * 8;
        const int y = y0 + (m >> pt.pw_log2), xx = x0 + (m & (PW - 1));
        const int co = co0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (y < H && xx < W && co < Co) {
          const float sc = scale ? scale[co] : 0.f, b = bias ? bias[co] : 0.f;
          store(out + ((n * Co + co) * H + y) * (long long)W + xx, acc[mi][ni][e], sc, b);
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch_qconv(const int8_t* xq, const int8_t* wq, const float* scale, const float* bias, void* out, int N,
                         int H, int W, int Cp, int Co, int k, cudaStream_t stream) {
  static size_t opted = 0;  // dynamic shared memory this instantiation is opted into
  const Patch pt = patch(W, k);
  const size_t smem = 2 * stage_bytes(pt, k);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(qconv_int8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const int tiles_x = (W + (1 << pt.pw_log2) - 1) >> pt.pw_log2;
  const int tiles_y = (H + pt.ph - 1) / pt.ph;
  const int tiles_n = (Co + BN - 1) / BN;
  const long long blocks = (long long)N * tiles_y * tiles_x * tiles_n;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  qconv_int8_kernel<OutT><<<unsigned(blocks), THREADS, smem, stream>>>(
      xq, wq, scale, bias, static_cast<OutT*>(out), H, W, Cp, Co, k, tiles_x, tiles_y, tiles_n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Element strides of x (N, C, H, W).
// Returns cudaGetLastError() after the launch.
extern "C" int quantize_int8(const void* x, const void* scale, void* out, long long sn, long long sc, long long sy,
                             long long sx, int N, int C, int H, int W, int Cp, int dtype, void* stream) {
  if (Cp % 32 != 0 || C > Cp || H > 65535) return int(cudaErrorInvalidValue);
  const int tiles_x = (W + 31) / 32;
  const long long blocks = (long long)N * (Cp / 32) * tiles_x;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const dim3 grid{static_cast<unsigned>(blocks), static_cast<unsigned>(H)}, block{32, 8};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  if (dtype == 0) {
    quantize_int8_kernel<float><<<grid, block, 0, st>>>(static_cast<const float*>(x), s, o, sn, sc, sy, sx, C, H,
                                                        W, Cp, tiles_x);
  } else if (dtype == 1) {
    quantize_int8_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(static_cast<const __nv_bfloat16*>(x), s, o, sn,
                                                                sc, sy, sx, C, H, W, Cp, tiles_x);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// xq [N, H, W, Cp] and wq [Co, k, k, Cp] int8, contiguous; scale and bias
// [Co] float32 (unused for int32 output); out [N, Co, H, W] contiguous.
// out_dtype: 0 = int32 (the sums, no epilogue), 1 = float32, 2 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int qconv_int8(const void* xq, const void* wq, const void* scale, const void* bias, void* out, int N,
                          int H, int W, int Cp, int Co, int k, int out_dtype, void* stream) {
  if (Cp % CHUNK != 0 || Cp <= 0 || Co <= 0 || k < 1 || k > 7 || (k & 1) == 0) return int(cudaErrorInvalidValue);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return int(launch_qconv<int>(x, w, nullptr, nullptr, out, N, H, W, Cp, Co, k, st));
    case 1: return int(launch_qconv<float>(x, w, s, b, out, N, H, W, Cp, Co, k, st));
    case 2: return int(launch_qconv<__nv_bfloat16>(x, w, s, b, out, N, H, W, Cp, Co, k, st));
  }
  return int(cudaErrorInvalidValue);
}

extern "C" const char* qconv_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
