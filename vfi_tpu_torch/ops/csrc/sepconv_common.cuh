// Helpers shared by the sepconv kernels (forward and both adjoints).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sepconv {

struct Strides {  // element strides of a rank-4 operand
  long long b, y, x, last;
};

__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(__nv_bfloat16 a) { return __bfloat162float(a); }
__device__ __forceinline__ void store(float* p, float a) { *p = a; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float a) { *p = __float2bfloat16(a); }

// Call F::run<T, C>(args...) for the operands' dtype (0 = float32,
// 1 = bfloat16) and channel count (1..4); cudaErrorInvalidValue otherwise.
template <typename F, typename... Args>
cudaError_t dispatch(int dtype, int C, Args... args) {
  if (dtype == 0) {
    switch (C) {
      case 1: return F::template run<float, 1>(args...);
      case 2: return F::template run<float, 2>(args...);
      case 3: return F::template run<float, 3>(args...);
      case 4: return F::template run<float, 4>(args...);
    }
  } else if (dtype == 1) {
    switch (C) {
      case 1: return F::template run<__nv_bfloat16, 1>(args...);
      case 2: return F::template run<__nv_bfloat16, 2>(args...);
      case 3: return F::template run<__nv_bfloat16, 3>(args...);
      case 4: return F::template run<__nv_bfloat16, 4>(args...);
    }
  }
  return cudaErrorInvalidValue;
}

// Opt the kernel into `smem` bytes of dynamic shared memory and launch it on
// `blocks` blocks; returns cudaGetLastError() after the launch.
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, long long blocks, int threads, size_t smem,
                          cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<unsigned(blocks), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace sepconv
