// Shared helpers of the port's kernels: dtype codes, conversions and the
// error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes the Python wrappers pass (ops/cuda/*.py: _DTYPE_CODES)
enum Dl4jDtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
// exact: every e4m3 value is an f16 value (cvt e4m3 -> f16 on sm_89+)
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

#define DL4J_EXPORT_ERROR_STRING                                      \
  extern "C" const char* dl4j_error_string(int code) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }
