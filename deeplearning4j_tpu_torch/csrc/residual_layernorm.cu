// Fused residual add + LayerNorm: y = x + r * mask, h = LN(y) * scale + bias.
//
// Replaces deeplearning4j_tpu/ops/pallas/layernorm.py::_fused_call
// (pl.pallas_call at layernorm.py:74), reached from
// fused_residual_layernorm, the transformer block's mid-sublayer seam when
// TransformerConfig.fused_ln is set.
//
// Both outputs come from one f32 pass: y is written rounded to x's dtype,
// but h is normalized from the UNROUNDED f32 y (layernorm.py:53-60), which
// is what sets it apart from the two-op seam in bf16.  Mean, then the mean
// of (y - mu)^2, eps inside the rsqrt, as the Pallas kernel computes them.
//
// What bounds it: bytes.  Each call reads x and r and writes y and h once:
// 4 * N * D * 2 bytes in bf16, 201 MB at N = 32768, D = 768, i.e. 0.060 ms
// at 3.35 TB/s; the ~10 operations per element are far below the line.
//
// Design: the TPU kernel takes row blocks of 256 (N padded to the block).
// Here one warp owns one row: lane l holds elements l, l+32, ... of y in
// registers (VPL of them, a template parameter: D = 768 is 24 a lane), so
// x and r are read once, coalesced, and both reductions are warp shuffles
// with no shared memory and no barrier.  Eight rows per block; rows past N
// are skipped by index (no padding).  The (N,) f32 keep-mask is read once
// per row.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VPL>
__global__ void __launch_bounds__(32 * kWarps)
residual_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                          const float* __restrict__ mask, const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y,
                          T* __restrict__ h, int N, int D, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const size_t base = static_cast<size_t>(row) * D;
  const float keep = mask[row];
  float yv[VPL];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    yv[i] = 0.f;
    if (c < D) {
      yv[i] = to_f32(x[base + c]) + to_f32(r[base + c]) * keep;
      sum += yv[i];
    }
  }
  const float inv_d = 1.f / static_cast<float>(D);
  const float mu = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      const float d = yv[i] - mu;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      y[base + c] = from_f32<T>(yv[i]);
      h[base + c] = from_f32<T>((yv[i] - mu) * rstd * scale[c] + bias[c]);
    }
  }
}

template <typename T, int VPL>
cudaError_t launch(const void* x, const void* r, const void* mask, const void* scale,
                   const void* bias, void* y, void* h, int N, int D, float eps,
                   cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  residual_layernorm_kernel<T, VPL><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const float*>(mask),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<T*>(h), N, D, eps);
  return cudaGetLastError();
}

// the per-lane register count: D / 32 rounded up to 8, 16, 32 or 64
template <typename T>
cudaError_t dispatch(const void* x, const void* r, const void* mask, const void* scale,
                     const void* bias, void* y, void* h, int N, int D, float eps,
                     cudaStream_t s) {
  const int vpl = (D + 31) / 32;
  if (vpl <= 8) return launch<T, 8>(x, r, mask, scale, bias, y, h, N, D, eps, s);
  if (vpl <= 16) return launch<T, 16>(x, r, mask, scale, bias, y, h, N, D, eps, s);
  if (vpl <= 32) return launch<T, 32>(x, r, mask, scale, bias, y, h, N, D, eps, s);
  if (vpl <= 64) return launch<T, 64>(x, r, mask, scale, bias, y, h, N, D, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

DL4J_EXPORT_ERROR_STRING

// x, r (N,D) contiguous in `dtype` (kF32 or kBF16); mask (N,) f32 keep
// factors; scale, bias (D,) f32; y, h (N,D) contiguous in `dtype`.
// D <= 2048.  Returns cudaGetLastError() after the launch.
extern "C" int dl4j_residual_layernorm(const void* x, const void* r, const void* mask,
                                       const void* scale, const void* bias, void* y, void* h,
                                       int N, int D, float eps, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || D > 2048) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch<float>(x, r, mask, scale, bias, y, h, N, D, eps, s));
    case kBF16:
      return static_cast<int>(
          dispatch<__nv_bfloat16>(x, r, mask, scale, bias, y, h, N, D, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
