// Blocked cross-entropy forward: per-token w * (lse - gold) and lse of
// h @ head, streamed over vocabulary tiles so the (N, V) logits never exist.
//
// Replaces deeplearning4j_tpu/ops/pallas/xent.py::_xent_fwd (pl.pallas_call
// at xent.py:97), reached from blocked_cross_entropy through
// ops/losses.blocked_token_xent in lm_head_loss (xent_impl="blocked" and the
// near-prime token counts).
//
// What bounds it: operations.  Every logit is a D-long dot: 2*N*V*D = 1.65e12
// operations at N = 32768, V = 32768, D = 768, i.e. 1.7 ms at the bf16
// peak, against 0.1 GB of h and head (0.03 ms).  So the products run on the
// tensor cores in bf16 (WMMA m16n16k16, f32 accumulate); f32 inputs take
// f32 FMAs.
//
// Design: the Pallas grid (N/BT, V/BV) carries the running (max,
// denominator, gold) across its sequential vocabulary axis in revisited
// output blocks.  GPU blocks run in no order, so here one block owns a tile
// of 128 tokens and loops over vocabulary tiles of 128 columns itself,
// keeping the running max m, denominator l and gold logit per row in
// registers.  When the token tiles alone would leave SMs idle (small N),
// the vocabulary is split over blockIdx.y and a second kernel merges the
// splits' (m, l, gold) in a fixed order (deterministic, no atomics); with
// one split the merge is a pass over N rows.  Each logit tile is built over
// depth chunks of 32 staged in shared memory: rows of h, and columns of head
// read through its strides; the tied head is tok_embed^T, a (V, D)
// row-major tensor read as (D, V), so a column is a contiguous row and no
// transposed copy is made.  Tail columns past the real V are masked to
// -1e30 (weight 0), tail rows past N are zero and never written; the gold
// logit is added once, where the column equals the target.  Zero-weight
// rows give 0 loss (their lse is still written).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBT = 128;   // tokens per block
constexpr int kBV = 128;   // vocabulary columns per tile
constexpr int kKC = 32;    // depth chunk
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Layout {
  static constexpr int kLd = kKC + (sizeof(T) == 2 ? 8 : 1);   // staged row stride
  static constexpr int kSw = kBV + 4;                           // logit tile row stride
  static constexpr size_t kH = 0;
  static constexpr size_t kE = ((static_cast<size_t>(kBT) * kLd * sizeof(T) + 127) / 128) * 128;
  static constexpr size_t kS =
      kE + ((static_cast<size_t>(kBV) * kLd * sizeof(T) + 127) / 128) * 128;
  static constexpr size_t kBytes = kS + static_cast<size_t>(kBT) * kSw * 4;
};

// rows [r0, r0+R) x depth [d0, d0+kKC) of a matrix whose element (r, d) is
// src[r*rs + d*ds] into dst[R][kLd]; rows >= nr and depths >= D are zero.
// vec: ds == 1 with 16-byte aligned rows (bf16 only).
template <typename T, int R>
__device__ __forceinline__ void load_chunk(T* __restrict__ dst, const T* __restrict__ src,
                                           long long rs, long long ds, int r0, int nr, int d0,
                                           int D, bool vec) {
  constexpr int kLd = Layout<T>::kLd;
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      constexpr int kPerRow = kKC / 8;
      for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
        const int r = i / kPerRow, c = (i % kPerRow) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < nr && d0 + c < D)
          val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + d0 + c);
        *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
      }
      return;
    }
  }
  if (ds == 1) {  // neighbouring threads on neighbouring depths
    for (int i = threadIdx.x; i < R * kKC; i += kThreads) {
      const int r = i / kKC, c = i % kKC;
      T val = from_f32<T>(0.f);
      if (r0 + r < nr && d0 + c < D) val = src[(r0 + r) * rs + d0 + c];
      dst[r * kLd + c] = val;
    }
  } else {        // neighbouring threads on neighbouring rows
    for (int i = threadIdx.x; i < R * kKC; i += kThreads) {
      const int c = i / R, r = i % R;
      T val = from_f32<T>(0.f);
      if (r0 + r < nr && d0 + c < D) val = src[(r0 + r) * rs + (d0 + c) * ds];
      dst[r * kLd + c] = val;
    }
  }
}

// the logit tile S[kBT][kBV] = h_tile @ head[:, v0:v0+kBV] into shared memory
__device__ __forceinline__ void logit_tile(const __nv_bfloat16* __restrict__ h,
                                           const __nv_bfloat16* __restrict__ e, int n0, int N,
                                           int v0, int V, int D, long long sd, long long sv,
                                           bool e_vec, unsigned char* smem) {
  using L = Layout<__nv_bfloat16>;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L::kH);
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(smem + L::kE);
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  const int warp = threadIdx.x / 32;
  const int wr = warp % 4, wc = warp / 4;   // 32 rows x 64 columns a warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[i][n], 0.f);
  for (int d0 = 0; d0 < D; d0 += kKC) {
    __syncthreads();
    load_chunk<__nv_bfloat16, kBT>(hs, h, D, 1, n0, N, d0, D, true);
    // column v of head, as a row: element (v, d) at v*sv + d*sd
    load_chunk<__nv_bfloat16, kBV>(es, e, sv, sd, v0, V, d0, D, e_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], hs + (wr * 32 + i * 16) * L::kLd + kk * 16, L::kLd);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, es + (wc * 64 + n * 16) * L::kLd + kk * 16, L::kLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][n], a[i], b, acc[i][n]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(ss + (wr * 32 + i * 16) * L::kSw + wc * 64 + n * 16, acc[i][n],
                              L::kSw, wmma::mem_row_major);
}

__device__ __forceinline__ void logit_tile(const float* __restrict__ h,
                                           const float* __restrict__ e, int n0, int N, int v0,
                                           int V, int D, long long sd, long long sv, bool,
                                           unsigned char* smem) {
  using L = Layout<float>;
  float* hs = reinterpret_cast<float*>(smem + L::kH);
  float* es = reinterpret_cast<float*>(smem + L::kE);
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  const int row = threadIdx.x / 2, sub = threadIdx.x % 2;
  float acc[kBV / 2];
#pragma unroll
  for (int i = 0; i < kBV / 2; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kKC) {
    __syncthreads();
    load_chunk<float, kBT>(hs, h, D, 1, n0, N, d0, D, false);
    load_chunk<float, kBV>(es, e, sv, sd, v0, V, d0, D, false);
    __syncthreads();
    for (int d = 0; d < kKC; ++d) {
      const float hv = hs[row * L::kLd + d];
#pragma unroll
      for (int i = 0; i < kBV / 2; ++i) acc[i] += hv * es[(2 * i + sub) * L::kLd + d];
    }
  }
#pragma unroll
  for (int i = 0; i < kBV / 2; ++i) ss[row * L::kSw + 2 * i + sub] = acc[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_tiles_kernel(const T* __restrict__ h, const T* __restrict__ e,
                  const int* __restrict__ targets, float* __restrict__ part, int N, int V, int D,
                  long long sd, long long sv, int e_vec, int tiles_per_split) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* ss = reinterpret_cast<const float*>(smem + L::kS);
  const int n0 = blockIdx.x * kBT, split = blockIdx.y;
  const int n_vt = (V + kBV - 1) / kBV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(n_vt, vt0 + tiles_per_split);
  const int row = threadIdx.x / 2, sub = threadIdx.x % 2;
  const int n = n0 + row;
  const int tgt = n < N ? targets[n] : -1;

  float m = kNegInf, l = 0.f, gold = 0.f;
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV;
    logit_tile(h, e, n0, N, v0, V, D, sd, sv, e_vec != 0, smem);
    __syncthreads();
    const float* srow = ss + row * L::kSw;
    float mx = kNegInf;
#pragma unroll 8
    for (int i = 0; i < kBV / 2; ++i) {
      const int c = 2 * i + sub;
      if (v0 + c < V) mx = fmaxf(mx, srow[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float ps = 0.f;
#pragma unroll 8
    for (int i = 0; i < kBV / 2; ++i) {
      const int c = 2 * i + sub;
      if (v0 + c < V) {
        const float s = srow[c];
        ps += expf(s - m_new);
        if (v0 + c == tgt) gold += s;
      }
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * expf(m - m_new) + ps;
    m = m_new;
  }
  gold += __shfl_xor_sync(0xffffffffu, gold, 1);
  if (sub == 0 && n < N) {
    float* p = part + (static_cast<size_t>(split) * N + n) * 3;
    p[0] = m;
    p[1] = l;
    p[2] = gold;
  }
}

// merge the splits of each row in a fixed order; write lse and w * (lse - gold)
__global__ void xent_merge_kernel(const float* __restrict__ part,
                                  const float* __restrict__ weights, float* __restrict__ wloss,
                                  float* __restrict__ lse, int N, int n_splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float M = kNegInf;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, part[(static_cast<size_t>(s) * N + n) * 3]);
  float Lsum = 0.f, G = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = part + (static_cast<size_t>(s) * N + n) * 3;
    Lsum += p[1] * expf(p[0] - M);
    G += p[2];
  }
  const float z = M + logf(fmaxf(Lsum, 1e-30f));
  lse[n] = z;
  wloss[n] = weights[n] * (z - G);
}

template <typename T>
cudaError_t launch(const void* h, const void* head, const void* targets, const void* weights,
                   void* wloss, void* lse, void* part, int N, int V, int D, long long sd,
                   long long sv, int e_vec, int n_splits, cudaStream_t stream) {
  constexpr size_t kBytes = Layout<T>::kBytes;
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(xent_tiles_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBytes));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_vt = (V + kBV - 1) / kBV;
  const int tps = (n_vt + n_splits - 1) / n_splits;
  dim3 grid((N + kBT - 1) / kBT, n_splits);
  xent_tiles_kernel<T><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(head), static_cast<const int*>(targets),
      static_cast<float*>(part), N, V, D, sd, sv, e_vec, tps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  xent_merge_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(weights),
      static_cast<float*>(wloss), static_cast<float*>(lse), N, n_splits);
  return cudaGetLastError();
}

}  // namespace

DL4J_EXPORT_ERROR_STRING

// h (N,D) contiguous in `dtype` (kF32 or kBF16; bf16 rows 16-byte aligned,
// D % 8 == 0); head (D,V) in `dtype` with element (d, v) at d*sd + v*sv;
// e_vec != 0 when sd == 1 and its columns are 16-byte aligned (bf16
// vector loads); targets (N,) int32; weights (N,) f32; wloss, lse (N,) f32;
// part (n_splits, N, 3) f32 scratch.  Returns cudaGetLastError() after the
// launches.
extern "C" int dl4j_blocked_xent(const void* h, const void* head, const void* targets,
                                 const void* weights, void* wloss, void* lse, void* part,
                                 int N, int V, int D, long long sd, long long sv, int e_vec,
                                 int n_splits, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (V <= 0 || D <= 0 || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(h, head, targets, weights, wloss, lse, part, N, V,
                                            D, sd, sv, 0, n_splits, s));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(h, head, targets, weights, wloss, lse,
                                                    part, N, V, D, sd, sv, e_vec, n_splits,
                                                    s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
