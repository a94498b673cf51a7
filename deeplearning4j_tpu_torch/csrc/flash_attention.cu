// Flash attention forward (flash-v2 schedule): out and the row log-sum-exp.
//
// Replaces two TPU kernels that share one body:
//   deeplearning4j_tpu/ops/flash_attention.py::_flash_fwd (pl.pallas_call at
//   flash_attention.py:93), which streams every key block and masks, and
//   deeplearning4j_tpu/ops/pallas/attention.py::_fused_fwd (attention.py:102),
//   which under `causal` stops the key loop at the causal frontier
//   (attention.py:58-62).  Here they are one template with a FRONTIER flag.
//
// out (B,T,H,Dh) = softmax(q k^T / sqrt(Dh)) v per (b, h), causal or not, and
// lse (B,H,T) f32 = the row log-sum-exp the backward recomputes P from.
// Masked scores are -1e30 (as in the Pallas kernels), and keys past T (a
// ragged last tile) get weight exactly 0; a causal row always has its
// diagonal, so no row is empty.
//
// What bounds it: at the BERT-base shape (B=64, H=12, T=512, Dh=64,
// bidirectional) the 4*B*H*T*T*Dh = 5.2e10 operations at the bf16 peak
// (0.052 ms) and the 201 MB of q/k/v/out at 3.35 TB/s (0.060 ms) are
// close; the causal leg with the frontier is operation-bound.
//
// Design: the TPU grid (B*H, T/128) runs in order with each program's key
// loop inside it; GPU blocks run in no order, but query tiles are
// independent, so the grid is (query tiles of 64 rows, B*H) and each block
// walks the key/value tiles of 64 rows through shared memory.  q, k and v
// are read in their (B,T,H,Dh) layout through strides (the last dim
// contiguous): no copy to (B*H,T,Dh).  Four warps; warp w owns query rows
// 16w..16w+15 for the scores, the softmax and its share of the output, so
// only the K/V tile loads need block-wide barriers.
//   bf16: S = Q K^T and P V run on the tensor cores (WMMA m16n16k16, bf16
//     in, f32 accumulate); P is rounded to bf16 for P V, as flash attention
//     on GPUs does (the Pallas kernel keeps p in f32: the cost is stated
//     beside the check in chip_smoke.py).
//   f32: the same schedule with f32 FMAs from shared memory.
// The running max m, denominator l and the output accumulator stay in
// registers in f32; thread 2r+s of warp w owns row 16w+r and the columns
// s, s+2, s+4, ...  A wgmma/TMA pipeline is later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kPad = 8;   // keeps rows 32-byte aligned for WMMA
};
template <>
struct Cfg<float> {
  static constexpr int kPad = 4;
};

template <typename T, int DH>
struct Layout {
  static constexpr int kLd = DH + Cfg<T>::kPad;            // q/k/v row stride
  static constexpr int kSw = (DH > kBK ? DH : kBK) + 4;    // scores / PV row stride
  static constexpr int kPl = kBK + 8;                      // bf16 P row stride
  static constexpr size_t kTile = static_cast<size_t>(kBQ) * kLd * sizeof(T);
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + ((kTile + 127) / 128) * 128;
  static constexpr size_t kV = kK + ((kTile + 127) / 128) * 128;
  static constexpr size_t kS = kV + ((kTile + 127) / 128) * 128;
  static constexpr size_t kP = kS + ((static_cast<size_t>(kBQ) * kSw * 4 + 127) / 128) * 128;
  static constexpr size_t kBytes =
      kP + (sizeof(T) == 2 ? static_cast<size_t>(kBQ) * kPl * 2 : 0);
};

// rows [t0, t0+64) of one (b, h) slice of a (B,T,H,Dh) tensor into a
// [64][kLd] shared tile, 16 bytes a thread at a time; rows past T are zero
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long stride_t, int t0, int T_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  constexpr int kLd = Layout<T, DH>::kLd;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T_len)
      val = *reinterpret_cast<const uint4*>(src + (t0 + r) * stride_t + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// S[16w.., 0..64) = Q K^T for this warp's 16 rows, f32, into s
template <int DH>
__device__ __forceinline__ void scores(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       float* s, int warp) {
  using L = Layout<__nv_bfloat16, DH>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, q + warp * 16 * L::kLd + kk * 16, L::kLd);
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      // K stored [key][d] row-major is K^T column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, k + n * 16 * L::kLd + kk * 16, L::kLd);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n)
    wmma::store_matrix_sync(s + warp * 16 * L::kSw + n * 16, acc[n], L::kSw,
                            wmma::mem_row_major);
}

template <int DH>
__device__ __forceinline__ void scores(const float* q, const float* k, float* s, int warp) {
  using L = Layout<float, DH>;
  const int lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, sub = lane % 2;
  float acc[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) acc[i] = 0.f;
  for (int d = 0; d < DH; ++d) {
    const float qv = q[row * L::kLd + d];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) acc[i] += qv * k[(2 * i + sub) * L::kLd + d];
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[row * L::kSw + 2 * i + sub] = acc[i];
}

template <typename T, int DH, bool FRONTIER>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                 long long sqb, long long sqt, long long sqh, long long skb, long long skt,
                 long long skh, long long svb, long long svt, long long svh, int causal,
                 float scale) {
  using L = Layout<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::kQ);
  T* ks = reinterpret_cast<T*>(smem + L::kK);
  T* vs = reinterpret_cast<T*>(smem + L::kV);
  float* ss = reinterpret_cast<float*>(smem + L::kS);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, sub = lane % 2;
  const int q_pos = q0 + row;

  load_tile<T, DH>(qs, q + b * sqb + h * sqh, sqt, q0, T_len);

  int n_k = (T_len + kBK - 1) / kBK;
  if (FRONTIER && causal) n_k = min(n_k, (q0 + kBQ + kBK - 1) / kBK);

  float m = kNegInf, l = 0.f, acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DH>(ks, k + b * skb + h * skh, skt, k0, T_len);
    load_tile<T, DH>(vs, v + b * svb + h * svh, svt, k0, T_len);
    __syncthreads();

    scores<DH>(qs, ks, ss, warp);
    __syncwarp();

    // running softmax over this tile: row `row`, columns sub, sub+2, ...
    float* srow = ss + row * L::kSw;
    float mx = m;
#pragma unroll 8
    for (int i = 0; i < kBK / 2; ++i) {
      const int c = 2 * i + sub, k_pos = k0 + c;
      float sv = srow[c] * scale;
      if (k_pos >= T_len || (causal && k_pos > q_pos)) sv = kNegInf;
      srow[c] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float corr = expf(m - mx);
    float psum = 0.f;
#pragma unroll 8
    for (int i = 0; i < kBK / 2; ++i) {
      const int c = 2 * i + sub;
      // keys past T weigh exactly 0; masked keys give exp(-1e30 - mx) == 0
      const float p = (k0 + c < T_len) ? expf(srow[c] - mx) : 0.f;
      psum += p;
      if constexpr (sizeof(T) == 2) {
        reinterpret_cast<__nv_bfloat16*>(smem + L::kP)[row * L::kPl + c] = __float2bfloat16(p);
      } else {
        srow[c] = p;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = mx;
    __syncwarp();

    // acc = acc * corr + P V for this warp's rows
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(smem + L::kP);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::fill_fragment(o, 0.f);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(a, ps + warp * 16 * L::kPl + kk * 16, L::kPl);
          wmma::load_matrix_sync(bf, vs + kk * 16 * L::kLd + n * 16, L::kLd);
          wmma::mma_sync(o, a, bf, o);
        }
        // the scores of this warp's rows are consumed: reuse them for P V
        wmma::store_matrix_sync(ss + warp * 16 * L::kSw + n * 16, o, L::kSw,
                                wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = acc[i] * corr + srow[2 * i + sub];
    } else {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= corr;
      for (int c = 0; c < kBK; ++c) {
        const float p = srow[c];
        const float* vrow = reinterpret_cast<const float*>(vs) + c * L::kLd;
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] += p * vrow[2 * i + sub];
      }
    }
    __syncwarp();
  }

  if (q_pos < T_len) {
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    T* orow = out + ((static_cast<long long>(b) * T_len + q_pos) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) orow[2 * i + sub] = from_f32<T>(acc[i] * inv);
    if (sub == 0) lse[static_cast<long long>(bh) * T_len + q_pos] = m + logf(l_safe);
  }
}

template <typename T, int DH, bool FRONTIER>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                   int H, int T_len, const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t kBytes = Layout<T, DH>::kBytes;
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, DH, FRONTIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBytes));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, DH, FRONTIER><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), H, T_len, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], causal, scale);
  return cudaGetLastError();
}

template <typename T, bool FRONTIER>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* out,
                        void* lse, int B, int H, int T_len, const long long* st, int causal,
                        float scale, cudaStream_t s) {
  switch (Dh) {
    case 32: return launch<T, 32, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
    case 64: return launch<T, 64, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
    case 128: return launch<T, 128, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_frontier(int frontier, int Dh, const void* q, const void* k,
                              const void* v, void* out, void* lse, int B, int H, int T_len,
                              const long long* st, int causal, float scale, cudaStream_t s) {
  if (frontier) return dispatch_dh<T, true>(Dh, q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
  return dispatch_dh<T, false>(Dh, q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
}

}  // namespace

DL4J_EXPORT_ERROR_STRING

// q, k, v (B,T,H,Dh) in `dtype` (kF32 or kBF16), each with its own
// (batch, time, head) element strides and a contiguous last dim, 16-byte
// aligned rows; out (B,T,H,Dh) contiguous in `dtype`; lse (B,H,T) f32.
// Dh in {32, 64, 128}.  frontier != 0 stops each query tile's key loop at
// the causal frontier (the fused kernel).  Returns cudaGetLastError()
// after the launch.
extern "C" int dl4j_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int B, int T_len, int H, int Dh,
                                    long long sqb, long long sqt, long long sqh, long long skb,
                                    long long skt, long long skh, long long svb,
                                    long long svt, long long svh, int causal, int frontier,
                                    float scale, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  const long long st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_frontier<float>(frontier, Dh, q, k, v, out, lse, B, H,
                                                       T_len, st, causal, scale, s));
    case kBF16:
      return static_cast<int>(dispatch_frontier<__nv_bfloat16>(
          frontier, Dh, q, k, v, out, lse, B, H, T_len, st, causal, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
