// Flash attention forward: out and the row log-sum-exp.
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
// bf16 design (flash-v3 shape, Hopper only): the TPU grid (B*H, T/128)
// runs in order with each program's key loop inside it; GPU blocks run in
// no order, but query tiles are independent, so the grid is (query tiles
// of 128 rows, B*H).  A block has three warpgroups: two consumers own 64
// query rows each, and one thread of the third (the producer, its
// registers given to the consumers by setmaxnreg) issues TMA loads: the Q
// tile once, then 128-key K and V tiles into a ring of three stages (two
// at Dh=128) in shared memory, each guarded by a full and an empty
// mbarrier.  q, k and v are the (B,T,H,Dh) views of the packed projection,
// mapped as 4-D tensors (Dh, H, T, B) with their byte strides, so nothing
// is copied; rows past T load as zeros.  Tiles are 128-byte swizzled
// (64-byte at Dh=32; Dh=128 is two 64-column halves).  Per tile j and
// consumer warpgroup:
//   S_j = Q K_j^T by wgmma m64n128k16 from shared memory, f32 in
//   registers, issued together with O += P_{j-1} V_{j-1} (wgmma m64nDh k16,
//   P_{j-1} in registers as the A operand, V MN-major from shared memory);
//   the online softmax of S_j runs while P V is in flight: the mask only on
//   tiles that straddle the diagonal or T, the row max over the four
//   threads of a quad, the scale and log2(e) folded into one FMA before
//   exp2, P_j rounded to bf16 in registers; then O (in registers) is
//   rescaled once P V is done.
// P is rounded to bf16 for P V, as flash attention on GPUs does (the
// Pallas kernel keeps p in f32: the cost is stated beside the check in
// chip_smoke.py), and the output is rounded once.
//
// f32 (off the main path, for the f32 checks): the grid is (query tiles of
// 64, B*H), each block walks 64-key tiles through shared memory with f32
// FMAs; thread 2r+s of warp w owns row 16w+r and the columns s, s+2, ...
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16

constexpr int kBQ = 128;        // query rows a block: two consumer warpgroups
constexpr int kBK = 128;        // keys a tile
constexpr int kConsumers = 256;
constexpr int kThreads = 384;   // two consumer warpgroups + the producer's

template <int DH>
struct Tiles {
  static constexpr int kSwz = DH == 32 ? 64 : 128;   // bytes a row of a sub-tile
  static constexpr int kCols = kSwz / 2;              // columns a sub-tile
  static constexpr int kSub = DH / kCols;             // sub-tiles across Dh
  static constexpr int kSubBytes = 128 * kSwz;        // one sub-tile of 128 rows
  static constexpr int kTile = kSub * kSubBytes;      // a Q, K or V tile
  // K/V ring depth: a consumer holds two stages (V of tile j-1, K/V of
  // tile j), so a third lets the producer load tile j+1 meanwhile; at
  // Dh=128 three stages do not fit beside Q
  static constexpr int kStages = DH == 128 ? 2 : 3;
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + kTile;              // stage s: K, then V
  static constexpr int kBars = kKV + kStages * 2 * kTile;
  static constexpr int kBytes = kBars + 64 + 1024;    // barriers, alignment slack
  static constexpr int kLayout = DH == 32 ? hopper::kSwizzle64 : hopper::kSwizzle128;
};

// S = Q K^T for this warpgroup's 64 rows: both K-major, the k16 step
// 32 bytes along a row (the next sub-tile past 64 columns)
template <int DH>
__device__ __forceinline__ void issue_s(float (&sacc)[kBK / 2], uint32_t qa, uint32_t ka) {
  using L = Tiles<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk * 16 / L::kCols) * L::kSubBytes + (kk * 16 % L::kCols) * 2;
    hopper::wgmma_m64n128_ss<0>(sacc, hopper::make_desc(qa + off, 16, 8 * L::kSwz, L::kLayout),
                                hopper::make_desc(ka + off, 16, 8 * L::kSwz, L::kLayout),
                                kk > 0);
  }
}

// O += P V: P from registers, V MN-major (16 key rows a k16 step)
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], uint32_t (&pa)[kBK / 16][4],
                                         uint32_t va) {
  using L = Tiles<DH>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    hopper::wgmma_rs<DH, 1>(
        o, pa[kk],
        hopper::make_desc(va + kk * 16 * L::kSwz, L::kSubBytes, 8 * L::kSwz, L::kLayout), 1);
}

template <int R>
__device__ __forceinline__ void fence_p(uint32_t (&pa)[R][4]) {
#pragma unroll
  for (int kk = 0; kk < R; ++kk) hopper::fence_regs(pa[kk]);
}

// the online softmax of one S tile in registers: row max over the quad,
// m (log2 units) and this thread's share of l updated, corr = the factor
// O must be scaled by, P rounded to bf16 as the A operand of P V.  The
// mask runs only where the tile straddles T or the warpgroup's diagonal;
// masked scores give exp2(-1e30 * c - m) == 0, so keys past T weigh 0.
__device__ __forceinline__ void softmax_tile(float (&sacc)[kBK / 2], uint32_t (&pa)[kBK / 16][4],
                                             float (&m)[2], float (&l)[2], float (&corr)[2],
                                             bool edge, int k0, int T_len, int causal, int row0,
                                             int qd, float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int half = (i % 4) / 2;
    if (edge) {
      const int k_pos = k0 + 8 * (i / 4) + qd + (i % 2);
      if (k_pos >= T_len || (causal && k_pos > row0 + 8 * half)) sacc[i] = kNegInf;
    }
    mx[half] = fmaxf(mx[half], sacc[i]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    const float m_new = fmaxf(m[half], mx[half] * scale_log2);   // the scale is positive
    corr[half] = hopper::fast_exp2(m[half] - m_new);
    m[half] = m_new;
    l[half] *= corr[half];
  }
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r, half = r % 2;
      const float p0 = hopper::fast_exp2(fmaf(sacc[i], scale_log2, -m[half]));
      const float p1 = hopper::fast_exp2(fmaf(sacc[i + 1], scale_log2, -m[half]));
      l[half] += p0 + p1;
      pa[kk][r] = hopper::pack_bf16(p0, p1);
    }
  }
}

template <int DH, bool FRONTIER>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int H, int T_len, int causal, float scale_log2) {
  using L = Tiles<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);   // swizzle atoms
  const uint32_t full = base + L::kBars, empty = full + 8 * L::kStages;
  const uint32_t qbar = empty + 8 * L::kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  int n_k = (T_len + kBK - 1) / kBK;
  if (FRONTIER && causal) n_k = min(n_k, (q0 + kBQ + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------ producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(qbar, L::kTile);
      for (int c = 0; c < L::kSub; ++c)
        hopper::tma_load_4d(base + L::kQ + c * L::kSubBytes, &tq, qbar, c * L::kCols, h, q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % L::kStages;
        if (j >= L::kStages) hopper::mbar_wait(empty + 8 * s, ((j / L::kStages) - 1) & 1);
        hopper::mbar_expect_tx(full + 8 * s, 2 * L::kTile);
        const uint32_t ka = base + L::kKV + s * 2 * L::kTile, va = ka + L::kTile;
        for (int c = 0; c < L::kSub; ++c) {
          hopper::tma_load_4d(ka + c * L::kSubBytes, &tk, full + 8 * s, c * L::kCols, h,
                              j * kBK, b);
          hopper::tma_load_4d(va + c * L::kSubBytes, &tv, full + 8 * s, c * L::kCols, h,
                              j * kBK, b);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumers
    hopper::reg_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;   // this thread's rows: row0, row0 + 8
    const int qd = 2 * (lane % 4);                          // its column pair in each 8
    const uint32_t qa = base + L::kQ + wg * 64 * L::kSwz;   // the warpgroup's 64 Q rows

    float o[DH / 2], sacc[kBK / 2], corr[2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    uint32_t pa[kBK / 16][4];

    // tile 0: S, then its softmax
    hopper::mbar_wait(qbar, 0);
    hopper::mbar_wait(full, 0);
    hopper::fence_regs(sacc);
    hopper::wgmma_fence();
    issue_s<DH>(sacc, qa, base + L::kKV);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    softmax_tile(sacc, pa, m, l, corr, kBK > T_len || (causal && kBK - 1 > q0 + 64 * wg), 0,
                 T_len, causal, row0, qd, scale_log2);

    // tile j: S_j and P_{j-1} V_{j-1} in flight together; the softmax of
    // S_j runs while P V does, then O is rescaled
    int prev = 0;   // the stage of tile j-1
    for (int j = 1; j < n_k; ++j) {
      const int s = j % L::kStages;
      hopper::mbar_wait(full + 8 * s, (j / L::kStages) & 1);
      const uint32_t ka = base + L::kKV + s * 2 * L::kTile;
      const uint32_t va_prev = base + L::kKV + prev * 2 * L::kTile + L::kTile;
      hopper::fence_regs(sacc);
      hopper::fence_regs(o);
      fence_p(pa);
      hopper::wgmma_fence();
      issue_s<DH>(sacc, qa, ka);
      hopper::wgmma_commit();
      issue_pv<DH>(o, pa, va_prev);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // S_j is done
      hopper::fence_regs(sacc);
      const int k0 = j * kBK;
      const bool edge = k0 + kBK > T_len || (causal && k0 + kBK - 1 > q0 + 64 * wg);
      uint32_t pb[kBK / 16][4];
      softmax_tile(sacc, pb, m, l, corr, edge, k0, T_len, causal, row0, qd, scale_log2);
      hopper::wgmma_wait<0>();   // P_{j-1} V_{j-1} is done
      hopper::fence_regs(o);
      fence_p(pa);
      hopper::mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i % 4) / 2];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pb[kk][r];
      prev = s;
    }
    hopper::fence_regs(o);
    fence_p(pa);
    hopper::wgmma_fence();
    issue_pv<DH>(o, pa, base + L::kKV + prev * 2 * L::kTile + L::kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    fence_p(pa);
    hopper::mbar_arrive(empty + 8 * prev);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
      const int q_pos = row0 + 8 * half;
      if (q_pos >= T_len) continue;
      const float l_safe = fmaxf(l[half], 1e-30f);
      const float inv = 1.f / l_safe;
      __nv_bfloat16* orow = out + ((static_cast<long long>(b) * T_len + q_pos) * H + h) * DH;
#pragma unroll
      for (int g = 0; g < DH / 8; ++g)
        *reinterpret_cast<uint32_t*>(orow + 8 * g + qd) =
            hopper::pack_bf16(o[4 * g + 2 * half] * inv, o[4 * g + 2 * half + 1] * inv);
      if (lane % 4 == 0)
        lse[static_cast<long long>(bh) * T_len + q_pos] = m[half] * kLn2 + logf(l_safe);
    }
  }
}

template <int DH, bool FRONTIER>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                        int H, int T_len, const long long* st, int causal, float scale,
                        cudaStream_t stream) {
  using L = Tiles<DH>;
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DH, FRONTIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // (Dh, H, T, B) views with byte strides; host-side only, so a CUDA graph
  // capture records the maps by value
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {static_cast<uint64_t>(DH), static_cast<uint64_t>(H),
                              static_cast<uint64_t>(T_len), static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(st[3 * i + 2]) * 2,
                                 static_cast<uint64_t>(st[3 * i + 1]) * 2,
                                 static_cast<uint64_t>(st[3 * i]) * 2};
    const uint32_t box[4] = {L::kCols, 1, kBK, 1};
    if (!hopper::encode_bf16(&maps[i], ptrs[i], 4, dims, strides, box, L::kSwz))
      return cudaErrorInvalidValue;
  }
  dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<DH, FRONTIER><<<grid, kThreads, L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H,
      T_len, causal, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32

constexpr int kBQ32 = 64;
constexpr int kBK32 = 64;
constexpr int kThreads32 = 128;

template <int DH>
struct Layout32 {
  static constexpr int kLd = DH + 4;                          // q/k/v row stride
  static constexpr int kSw = (DH > kBK32 ? DH : kBK32) + 4;   // scores row stride
  static constexpr size_t kTile = static_cast<size_t>(kBQ32) * kLd * 4;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + ((kTile + 127) / 128) * 128;
  static constexpr size_t kV = kK + ((kTile + 127) / 128) * 128;
  static constexpr size_t kS = kV + ((kTile + 127) / 128) * 128;
  static constexpr size_t kBytes = kS + static_cast<size_t>(kBQ32) * kSw * 4;
};

// rows [t0, t0+64) of one (b, h) slice of a (B,T,H,Dh) tensor into a
// [64][kLd] shared tile, 16 bytes a thread at a time; rows past T are zero
template <int DH>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          long long stride_t, int t0, int T_len) {
  constexpr int kPerRow = DH / 4;
  constexpr int kLd = Layout32<DH>::kLd;
  for (int i = threadIdx.x; i < kBQ32 * kPerRow; i += kThreads32) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T_len) val = *reinterpret_cast<const uint4*>(src + (t0 + r) * stride_t + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <int DH, bool FRONTIER>
__global__ void __launch_bounds__(kThreads32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int T_len, long long sqb, long long sqt,
                     long long sqh, long long skb, long long skt, long long skh, long long svb,
                     long long svt, long long svh, int causal, float scale) {
  using L = Layout32<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
  float* ss = reinterpret_cast<float*>(smem + L::kS);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, sub = lane % 2;
  const int q_pos = q0 + row;

  load_tile<DH>(qs, q + b * sqb + h * sqh, sqt, q0, T_len);

  int n_k = (T_len + kBK32 - 1) / kBK32;
  if (FRONTIER && causal) n_k = min(n_k, (q0 + kBQ32 + kBK32 - 1) / kBK32);

  float m = kNegInf, l = 0.f, acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  float* srow = ss + row * L::kSw;
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kBK32;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DH>(ks, k + b * skb + h * skh, skt, k0, T_len);
    load_tile<DH>(vs, v + b * svb + h * svh, svt, k0, T_len);
    __syncthreads();

    // S for row `row`, columns sub, sub+2, ...
    float sc[kBK32 / 2];
#pragma unroll
    for (int i = 0; i < kBK32 / 2; ++i) sc[i] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qv = qs[row * L::kLd + d];
#pragma unroll
      for (int i = 0; i < kBK32 / 2; ++i) sc[i] += qv * ks[(2 * i + sub) * L::kLd + d];
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < kBK32 / 2; ++i) {
      const int c = 2 * i + sub, k_pos = k0 + c;
      float sv = sc[i] * scale;
      if (k_pos >= T_len || (causal && k_pos > q_pos)) sv = kNegInf;
      sc[i] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float corr = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK32 / 2; ++i) {
      const int c = 2 * i + sub;
      // keys past T weigh exactly 0; masked keys give exp(-1e30 - mx) == 0
      const float p = (k0 + c < T_len) ? expf(sc[i] - mx) : 0.f;
      psum += p;
      srow[c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = mx;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= corr;
    for (int c = 0; c < kBK32; ++c) {
      const float p = srow[c];
      const float* vrow = vs + c * L::kLd;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] += p * vrow[2 * i + sub];
    }
    __syncwarp();
  }

  if (q_pos < T_len) {
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    float* orow = out + ((static_cast<long long>(b) * T_len + q_pos) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) orow[2 * i + sub] = acc[i] * inv;
    if (sub == 0) lse[static_cast<long long>(bh) * T_len + q_pos] = m + logf(l_safe);
  }
}

template <int DH, bool FRONTIER>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                       int H, int T_len, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t kBytes = Layout32<DH>::kBytes;
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel<DH, FRONTIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBytes));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((T_len + kBQ32 - 1) / kBQ32, B * H);
  flash_fwd_f32_kernel<DH, FRONTIER><<<grid, kThreads32, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), H, T_len, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], causal, scale);
  return cudaGetLastError();
}

template <bool FRONTIER>
cudaError_t dispatch(int dtype, int Dh, const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int H, int T_len, const long long* st, int causal,
                     float scale, cudaStream_t s) {
  if (dtype == kBF16) {
    switch (Dh) {
      case 32: return launch_bf16<32, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
      case 64: return launch_bf16<64, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
      case 128: return launch_bf16<128, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kF32) {
    switch (Dh) {
      case 32: return launch_f32<32, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
      case 64: return launch_f32<64, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
      case 128: return launch_f32<128, FRONTIER>(q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

DL4J_EXPORT_ERROR_STRING

// q, k, v (B,T,H,Dh) in `dtype` (kF32 or kBF16), each with its own
// (batch, time, head) element strides and a contiguous last dim, 16-byte
// aligned rows (bf16: the strides and base are the TMA maps' and must be
// multiples of 16 bytes); out (B,T,H,Dh) contiguous in `dtype`; lse (B,H,T)
// f32.  Dh in {32, 64, 128}.  frontier != 0 stops each query tile's key
// loop at the causal frontier (the fused kernel).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when a tensor
// map cannot be encoded).
extern "C" int dl4j_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int B, int T_len, int H, int Dh,
                                    long long sqb, long long sqt, long long sqh, long long skb,
                                    long long skt, long long skh, long long svb,
                                    long long svt, long long svh, int causal, int frontier,
                                    float scale, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  const long long st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      frontier ? dispatch<true>(dtype, Dh, q, k, v, out, lse, B, H, T_len, st, causal, scale, s)
               : dispatch<false>(dtype, Dh, q, k, v, out, lse, B, H, T_len, st, causal, scale, s);
  return static_cast<int>(e);
}
