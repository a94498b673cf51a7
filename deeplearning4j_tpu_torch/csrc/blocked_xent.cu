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
// peak, against 0.1 GB of h and head (0.03 ms).  So bf16 runs on the tensor
// cores (wgmma, f32 accumulate); f32 inputs take f32 FMAs.
//
// Design: the Pallas grid (N/BT, V/BV) carries the running (max,
// denominator, gold) across its sequential vocabulary axis in revisited
// output blocks.  GPU blocks run in no order, so here one block owns 128
// tokens and loops over vocabulary tiles itself.  When the token tiles
// alone would leave SMs idle (small N), the vocabulary is split over
// blockIdx.y and a second kernel merges the splits' (m, l, gold) in a fixed
// order (deterministic, no atomics); with one split the merge is a pass over
// N rows.  Tail columns past the real V are masked by index (weight 0),
// rows past N load as zeros and are never written; the gold logit is added
// once, where the column equals the target.  Zero-weight rows give 0 loss
// (their lse is still written).
//
// bf16 (Hopper only): three warpgroups a block.  Two consumers own 64
// tokens each; one thread of the third (the producer, its registers given
// to the consumers by setmaxnreg) issues TMA loads into a ring of kStages
// stages, each guarded by a full and an empty mbarrier and holding a
// 64-deep chunk of 128 head columns and the same depth of the block's 128
// rows of h: every head byte read from L2 feeds 128 tokens.  L2 latency,
// not its bandwidth, bounds the loads, so the ring is deep (128 KB in
// flight) and h streams beside the head, re-read for every vocabulary tile:
// an h tile kept resident in shared memory (192 KB at D = 768) left room
// for two stages only and ran 1.4x slower on an H100.  The tied head
// (tok_embed, element (d, v) at v*sv + d) is the K-major B operand; a
// row-major (D, V) head is MN-major (the transpose flag), its rows 16-byte
// aligned (the wrapper pads a copy otherwise).  Each logit tile is a
// wgmma m64n128k16 accumulator in registers, one wgmma group kept in
// flight across depth chunks.  A finished tile is copied to
// a second register tile, and its epilogue runs in four parts, each while
// one of the next tile's first depth chunks is on the tensor cores: each
// thread keeps a running (max, sum of exp, gold) over its own columns, and
// the four threads of a row merge once, at the end.  No logit goes to
// shared memory.
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16

constexpr int kBT = 128;            // tokens a block
constexpr int kBV = 128;            // vocabulary columns a tile
constexpr int kKC = 64;             // depth a chunk (one 128-byte swizzled row)
constexpr int kChunk = kBT * kKC * 2;   // bytes of an h chunk or a head chunk: 16 KB
constexpr int kStages = 4;   // 128 KB in flight; six measured no faster
constexpr int kStageBytes = 2 * kChunk;   // a head chunk, then an h chunk
constexpr int kBars = kStages * kStageBytes;
constexpr int kBytes = kBars + 16 * kStages + 1024;   // barriers, alignment slack
constexpr int kConsumers = 256;
constexpr int kThreads = 384;

// Part Q of a finished logit tile's epilogue: its columns 32Q..32Q+31 of
// this thread's share (accumulator groups 4Q..4Q+3) update the thread's
// running max m, sum of exp l and gold logit of its two rows.  Columns past
// the real V are skipped; the gold logit is added where the column equals
// the target.
template <int Q>
__device__ __forceinline__ void epilogue_part(float (&sv)[kBV / 2], float (&m)[2], float (&l)[2],
                                              float (&gold)[2], const int (&tgt)[2], int v0,
                                              int V, int qd) {
  constexpr int kLo = 16 * Q, kHi = kLo + 16;
  const bool edge = v0 + 32 * (Q + 1) > V;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = kLo; i < kHi; ++i) {
    if (edge && v0 + 8 * (i / 4) + qd + (i % 2) >= V) sv[i] = kNegInf;
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sv[i]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] *= hopper::fast_exp2((m[half] - mx[half]) * kLog2e);
    m[half] = mx[half];
    const int rel = tgt[half] - v0;
    if (rel >= 32 * Q && rel < 32 * (Q + 1)) {
#pragma unroll
      for (int i = kLo; i < kHi; ++i)
        if ((i % 4) / 2 == half && 8 * (i / 4) + qd + (i % 2) == rel) gold[half] += sv[i];
    }
  }
#pragma unroll
  for (int i = kLo; i < kHi; ++i) {
    const int half = (i % 4) / 2;
    // masked columns add nothing
    if (sv[i] > kNegInf) l[half] += hopper::fast_exp2((sv[i] - m[half]) * kLog2e);
  }
}

__device__ __forceinline__ void epilogue(int q, float (&sv)[kBV / 2], float (&m)[2],
                                         float (&l)[2], float (&gold)[2], const int (&tgt)[2],
                                         int v0, int V, int qd) {
  switch (q) {
    case 0: epilogue_part<0>(sv, m, l, gold, tgt, v0, V, qd); break;
    case 1: epilogue_part<1>(sv, m, l, gold, tgt, v0, V, qd); break;
    case 2: epilogue_part<2>(sv, m, l, gold, tgt, v0, V, qd); break;
    default: epilogue_part<3>(sv, m, l, gold, tgt, v0, V, qd); break;
  }
}

template <int TRANS>
__global__ void __launch_bounds__(kThreads, 1)
xent_tiles_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap te,
                  const int* __restrict__ targets, float* __restrict__ part, int N, int V, int D,
                  int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);   // swizzle atoms
  const uint32_t full = base + kBars, empty = full + 8 * kStages;

  const int n0 = blockIdx.x * kBT, split = blockIdx.y;
  const int n_vt = (V + kBV - 1) / kBV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(n_vt, vt0 + tiles_per_split);
  const int n_dc = (D + kKC - 1) / kKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------ producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int vt = vt0; vt < vt1; ++vt) {
        for (int dc = 0; dc < n_dc; ++dc, ++it) {
          const int s = it % kStages;
          if (it >= kStages) hopper::mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
          const uint32_t st = base + s * kStageBytes, bar = full + 8 * s;
          hopper::mbar_expect_tx(bar, kStageBytes);
          if (TRANS) {   // (D, V) rows: two boxes of 64 columns x 64 depths
            hopper::tma_load_2d(st, &te, bar, vt * kBV, dc * kKC);
            hopper::tma_load_2d(st + kChunk / 2, &te, bar, vt * kBV + 64, dc * kKC);
          } else {       // (V, D) rows: one box of 64 depths x 128 columns
            hopper::tma_load_2d(st, &te, bar, dc * kKC, vt * kBV);
          }
          hopper::tma_load_2d(st + kChunk, &th, bar, dc * kKC, n0);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumers
    hopper::reg_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = n0 + 64 * wg + 16 * warp + lane / 4;   // rows row0, row0 + 8
    const int qd = 2 * (lane % 4);                          // column pair in each 8
    int tgt[2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      tgt[half] = row0 + 8 * half < N ? targets[row0 + 8 * half] : -1;

    float acc[kBV / 2], sv[kBV / 2];   // the tile in flight, the tile finished
#pragma unroll
    for (int i = 0; i < kBV / 2; ++i) acc[i] = sv[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};

    int it = 0;
    for (int vt = vt0; vt < vt1; ++vt) {
      const int v_done = (vt - 1) * kBV;   // the finished tile's first column
      int prev = -1;   // stage of the wgmma group still in flight
      for (int dc = 0; dc < n_dc; ++dc, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(full + 8 * s, (it / kStages) & 1);
        const uint32_t st = base + s * kStageBytes;
        const uint32_t ha = st + kChunk + wg * 64 * 128;   // this warpgroup's 64 rows
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) {
          const uint64_t da = hopper::make_desc(ha + kk * 32, 16, 1024, hopper::kSwizzle128);
          const uint64_t db =
              TRANS ? hopper::make_desc(st + kk * 16 * 128, kChunk / 2, 1024, hopper::kSwizzle128)
                    : hopper::make_desc(st + kk * 32, 16, 1024, hopper::kSwizzle128);
          hopper::wgmma_m64n128_ss<TRANS>(acc, da, db, dc > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();   // the previous chunk's group is done
        if (prev >= 0) hopper::mbar_arrive(empty + 8 * prev);
        prev = s;
        // the finished tile's epilogue, a part while each of the first
        // four chunks of this one is on the tensor cores
        if (vt > vt0 && dc < 4) epilogue(dc, sv, m, l, gold, tgt, v_done, V, qd);
      }
      if (vt > vt0)
        for (int q = n_dc; q < 4; ++q) epilogue(q, sv, m, l, gold, tgt, v_done, V, qd);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int i = 0; i < kBV / 2; ++i) sv[i] = acc[i];
    }
    if (vt1 > vt0)
      for (int q = 0; q < 4; ++q) epilogue(q, sv, m, l, gold, tgt, (vt1 - 1) * kBV, V, qd);

    // merge the quad's four column sets of each row, in a fixed order
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float M = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 1));
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
      float Lq = l[half] * hopper::fast_exp2((m[half] - M) * kLog2e);
      Lq += __shfl_xor_sync(0xffffffffu, Lq, 1);
      Lq += __shfl_xor_sync(0xffffffffu, Lq, 2);
      float G = gold[half] + __shfl_xor_sync(0xffffffffu, gold[half], 1);
      G += __shfl_xor_sync(0xffffffffu, G, 2);
      const int n = row0 + 8 * half;
      if (lane % 4 == 0 && n < N) {
        float* p = part + (static_cast<size_t>(split) * N + n) * 3;
        p[0] = M;
        p[1] = Lq;
        p[2] = G;
      }
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int kBT32 = 128;
constexpr int kBV32 = 128;
constexpr int kKC32 = 32;
constexpr int kThreads32 = 256;

struct Layout32 {
  static constexpr int kLd = kKC32 + 1;    // staged row stride
  static constexpr int kSw = kBV32 + 4;    // logit tile row stride
  static constexpr size_t kH = 0;
  static constexpr size_t kE = ((static_cast<size_t>(kBT32) * kLd * 4 + 127) / 128) * 128;
  static constexpr size_t kS = kE + ((static_cast<size_t>(kBV32) * kLd * 4 + 127) / 128) * 128;
  static constexpr size_t kBytes = kS + static_cast<size_t>(kBT32) * kSw * 4;
};

// rows [r0, r0+R) x depth [d0, d0+kKC32) of a matrix whose element (r, d)
// is src[r*rs + d*ds] into dst[R][kLd]; rows >= nr and depths >= D are zero
template <int R>
__device__ __forceinline__ void load_chunk(float* __restrict__ dst, const float* __restrict__ src,
                                           long long rs, long long ds, int r0, int nr, int d0,
                                           int D) {
  constexpr int kLd = Layout32::kLd;
  if (ds == 1) {  // neighbouring threads on neighbouring depths
    for (int i = threadIdx.x; i < R * kKC32; i += kThreads32) {
      const int r = i / kKC32, c = i % kKC32;
      float val = 0.f;
      if (r0 + r < nr && d0 + c < D) val = src[(r0 + r) * rs + d0 + c];
      dst[r * kLd + c] = val;
    }
  } else {        // neighbouring threads on neighbouring rows
    for (int i = threadIdx.x; i < R * kKC32; i += kThreads32) {
      const int c = i / R, r = i % R;
      float val = 0.f;
      if (r0 + r < nr && d0 + c < D) val = src[(r0 + r) * rs + (d0 + c) * ds];
      dst[r * kLd + c] = val;
    }
  }
}

// the logit tile S[kBT32][kBV32] = h_tile @ head[:, v0:v0+kBV32] into shared memory
__device__ __forceinline__ void logit_tile(const float* __restrict__ h,
                                           const float* __restrict__ e, int n0, int N, int v0,
                                           int V, int D, long long sd, long long sv,
                                           unsigned char* smem) {
  using L = Layout32;
  float* hs = reinterpret_cast<float*>(smem + L::kH);
  float* es = reinterpret_cast<float*>(smem + L::kE);
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  const int row = threadIdx.x / 2, sub = threadIdx.x % 2;
  float acc[kBV32 / 2];
#pragma unroll
  for (int i = 0; i < kBV32 / 2; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kKC32) {
    __syncthreads();
    load_chunk<kBT32>(hs, h, D, 1, n0, N, d0, D);
    // column v of head, as a row: element (v, d) at v*sv + d*sd
    load_chunk<kBV32>(es, e, sv, sd, v0, V, d0, D);
    __syncthreads();
    for (int d = 0; d < kKC32; ++d) {
      const float hv = hs[row * L::kLd + d];
#pragma unroll
      for (int i = 0; i < kBV32 / 2; ++i) acc[i] += hv * es[(2 * i + sub) * L::kLd + d];
    }
  }
#pragma unroll
  for (int i = 0; i < kBV32 / 2; ++i) ss[row * L::kSw + 2 * i + sub] = acc[i];
}

__global__ void __launch_bounds__(kThreads32)
xent_tiles_f32_kernel(const float* __restrict__ h, const float* __restrict__ e,
                      const int* __restrict__ targets, float* __restrict__ part, int N, int V,
                      int D, long long sd, long long sv, int tiles_per_split) {
  using L = Layout32;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* ss = reinterpret_cast<const float*>(smem + L::kS);
  const int n0 = blockIdx.x * kBT32, split = blockIdx.y;
  const int n_vt = (V + kBV32 - 1) / kBV32;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(n_vt, vt0 + tiles_per_split);
  const int row = threadIdx.x / 2, sub = threadIdx.x % 2;
  const int n = n0 + row;
  const int tgt = n < N ? targets[n] : -1;

  float m = kNegInf, l = 0.f, gold = 0.f;
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV32;
    logit_tile(h, e, n0, N, v0, V, D, sd, sv, smem);
    __syncthreads();
    const float* srow = ss + row * L::kSw;
    float mx = kNegInf;
#pragma unroll 8
    for (int i = 0; i < kBV32 / 2; ++i) {
      const int c = 2 * i + sub;
      if (v0 + c < V) mx = fmaxf(mx, srow[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float ps = 0.f;
#pragma unroll 8
    for (int i = 0; i < kBV32 / 2; ++i) {
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

// ---------------------------------------------------------------- merge

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

template <int TRANS>
cudaError_t launch_tiles_bf16(const void* h, const void* head, const void* targets, void* part,
                              int N, int V, int D, long long sd, long long sv, int tps,
                              int n_splits, cudaStream_t stream) {
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(xent_tiles_kernel<TRANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // host-side only, so a CUDA graph capture records the maps by value
  CUtensorMap th, te;
  {
    const uint64_t dims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N)};
    const uint64_t strides[1] = {static_cast<uint64_t>(D) * 2};
    const uint32_t box[2] = {kKC, kBT};
    if (!hopper::encode_bf16(&th, h, 2, dims, strides, box, 128)) return cudaErrorInvalidValue;
  }
  if (TRANS) {   // element (d, v) at d*sd + v
    const uint64_t dims[2] = {static_cast<uint64_t>(V), static_cast<uint64_t>(D)};
    const uint64_t strides[1] = {static_cast<uint64_t>(sd) * 2};
    const uint32_t box[2] = {64, kKC};
    if (!hopper::encode_bf16(&te, head, 2, dims, strides, box, 128)) return cudaErrorInvalidValue;
  } else {       // element (d, v) at v*sv + d
    const uint64_t dims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(V)};
    const uint64_t strides[1] = {static_cast<uint64_t>(sv) * 2};
    const uint32_t box[2] = {kKC, kBV};
    if (!hopper::encode_bf16(&te, head, 2, dims, strides, box, 128)) return cudaErrorInvalidValue;
  }
  dim3 grid((N + kBT - 1) / kBT, n_splits);
  xent_tiles_kernel<TRANS><<<grid, kThreads, kBytes, stream>>>(
      th, te, static_cast<const int*>(targets), static_cast<float*>(part), N, V, D, tps);
  return cudaGetLastError();
}

cudaError_t launch_tiles_f32(const void* h, const void* head, const void* targets, void* part,
                             int N, int V, int D, long long sd, long long sv, int tps,
                             int n_splits, cudaStream_t stream) {
  constexpr size_t kBytes = Layout32::kBytes;
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(xent_tiles_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBytes));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((N + kBT32 - 1) / kBT32, n_splits);
  xent_tiles_f32_kernel<<<grid, kThreads32, kBytes, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(head),
      static_cast<const int*>(targets), static_cast<float*>(part), N, V, D, sd, sv, tps);
  return cudaGetLastError();
}

}  // namespace

DL4J_EXPORT_ERROR_STRING

// h (N,D) contiguous in `dtype` (kF32 or kBF16); head (D,V) in `dtype` with
// element (d, v) at d*sd + v*sv; targets (N,) int32; weights (N,) f32;
// wloss, lse (N,) f32; part (n_splits, N, 3) f32 scratch; n_splits <= the
// vocabulary tiles of 128.  bf16 takes TMA maps of h and head: 16-byte
// aligned bases, D % 8 == 0, and e_kmajor != 0 with sd == 1 and sv % 8 == 0
// (the tied head) or e_kmajor == 0 with sv == 1 and sd % 8 == 0 (a
// row-major head).  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a layout the bf16 path does not take).
extern "C" int dl4j_blocked_xent(const void* h, const void* head, const void* targets,
                                 const void* weights, void* wloss, void* lse, void* part,
                                 int N, int V, int D, long long sd, long long sv, int e_kmajor,
                                 int n_splits, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (V <= 0 || D <= 0 || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_vt = (V + kBV - 1) / kBV;
  const int tps = (n_vt + n_splits - 1) / n_splits;
  cudaError_t e;
  if (dtype == kBF16) {
    if ((e_kmajor ? (sd != 1 || sv % 8) : (sv != 1 || sd % 8)) || D % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    e = e_kmajor ? launch_tiles_bf16<0>(h, head, targets, part, N, V, D, sd, sv, tps, n_splits, s)
                 : launch_tiles_bf16<1>(h, head, targets, part, N, V, D, sd, sv, tps, n_splits, s);
  } else if (dtype == kF32) {
    e = launch_tiles_f32(h, head, targets, part, N, V, D, sd, sv, tps, n_splits, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  xent_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(weights),
      static_cast<float*>(wloss), static_cast<float*>(lse), N, n_splits);
  return static_cast<int>(cudaGetLastError());
}
