// Weight-only int8 matmul for the decode path: out (M,N) f32 =
// (x (M,K) @ q (K,N) int8) * scale (N,).
//
// Replaces deeplearning4j_tpu/ops/pallas/matmul_int8.py::int8_matmul
// (_int8_call, the pl.pallas_call at matmul_int8.py:86).
//
// What bounds it: M is 1 in prefill (token by token) and the slot count
// (8) in a decode step, so a weight byte carries 2 M operations, far
// below the card's ~295 operations a byte: the int8 weight bytes, K N of
// them, bound it (2.4 MB for the flagship's FFN matrices, 0.7 us at 3.35
// TB/s; 25.2 MB for its 768 x 32768 LM head).  At the FFN's size a call
// is a chain of latencies instead: the launch, one round trip to device
// memory for the weights and x, the reductions and the merge of a split
// K (on an H100, ~1 us of launch, ~2.8 us until a block's weights are
// in, ~0.8 us of reductions and ~0.6 us more for a cluster merge;
// PERF.md, int8_probe.py --timeline).  So the design keeps that chain
// short: one launch, a block's loads in flight from its first
// instructions, and no round trip through global memory.
//
// Design (the launch plan comes from ops/cuda/matmul_int8.py::_plan):
// - One launch for every shape.  A block owns block_n output columns of
//   row_tile (MT) rows of x and one chunk of K.  Where the column tiles
//   alone give too few blocks, K is split over the blocks of a
//   thread-block cluster (grid.x = cluster size, at most 8): each block
//   reduces its partial tile in its own shared memory and writes slice r
//   of it into rank r's shared memory (map_shared_rank); after one
//   cluster.sync() rank r sums its slices in rank order, scales and
//   stores.  Nothing goes through global memory; the sum's order is
//   fixed, so two runs agree bitwise.  A cluster of one is a plain launch
//   (on an H100 the cluster launch attribute alone cost ~1 us for an
//   empty 512-block grid).  A chunk larger than one x tile (kTileFloats /
//   MT rows of K) loops over tiles inside the block.
// - Fewer, fuller blocks: the plan aims at about two thirds of a block a
//   SM, since each block pays the chain once (at one row of x, without a
//   cluster where narrow column tiles reach that).
// - Wide loads, in flight early.  A thread owns VEC neighbouring columns
//   (16 at MT = 1, 8 above, which keeps MT x VEC accumulators in
//   registers) and loads them as one 16- or 8-byte ld.global.nc per
//   K-row.  The block's 256 threads are 256 / TPR row groups of TPR =
//   block_n / VEC threads; a row group walks every (256 / TPR)-th K-row of
//   the chunk, kUnroll rows at a time, with the next kUnroll rows' loads
//   issued before the current ones are used (register double buffer).
//   The first loads go out before x is staged, so the round trips for x
//   and for the weights overlap.  Each weight byte is read once, so the
//   loads skip L1 (L1::no_allocate).  Rows whose length N is not a
//   multiple of VEC (or a q not aligned to VEC bytes) take byte loads
//   instead; the ragged N edge is masked.
// - x laid out for broadcast.  The block stages its chunk of x once into
//   shared memory as f32, transposed to [k][m], so one ld.shared.v4 gives
//   four rows of one k; 16-byte loads, all in flight at once, where the
//   rows are aligned.
// - Exact int8 -> f32 by byte permute: a weight byte b (xor 0x80, so
//   b + 128) is placed under the exponent of 2^23 (prmt) and 2^23 + 128
//   subtracted: an integer and a float instruction per weight in place of
//   a conversion (I2F), which runs at a quarter of the float rate.
//   Products are accumulated in f32; the scale is applied once, in the
//   epilogue, from registers loaded at the start.
// - Reduction: the row groups of a warp by xor shuffles that halve the
//   values a lane holds at each step (about MT x VEC shuffles a lane in
//   all, not MT x VEC a step), the block's 8 warps in shared memory in
//   warp order, then the cluster's ranks.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTpr = 8;        // threads across a row: block_n <= 8 VEC
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kUnroll = 4;        // K-rows a thread loads per batch
constexpr int kTileFloats = 4096; // x staged per tile: kTileFloats / MT rows

template <int VEC> struct Words;
template <> struct Words<16> { using type = uint4; };
template <> struct Words<8> { using type = uint2; };

// 16- / 8-byte weight loads through the read-only path without an L1
// line; volatile with a memory clobber, so they stay ahead of x's staging
__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint2 load_nc(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p) : "memory");
  return v;
}

// VEC weights of K-row k at columns n0.. as VEC / 4 little-endian words;
// zero past the chunk end or the N edge.
template <int VEC, bool kAligned>
__device__ __forceinline__ typename Words<VEC>::type load_row(
    const int8_t* __restrict__ q, int k, int k_end, int n0, int N) {
  using W = typename Words<VEC>::type;
  W w;
  uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j) wp[j] = 0u;
  if (k >= k_end || n0 >= N) return w;
  const int8_t* p = q + static_cast<size_t>(k) * N + n0;
  if constexpr (kAligned) {
    return load_nc(reinterpret_cast<const W*>(p));
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (n0 + c < N)
        wp[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + c)))
                     << (8 * (c % 4));
    return w;
  }
}

// acc[m][c] += xv[m] * (int8) byte c of w, the byte made f32 exactly by
// prmt under 2^23 and one subtraction
template <int MT, int VEC, typename W>
__device__ __forceinline__ void fma_row(float (&acc)[MT][VEC], const W& w,
                                        const float (&xv)[MT]) {
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j) {
    const uint32_t biased = wp[j] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float f = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                                  0x7440u + b)) - 8388736.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m][4 * j + b] = fmaf(xv[m], f, acc[m][4 * j + b]);
    }
  }
}

// Step S of the warp's reduction over its row groups (lanes 16 >> S
// apart, while that is at least tpr): of the V >> S values a lane holds,
// the lane with that bit set keeps the upper half and its partner the
// lower, each adding the other's copy; `base` tracks the original index
// of a[0].  A fixed order, so the sum is deterministic.
template <int V, int S>
__device__ __forceinline__ void halve(float (&a)[V], int lane, int tpr,
                                      int& base) {
  if constexpr (S < 5 && (V >> (S + 1)) > 0) {
    constexpr int off = 16 >> S;
    constexpr int half = V >> (S + 1);
    if (off >= tpr) {
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? a[i] : a[i + half];
        const float keep = upper ? a[i + half] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (upper) base += half;
      halve<V, S + 1>(a, lane, tpr, base);
    }
  }
}

// x rows m0 .. m0 + MT of columns [k0, k0 + kt) into xs[kk * MT + m] as
// f32, zero past M.  Where the rows allow it, one 16-byte load per E =
// 16 / sizeof(T) elements, all of a thread's loads issued before any is
// stored: every block reads the same x, and element loads cost one L2
// request each and a round trip per unrolled batch.
template <typename T, int MT>
__device__ __forceinline__ void stage_x(float* xs, const T* __restrict__ x,
                                        int M, int K, int m0, int k0, int kt,
                                        int tid) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kLoads = kTileFloats / E / kThreads;  // a thread's, at most
  static_assert(kLoads >= 1 && (kTileFloats / MT) % E == 0, "x tile");
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % E == 0 &&
      k0 % E == 0) {
    const int nv = (kt + E - 1) / E;     // vectors a row; m varies fastest
    uint4 v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads, m = i % MT, kv = i / MT;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (kv < nv && m0 + m < M)
        v[j] = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m0 + m) * K + k0) + kv);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads, m = i % MT, kv = i / MT;
      const T* t = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (kv < nv && kv * E + e < kt)
          xs[(kv * E + e) * MT + m] = to_f32(t[e]);
    }
  } else {
    for (int i = tid; i < MT * kt; i += kThreads) {
      const int m = i / kt, kk = i - m * kt;
      xs[kk * MT + m] = m0 + m < M
          ? to_f32(x[static_cast<size_t>(m0 + m) * K + k0 + kk]) : 0.f;
    }
  }
}

template <int MT>
__device__ __forceinline__ void load_x(const float* xs, float (&xv)[MT]) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int m = 0; m < MT; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xs + m);
      xv[m] = v.x; xv[m + 1] = v.y; xv[m + 2] = v.z; xv[m + 3] = v.w;
    }
  } else {
    xv[0] = xs[0];
  }
}

template <typename T, int MT, int VEC, bool kAligned>
__global__ void __launch_bounds__(kThreads)
int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int M, int K, int N, int block_n, int k_chunk) {
  using W = typename Words<VEC>::type;
  constexpr int kTileK = kTileFloats / MT;
  __shared__ __align__(16) float xs[kTileFloats];
  constexpr int kMaxTile = MT * VEC * kMaxTpr;   // outputs a block owns
  static_assert(kMaxTile <= 2 * kThreads, "two outputs a thread at most");
  __shared__ __align__(16) float red[kWarps * kMaxTile];
  __shared__ float inbox[kMaxTile + kMaxCluster];  // [rank][slice]

  cg::cluster_group cluster = cg::this_cluster();
  // a rank writes another's shared memory only once all have started:
  // arrive now, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int tpr = block_n / VEC;
  const int groups = kThreads / tpr;        // K-rows in flight per batch
  const int cq = tid % tpr;
  const int rg = tid / tpr;
  const int n0 = blockIdx.y * block_n + cq * VEC;
  const int m0 = blockIdx.z * MT;
  const int k_begin = rank * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  // this rank stores slice `rank` of the block's tile (tile / ranks
  // outputs, at most two a thread): its scales are loaded now, beside the
  // weights, and not after the merge
  const int tile = MT * block_n;
  const int per = (tile + ranks - 1) / ranks;
  float sc[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = tid + u * kThreads, i = rank * per + j;
    const int n = blockIdx.y * block_n + i % block_n;
    sc[u] = j < per && i < tile && n < N ? __ldg(scale + n) : 0.f;
  }

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int k1 = min(k_end, k0 + kTileK);
    const int kt = k1 - k0;
    W cur[kUnroll], nxt[kUnroll];
    int k = k0 + rg;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      cur[u] = load_row<VEC, kAligned>(q, k + u * groups, k1, n0, N);
    stage_x<T, MT>(xs, x, M, K, m0, k0, kt, tid);
    __syncthreads();
    for (; k < k1; k += kUnroll * groups) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        nxt[u] = load_row<VEC, kAligned>(q, k + (kUnroll + u) * groups, k1,
                                         n0, N);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k + u * groups;
        if (kk < k1) {
          float xv[MT];
          load_x<MT>(xs + (kk - k0) * MT, xv);
          fma_row<MT, VEC>(acc, cur[u], xv);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    }
    __syncthreads();
  }

  // the row groups of a warp (lanes tpr apart), by xor shuffles that
  // halve what each lane holds: lane l ends with MT VEC tpr / 32 sums,
  // from original index `base`
  constexpr int V = MT * VEC;
  float a[V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) a[m * VEC + c] = acc[m][c];
  const int warp = tid / 32, lane = tid % 32;
  int base = 0;
  halve<V, 0>(a, lane, tpr, base);
  const int held = V * tpr / 32;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < held) {
      const int o = base + j, m = o / VEC;
      red[warp * tile + m * block_n + cq * VEC + (o - m * VEC)] = a[j];
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // the block's warps in warp order; each sum goes straight to the inbox
  // of the rank that stores it (distributed shared memory), so one
  // cluster barrier orders the whole merge and no rank reads another's
  // memory after it
  for (int i = tid; i < tile; i += kThreads) {
    float s = red[i];
    for (int w = 1; w < kWarps; ++w) s += red[w * tile + i];
    const int owner = i / per;
    cluster.map_shared_rank(inbox, owner)[rank * per + i - owner * per] = s;
  }
  cluster.sync();
  // the ranks' partial sums of this rank's slice, in rank order
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = tid + u * kThreads, i = rank * per + j;
    if (j < per && i < tile) {
      float s = inbox[j];
      for (int r = 1; r < ranks; ++r) s += inbox[r * per + j];
      const int m = i / block_n;
      const int n = blockIdx.y * block_n + (i - m * block_n);
      if (m0 + m < M && n < N)
        out[static_cast<size_t>(m0 + m) * N + n] = s * sc[u];
    }
  }
}

template <typename T, int MT, int VEC, bool kAligned>
cudaError_t launch_one(const void* x, const void* q, const void* scale,
                       void* out, int M, int K, int N, int block_n,
                       int cluster, int k_chunk, cudaStream_t stream) {
  const dim3 grid(cluster, (N + block_n - 1) / block_n, (M + MT - 1) / MT);
  if (cluster == 1) {  // an implicit cluster of one block, launched plainly
    int8_gemv_kernel<T, MT, VEC, kAligned><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), M, K, N,
        block_n, k_chunk);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_gemv_kernel<T, MT, VEC, kAligned>,
                            static_cast<const T*>(x),
                            static_cast<const int8_t*>(q),
                            static_cast<const float*>(scale),
                            static_cast<float*>(out), M, K, N, block_n,
                            k_chunk);
}

template <typename T, int MT>
cudaError_t launch_mt(const void* x, const void* q, const void* scale,
                      void* out, int M, int K, int N, int block_n,
                      int cluster, int k_chunk, cudaStream_t stream) {
  constexpr int VEC = MT == 1 ? 16 : 8;
  const int tpr = block_n / VEC;
  if (block_n % VEC != 0 || tpr < 2 || tpr > kMaxTpr || (tpr & (tpr - 1)))
    return cudaErrorInvalidValue;
  const bool aligned = N % VEC == 0 &&
                       reinterpret_cast<uintptr_t>(q) % VEC == 0;
  return aligned
      ? launch_one<T, MT, VEC, true>(x, q, scale, out, M, K, N, block_n,
                                     cluster, k_chunk, stream)
      : launch_one<T, MT, VEC, false>(x, q, scale, out, M, K, N, block_n,
                                      cluster, k_chunk, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out,
                   int M, int K, int N, int block_n, int row_tile,
                   int cluster, int k_chunk, cudaStream_t stream) {
  switch (row_tile) {
    case 1: return launch_mt<T, 1>(x, q, scale, out, M, K, N, block_n, cluster, k_chunk, stream);
    case 4: return launch_mt<T, 4>(x, q, scale, out, M, K, N, block_n, cluster, k_chunk, stream);
    case 8: return launch_mt<T, 8>(x, q, scale, out, M, K, N, block_n, cluster, k_chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

DL4J_EXPORT_ERROR_STRING

// x (M,K) in `dtype`, q (K,N) int8, scale (N,) f32, out (M,N) f32, all
// contiguous on one device; the plan (block_n, row_tile, cluster, k_chunk)
// from ops/cuda/matmul_int8.py::_plan, with cluster * k_chunk >= K.  One
// launch; returns its error code (cudaGetLastError() semantics).
extern "C" int dl4j_int8_matmul(const void* x, int dtype, const void* q,
                                const void* scale, void* out, int M, int K,
                                int N, int block_n, int row_tile, int cluster,
                                int k_chunk, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (block_n < 1 || row_tile < 1 || K < 0 || k_chunk < 0 || cluster < 1 ||
      cluster > kMaxCluster || static_cast<long long>(cluster) * k_chunk < K ||
      (N + block_n - 1) / block_n > 65535 ||
      (M + row_tile - 1) / row_tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kF32: e = launch<float>(x, q, scale, out, M, K, N, block_n, row_tile, cluster, k_chunk, s); break;
    case kBF16: e = launch<__nv_bfloat16>(x, q, scale, out, M, K, N, block_n, row_tile, cluster, k_chunk, s); break;
    case kF16: e = launch<__half>(x, q, scale, out, M, K, N, block_n, row_tile, cluster, k_chunk, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
