// Paged single-query decode attention, float, int8 or fp8 (e4m3) pages.
//
// Replaces deeplearning4j_tpu/ops/pallas/paged_attention.py::paged_attention
// (pl.pallas_call at paged_attention.py:197) and ::paged_attention_int8
// (paged_attention.py:258, over int8 or float8_e4m3fn pages); both Pallas
// kernels share _accumulate_page, so here they are one kernel template
// with a QUANT flag and the page type KT.
//
// out (B,H,Dh) = softmax(q . K^T / sqrt(Dh)) V over each row's first
// lengths[b] positions, where K/V live in (P, ps, Kv, Dh) page pools and
// row b's logical position t sits at page bt[b, t / ps], slot t % ps.
// Kv < H is GQA: query head h reads kv head h / (H / Kv).  int8 and e4m3
// pages carry a per-(page, kv-head) f32 scale and are dequantized in the
// kernel (in f32, from shared memory) by one multiply; an e4m3 element
// converts to f32 exactly, and a 1-byte page type sizes its stages as
// int8 does.
//
// What bounds it: each K/V byte of a valid position is read once and used
// for 2 flops per query head of its group, far below the card's ~295
// flops a byte, so the K+V bytes of the rows' valid positions bound it
// (3,072 bytes a position at 12 kv heads, Dh 64, bf16; half in int8 or e4m3).
// To reach that bound a decode batch, whose rows may hold 1 or 2048
// positions, has to keep every SM streaming about the same number of
// bytes, with tens of KB in flight on each; at the engines' short rows
// the floor is latency: the launch, the lengths and block-table reads,
// one tile's copy and a merge.
//
// Design:
// - Work from the lengths, on the device.  The grid is one block per SM
//   (fixed by the host from B, the table width and the SM count, so a
//   CUDA-graph capture stays valid).  Every block reads `lengths` and
//   takes a prefix sum of each row's tiles (runs of T tokens of one page,
//   T dividing ps, T Kv Dh K+V elements at most 48 KB): W tiles in all.
//   A row's tiles group into chunks of whole pages, ceil(pages /
//   max_chunks) pages each, so a row has at most max_chunks chunks (32;
//   one page a chunk up to 32 pages).  Block i owns the chunks that start
//   in tiles [i W / n, (i+1) W / n), so a row of 2048 positions is spread
//   over many SMs and a row of 1 costs one tile; no block touches the
//   table's padding past a row's length.
// - Stream tiles with the asynchronous copy engine.  A page is one
//   contiguous (ps, Kv, Dh) run of bytes, and T of its tokens are T Kv Dh
//   contiguous elements: one 1-D bulk copy (cp.async.bulk, no tensor map)
//   each for K and V, completing on the stage's mbarrier.  One producer
//   warp reads the block-table entries of 32 tiles at once, then its lane
//   0 keeps a ring of up to 8 stages in flight (4 of 48 KB at the
//   flagship's shape, 8 of 24 KB for its int8 pages); for int8 pages it
//   also copies the page's 2 Kv scales with 4-byte cp.async, which arrive
//   on the same barrier.  A row's q rides with the first tile of each of
//   its chunks.
// - Scores without a shuffle chain.  Sixteen consumer warps take a tile at
//   a time from shared memory.  One thread computes a whole (query head,
//   token) dot, neighbouring lanes on neighbouring tokens of one head,
//   each walking the row's 16-byte chunks in an order rotated by its lane
//   so that rows a multiple of 128 bytes apart meet different banks (a
//   dot split over lanes spends more instructions on index math and
//   shuffles than on FMAs).  Then eight lanes per query head move the
//   running max and sum once per tile, and P V runs one thread per (head,
//   2 columns) over the tile's tokens, the accumulator in shared memory.
//   f32 throughout; int8 K scales the score and int8 V the tile's sum.
// - One launch, deterministic and batch-invariant.  Each chunk runs its
//   own softmax state over its tiles in order.  A row of one chunk is
//   written by the block that holds it.  A row of several leaves one (m,
//   l, acc) partial per chunk in scratch (row b's chunk j in slot b
//   max_chunks + j); the block of each chunk bumps the row's ticket after
//   writing, and the block that bumps it last merges the partials in
//   chunk order (8 in flight per thread, the running max rescaled as it
//   grows), writes the row and resets the ticket to 0 for the next call.
//   Where a row splits, and in what order its sums run, depends on the
//   row's own length only, never on the other rows of the batch: a row's
//   output is bitwise the same in any batch (a request decodes to the
//   same tokens whatever else is served beside it), and two calls on the
//   same inputs agree bitwise.
// Positions >= lengths[b] are never read, so they contribute exactly 0.
#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxStages = 8;
constexpr int kStageTarget = 48 * 1024;  // K + V bytes of a full stage
constexpr int kSmemLimit = 232448;       // 227 KB, one block a SM
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// N neighbouring elements at p (aligned to N elements) as f32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(pk.v[i]);
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The row owning tile u: cum[r] <= u < cum[r + 1] (cum[0] = 0 <= u < cum[B]).
__device__ __forceinline__ int row_of(const int* cum, int B, int u) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (cum[mid] <= u) lo = mid;
    else hi = mid;
  }
  return lo;
}

// tiles in each chunk of a row of `len` positions: whole pages (tpp tiles
// a page), ceil(pages / max_chunks) of them
__device__ __forceinline__ int chunk_tiles(int len, int ps, int tpp, int max_chunks) {
  const int pages = (len + ps - 1) / ps;
  return max(1, (pages + max_chunks - 1) / max_chunks) * tpp;
}

// floats of one partial (acc (H, DH), then m and l (H) each), padded so
// every partial starts on 16 bytes
__host__ __device__ __forceinline__ size_t part_stride(int H, int DH) {
  return static_cast<size_t>(H) * DH + (2 * H + 3) / 4 * 4;
}

// Shared-memory layout, fixed on the host (all offsets in bytes).
struct Plan {
  int B, H, Kv, ps, n_pages;
  int max_chunks;   // chunks a row at most; partial slots a row
  int tile;         // most tokens a stage holds; divides ps
  int stages;
  int stage_bytes;  // stride of the ring
  int v_off, sc_off, q_off;  // inside a stage: K at 0, V, int8 scales, q
  int qs_off, acc_off, p_off, stat_off, rows_off, flag_off, bar_off;
  float q_scale;    // log2(e) / sqrt(Dh): scores in base 2
};

template <typename QT, typename KT, bool QUANT, int DH>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                       const KT* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ bt,
                       const int* __restrict__ lengths, QT* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ tickets, const Plan p) {
  constexpr int kEpc = 16 / sizeof(KT);           // elements of a 16-byte chunk
  constexpr int kChunks = DH * sizeof(KT) / 16;  // chunks of one head's row
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = p.B, H = p.H, Kv = p.Kv, ps = p.ps;
  const int G = H / Kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nblk = gridDim.x, blk = blockIdx.x;
  float* qs = reinterpret_cast<float*>(smem + p.qs_off);     // (H, DH), scaled q
  float* acc = reinterpret_cast<float*>(smem + p.acc_off);   // (H, DH)
  float* pr = reinterpret_cast<float*>(smem + p.p_off);      // (H, tile): s, then p
  float* m_s = reinterpret_cast<float*>(smem + p.stat_off);  // (H) running max
  float* l_s = m_s + H;                                      // (H) running sum
  float* c_s = l_s + H;                                      // (H) this tile's rescale
  int* cum = reinterpret_cast<int*>(smem + p.rows_off);      // (B + 1) tile prefix
  int* lens = cum + B + 1;                                   // (B) clamped lengths
  int* bstart = lens + B;                                    // (nblk + 1) tile ranges
  int* merge = reinterpret_cast<int*>(smem + p.flag_off);    // this block merges
  const uint32_t bars = hopper::smem_u32(smem + p.bar_off);  // full[s], empty[s]

  // ---- the schedule: every block derives the same one from `lengths`
  const int max_len = p.n_pages * ps;
  for (int b = tid; b < B; b += kThreads) lens[b] = min(max(lengths[b], 0), max_len);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(bars + 8 * s, QUANT ? 2 : 1);       // full
      hopper::mbar_init(bars + 8 * (kMaxStages + s), 1);    // empty
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int T = p.tile;
  if (warp == 0) {
    int carry = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      int x = b < B ? (lens[b] + T - 1) / T : 0;  // inclusive scan over the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (b < B) cum[b + 1] = carry + x;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) cum[0] = 0;
    __syncwarp();
    // block x starts at the first chunk starting at or after tile x W / n
    const bool narrow = carry <= 0x7fffffff / nblk;  // x W fits 32 bits
    for (int x = lane; x <= nblk; x += 32) {
      const int t = narrow ? x * carry / nblk
                           : static_cast<int>(static_cast<long long>(x) * carry / nblk);
      int st = t;
      if (t < carry) {
        const int r = row_of(cum, B, t);
        const int ct = chunk_tiles(lens[r], ps, ps / T, p.max_chunks);
        st = min(cum[r] + (t - cum[r] + ct - 1) / ct * ct, cum[r + 1]);
      }
      bstart[x] = st;
    }
  }
  __syncthreads();
  // rows with no position (length 0) get zeros, one block each
  for (int b = blk; b < B; b += nblk) {
    if (lens[b] > 0) continue;
    for (int i = tid; i < H * DH; i += kThreads)
      out[static_cast<size_t>(b) * H * DH + i] = from_f32<QT>(0.f);
  }
  const int start = bstart[blk], end = bstart[blk + 1];
  if (start >= end) return;
  const size_t tok_elems = static_cast<size_t>(Kv) * DH;  // one token, all kv heads

  if (warp == kConsumerWarps) {
    // ---- producer: block-table entries 32 tiles at a time, then lane 0
    // issues each tile's copies into the ring
    int it = 0;
    for (int c0 = start; c0 < end; c0 += 32) {
      const int u = c0 + lane;
      int rb = 0, pid = 0;
      if (u < end) {
        rb = row_of(cum, B, u);
        pid = bt[static_cast<size_t>(rb) * p.n_pages + (u - cum[rb]) * T / ps];
      }
      const int cnt = min(32, end - c0);
      for (int j = 0; j < cnt; ++j, ++it) {
        const int ub = __shfl_sync(0xffffffffu, rb, j);
        const int page = __shfl_sync(0xffffffffu, pid, j);
        if (lane == 0) {
          const int s = it % p.stages;
          if (it >= p.stages) hopper::mbar_wait(bars + 8 * (kMaxStages + s), ((it / p.stages) + 1) & 1);
          const int uu = c0 + j;
          const int tok0 = (uu - cum[ub]) * T;
          const int n = min(T, lens[ub] - tok0);
          // q rides with each chunk's first tile (a block starts on one)
          const bool first =
              (uu - cum[ub]) % chunk_tiles(lens[ub], ps, ps / T, p.max_chunks) == 0;
          const uint32_t kv_bytes = static_cast<uint32_t>(n * tok_elems * sizeof(KT));
          const uint32_t q_bytes = first ? static_cast<uint32_t>(H * DH * sizeof(QT)) : 0u;
          const uint32_t full = bars + 8 * s;
          unsigned char* st = smem + static_cast<size_t>(s) * p.stage_bytes;
          hopper::mbar_expect_tx(full, 2 * kv_bytes + q_bytes);
          const size_t off = (static_cast<size_t>(page) * ps + tok0 % ps) * tok_elems;
          hopper::bulk_load(hopper::smem_u32(st), kp + off, kv_bytes, full);
          hopper::bulk_load(hopper::smem_u32(st + p.v_off), vp + off, kv_bytes, full);
          if (first)
            hopper::bulk_load(hopper::smem_u32(st + p.q_off), q + static_cast<size_t>(ub) * H * DH,
                              q_bytes, full);
          if (QUANT) {
            const uint32_t sc = hopper::smem_u32(st + p.sc_off);
            for (int h = 0; h < Kv; ++h) {
              hopper::cp_async_4(sc + 4 * h, ks + static_cast<size_t>(page) * Kv + h);
              hopper::cp_async_4(sc + 4 * (Kv + h), vs + static_cast<size_t>(page) * Kv + h);
            }
            hopper::cp_async_mbar_arrive(full);
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // ---- consumers: one segment (a chunk: a run of a row's tiles) at a time
  int it = 0;
  for (int u = start; u < end;) {
    const int b = row_of(cum, B, u);
    const int seg0 = u;
    const int ct = chunk_tiles(lens[b], ps, ps / T, p.max_chunks);
    const int chunk = (seg0 - cum[b]) / ct;
    const int n_chunks = (cum[b + 1] - cum[b] + ct - 1) / ct;
    const int seg1 = min(cum[b] + (chunk + 1) * ct, cum[b + 1]);
    for (; u < seg1; ++u, ++it) {
      const int s = it % p.stages;
      const unsigned char* st = smem + static_cast<size_t>(s) * p.stage_bytes;
      const KT* kt = reinterpret_cast<const KT*>(st);
      const KT* vt = reinterpret_cast<const KT*>(st + p.v_off);
      const float* scl = reinterpret_cast<const float*>(st + p.sc_off);
      const int n = min(T, lens[b] - (u - cum[b]) * T);
      hopper::mbar_wait(bars + 8 * s, (it / p.stages) & 1);
      if (u == seg0) {  // a new chunk: its row's q, scaled, and a fresh softmax state
        const QT* qt = reinterpret_cast<const QT*>(st + p.q_off);
        for (int i = tid; i < H * DH; i += kConsumers) {
          qs[i] = to_f32(qt[i]) * p.q_scale;
          acc[i] = 0.f;
        }
        for (int h = tid; h < H; h += kConsumers) {
          m_s[h] = kNegInf;
          l_s[h] = 0.f;
        }
        hopper::named_sync(1, kConsumers);
      }
      // scores: one thread a (query head, token), the whole dot from shared
      // memory; neighbouring lanes take neighbouring tokens of one head and
      // walk the row's 16-byte chunks in rotated order, so the rows (a
      // multiple of 128 bytes apart) meet different banks
      for (int i = tid; i < n * H; i += kConsumers) {
        const int h = i / n, tok = i - h * n, kvh = h / G;
        const KT* krow = kt + static_cast<size_t>(tok * Kv + kvh) * DH;
        const float* qh = qs + h * DH;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int cc = (c + lane) % kChunks;
          float kf[kEpc], qf[kEpc];
          load_f32<KT, kEpc>(krow + cc * kEpc, kf);
          load_f32<float, kEpc>(qh + cc * kEpc, qf);
#pragma unroll
          for (int e = 0; e < kEpc; e += 2) {
            d0 = fmaf(qf[e], kf[e], d0);
            d1 = fmaf(qf[e + 1], kf[e + 1], d1);
          }
        }
        pr[h * p.tile + tok] = (d0 + d1) * (QUANT ? scl[kvh] : 1.f);
      }
      hopper::named_sync(1, kConsumers);
      // running max and sum, once per tile: eight lanes a head, a 3-step
      // shuffle tree among them
      const unsigned gmask = 0xffu << (lane & 24);
      for (int h = tid / 8; h < H; h += kConsumers / 8) {
        float* row = pr + h * p.tile;
        const int sub = lane % 8;
        float mx = kNegInf;
        for (int j = sub; j < n; j += 8) mx = fmaxf(mx, row[j]);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, o));
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = sub; j < n; j += 8) {
          const float e = exp2f(row[j] - m_new);
          row[j] = e;
          sum += e;
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(gmask, sum, o);
        if (sub == 0) {
          const float corr = exp2f(m_old - m_new);  // 0 on a row's first tile
          c_s[h] = corr;
          l_s[h] = l_s[h] * corr + sum;
          m_s[h] = m_new;
        }
      }
      hopper::named_sync(1, kConsumers);
      // P V: one thread a (query head, 2 columns) over the tile's tokens
      for (int i = tid; i < H * (DH / 2); i += kConsumers) {
        const int h = i / (DH / 2);
        const int d = (i % (DH / 2)) * 2;
        const int kvh = h / G;
        const float* row = pr + h * p.tile;
        const KT* vcol = vt + kvh * DH + d;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
          float v2[2];
          load_f32<KT, 2>(vcol + static_cast<size_t>(t) * tok_elems, v2);
          const float w = row[t];
          a0 = fmaf(w, v2[0], a0);
          a1 = fmaf(w, v2[1], a1);
        }
        const float vsc = QUANT ? scl[Kv + kvh] : 1.f;
        const float corr = c_s[h];
        float* a = acc + h * DH + d;
        a[0] = fmaf(a[0], corr, a0 * vsc);
        a[1] = fmaf(a[1], corr, a1 * vsc);
      }
      hopper::named_sync(1, kConsumers);
      if (tid == 0) hopper::mbar_arrive(bars + 8 * (kMaxStages + s));  // stage free
    }

    // ---- the chunk's end: write the row, or a partial and maybe merge
    QT* orow = out + static_cast<size_t>(b) * H * DH;
    if (n_chunks == 1) {
      for (int i = tid; i < H * DH; i += kConsumers)
        orow[i] = from_f32<QT>(acc[i] / l_s[i / DH]);
    } else {
      const size_t stride = part_stride(H, DH);
      const size_t slot0 = static_cast<size_t>(b) * p.max_chunks;
      float* mine = part + (slot0 + chunk) * stride;
      for (int i = tid; i < H * DH; i += kConsumers) mine[i] = acc[i];
      for (int h = tid; h < H; h += kConsumers) {
        mine[H * DH + h] = m_s[h];
        mine[H * DH + H + h] = l_s[h];
      }
      __threadfence();
      hopper::named_sync(1, kConsumers);
      if (tid == 0) {
        const int t = atomicAdd(tickets + b, 1);
        const bool last = t == n_chunks - 1;
        if (last) tickets[b] = 0;  // ready for the next call
        __threadfence();
        *merge = last;
      }
      hopper::named_sync(1, kConsumers);
      if (*merge) {
        // every partial is in: merge in chunk order, one thread 4 columns;
        // each round loads 8 partials' (m, l, acc) at once and folds them
        // into a running (M, L, A), rescaled when M grows
        for (int i = tid * 4; i < H * DH; i += kConsumers * 4) {
          const int h = i / DH;
          float M = kNegInf, L = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
          for (int j0 = 0; j0 < n_chunks; j0 += 8) {
            float mx[8], lx[8];
            float4 v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int j = j0 + k;
              mx[k] = kNegInf;  // past the last chunk: weight 0
              lx[k] = 0.f;
              v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
              if (j < n_chunks) {
                const float* px = part + (slot0 + j) * stride;
                mx[k] = __ldcg(px + H * DH + h);
                lx[k] = __ldcg(px + H * DH + H + h);
                v[k] = __ldcg(reinterpret_cast<const float4*>(px + i));
              }
            }
            float M2 = M;
#pragma unroll
            for (int k = 0; k < 8; ++k) M2 = fmaxf(M2, mx[k]);
            const float r = exp2f(M - M2);
            L *= r;
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] *= r;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const float w = exp2f(mx[k] - M2);
              L = fmaf(lx[k], w, L);
              a[0] = fmaf(v[k].x, w, a[0]);
              a[1] = fmaf(v[k].y, w, a[1]);
              a[2] = fmaf(v[k].z, w, a[2]);
              a[3] = fmaf(v[k].w, w, a[3]);
            }
            M = M2;
          }
          const float inv = 1.f / L;
#pragma unroll
          for (int e = 0; e < 4; ++e) orow[i + e] = from_f32<QT>(a[e] * inv);
        }
      }
    }
    hopper::named_sync(1, kConsumers);  // acc and the stats are reused next
  }
}

// the shared-memory plan for these shapes; false if it does not fit
template <typename QT, typename KT>
bool make_plan(Plan& p, int B, int H, int Kv, int Dh, int ps, int n_pages, int n_blocks,
               int max_chunks) {
  p.B = B;
  p.max_chunks = max_chunks;
  p.H = H;
  p.Kv = Kv;
  p.ps = ps;
  p.n_pages = n_pages;
  const int tok_kv = Kv * Dh * static_cast<int>(sizeof(KT));  // K (or V) bytes of a token
  p.tile = 1;  // the largest divisor of ps whose K + V fit the stage target
  for (int t = ps; t >= 1; --t)
    if (ps % t == 0 && 2 * t * tok_kv <= kStageTarget) {
      p.tile = t;
      break;
    }
  p.v_off = round_up(p.tile * tok_kv, 128);
  p.sc_off = p.v_off + round_up(p.tile * tok_kv, 16);
  p.q_off = p.sc_off + round_up(2 * Kv * 4, 16);
  p.stage_bytes = round_up(p.q_off + H * Dh * static_cast<int>(sizeof(QT)), 128);
  int fixed = 0;
  p.qs_off = fixed;  // relative for now; shifted past the ring below
  fixed += H * Dh * 4;
  p.acc_off = fixed;
  fixed += H * Dh * 4;
  p.p_off = fixed;
  fixed += round_up(H * p.tile * 4, 16);
  p.stat_off = fixed;
  fixed += round_up(3 * H * 4, 16);
  p.rows_off = fixed;
  fixed += round_up((2 * B + n_blocks + 2) * 4, 16);
  p.flag_off = fixed;
  fixed += 16;
  p.bar_off = fixed;
  fixed += 2 * kMaxStages * 8;
  p.stages = (kSmemLimit - fixed) / p.stage_bytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  if (p.stages < 2) return false;
  const int ring = p.stages * p.stage_bytes;
  p.qs_off += ring;
  p.acc_off += ring;
  p.p_off += ring;
  p.stat_off += ring;
  p.rows_off += ring;
  p.flag_off += ring;
  p.bar_off += ring;
  p.q_scale = kLog2e / sqrtf(static_cast<float>(Dh));
  return true;
}

inline int smem_bytes(const Plan& p) { return p.bar_off + 2 * kMaxStages * 8; }

template <typename QT, typename KT, bool QUANT, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* bt, const void* lengths, void* out,
                   void* part, void* tickets, int B, int H, int Kv, int ps, int n_pages,
                   int n_blocks, int max_chunks, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KT, QUANT, DH>;
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  Plan p;
  if (!make_plan<QT, KT>(p, B, H, Kv, DH, ps, n_pages, n_blocks, max_chunks)) return cudaErrorInvalidValue;
  kernel<<<n_blocks, kThreads, smem_bytes(p), stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<QT*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), p);
  return cudaGetLastError();
}

// page-type codes (ops/cuda/paged_attention.py: _PAGE_CODES)
enum PageType : int { kPagesModel = 0, kPagesInt8 = 1, kPagesE4M3 = 2 };

template <typename QT, int DH>
cudaError_t dispatch_quant(int quant, const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* bt, const void* lengths,
                           void* out, void* part, void* tickets, int B, int H, int Kv, int ps,
                           int n_pages, int n_blocks, int max_chunks, cudaStream_t s) {
  switch (quant) {
    case kPagesModel:
      return launch<QT, QT, false, DH>(q, k, v, ks, vs, bt, lengths, out, part, tickets, B, H,
                                       Kv, ps, n_pages, n_blocks, max_chunks, s);
    case kPagesInt8:
      return launch<QT, int8_t, true, DH>(q, k, v, ks, vs, bt, lengths, out, part, tickets, B,
                                          H, Kv, ps, n_pages, n_blocks, max_chunks, s);
    case kPagesE4M3:
      return launch<QT, __nv_fp8_e4m3, true, DH>(q, k, v, ks, vs, bt, lengths, out, part,
                                                 tickets, B, H, Kv, ps, n_pages, n_blocks, max_chunks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t dispatch_dh(int Dh, int quant, const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* bt, const void* lengths,
                        void* out, void* part, void* tickets, int B, int H, int Kv, int ps,
                        int n_pages, int n_blocks, int max_chunks, cudaStream_t s) {
  switch (Dh) {
    case 32: return dispatch_quant<QT, 32>(quant, q, k, v, ks, vs, bt, lengths, out, part, tickets, B, H, Kv, ps, n_pages, n_blocks, max_chunks, s);
    case 64: return dispatch_quant<QT, 64>(quant, q, k, v, ks, vs, bt, lengths, out, part, tickets, B, H, Kv, ps, n_pages, n_blocks, max_chunks, s);
    case 128: return dispatch_quant<QT, 128>(quant, q, k, v, ks, vs, bt, lengths, out, part, tickets, B, H, Kv, ps, n_pages, n_blocks, max_chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

DL4J_EXPORT_ERROR_STRING

// q (B,H,Dh) and out in `dtype`; k/v pools (P,ps,Kv,Dh) of the page type
// `quant`: in `dtype` (0), or int8 (1) or e4m3 (2) with (P,Kv) f32
// k_scale/v_scale;
// bt (B,n_pages) and lengths (B,) int32; Dh in {32, 64, 128}; H a
// multiple of Kv with H / Kv <= 16.  q, k and v 16-byte aligned.  A row
// splits into at most max_chunks chunks (ceil(pages / max_chunks) pages
// each); part is f32 scratch of B * max_chunks * (H * Dh + round_up(2 H,
// 4)); tickets is B int32 that are 0 on entry and are left 0 (the wrapper
// keeps one zeroed buffer per stream).  All contiguous on one device.  Returns cudaGetLastError()
// after the one launch.
extern "C" int dl4j_paged_attention(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale, const void* bt,
                                    const void* lengths, void* out, void* part, void* tickets,
                                    int B, int H, int Kv, int Dh, int ps, int n_pages,
                                    int n_blocks, int max_chunks, int dtype, int quant,
                                    void* stream) {
  if (B <= 0) return 0;
  if (Kv <= 0 || H % Kv != 0 || H / Kv > 16 || n_blocks < 1 || n_pages < 1 || ps < 1 ||
      max_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case kF32:
      e = dispatch_dh<float>(Dh, quant, q, k, v, k_scale, v_scale, bt, lengths, out, part, tickets, B, H, Kv, ps, n_pages, n_blocks, max_chunks, s);
      break;
    case kBF16:
      e = dispatch_dh<__nv_bfloat16>(Dh, quant, q, k, v, k_scale, v_scale, bt, lengths, out, part, tickets, B, H, Kv, ps, n_pages, n_blocks, max_chunks, s);
      break;
    case kF16:
      e = dispatch_dh<__half>(Dh, quant, q, k, v, k_scale, v_scale, bt, lengths, out, part, tickets, B, H, Kv, ps, n_pages, n_blocks, max_chunks, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
