// Ragged paged attention for Hopper (sm_90a): one kernel family for every
// paged-KV attention dispatch of the serving engine (prefill chunks,
// speculative-verify windows, and decode as the q_len = 1 case).
//
// Replaces the TPU kernel `_ragged_kernel` of
// ray_tpu/ops/ragged_paged_attention.py (Pallas). It computes the same
// function, written from what that kernel computes rather than block by
// block:
//
//   row r's queries sit at positions starts[r] + i, i < q_lens[r]; query
//   head `head` attends kv head head / G (G = H / KVH, no K/V repeat);
//   key position k_pos is kept iff k_pos <= q_pos and
//   k_pos < starts[r] + q_lens[r]; softmax streams over the live keys in
//   f32 (m, l, acc); in bf16 the unnormalised p is rounded to V's dtype
//   before p.V, where the Pallas kernel rounds it (`:112`); the output is
//   acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on this card: the bytes of the live K/V pages (each live
// key's K and V row, per kv head). At decode the arithmetic is ~1 FLOP per
// byte, far below the H100's ~295 FLOP/B ridge, and at a 128-token prefill
// chunk (G = 4: 512 query rows per kv head) it is still below it; but
// only if the products run at tensor-core rates, since on CUDA cores
// (67 TFLOP/s f32) a prefill chunk's products take longer than its bytes.
//
// Shared by both dtypes:
//   * GQA without repeat: a block owns (row r, kv head h, a tile of flat
//     rows f = i * G + g, i.e. query positions times the G query heads of
//     h), so each K/V tile leaves device memory once per block and serves
//     every query head of the group;
//   * a block walks only the keys its own real queries can see (positions
//     <= the last real query of its tile), so pages past a row's live
//     count, and the block-table entries that name them, are never read:
//     table tails may hold stale or poisoned page ids;
//   * masked keys get the finite -1e30 and p is re-masked to 0 after the
//     exp, so a fully masked query row gives 0, not NaN.
//
// bf16 (rpa_kernel_mma, rpa_merge_kernel): tensor cores and split-KV.
//   * Products: S = Q K^T and P V are mma.sync.m16n8k16 (bf16 in, f32
//     accumulate) on operands read from shared memory by ldmatrix (V by
//     ldmatrix.trans: nothing is transposed in memory), 16 flat rows per
//     warp with Q's A fragments held in registers across the key loop;
//     the streaming softmax runs on the f32 C fragments and p is packed
//     to bf16 in registers as the A operand of P V (mma_sm90.cuh
//     softmax_tile, shared with the flash forward).
//   * Staging: Q rows by 16-byte cp.async, one address per flat row
//     (q[r, f / G, h G + f % G]); K/V in 64-key tiles gathered through
//     the block table (each key's page read from bt_row[key / page_size],
//     any page size), by 16-byte cp.async.cg, double-buffered so the
//     next tile lands while the current one computes; keys past the
//     block's range are zero-filled through cp.async's src-size operand
//     (never addressed) and masked.
//   * Warps per block follow the flat rows a (row, kv head) has: 1 warp
//     for up to 16 (decode, q_len 1: G live rows of the warp's 16), 2 for
//     up to 32 (verify, 5 x G 4 = 20), else 4 (prefill chunks). At decode
//     only G of the 16 tensor-core rows are live; decode is bound by
//     bytes, so the idle rows cost tensor-core issue slots, not time
//     (tensor-core products were taken for all three families, one design).
//   * Split-KV, batch-invariant: at decode and verify widths (Q <= 32)
//     each row's keys are cut into splits of a fixed number of whole
//     pages (split_pages, chosen by the wrapper from the page size
//     alone: 8 pages of 16 keys), split s covering keys [s * span,
//     (s + 1) * span), span = split_pages * page_size; the wrapper asks
//     for ceil(table width / split_pages) splits. Which keys a split
//     holds therefore depends only on the page index, never on the
//     call's row count, its longest row or its table width, so a row's
//     output has the same bits in any batch (the Pallas kernel walks a
//     row's pages in order, whatever else is in the call). Pass 1 writes
//     each split's unnormalised (m, l, acc) to f32 scratch [R, n_splits,
//     Q, H] (+ D); blocks whose split starts past their own keys return
//     at once; pass 2 (one block per query position and head) merges, in
//     page order, only the splits that hold keys of that query and
//     writes 0 for padding positions (i >= q_lens[r]). A query whose
//     keys lie in one split is written as pass 1 writes an unsplit call
//     (acc / max(l, 1e-30), rounded once), so the table width does not
//     change its bits either. Prefill widths (Q > 32) run unsplit: a
//     whole pass in page order, batch-invariant by itself, and pass 2 is
//     not launched. No host sync: nothing is sized from the data.
//   * Deterministic: no atomics, so two launches give the same bits.
//
// f32 (rpa_kernel_f32, rpa_merge_kernel<float>): CUDA cores, split-KV.
// Tensor cores in f32 would mean TF32, three decimal digits, far from the
// f32 reference, so products and sums stay on CUDA cores in f32; at
// decode and verify widths a call is bound by the bytes of K/V (4 bytes an
// element: 2 FLOP per byte at decode with G = 4, against a CUDA-core ridge
// of 67e12 / 3.35e12 = 20). What held the first
// f32 design far below that bound: it never split, so two long
// rows gave 16 blocks for 132 SMs, each walking thousands of keys with one
// 32-key tile of loads in flight, staged through registers. Now:
//   * the bf16 kernel's split rule (above): at Q <= 32 runs of split_pages
//     whole pages fixed by the page index (batch-invariant), merged in
//     page order by rpa_merge_kernel<float>, a query whose keys lie in
//     one split written as an unsplit call writes it; prefill unsplit;
//   * K/V stages of 16 keys gathered through the block table by 16-byte
//     cp.async.cg into a ring of kStages (4) slots of shared memory (K
//     rows padded by 16 bytes), so three stages are in flight while one
//     is computed, and nothing passes through registers; keys past the
//     block's range are zero-filled, never addressed. 16-key stages keep
//     the block at 74.8 KB (D 128), three blocks an SM: on CUDA cores
//     the warps an SM holds hide the softmax's shuffle and exp latencies,
//     and three 16 KB stages in flight per block already cover the
//     memory latency;
//   * a warp owns up to kRowsPerWarp flat rows (m, l, acc in registers);
//     lanes j and j + 16 score key j, each over one half of D with
//     16-byte reads of its K row and of the query (a broadcast), and add
//     their halves with one shuffle; a row whose query precedes the stage
//     skips it (its m, l, acc would not change); the warp reduces max and
//     sum with shuffles; each V row, read once per warp, serves all its
//     rows, and each lane accumulates P.V for its D/32 output dims.
//
// C interface (bound with ctypes, see ray_tpu_torch/ops/_build.py):
// rpa_forward launches the pass(es) on `stream` and returns
// cudaGetLastError() after each launch (or the error of setting the
// dynamic shared-memory size), and cudaErrorInvalidValue for a
// dtype/head_dim it was not built for or a split count that does not
// cover the table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // PTX helpers, tile products, softmax_tile

namespace {

// the f32 kernel's layout
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * kRowsPerWarp;  // flat rows per block
constexpr int kKeyTile = 16;   // keys per stage: two lanes a key
constexpr int kStages = 4;     // stages of the cp.async ring

template <int D>
struct RpaF32Cfg {
  // K rows padded by 16 bytes: the 16-byte read of key j's row starts at
  // bank 4 j mod 32, so each quarter-warp phase of an LDS.128 (eight keys,
  // one half of D) touches eight distinct bank quads (no conflict)
  static constexpr int KLD = D + 4;
  static constexpr int kStage = kKeyTile * (KLD + D);  // floats: K then V
  static constexpr int kSmemBytes = (kRows * D + kStages * kStage) * 4;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// the sum over each half of the warp, in every lane of that half
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores, split-KV
// ---------------------------------------------------------------------------

// Pass 1. q, out: [R, Q, H, D] f32; k_pages, v_pages: [P, page_size, KVH,
// D] f32; block_tables: [R, max_pages]; starts, q_lens: [R]. part_o /
// part_ml as the bf16 kernel's (read only when n_splits > 1); split s
// holds keys [s * span, (s + 1) * span), span = split_pages * page_size.
// grid = (KVH * n_splits, ceil(Q * G / kRows), R), block = kThreads,
// dynamic shared memory RpaF32Cfg<D>::kSmemBytes.
template <int D>
__global__ void __launch_bounds__(kThreads)
rpa_kernel_f32(const float* __restrict__ q, const float* __restrict__ k_pages,
               const float* __restrict__ v_pages,
               const int* __restrict__ block_tables,
               const int* __restrict__ starts, const int* __restrict__ q_lens,
               float* __restrict__ out, float* __restrict__ part_o,
               float* __restrict__ part_ml, int Q, int H, int KVH,
               int page_size, int max_pages, int n_splits, int split_pages,
               float scale) {
  using C = RpaF32Cfg<D>;
  constexpr int KLD = C::KLD;
  constexpr int C4 = D / 4;       // 16-byte chunks per K/V row
  constexpr int DPL = D / 32;     // output dims per lane
  constexpr int kCopies = kKeyTile * C4 / kThreads;  // per thread per stage
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  static_assert(kKeyTile * C4 % kThreads == 0, "tile split");
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                 // [kRows][D]
  float* ring = q_s + kRows * D;       // kStages x {K [32][KLD], V [32][D]}

  const int h = blockIdx.x % KVH, split = blockIdx.x / KVH;
  const int r = blockIdx.z;
  const int G = H / KVH;
  const int n_flat = Q * G;              // flat row f = i * G + g
  const int flat0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int start = starts[r];
  const int q_len = min(max(q_lens[r], 0), Q);
  const int kv_len = start + q_len;      // positions < kv_len are live
  const int cap = max_pages * page_size;
  // keys this block needs: up to its last REAL query position
  const int i_lo = flat0 / G;
  const int i_hi = min((min(flat0 + kRows, n_flat) - 1) / G, q_len - 1);
  const int n_keys = i_hi >= i_lo ? min(start + i_hi + 1, cap) : 0;
  // this split's keys (one split: all of them)
  const int span = n_splits > 1 ? split_pages * page_size : cap;
  const int k_lo = split * span;
  const int k_hi = min(k_lo + span, n_keys);
  // uniform: pass 2 reads only used splits; an unsplit block writes its
  // rows even with no keys (zeros)
  if (n_splits > 1 && k_lo >= k_hi) return;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeyTile - 1) / kKeyTile
                                  : 0;

  // Stage s of this split into ring slot s % kStages: each key's page from
  // the block table, 16-byte cp.async.cg; keys >= k_hi are zero-filled and
  // never addressed, so only live table entries are read.
  const int* bt_row = block_tables + (size_t)r * max_pages;
  auto stage = [&](int s) {
    const int kb = k_lo + s * kKeyTile;
    float* ks = ring + (s % kStages) * C::kStage;
    float* vs = ks + kKeyTile * KLD;
#pragma unroll
    for (int it = 0; it < kCopies; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int j = idx / C4, c = idx - j * C4;
      const int key = kb + j;
      const bool ok = key < k_hi;
      size_t off = 0;
      if (ok) {
        const int pid = bt_row[key / page_size];
        off = (((size_t)pid * page_size + key % page_size) * KVH + h) * D +
              c * 4;
      }
      cp_async16(smem_addr(ks + j * KLD + c * 4), k_pages + off, ok);
      cp_async16(smem_addr(vs + j * D + c * 4), v_pages + off, ok);
    }
  };
  // the first kStages - 1 stages go in flight before q is even read
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s);
    cp_async_commit();
  }

  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int k = idx / D, d = idx % D;
    const int f = flat0 + k;
    q_s[idx] = f < n_flat
                   ? q[(((size_t)r * Q + f / G) * H + h * G + f % G) * D + d]
                   : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int q_pos[kRowsPerWarp];
  bool active[kRowsPerWarp];
#pragma unroll
  for (int jr = 0; jr < kRowsPerWarp; ++jr) {
    const int f = flat0 + warp + jr * kWarps;
    active[jr] = f < n_flat;
    q_pos[jr] = start + f / G;
    m[jr] = kNegInf;
    l[jr] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[jr][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // refill the slot stage t - 1 used (every warp left it at the barrier
    // that ended the last iteration)
    if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of stage t landed
    __syncthreads();               // everyone's; q_s staged
    const int kb = k_lo + t * kKeyTile;
    const int nt = min(kKeyTile, k_hi - kb);
    const float* ks = ring + (t % kStages) * C::kStage;
    const float* vs = ks + kKeyTile * KLD;
    // lanes j and j + 16 score key kb + j, each over one half of D, for
    // each of the warp's rows; a row whose query precedes the whole stage
    // sees none of it (uniform per warp)
    const int kj = lane & (kKeyTile - 1), half = lane / kKeyTile;
    const int k_pos = kb + kj;
    float p[kRowsPerWarp];
    bool sees[kRowsPerWarp];
#pragma unroll
    for (int jr = 0; jr < kRowsPerWarp; ++jr) {
      sees[jr] = active[jr] && kb <= q_pos[jr];
      p[jr] = 0.f;
      if (!sees[jr]) continue;
      const bool keep = kj < nt && k_pos <= q_pos[jr] && k_pos < kv_len;
      const float4* kr =
          reinterpret_cast<const float4*>(ks + kj * KLD + half * (D / 2));
      const float4* qr = reinterpret_cast<const float4*>(
          q_s + (warp + jr * kWarps) * D + half * (D / 2));
      float d0 = 0.f, d1 = 0.f;
#pragma unroll 8
      for (int c = 0; c < C4 / 2; c += 2) {
        const float4 k0 = kr[c], q0 = qr[c];
        const float4 k1 = kr[c + 1], q1 = qr[c + 1];
        d0 = fmaf(q0.x, k0.x, d0);
        d0 = fmaf(q0.y, k0.y, d0);
        d0 = fmaf(q0.z, k0.z, d0);
        d0 = fmaf(q0.w, k0.w, d0);
        d1 = fmaf(q1.x, k1.x, d1);
        d1 = fmaf(q1.y, k1.y, d1);
        d1 = fmaf(q1.z, k1.z, d1);
        d1 = fmaf(q1.w, k1.w, d1);
      }
      float dot = d0 + d1;
      dot += __shfl_xor_sync(kFull, dot, kKeyTile);  // the other half of D
      // lanes past the stage read zero-filled rows; keys past the query
      // are live keys: both masked here
      const float s = keep ? dot * scale : kNegInf;
      const float m_new = fmaxf(m[jr], warp_max(s));
      p[jr] = keep ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[jr] - m_new);
      l[jr] = l[jr] * alpha + half_warp_sum(p[jr]);
      m[jr] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[jr][e] *= alpha;
    }
    // P.V over the whole stage: each V row is read once and serves every
    // row of the warp; lane owns output dims [lane * DPL, lane * DPL +
    // DPL). Keys past the stage's end are zero-filled and their p is 0, so
    // they add exactly nothing, and a fixed trip count lets the shuffles
    // and reads of all 16 keys overlap.
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j) {
      float v[DPL];
      const float* vr = vs + j * D + lane * DPL;
      if constexpr (DPL == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr);
        v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
      } else {
        const float2 v2 = *reinterpret_cast<const float2*>(vr);
        v[0] = v2.x; v[1] = v2.y;
      }
#pragma unroll
      for (int jr = 0; jr < kRowsPerWarp; ++jr) {
        if (!sees[jr]) continue;             // uniform across the warp
        const float pj = __shfl_sync(kFull, p[jr], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[jr][e] = fmaf(pj, v[e], acc[jr][e]);
      }
    }
    __syncthreads();  // this slot is refilled at the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int jr = 0; jr < kRowsPerWarp; ++jr) {
    if (!active[jr]) continue;
    const int f = flat0 + warp + jr * kWarps;
    const int qi = f / G, head = h * G + f % G;
    if (n_splits == 1) {
      const float denom = fmaxf(l[jr], 1e-30f);
      float* o = out + (((size_t)r * Q + qi) * H + head) * D + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[e] = acc[jr][e] / denom;
    } else {
      const size_t at = (((size_t)r * n_splits + split) * Q + qi) * H + head;
      float* o = part_o + at * D + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[e] = acc[jr][e];
      if (lane == 0)
        *reinterpret_cast<float2*>(part_ml + at * 2) =
            make_float2(m[jr], l[jr]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores, split-KV
// ---------------------------------------------------------------------------

template <int D, int NW>
struct RpaMmaCfg {
  static constexpr int NT = 32 * NW;
  static constexpr int ROWS = 16 * NW;  // flat rows per block, 16 per warp
  static constexpr int BK = 64;         // keys per tile
  static constexpr int LDS = D + 8;     // row stride in elements (+16 bytes)
  // q once (read into registers), K and V twice (double buffer)
  static constexpr int kSmemBytes = (ROWS + 4 * BK) * LDS * 2;
};

// Pass 1. q, out: [R, Q, H, D] bf16; k_pages, v_pages: [P, page_size, KVH,
// D] bf16; block_tables: [R, max_pages]; starts, q_lens: [R].
// part_o: [R, n_splits, Q, H, D] f32, part_ml: [R, n_splits, Q, H, 2] f32
// (read only when n_splits > 1); split s holds keys [s * span, (s + 1) *
// span), span = split_pages * page_size.
// grid = (KVH * n_splits, ceil(Q * G / ROWS), R), block = 32 NW threads;
// the flat-row tile index runs backwards (the last tiles see the most
// keys and start first).
template <int D, int NW>
__global__ void __launch_bounds__(RpaMmaCfg<D, NW>::NT)
rpa_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
               const bf16* __restrict__ v_pages,
               const int* __restrict__ block_tables,
               const int* __restrict__ starts, const int* __restrict__ q_lens,
               bf16* __restrict__ out, float* __restrict__ part_o,
               float* __restrict__ part_ml, int Q, int H, int KVH,
               int page_size, int max_pages, int n_splits, int split_pages,
               float scale) {
  using C = RpaMmaCfg<D, NW>;
  constexpr int ROWS = C::ROWS, BK = C::BK, LDS = C::LDS, NT = C::NT;
  constexpr int VPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * VPR % NT == 0 && BK * VPR % NT == 0, "tile split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LDS]
  bf16* k_s = q_s + ROWS * LDS;                    // [2][BK][LDS]
  bf16* v_s = k_s + 2 * BK * LDS;                  // [2][BK][LDS]

  const int h = blockIdx.x % KVH, split = blockIdx.x / KVH;
  const int flat0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int r = blockIdx.z;
  const int G = H / KVH;
  const int n_flat = Q * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const int start = starts[r];
  const int q_len = min(max(q_lens[r], 0), Q);
  const int kv_len = start + q_len;  // positions < kv_len are live
  const int cap = max_pages * page_size;
  // keys this block needs: up to its last REAL query position
  const int i_lo = flat0 / G;
  const int i_hi = min((min(flat0 + ROWS, n_flat) - 1) / G, q_len - 1);
  const int n_keys = i_hi >= i_lo ? min(start + i_hi + 1, cap) : 0;
  // this split's keys (one split: all of them); written without a branch
  // on n_splits, which ptxas allocates without spilling at D 64
  const int span = n_splits > 1 ? split_pages * page_size : cap;
  const int k_lo = split * span;
  const int k_hi = min(k_lo + span, n_keys);
  // uniform: pass 2 reads only used splits; an unsplit block writes its
  // rows even with no keys (zeros)
  if (n_splits > 1 && k_lo >= k_hi) return;
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  // Q: one address per flat row; rows past Q * G are zero-filled
#pragma unroll
  for (int it = 0; it < ROWS * VPR / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int row = idx / VPR, c = idx - row * VPR;
    const int f = flat0 + row;
    const bool ok = f < n_flat;
    const size_t off =
        ok ? (((size_t)r * Q + f / G) * H + h * G + f % G) * D + c * 8 : 0;
    cp_async16(smem_addr(q_s + row * LDS + c * 8), q + off, ok);
  }
  cp_async_commit();

  // K/V tile at key kb into buffer buf: each key's page from the block
  // table; keys >= k_hi are zero-filled and never addressed
  const int* bt_row = block_tables + (size_t)r * max_pages;
  auto stage = [&](int kb, int buf) {
#pragma unroll
    for (int it = 0; it < BK * VPR / NT; ++it) {
      const int idx = threadIdx.x + it * NT;
      const int j = idx / VPR, c = idx - j * VPR;
      const int key = kb + j;
      const bool ok = key < k_hi;
      size_t off = 0;
      if (ok) {
        const int pid = bt_row[key / page_size];
        off = (((size_t)pid * page_size + key % page_size) * KVH + h) * D +
              c * 8;
      }
      const int at = (buf * BK + j) * LDS + c * 8;
      cp_async16(smem_addr(k_s + at), k_pages + off, ok);
      cp_async16(smem_addr(v_s + at), v_pages + off, ok);
    }
  };
  if (n_tiles > 0) stage(k_lo, 0);
  cp_async_commit();
  cp_async_wait<1>();  // q has landed; the first K/V tile may not have
  __syncthreads();
  uint32_t qa[D / 16][4];  // this warp's 16 flat rows, for every key tile
  ldsm_a<D, LDS>(qa, q_s + warp * 16 * LDS, lane);

  // this thread's flat rows: warp * 16 + g and + 8
  const int wf0 = flat0 + warp * 16;
  const bool warp_live = wf0 < n_flat;
  const int wq_lo = start + wf0 / G;                         // first q_pos
  const int wq_hi = start + (min(wf0 + 15, n_flat - 1)) / G;  // last q_pos
  int q_pos[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_pos[i] = start + (wf0 + g + 8 * i) / G;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = k_lo + it * BK;
    if (it + 1 < n_tiles) stage(kb + BK, (it + 1) % 2);  // lands meanwhile
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // a warp of padding rows, or whose queries all precede the tile,
    // sees none of it (uniform across the warp)
    if (warp_live && kb <= wq_hi) {
      const bf16* ks = k_s + (it % 2) * BK * LDS;
      const bf16* vs = v_s + (it % 2) * BK * LDS;
      float s[BK / 8][4];
      mma_abt_frag<D, BK / 16, LDS>(s, qa, ks, lane);
      // kv_len >= k_hi, so only the block's key range and the diagonal
      // can cut a tile
      const bool edge = kb + BK > k_hi || kb + BK - 1 > wq_lo;
      uint32_t pa[BK / 16][4];
      softmax_tile<BK / 8, D / 8>(
          s, m, l, acc, pa, scale, edge, [&](int i, int col) {
            const int k_pos = kb + col;
            return k_pos < k_hi && k_pos <= q_pos[i] && k_pos < kv_len;
          });
      mma_ab<D, BK / 16, LDS>(acc, pa, vs, lane);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int f = wf0 + g + 8 * i;
    if (f >= n_flat) continue;
    const int qi = f / G, head = h * G + f % G;
    if (n_splits == 1) {
      const float denom = fmaxf(l[i], 1e-30f);
      bf16* o = out + (((size_t)r * Q + qi) * H + head) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + n * 8) =
            pack_bf16(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    } else {
      const size_t at = (((size_t)r * n_splits + split) * Q + qi) * H + head;
      float* o = part_o + at * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(part_ml + at * 2) = make_float2(m[i], l[i]);
    }
  }
}

// Pass 2 (both dtypes). grid = (H, Q, R), block = D threads: thread d
// merges dim d of one (row, query position, head) over the splits that
// hold keys of that query, in page order (m = max m_s, l = sum l_s
// exp(m_s - m), acc likewise). A query whose keys lie in one split gets
// acc / max(l, 1e-30), the expression pass 1 writes when a call is not
// split. Padding positions (i >= q_lens[r]) get 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
rpa_merge_kernel(const float* __restrict__ part_o,
                 const float* __restrict__ part_ml,
                 const int* __restrict__ starts,
                 const int* __restrict__ q_lens, T* __restrict__ out,
                 int Q, int H, int page_size, int max_pages, int n_splits,
                 int split_pages) {
  const int head = blockIdx.x, qi = blockIdx.y, r = blockIdx.z;
  const int d = threadIdx.x;
  const int cap = max_pages * page_size;
  const int span = split_pages * page_size;
  T* o = out + (((size_t)r * Q + qi) * H + head) * D + d;
  if (qi >= min(max(q_lens[r], 0), Q)) {
    store_out(o, 0.f);
    return;
  }
  // keys this query sees lie below row_keys; a split holds some of them
  // iff it starts below row_keys, and pass 1 wrote every such split
  const int row_keys = min(starts[r] + qi + 1, cap);
  const int n_used = (row_keys + span - 1) / span;
  const size_t row = (size_t)r * n_splits;
  if (n_used == 1) {
    const size_t at = (row * Q + qi) * H + head;
    store_out(o, part_o[at * D + d] / fmaxf(part_ml[at * 2 + 1], 1e-30f));
    return;
  }
  float m = kNegInf;
  for (int s = 0; s < n_used; ++s)
    m = fmaxf(m, part_ml[(((row + s) * Q + qi) * H + head) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_used; ++s) {
    const size_t at = ((row + s) * Q + qi) * H + head;
    const float w = expf(part_ml[at * 2] - m);
    l += part_ml[at * 2 + 1] * w;
    acc += part_o[at * D + d] * w;
  }
  store_out(o, acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
cudaError_t launch_merge(const void* part_o, const void* part_ml,
                         const void* starts, const void* q_lens, void* out,
                         int R, int Q, int H, int page_size, int max_pages,
                         int n_splits, int split_pages,
                         cudaStream_t stream) {
  dim3 grid2(H, Q, R);
  rpa_merge_kernel<T, D><<<grid2, D, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int*>(starts), static_cast<const int*>(q_lens),
      static_cast<T*>(out), Q, H, page_size, max_pages, n_splits,
      split_pages);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k_pages,
                       const void* v_pages, const void* block_tables,
                       const void* starts, const void* q_lens, void* part_o,
                       void* part_ml, void* out, int R, int Q, int H,
                       int KVH, int page_size, int max_pages, int n_splits,
                       int split_pages, float scale, cudaStream_t stream) {
  using C = RpaF32Cfg<D>;
  // not a stream operation: legal while the stream is being captured
  cudaError_t e = allow_smem(rpa_kernel_f32<D>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid1(KVH * n_splits, (Q * (H / KVH) + kRows - 1) / kRows, R);
  rpa_kernel_f32<D><<<grid1, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(starts),
      static_cast<const int*>(q_lens), static_cast<float*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), Q, H, KVH,
      page_size, max_pages, n_splits, split_pages, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return e;
  return launch_merge<float, D>(part_o, part_ml, starts, q_lens, out, R, Q,
                                H, page_size, max_pages, n_splits,
                                split_pages, stream);
}

template <int D, int NW>
cudaError_t launch_mma_nw(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_tables,
                          const void* starts, const void* q_lens,
                          void* part_o, void* part_ml, void* out, int R,
                          int Q, int H, int KVH, int page_size,
                          int max_pages, int n_splits, int split_pages,
                          float scale, cudaStream_t stream) {
  using C = RpaMmaCfg<D, NW>;
  const int tiles = (Q * (H / KVH) + C::ROWS - 1) / C::ROWS;
  // not a stream operation: legal while the stream is being captured
  cudaError_t e = allow_smem(rpa_kernel_mma<D, NW>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid1(KVH * n_splits, tiles, R);
  rpa_kernel_mma<D, NW><<<grid1, C::NT, C::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(starts),
      static_cast<const int*>(q_lens), static_cast<bf16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), Q, H, KVH,
      page_size, max_pages, n_splits, split_pages, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return e;
  return launch_merge<bf16, D>(part_o, part_ml, starts, q_lens, out, R, Q,
                               H, page_size, max_pages, n_splits,
                               split_pages, stream);
}

// Warps per pass-1 block: 1, 2 or 4 (the wrapper picks them from the flat
// rows of one (row, kv head): rows_per_block in
// ray_tpu_torch/ops/ragged_paged_attention.py).
template <int D>
cudaError_t launch_mma(const void* q, const void* k_pages,
                       const void* v_pages, const void* block_tables,
                       const void* starts, const void* q_lens, void* part_o,
                       void* part_ml, void* out, int R, int Q, int H,
                       int KVH, int page_size, int max_pages, int n_splits,
                       int split_pages, int warps, float scale,
                       cudaStream_t stream) {
#define RPA_NW(NW)                                                          \
  return launch_mma_nw<D, NW>(q, k_pages, v_pages, block_tables, starts,    \
                              q_lens, part_o, part_ml, out, R, Q, H, KVH,   \
                              page_size, max_pages, n_splits, split_pages,  \
                              scale, stream)
  switch (warps) {
    case 1: RPA_NW(1);
    case 2: RPA_NW(2);
    case 4: RPA_NW(4);
    default: return cudaErrorInvalidValue;
  }
#undef RPA_NW
}

}  // namespace

// dtype: 0 = float32 (warps must be 1), 1 = bfloat16. head_dim: 64 or
// 128. part_o / part_ml: f32 scratch [R, n_splits, Q, H, D] and
// [R, n_splits, Q, H, 2], read only when n_splits > 1; split s holds keys
// [s, s + 1) * split_pages * page_size, and n_splits * split_pages must
// cover max_pages. warps: per bf16 pass-1 block, 1, 2 or 4.
extern "C" int rpa_forward(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* starts, const void* q_lens,
                           void* part_o, void* part_ml, void* out, int R,
                           int Q, int H, int KVH, int D, int page_size,
                           int max_pages, int n_splits, int split_pages,
                           int warps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 65535 || Q > 65535 || n_splits < 1 || split_pages < 1 ||
      (n_splits > 1 && (long long)n_splits * split_pages < max_pages) ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && warps == 1) {
#define RPA_F32(DIM)                                                         \
  return (int)launch_f32<DIM>(q, k_pages, v_pages, block_tables, starts,    \
                              q_lens, part_o, part_ml, out, R, Q, H, KVH,   \
                              page_size, max_pages, n_splits, split_pages,   \
                              scale, s)
    if (D == 64) RPA_F32(64);
    RPA_F32(128);
#undef RPA_F32
  }
#define RPA_MMA(DIM)                                                         \
  return (int)launch_mma<DIM>(q, k_pages, v_pages, block_tables, starts,    \
                              q_lens, part_o, part_ml, out, R, Q, H, KVH,   \
                              page_size, max_pages, n_splits, split_pages,   \
                              warps, scale, s)
  if (dtype == 1 && D == 64) RPA_MMA(64);
  if (dtype == 1 && D == 128) RPA_MMA(128);
#undef RPA_MMA
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per pass-1 block: dtype 0 the f32 kernel (nw
// ignored), 1 the bf16 kernel with nw warps, at head_dim D; -1 for what
// is not built.
extern "C" int rpa_smem_bytes(int dtype, int nw, int D) {
  if (D != 64 && D != 128) return -1;
  const bool d64 = D == 64;
  if (dtype == 0)
    return d64 ? RpaF32Cfg<64>::kSmemBytes : RpaF32Cfg<128>::kSmemBytes;
  if (dtype != 1) return -1;
  switch (nw) {
    case 1:
      return d64 ? RpaMmaCfg<64, 1>::kSmemBytes : RpaMmaCfg<128, 1>::kSmemBytes;
    case 2:
      return d64 ? RpaMmaCfg<64, 2>::kSmemBytes : RpaMmaCfg<128, 2>::kSmemBytes;
    case 4:
      return d64 ? RpaMmaCfg<64, 4>::kSmemBytes : RpaMmaCfg<128, 4>::kSmemBytes;
    default:
      return -1;
  }
}
