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
// f32 (ragged_paged_attention_kernel): the first design, kept because
// tensor cores in f32 would mean TF32, three decimal digits, far from the
// f32 reference: a warp owns up to kRowsPerWarp flat rows with m, l and
// acc in registers; for a tile of 32 keys staged in shared memory by
// 16-byte loads (the next tile's loads in flight while the current one is
// computed), lane j scores key j (odd word stride: 32 banks), the warp
// reduces max and sum with shuffles, and each lane accumulates P.V for its
// D/32 output dims. Products and sums on CUDA cores in f32; no split-KV.
//
// C interface (bound with ctypes, see ray_tpu_torch/ops/_build.py):
// rpa_forward launches the pass(es) on `stream` and returns
// cudaGetLastError() after each launch (or the error of setting the
// dynamic shared-memory size), and cudaErrorInvalidValue for a
// dtype/head_dim it was not built for or a split count the dtype does
// not take (f32: 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // PTX helpers, tile products, softmax_tile

namespace {

// the f32 kernel's layout
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeyTile = 32;                  // keys per tile: one per lane

// Element access by 32-bit words (the f32 kernel: one f32 a word).
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
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

// ---------------------------------------------------------------------------
// f32 on CUDA cores
// ---------------------------------------------------------------------------

// q, out: [R, Q, H, D]; k_pages, v_pages: [P, page_size, KVH, D];
// block_tables: [R, max_pages] int32; starts, q_lens: [R] int32.
// grid = (ceil(Q * G / kRows), KVH, R), block = kWarps * 32 threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ starts,
                              const int* __restrict__ q_lens,
                              T* __restrict__ out, int Q, int H, int KVH,
                              int page_size, int max_pages, float scale) {
  using E = Elem<T>;
  constexpr int PW = E::kPerWord;
  constexpr int DW = D / PW;      // words per K/V row
  constexpr int DPL = D / 32;     // output dims per lane
  constexpr int WPL = DPL / PW;   // V words per lane
  constexpr int VPR = DW / 4;      // 16-byte vectors per K/V row
  constexpr int kLoads = kKeyTile * VPR / kThreads;  // per thread per tile
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  static_assert(kKeyTile * VPR % kThreads == 0, "tile split");

  __shared__ float q_s[kRows][D];
  __shared__ uint32_t k_s[kKeyTile][DW + 1];  // odd stride: lane j -> bank j
  __shared__ __align__(16) uint32_t v_s[kKeyTile][DW];

  const int r = blockIdx.z;
  const int h = blockIdx.y;
  const int G = H / KVH;
  const int n_flat = Q * G;              // flat row f = i * G + g
  const int flat0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int start = starts[r];
  const int q_len = min(max(q_lens[r], 0), Q);
  const int kv_len = start + q_len;      // positions < kv_len are live

  // keys this block needs: up to its last REAL query position
  const int i_lo = flat0 / G;
  const int i_hi = min((min(flat0 + kRows, n_flat) - 1) / G, q_len - 1);
  int n_keys = i_hi >= i_lo ? start + i_hi + 1 : 0;
  n_keys = min(n_keys, max_pages * page_size);

  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int k = idx / D, d = idx % D;
    const int f = flat0 + k;
    float val = 0.f;
    if (f < n_flat) {
      const int i = f / G, head = h * G + f % G;
      val = E::to_float(q[((size_t)(r * Q + i) * H + head) * D + d]);
    }
    q_s[k][d] = val;
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

  const uint4* k_vec = reinterpret_cast<const uint4*>(k_pages);
  const uint4* v_vec = reinterpret_cast<const uint4*>(v_pages);
  const int* bt_row = block_tables + (size_t)r * max_pages;

  // A key tile moves as kLoads independent 16-byte loads of K and of V
  // per thread, all started before any is used; the next tile's loads
  // start right after the current tile is in shared memory, so they are
  // in flight while the current tile is computed. Only keys < n_keys are
  // touched, so only live block-table entries are read.
  uint4 k_reg[kLoads], v_reg[kLoads];
  auto load_tile = [&](int kb) {
    const int nt = min(kKeyTile, n_keys - kb);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int j = idx / VPR, c = idx % VPR;
      if (j < nt) {
        const int key = kb + j;
        const int pid = bt_row[key / page_size];
        const size_t off =
            (((size_t)pid * page_size + key % page_size) * KVH + h) * VPR + c;
        k_reg[i] = k_vec[off];
        v_reg[i] = v_vec[off];
      }
    }
  };

  if (n_keys > 0) load_tile(0);
  for (int kb = 0; kb < n_keys; kb += kKeyTile) {
    const int nt = min(kKeyTile, n_keys - kb);
    __syncthreads();  // q_s staged / previous tile consumed
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int j = idx / VPR, c = idx % VPR;
      if (j < nt) {
        uint32_t* kd = &k_s[j][c * 4];
        kd[0] = k_reg[i].x;
        kd[1] = k_reg[i].y;
        kd[2] = k_reg[i].z;
        kd[3] = k_reg[i].w;
        *reinterpret_cast<uint4*>(&v_s[j][c * 4]) = v_reg[i];
      }
    }
    __syncthreads();
    if (kb + kKeyTile < n_keys) load_tile(kb + kKeyTile);

    const int k_pos = kb + lane;
#pragma unroll
    for (int jr = 0; jr < kRowsPerWarp; ++jr) {
      if (!active[jr]) continue;         // uniform across the warp
      const float* qr = q_s[warp + jr * kWarps];
      const bool keep = lane < nt && k_pos <= q_pos[jr] && k_pos < kv_len;
      float s = kNegInf;
      if (keep) {
        float dot = 0.f;
#pragma unroll 8
        for (int w = 0; w < DW; ++w) {
          float kf[PW];
          E::unpack(k_s[lane][w], kf);
#pragma unroll
          for (int e = 0; e < PW; ++e) dot += qr[w * PW + e] * kf[e];
        }
        s = dot * scale;
      }
      const float m_new = fmaxf(m[jr], warp_max(s));
      const float p = keep ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[jr] - m_new);
      l[jr] = l[jr] * alpha + warp_sum(p);
      m[jr] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[jr][e] *= alpha;
      for (int j = 0; j < nt; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int ww = 0; ww < WPL; ++ww) {
          float vf[PW];
          E::unpack(v_s[j][lane * WPL + ww], vf);
#pragma unroll
          for (int e = 0; e < PW; ++e) acc[jr][ww * PW + e] += pj * vf[e];
        }
      }
    }
  }

#pragma unroll
  for (int jr = 0; jr < kRowsPerWarp; ++jr) {
    if (!active[jr]) continue;
    const int f = flat0 + warp + jr * kWarps;
    const int i = f / G, head = h * G + f % G;
    const float denom = fmaxf(l[jr], 1e-30f);
    T* o = out + ((size_t)(r * Q + i) * H + head) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = E::from_float(acc[jr][e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch_f32(const void* q, const void* k_pages,
                       const void* v_pages, const void* block_tables,
                       const void* starts, const void* q_lens, void* out,
                       int R, int Q, int H, int KVH, int page_size,
                       int max_pages, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid((Q * G + kRows - 1) / kRows, KVH, R);
  ragged_paged_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(starts), static_cast<const int*>(q_lens),
      static_cast<T*>(out), Q, H, KVH, page_size, max_pages, scale);
  return cudaGetLastError();
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

// Pass 2. grid = (H, Q, R), block = D threads: thread d merges dim d of one
// (row, query position, head) over the splits that hold keys of that
// query, in page order (m = max m_s, l = sum l_s exp(m_s - m), acc
// likewise). A query whose keys lie in one split gets acc / max(l, 1e-30),
// the expression pass 1 writes when a call is not split. Padding
// positions (i >= q_lens[r]) get 0.
template <int D>
__global__ void __launch_bounds__(D)
rpa_merge_kernel(const float* __restrict__ part_o,
                 const float* __restrict__ part_ml,
                 const int* __restrict__ starts,
                 const int* __restrict__ q_lens, bf16* __restrict__ out,
                 int Q, int H, int page_size, int max_pages, int n_splits,
                 int split_pages) {
  const int head = blockIdx.x, qi = blockIdx.y, r = blockIdx.z;
  const int d = threadIdx.x;
  const int cap = max_pages * page_size;
  const int span = split_pages * page_size;
  bf16* o = out + (((size_t)r * Q + qi) * H + head) * D + d;
  if (qi >= min(max(q_lens[r], 0), Q)) {
    *o = __float2bfloat16(0.f);
    return;
  }
  // keys this query sees lie below row_keys; a split holds some of them
  // iff it starts below row_keys, and pass 1 wrote every such split
  const int row_keys = min(starts[r] + qi + 1, cap);
  const int n_used = (row_keys + span - 1) / span;
  const size_t row = (size_t)r * n_splits;
  if (n_used == 1) {
    const size_t at = (row * Q + qi) * H + head;
    *o = __float2bfloat16(part_o[at * D + d] /
                          fmaxf(part_ml[at * 2 + 1], 1e-30f));
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
  *o = __float2bfloat16(acc / fmaxf(l, 1e-30f));
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
  dim3 grid2(H, Q, R);
  rpa_merge_kernel<D><<<grid2, D, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int*>(starts), static_cast<const int*>(q_lens),
      static_cast<bf16*>(out), Q, H, page_size, max_pages, n_splits,
      split_pages);
  return cudaGetLastError();
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
  if (R > 65535 || Q > 65535 || n_splits < 1 || split_pages < 1 ||
      (n_splits > 1 && (long long)n_splits * split_pages < max_pages))
    return cudaErrorInvalidValue;
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

// dtype: 0 = float32 (n_splits and warps must be 1), 1 = bfloat16.
// head_dim: 64 or 128. part_o / part_ml: f32 scratch
// [R, n_splits, Q, H, D] and [R, n_splits, Q, H, 2], read only when
// n_splits > 1; split s holds keys [s, s + 1) * split_pages * page_size,
// and n_splits * split_pages must cover max_pages. warps: per bf16 pass-1
// block, 1, 2 or 4.
extern "C" int rpa_forward(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* starts, const void* q_lens,
                           void* part_o, void* part_ml, void* out, int R,
                           int Q, int H, int KVH, int D, int page_size,
                           int max_pages, int n_splits, int split_pages,
                           int warps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && n_splits == 1 && warps == 1 && (D == 64 || D == 128)) {
    return (int)(D == 64 ? launch_f32<float, 64>(
                               q, k_pages, v_pages, block_tables, starts,
                               q_lens, out, R, Q, H, KVH, page_size,
                               max_pages, scale, s)
                         : launch_f32<float, 128>(
                               q, k_pages, v_pages, block_tables, starts,
                               q_lens, out, R, Q, H, KVH, page_size,
                               max_pages, scale, s));
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

// Dynamic shared memory per pass-1 block of the bf16 kernel with nw warps
// at head_dim D; -1 for what is not built (the f32 kernel uses static
// shared memory only).
extern "C" int rpa_smem_bytes(int nw, int D) {
  if (D != 64 && D != 128) return -1;
  const bool d64 = D == 64;
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
