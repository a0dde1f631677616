// Decode-only paged attention for Hopper (sm_90a): split-KV over fixed runs
// of whole pages, a ring of cp.async stages, and the merge in the same
// launch.
//
// Replaces the TPU kernel `_paged_decode_kernel` of
// ray_tpu/ops/paged_attention.py (Pallas). It computes the same function,
// written from what that kernel computes rather than block by block:
//
//   row b's query q[b] [H, D] attends positions < lengths[b] of the row's
//   pages (through block_table[b]); query head `head` attends kv head
//   head / G (G = H / KVH, no K/V repeat); softmax streams over the live
//   keys in f32 (m, l, acc); in bf16 the unnormalised p is rounded to V's
//   dtype before p.V, as the reference rounds it; the output is
//   acc / max(l, 1e-30) in q's dtype, so a row of length 0 gives exact 0.
//
// What bounds it on this card: the bytes of the live K/V pages. A decode
// step does 4 * D FLOPs per key and query head and moves 2 * D * elt bytes
// per key and kv head: with G = 4 (Llama-3-8B) that is 4 FLOPs a byte in
// bf16 and 2 in f32, far below the ridge of the CUDA cores' f32 rate
// (67e12 / 3.35e12 = 20 FLOPs a byte), so CUDA cores keep up with the
// bytes and the design is about keeping enough loads in flight on all
// 132 SMs.
//
// The split rule (batch-invariant): a row's keys are cut into splits of
// split_pages whole pages (SPLIT_KEYS = 128 keys: 8 pages of 16), split s
// holding keys [s * span, (s + 1) * span), span = split_pages * page_size,
// and the wrapper launches ceil(table width / split_pages) of them. Which
// keys a split holds depends only on the page index and the page size:
// never on the batch, the other rows' lengths or the table width, so a
// row's output has the same bits alone and in any batch, and at any table
// width that covers it (the Pallas kernel walks a row's pages in order,
// whatever else is in the call). The first design sized its splits from
// the call's longest row (an atomicMax prologue in every block of both
// passes) and chose their count from the batch and the SM count, so a
// row's bits changed with its neighbours.
//
// One launch, grid (split, kv head x row tile, row), 128 threads:
//   * a block takes up to four query heads of one kv head (one per warp;
//     G = 4 at Llama-3-8B, larger groups take ceil(G / 4) row tiles) and
//     one split of one row; a split that starts past the row's live keys
//     returns at once;
//   * K/V move in stages of 32 keys gathered through the block table by
//     16-byte cp.async.cg into a ring of kStages (3) slots of shared
//     memory: the block's first two stages are in flight before it reads
//     q, and each stage it computes is replaced by the one three on, so
//     at the 8B shape a 128-key split has all of its K/V requested by its
//     second stage; keys past the split's end are zero-filled and never
//     addressed, and block-table entries past a row's live pages are never
//     read (table tails may name stale or poisoned pages);
//   * lane j of each warp scores key j of the stage with 16-byte reads of
//     its K row (rows padded by 16 bytes, so the reads do not conflict)
//     and of the warp's query (a broadcast); the warp reduces max and sum
//     with shuffles; each lane accumulates P.V for its D / 32 output dims;
//   * a row whose live keys fit in one split is written by that block:
//     acc / max(l, 1e-30). Otherwise each block writes its split's
//     unnormalised (m, l, acc) to f32 scratch [B, n_splits, H] (+ D),
//     then counts itself in an arrival counter of its (row, kv head
//     tile); the last block to arrive merges the row's splits in split
//     order (m = max m_s, l = sum l_s exp(m_s - m), acc likewise). The
//     order is fixed, so two launches give the same bits whichever block
//     arrives last. The counters belong to one call: the wrapper takes
//     them from the caching allocator and pda_forward zeroes them on the
//     launch stream before the kernel (a memset node under capture), so
//     two launches that run at once never share them. Merging in the last
//     block beat a second launch for the merge at every timed shape on
//     the H100.
//
// Products and sums on CUDA cores in f32.
//
// C interface (bound with ctypes, see ray_tpu_torch/ops/_build.py):
// pda_forward launches on `stream` and returns cudaGetLastError() after
// each launch (or the error of setting the dynamic shared-memory size),
// or cudaErrorInvalidValue for a dtype/head_dim it was not built for, a
// split count that does not cover the table or a grid it cannot launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // cp.async wrappers, kNegInf, kFull, allow_smem

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps;    // query heads per block: one per warp
constexpr int kKeyTile = 32;     // keys per stage: one per lane
constexpr int kStages = 3;       // stages of the cp.async ring

// Element access by 32-bit words: a word holds one f32 or two bf16.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float to_float(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
};

template <>
struct Elem<bf16> {
  static constexpr int kPerWord = 2;
  __device__ static float to_float(bf16 x) { return __bfloat162float(x); }
  // p rounded to V's dtype before p.V, where the reference rounds it
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  // a bf16 is the top half of an f32: element 0 is the word's low half
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// N consecutive 32-bit words of shared memory in one load (N = 1, 2, 4;
// p aligned to 4 N bytes)
template <int N>
__device__ __forceinline__ void lds_words(uint32_t (&w)[N],
                                          const uint32_t* p) {
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

template <typename T, int D>
struct PdaCfg {
  static constexpr int KW = D * (int)sizeof(T) / 4;  // words per K/V row
  static constexpr int KLD = KW + 4;  // K row stride in words (+16 bytes)
  static constexpr int kStage = kKeyTile * (KLD + KW);  // words: K then V
  static constexpr int kSmemBytes = (kRows * D + kStages * kStage) * 4;
};

// Live keys of a row: lengths[b] clamped to the table's capacity (the
// reference attends the whole table when a length exceeds it).
__device__ __forceinline__ int live_keys(int len, int page_size,
                                         int max_pages) {
  return min(max(len, 0), max_pages * page_size);
}

// Merge one query head's n_used splits (row b), in split order, and write
// its output; lane owns dims [lane * DPL, lane * DPL + DPL). The splits
// were written by other blocks: read through L2 (ld.cg), never a stale L1.
template <typename T, int D>
__device__ __forceinline__ void merge_splits(const float* part_o,
                                             const float* part_ml, T* out,
                                             int b, int H, int head,
                                             int n_splits, int n_used,
                                             int lane) {
  constexpr int DPL = D / 32;
  const size_t row = (size_t)b * n_splits;
  float m = kNegInf;
  for (int s = 0; s < n_used; ++s)
    m = fmaxf(m, __ldcg(part_ml + ((row + s) * H + head) * 2));
  float l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_used; ++s) {
    const size_t at = (row + s) * H + head;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + at);
    const float w = expf(ml.x - m);
    l += ml.y * w;
    const float* o = part_o + at * D + lane * DPL;
    float v[DPL];
    if constexpr (DPL == 4) {
      const float4 v4 = __ldcg(reinterpret_cast<const float4*>(o));
      v[0] = v4.x;
      v[1] = v4.y;
      v[2] = v4.z;
      v[3] = v4.w;
    } else {
      const float2 v2 = __ldcg(reinterpret_cast<const float2*>(o));
      v[0] = v2.x;
      v[1] = v2.y;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] += v[e] * w;
  }
  const float denom = fmaxf(l, 1e-30f);
  T* dst = out + ((size_t)b * H + head) * D + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e) store_out(dst + e, acc[e] / denom);
}

// q, out: [B, H, D]; k_pages, v_pages: [P, page_size, KVH, D];
// block_table: [B, max_pages] int32; lengths: [B] int32.
// part_o: [B, n_splits, H, D] f32; part_ml: [B, n_splits, H, 2] f32;
// counters: [B, KVH * ceil(G / kRows)] int32, zero at launch.
// grid = (n_splits, KVH * ceil(G / kRows), B), block = kThreads, dynamic
// shared memory PdaCfg<T, D>::kSmemBytes.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
pda_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
           const T* __restrict__ v_pages, const int* __restrict__ block_table,
           const int* __restrict__ lengths, float* __restrict__ part_o,
           float* __restrict__ part_ml, int* __restrict__ counters,
           T* __restrict__ out, int H, int KVH, int page_size, int max_pages,
           int n_splits, int split_pages, float scale) {
  using E = Elem<T>;
  using C = PdaCfg<T, D>;
  constexpr int PW = E::kPerWord;
  constexpr int KW = C::KW, KLD = C::KLD;
  constexpr int VPR = KW / 4;       // 16-byte vectors per K/V row
  constexpr int DPL = D / 32;       // output dims per lane
  constexpr int WPL = DPL / PW;     // V words per lane
  constexpr int kCopies = kKeyTile * VPR / kThreads;  // per thread, stage
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  static_assert(kKeyTile * VPR % kThreads == 0, "stage split");
  extern __shared__ __align__(16) uint32_t smem_w[];
  float* q_s = reinterpret_cast<float*>(smem_w);  // [kRows][D]
  uint32_t* ring = smem_w + kRows * D;  // kStages x {K [32][KLD], V [32][KW]}
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int G = H / KVH;
  const int row_tiles = (G + kRows - 1) / kRows;
  const int h = blockIdx.y / row_tiles;
  const int g0 = (blockIdx.y % row_tiles) * kRows;  // first head of the tile
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = g0 + warp < G;  // this warp's query head exists
  const int head = h * G + g0 + warp;

  const int n_live = live_keys(lengths[b], page_size, max_pages);
  const int span = split_pages * page_size;
  const int n_used = (n_live + span - 1) / span;  // splits holding keys
  const int k_lo = split * span;
  const int k_hi = min(k_lo + span, n_live);
  if (k_lo >= k_hi) {  // uniform
    // a row with no live key is written 0 by its first split's block
    if (n_used == 0 && split == 0 && active) {
      T* dst = out + ((size_t)b * H + head) * D + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) store_out(dst + e, 0.f);
    }
    return;
  }
  const int n_tiles = (k_hi - k_lo + kKeyTile - 1) / kKeyTile;

  // Stage s of this split into ring slot s % kStages: each key's page from
  // the block table; keys >= k_hi are zero-filled and never addressed.
  const int* bt_row = block_table + (size_t)b * max_pages;
  auto stage = [&](int s) {
    const int kb = k_lo + s * kKeyTile;
    uint32_t* ks = ring + (s % kStages) * C::kStage;
    uint32_t* vs = ks + kKeyTile * KLD;
#pragma unroll
    for (int it = 0; it < kCopies; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int j = idx / VPR, c = idx - j * VPR;
      const int key = kb + j;
      const bool ok = key < k_hi;
      size_t off = 0;  // in elements
      if (ok) {
        const int pid = bt_row[key / page_size];
        off = (((size_t)pid * page_size + key % page_size) * KVH + h) * D +
              c * (16 / (int)sizeof(T));
      }
      cp_async16(smem_addr(ks + j * KLD + c * 4), k_pages + off, ok);
      cp_async16(smem_addr(vs + j * KW + c * 4), v_pages + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s);
    cp_async_commit();
  }

  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int k = idx / D, d = idx % D;
    const int g = g0 + k;
    q_s[idx] = g < G ? E::to_float(q[((size_t)b * H + h * G + g) * D + d])
                     : 0.f;
  }

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // refill the slot stage t - 1 used (every warp left it at the barrier
    // that ended the last iteration)
    if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of stage t landed
    __syncthreads();               // everyone's; q_s staged
    if (active) {                  // uniform across the warp
      const int kb = k_lo + t * kKeyTile;
      const int nt = min(kKeyTile, k_hi - kb);
      const uint32_t* ks = ring + (t % kStages) * C::kStage;
      const uint32_t* vs = ks + kKeyTile * KLD;
      // lane j scores key kb + j
      const bool keep = lane < nt;
      float s = kNegInf;
      if (keep) {
        const uint4* kr = reinterpret_cast<const uint4*>(ks + lane * KLD);
        const float4* qr = reinterpret_cast<const float4*>(q_s + warp * D);
        float dot[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < VPR; ++c) {
          const uint4 kv = kr[c];
          const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
          float kf[4 * PW];
#pragma unroll
          for (int i = 0; i < 4; ++i) E::unpack(kw[i], kf + i * PW);
#pragma unroll
          for (int i = 0; i < PW; ++i) {
            const float4 qv = qr[c * PW + i];
            float& dd = dot[c & 1];
            dd = fmaf(qv.x, kf[4 * i], dd);
            dd = fmaf(qv.y, kf[4 * i + 1], dd);
            dd = fmaf(qv.z, kf[4 * i + 2], dd);
            dd = fmaf(qv.w, kf[4 * i + 3], dd);
          }
        }
        s = (dot[0] + dot[1]) * scale;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float p = keep ? expf(s - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(p);
      m = m_new;
      const float pv = E::round(p);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] *= alpha;
      // keys past the stage's end are zero-filled and their p is 0: they
      // add exactly nothing, and a fixed trip count lets the shuffles and
      // reads of all 32 keys overlap
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        const float pj = __shfl_sync(kFull, pv, j);
        uint32_t vw[WPL];
        lds_words<WPL>(vw, vs + j * KW + lane * WPL);
#pragma unroll
        for (int ww = 0; ww < WPL; ++ww) {
          float vf[PW];
          E::unpack(vw[ww], vf);
#pragma unroll
          for (int e = 0; e < PW; ++e)
            acc[ww * PW + e] = fmaf(pj, vf[e], acc[ww * PW + e]);
        }
      }
    }
    __syncthreads();  // this slot is refilled at the next iteration
  }
  cp_async_wait<0>();

  if (n_used == 1) {  // uniform: this block holds all of the row's keys
    if (active) {
      const float denom = fmaxf(l, 1e-30f);
      T* dst = out + ((size_t)b * H + head) * D + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) store_out(dst + e, acc[e] / denom);
    }
    return;
  }
  if (active) {
    const size_t at = ((size_t)b * n_splits + split) * H + head;
    float* o = part_o + at * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = acc[e];
    if (lane == 0)
      *reinterpret_cast<float2*>(part_ml + at * 2) = make_float2(m, l);
  }
  // the last of the row's used splits to arrive merges them all
  __threadfence();  // this block's partials are visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = counters + (size_t)b * gridDim.y + blockIdx.y;
    s_last = atomicAdd(counter, 1) == n_used - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (active)
    merge_splits<T, D>(part_o, part_ml, out, b, H, head, n_splits, n_used,
                       lane);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* lengths,
                   void* part_o, void* part_ml, void* counters, void* out,
                   int B, int H, int KVH, int page_size, int max_pages,
                   int n_splits, int split_pages, float scale,
                   cudaStream_t stream) {
  using C = PdaCfg<T, D>;
  // not a stream operation: legal while the stream is being captured
  cudaError_t e = allow_smem(pda_kernel<T, D>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  const int tiles = KVH * ((H / KVH + kRows - 1) / kRows);
  e = cudaMemsetAsync(counters, 0, sizeof(int) * (size_t)B * tiles, stream);
  if (e != cudaSuccess) return e;
  dim3 grid1(n_splits, tiles, B);
  pda_kernel<T, D><<<grid1, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), static_cast<int*>(counters),
      static_cast<T*>(out), H, KVH, page_size, max_pages, n_splits,
      split_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. Split s holds
// keys [s, s + 1) * split_pages * page_size; n_splits * split_pages must
// cover max_pages. counters: int32 [B * KVH * ceil(H / KVH / 4)], this
// call's own; zeroed here on `stream` before the kernel.
extern "C" int pda_forward(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* block_table,
                           const void* lengths, void* part_o, void* part_ml,
                           void* counters, void* out, int B, int H, int KVH,
                           int D, int page_size, int max_pages, int n_splits,
                           int split_pages, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (long long)KVH * ((H / KVH + kRows - 1) / kRows);
  if (B > 65535 || tiles > 65535 || n_splits < 1 || split_pages < 1 ||
      (long long)n_splits * split_pages < max_pages)
    return (int)cudaErrorInvalidValue;
#define PDA_CASE(T, DIM)                                                  \
  return (int)launch<T, DIM>(q, k_pages, v_pages, block_table, lengths,  \
                             part_o, part_ml, counters, out, B, H, KVH,  \
                             page_size, max_pages, n_splits, split_pages, \
                             scale, s)
  if (dtype == 0 && D == 64) PDA_CASE(float, 64);
  if (dtype == 0 && D == 128) PDA_CASE(float, 128);
  if (dtype == 1 && D == 64) PDA_CASE(bf16, 64);
  if (dtype == 1 && D == 128) PDA_CASE(bf16, 128);
#undef PDA_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block (dtype 0 = float32, 1 = bfloat16), at
// head_dim D; -1 for what is not built.
extern "C" int pda_smem_bytes(int dtype, int D) {
  if (dtype == 0 && D == 64) return PdaCfg<float, 64>::kSmemBytes;
  if (dtype == 0 && D == 128) return PdaCfg<float, 128>::kSmemBytes;
  if (dtype == 1 && D == 64) return PdaCfg<bf16, 64>::kSmemBytes;
  if (dtype == 1 && D == 128) return PdaCfg<bf16, 128>::kSmemBytes;
  return -1;
}
