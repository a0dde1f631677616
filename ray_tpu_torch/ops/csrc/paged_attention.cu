// Decode-only paged attention for Hopper (sm_90a), split over the KV
// sequence ("split-KV") in two launches.
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
// What bounds it on this card: the bytes of the live K/V pages. One decode
// step does ~1 FLOP per byte of K/V it reads (4 * D FLOPs per key and
// query head, 2 * D * elt bytes per key and kv head, G = 4 query heads per
// kv head at Llama-3-8B), far below the H100's ~295 FLOP/B ridge.
//
// What the design does about that: reaching the HBM rate needs enough
// loads in flight on all 132 SMs, and a decode batch gives few blocks
// when each (row, kv head) walks its whole context alone (8 rows x 8 kv heads = 64
// blocks at 8B widths: the ragged kernel's decode case). So each row's
// live pages are cut into splits:
//   * pass 1, grid (split, kv head x row tile, row): a block takes up to
//     four query heads of one kv head (one per warp; G = 4 at Llama-3-8B,
//     and larger groups take ceil(G / 4) row tiles) and walks only its
//     split's share of that row's LIVE pages, in tiles of 32 keys staged
//     in shared memory with 16-byte loads (the next tile's loads in flight
//     while the current one is computed); every query head of the tile
//     reads K/V from there, so K/V leave device memory once per block. A
//     warp keeps m, l and acc of its head in f32 registers and writes them
//     to an f32 scratch
//     [B, n_splits, H, D] (+ [B, n_splits, H, 2] for m and l);
//   * pass 2, grid (head, row): merges the row's used splits
//     (m = max m_s, l = sum l_s exp(m_s - m), acc likewise) and writes out.
// The wrapper fixes the number of splits from the SM count and the table
// width, so that rows x kv heads x row tiles x splits give about four
// blocks per SM;
// on the device every block derives the pages per split from the LONGEST
// live length of the call (ceil(longest pages / n_splits)), so the
// longest row is spread over all splits, no host sync is needed, and a
// split never cuts a page. Blocks whose split starts past their row's
// live pages return at once, and pass 2 reads only the splits that hold
// keys.
//
// Never read: block-table entries past a row's live page count (table
// tails may be stale or name poisoned pages) and slots past lengths[b]
// inside the last live page. Keys are loaded only below lengths[b].
//
// Products and sums run on CUDA cores in f32; tensor-core tiles are later
// work (PERF.md has the times).
//
// C interface (bound with ctypes, see ray_tpu_torch/ops/_build.py):
// pda_forward launches both passes on `stream` and returns
// cudaGetLastError() after each launch, or cudaErrorInvalidValue for a
// dtype/head_dim it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps;                 // query heads per block: one
                                              // per warp
constexpr int kKeyTile = 32;                  // keys per tile: one per lane
constexpr float kNegInf = -1e30f;             // NEG_INF of the paged family
constexpr unsigned kFull = 0xffffffffu;

// Element access by 32-bit words: a word holds one f32 or two bf16.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  // p rounded to V's dtype before p.V, where the reference rounds it
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static void unpack(uint32_t w, float* out) {
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&w);
    float2 f = __bfloat1622float2(b);
    out[0] = f.x;
    out[1] = f.y;
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

// Live keys of a row: lengths[b] clamped to the table's capacity (the
// reference attends the whole table when a length exceeds it).
__device__ __forceinline__ int live_keys(int len, int page_size,
                                         int max_pages) {
  return min(max(len, 0), max_pages * page_size);
}

// Pages each split takes: ceil(longest live page count / n_splits), at
// least 1. Every block of both passes computes it from `lengths` alone.
__device__ int split_pages(const int* __restrict__ lengths, int B,
                           int page_size, int max_pages, int n_splits) {
  __shared__ int s_longest;
  if (threadIdx.x == 0) s_longest = 0;
  __syncthreads();
  int longest = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int n = live_keys(lengths[b], page_size, max_pages);
    longest = max(longest, (n + page_size - 1) / page_size);
  }
  atomicMax(&s_longest, longest);
  __syncthreads();
  return max(1, (s_longest + n_splits - 1) / n_splits);
}

// Pass 1. q, out: [B, H, D]; k_pages, v_pages: [P, page_size, KVH, D];
// block_table: [B, max_pages] int32; lengths: [B] int32.
// part_o: [B, n_splits, H, D] f32; part_ml: [B, n_splits, H, 2] f32.
// grid = (n_splits, KVH * ceil(G / kRows), B), block = kThreads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ block_table,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_o,
                          float* __restrict__ part_ml, int B, int H, int KVH,
                          int page_size, int max_pages, int n_splits,
                          float scale) {
  using E = Elem<T>;
  constexpr int PW = E::kPerWord;
  constexpr int DW = D / PW;      // words per K/V row
  constexpr int DPL = D / 32;     // output dims per lane
  constexpr int WPL = DPL / PW;   // V words per lane
  constexpr int VPR = DW / 4;     // 16-byte vectors per K/V row
  constexpr int kLoads = kKeyTile * VPR / kThreads;  // per thread per tile
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  static_assert(kKeyTile * VPR % kThreads == 0, "tile split");

  __shared__ float q_s[kRows][D];
  __shared__ uint32_t k_s[kKeyTile][DW + 1];  // odd stride: lane j -> bank j
  __shared__ __align__(16) uint32_t v_s[kKeyTile][DW];

  const int split = blockIdx.x;
  const int G = H / KVH;
  const int row_tiles = (G + kRows - 1) / kRows;
  const int h = blockIdx.y / row_tiles;
  const int g0 = (blockIdx.y % row_tiles) * kRows;  // first head of the tile
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = g0 + warp < G;  // this warp's query head exists

  const int pps = split_pages(lengths, B, page_size, max_pages, n_splits);
  const int n_live = live_keys(lengths[b], page_size, max_pages);
  const int k_lo = split * pps * page_size;
  const int k_hi = min(k_lo + pps * page_size, n_live);
  if (k_lo >= k_hi) return;  // uniform: pass 2 reads only used splits

  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int k = idx / D, d = idx % D;
    const int g = g0 + k;
    q_s[k][d] = g < G ? E::to_float(q[((size_t)b * H + h * G + g) * D + d])
                      : 0.f;
  }

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  const uint4* k_vec = reinterpret_cast<const uint4*>(k_pages);
  const uint4* v_vec = reinterpret_cast<const uint4*>(v_pages);
  const int* bt_row = block_table + (size_t)b * max_pages;

  // A key tile moves as kLoads independent 16-byte loads of K and of V per
  // thread, all started before any is used; the next tile's loads start
  // right after the current tile is in shared memory. Only keys < k_hi
  // (<= lengths[b]) are touched, so only live table entries are read.
  uint4 k_reg[kLoads], v_reg[kLoads];
  auto load_tile = [&](int kb) {
    const int nt = min(kKeyTile, k_hi - kb);
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

  const float* qr = q_s[warp];
  load_tile(k_lo);
  for (int kb = k_lo; kb < k_hi; kb += kKeyTile) {
    const int nt = min(kKeyTile, k_hi - kb);
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
    if (kb + kKeyTile < k_hi) load_tile(kb + kKeyTile);
    if (!active) continue;  // uniform across the warp; it still stages

    // lane j scores key kb + j
    const bool keep = lane < nt;
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
    const float m_new = fmaxf(m, warp_max(s));
    const float p = keep ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
    m = m_new;
    const float pv = E::round(p);
    // lane owns output dims [lane * DPL, lane * DPL + DPL)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] *= alpha;
    for (int j = 0; j < nt; ++j) {
      const float pj = __shfl_sync(kFull, pv, j);
#pragma unroll
      for (int ww = 0; ww < WPL; ++ww) {
        float vf[PW];
        E::unpack(v_s[j][lane * WPL + ww], vf);
#pragma unroll
        for (int e = 0; e < PW; ++e) acc[ww * PW + e] += pj * vf[e];
      }
    }
  }

  if (!active) return;
  const int head = h * G + g0 + warp;
  const size_t at = ((size_t)b * n_splits + split) * H + head;
  float* o = part_o + at * D + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = acc[e];
  if (lane == 0) {
    part_ml[at * 2] = m;
    part_ml[at * 2 + 1] = l;
  }
}

// Pass 2. grid = (H, B), block = D threads: thread d merges dim d of one
// (row, head) over the splits that hold keys. A row with no live key
// merges nothing and writes 0 / 1e-30 = 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part_o,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, int B, int H, int page_size,
                          int max_pages, int n_splits) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int pps = split_pages(lengths, B, page_size, max_pages, n_splits);
  const int n_live = live_keys(lengths[b], page_size, max_pages);
  const int n_used = ((n_live + page_size - 1) / page_size + pps - 1) / pps;
  const size_t row = (size_t)b * n_splits;
  float m = kNegInf;
  for (int s = 0; s < n_used; ++s)
    m = fmaxf(m, part_ml[((row + s) * H + head) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_used; ++s) {
    const size_t at = (row + s) * H + head;
    const float w = expf(part_ml[at * 2] - m);
    l += part_ml[at * 2 + 1] * w;
    acc += part_o[at * D + d] * w;
  }
  out[((size_t)b * H + head) * D + d] =
      Elem<T>::from_float(acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* lengths,
                   void* part_o, void* part_ml, void* out, int B, int H,
                   int KVH, int page_size, int max_pages, int n_splits,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const int row_tiles = (G + kRows - 1) / kRows;
  dim3 grid1(n_splits, KVH * row_tiles, B);
  paged_decode_split_kernel<T, D><<<grid1, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), B, H, KVH, page_size, max_pages,
      n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2(H, B);
  paged_decode_merge_kernel<T, D><<<grid2, D, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), B, H,
      page_size, max_pages, n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128.
extern "C" int pda_forward(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* block_table,
                           const void* lengths, void* part_o, void* part_ml,
                           void* out, int B, int H, int KVH, int D,
                           int page_size, int max_pages, int n_splits,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PDA_CASE(T, DIM)                                                   \
  return (int)launch<T, DIM>(q, k_pages, v_pages, block_table, lengths,   \
                             part_o, part_ml, out, B, H, KVH, page_size,  \
                             max_pages, n_splits, scale, s)
  if (dtype == 0 && D == 64) PDA_CASE(float, 64);
  if (dtype == 0 && D == 128) PDA_CASE(float, 128);
  if (dtype == 1 && D == 64) PDA_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PDA_CASE(__nv_bfloat16, 128);
#undef PDA_CASE
  return (int)cudaErrorInvalidValue;
}
