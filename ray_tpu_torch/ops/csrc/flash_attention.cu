// Flash attention for Hopper (sm_90a): the forward, the dq and the dkv
// kernels of the training path, one source with three C entry points.
//
// Replaces the TPU kernels of ray_tpu/ops/flash_attention.py (Pallas):
//   flash_fwd  <- _fwd_kernel      (:66)  out and the f32 log-sum-exp
//   flash_dq   <- _bwd_dq_kernel   (:238) dq
//   flash_dkv  <- _bwd_dkv_kernel  (:294) dk and dv, per KV head
// They compute what those kernels compute, written from the function and
// not block by block:
//
//   s = (q . k) * scale, kept iff k_pos < Sk and (not causal or
//   q_pos >= k_pos), both positions counted from 0 (top-left causal
//   alignment, also when Sq != Sk); a masked score is the finite -1e30
//   and its probability is re-masked to exactly 0 after the exp.
//   forward: streaming softmax in f32 (m, l, acc); p is rounded to the
//     input dtype before p.V; out = acc / max(l, 1e-30) in the input
//     dtype, lse = m + log(max(l, 1e-30)) in f32.
//   dq:  p = exp(s - lse), dp = dO.V^T, ds = p (dp - delta) scale rounded
//        to the input dtype, dq = sum over keys of ds.K.
//   dkv: the same p and ds; dv = sum over queries of round(p).dO and
//        dk = sum of ds.Q, summed over the G query heads of the KV head.
//   delta = rowsum(dO * O) comes in from the caller, as in the reference.
//
// Layouts: q, dO, out, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, KVH, D]
// (read with strides, never transposed); lse, delta [B, H, Sq] f32.
// Query head h reads kv head h / (H / KVH): no K/V repeat.
//
// What bounds them on this card: at the Llama-3-8B training shape (causal,
// S 4096, D 128) the work is about 4 D (forward), 6 D (dq: q.k, dO.v,
// ds.K) and 8 D (dkv: k.q, v.dO, p^T.dO, ds^T.Q) FLOPs per visible
// (query, key) pair per head against a few bytes per pair, far above the
// H100's ~295 FLOP/B ridge: operations bound all three, so in bf16 only
// the tensor cores (989 TFLOP/s) can bring them near their bound.
//
// Shared by all three kernels:
//   * one block owns a (b, h, 64-query tile) for the forward and for dq
//     and loops over key tiles itself; one block owns a (b, kv head,
//     64-key tile) for dkv and loops over the q tiles AND the G query
//     heads of its kv head, so dk/dv come out per kv head with their f32
//     accumulators in registers (no [B, Sk, H, D] buffers, no group sum);
//     dq and dkv stay two passes, so both are deterministic (no atomics);
//   * causal: the key loop (forward, dq) stops at the tile's last query,
//     and the q loop (dkv) starts at the tile holding the first key, so
//     fully masked tiles are never visited;
//   * ragged lengths: the last tile is bound-checked (zero-staged rows,
//     masked scores); there are no padding copies.
//
// bf16 (flash_fwd_kernel_mma, flash_dq_kernel_mma, flash_dkv_kernel_mma):
// tensor cores and asynchronous copies, from the pieces in mma_sm90.cuh.
//   * every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//     operands read from shared memory by ldmatrix; the operands reduced
//     over their row index (V in p.V, K in ds.K, dO in p^T.dO, Q in
//     ds^T.Q) by ldmatrix.trans, so nothing is transposed in memory.
//     mma.sync and not wgmma: a warp owns 16 rows of S / dP and rewrites
//     their f32 accumulator fragment in registers as the bf16 A fragment
//     of the next product (p for the forward; ds for dq; p^T and ds^T for
//     dkv), which the m16n8k16 layouts make a pure register repack; that
//     bf16 conversion is the reference's .astype, so p and ds round where
//     they round there;
//   * Q, K, V and dO stay bf16 in shared memory, rows padded by 16 bytes
//     so that the 8 row addresses of an ldmatrix phase fall in 8 distinct
//     bank groups; they arrive by 16-byte cp.async.cg, rows past Sq / Sk
//     zero-filled through the src-size operand (never read), lse / delta
//     by 4-byte cp.async.ca; the next K/V tile (forward, dq) or
//     Q/dO/lse/delta tile (dkv) is copied while the current one computes
//     (two buffers);
//   * forward: 4 warps x 16 queries over 64-key tiles; each warp keeps its
//     Q tile as A fragments in registers for the whole key loop (D / 4 a
//     thread) and runs the streaming softmax on the f32 fragments of S:
//     row max and sum over the quad of lanes that share a row (shuffles
//     1 and 2; the sum only once, after the loop), the accumulator
//     rescaled in registers, exp as exp2 with scale * log2(e) folded in;
//     m stays in natural units, so lse = m + log(max(l, 1e-30)) is what
//     dq and dkv read (they multiply it by log2(e) themselves). Blocks
//     of 8 warps x 16 queries were slower at the 8B shape;
//   * dq: 4 warps x 16 queries, 64-key tiles; dkv: 4 warps x 16 keys,
//     32-query tiles (its dk and dv accumulators are 2 x D / 2 f32
//     registers a thread: 64-query tiles would spill at D 128); only
//     tiles that cross the diagonal or a ragged edge are masked;
//   * causal work differs by up to 64x between blocks: the tile index is
//     the grid's slowest dimension, the forward and dq walk it from the
//     last query tile and dkv from the first key tile, so the heaviest
//     blocks start first; a forward warp whose 16 queries all precede a
//     key tile skips it.
// The f32 instantiation (dtype 0) keeps CUDA-core kernels
// (flash_fwd_kernel_f32, flash_dq_kernel_f32, flash_dkv_kernel_f32):
// tensor cores in f32 would mean TF32, three decimal digits, far from the
// f32 reference. All three are built for Hopper's CUDA cores (their
// sections say how): 16-byte shared reads laid out per quarter-warp feed
// 4-8 FMAs a value, and the streamed operand (K / V for the forward and
// dq, Q / dO / lse / delta for dkv) arrives through a cp.async ring.
// Not done yet (later work): wgmma with TMA and mbarriers instead of
// mma.sync with cp.async (a warpgroup-wide product needs its accumulator
// rewritten through shared memory or the wgmma register-A form); a fused
// backward (dq by atomics or a split reduction).
//
// C interface (bound with ctypes, see ray_tpu_torch/ops/_build.py): each
// entry point returns cudaGetLastError() after its launch (or the error
// of setting the dynamic shared-memory size), and cudaErrorInvalidValue
// for a dtype/head_dim it was not built for. dtype: 0 = f32, 1 = bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"  // PTX helpers, tile products, softmax_tile

namespace {

// ---------------------------------------------------------------------------
// f32 dkv on CUDA cores: grid (KVH, B, ceil(Sk / BK)), first key tile first
// ---------------------------------------------------------------------------
//
// What bounds it: operations. Four products of D FMAs (8 D FLOPs) per
// visible (query, key) pair and query head, in f32 on CUDA cores (no
// TF32), against a few bytes per pair. An SM issues 4 warp-FMAs a clock;
// a warp's 16-byte shared read (LDS.128) holds the shared-memory pipe
// for two clocks at best, and lanes share a read only within their
// quarter-warp. So the design counts shared reads per FMA and lays the
// lanes out so that every read takes the fewest clocks.
//
// One block owns 64 keys of one (b, kv head) and walks the kv head's G
// query heads and their 32-query tiles in order. Its 256 threads are two
// warp groups of 128 that split every tile's four products between them:
//   group 0: S^T = K Q^T, P^T = exp(S^T scale - lse) (masked) to shared
//            memory, then dV += P^T dO;
//   group 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale to shared
//            memory, then dK += dS^T Q.
// Each thread of a group holds 4 keys x 4 queries of S^T (or dP^T): 8
// reads of 16 bytes feed 64 FMAs along D. It holds 8 keys x D / 16 dims
// of dV (or dK): 4 reads (D 128) feed 64 FMAs per query. Each
// quarter-warp reads 2 distinct key rows and 4 query rows (the lane map
// below), which keeps every read at its two clocks; lanes laid out in
// rows of 8 queries read 8 query rows a quarter and ran slower. Rows of
// K, V, Q and dO are padded by 16 bytes, and those of P^T and dS^T
// likewise, so the rows a quarter-warp reads fall in distinct bank
// groups. Q, dO, lse and delta arrive by cp.async in a ring of kStages
// tiles, each requested kStages - 1 tiles ahead. One barrier a tile both
// publishes the landed tile and frees the slot of the previous one, a
// second publishes P^T, and group 1 alone waits on a third (a named
// barrier) for its dS^T. The groups run in lockstep: a schedule that
// staggered them by half a tile (one group's D-long product beside the
// other's outer product, one barrier a half) was slower, and 64-query
// tiles (4 x 8 of S^T a thread, every row swizzled to fit) and 512
// threads (16 warps an SM) were no faster; PERF.md has the times.
template <int D>
struct DkvF32Cfg {
  static constexpr int NT = 256;     // two warp groups of 128
  static constexpr int BK = 64;      // keys per block
  static constexpr int BQ = 32;      // queries per tile
  static constexpr int kStages = 3;  // ring of Q / dO / lse / delta tiles
  static constexpr int LD = D + 4;   // K, V, Q, dO row stride in floats
  static constexpr int LDX = BK + 4; // P^T and dS^T stored [query][key]
  static constexpr int kStageFloats = 2 * BQ * LD + 2 * BQ;
  static constexpr int kSmemBytes =
      (2 * BK * LD + kStages * kStageFloats + 2 * BQ * LDX) * 4;
  static_assert(BK == 64 && BQ == 32 && NT == 256 && D % 64 == 0,
                "the thread layouts below assume these sizes");
};

// ROWS rows of D floats (row r at src + r * stride) into dst with row
// stride LD by 16-byte cp.async; rows >= valid are zero-filled and their
// source is never read (valid >= 1: row 0 stands in as the address).
template <int D, int ROWS, int NT, int LD>
__device__ __forceinline__ void cp_rows_f32(float* dst, const float* src,
                                            size_t stride, int valid) {
  constexpr int VPR = D / 4;
  static_assert(ROWS * VPR % NT == 0, "tile split");
#pragma unroll
  for (int it = 0; it < ROWS * VPR / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int r = idx / VPR, c = idx - r * VPR;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * LD + c * 4),
               src + (ok ? (size_t)r * stride : 0) + c * 4, ok);
  }
}

// s[i][j] = sum_d a[16 i * LD + d] * b[SB j * LD + d]: 4 rows of A 16
// apart against 4 rows of B SB apart, read 4 dims at a time.
template <int D, int LD, int SB = 8>
__device__ __forceinline__ void dot4x4(float (&s)[4][4], const float* a,
                                       const float* b) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * 16 * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + j * SB * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[e][n] += sum_{r < BQ} x[r * LDX + key(e)] * y[r * LD + dim(n)],
// key(e) = 32 (e / 4) + e % 4 and dim(n) = 64 (n / 4) + n % 4: 8 keys of
// P^T or dS^T against D / 16 dims of dO or Q, one query row at a time.
template <int D, int BQ, int LD, int LDX>
__device__ __forceinline__ void outer8(float (&acc)[8][D / 16],
                                       const float* x, const float* y) {
  constexpr int NC = D / 64;
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    const float4 x0 = *reinterpret_cast<const float4*>(x + r * LDX);
    const float4 x1 = *reinterpret_cast<const float4*>(x + r * LDX + 32);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float yv[4 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 u = *reinterpret_cast<const float4*>(y + r * LD + 64 * c);
      yv[4 * c] = u.x;
      yv[4 * c + 1] = u.y;
      yv[4 * c + 2] = u.z;
      yv[4 * c + 3] = u.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int n = 0; n < 4 * NC; ++n)
        acc[e][n] = fmaf(xv[e], yv[n], acc[e][n]);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvF32Cfg<D>::NT, 1)
flash_dkv_kernel_f32(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                     int causal, float scale) {
  using C = DkvF32Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LDX = C::LDX;
  constexpr int NT = C::NT, S = C::kStages, NC = D / 64;
  extern __shared__ __align__(16) float smem_f[];
  float* k_s = smem_f;                       // [BK][LD]
  float* v_s = k_s + BK * LD;                // [BK][LD]
  float* ring = v_s + BK * LD;               // [S]: Q, dO [BQ][LD]; lse, delta
  float* p_s = ring + S * C::kStageFloats;   // P^T as [BQ][LDX]
  float* ds_s = p_s + BQ * LDX;              // dS^T as [BQ][LDX]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int G = H / KVH;
  const int grp = threadIdx.x / 128;  // warp-uniform
  const int w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;

  // causal: queries before the block's first key never see it
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt_first = causal ? min(k0 / BQ, n_qt) : 0;
  const int per_head = n_qt - qt_first;
  const int n_tiles = G * per_head;

  {  // K and V: the first cp.async group, with tile 0
    const size_t off = (((size_t)b * Sk + k0) * KVH + kvh) * D;
    const int rows = min(BK, Sk - k0);
    cp_rows_f32<D, BK, NT, LD>(k_s, k + off, kv_stride, rows);
    cp_rows_f32<D, BK, NT, LD>(v_s, v + off, kv_stride, rows);
  }
  // tile it = (query head g, query tile): Q, dO, lse, delta into slot it % S
  auto stage = [&](int it) {
    if (it < n_tiles) {
      const int g = it / per_head;
      const int q0 = (qt_first + it - g * per_head) * BQ;
      const int h = kvh * G + g, rows = min(BQ, Sq - q0);
      float* slot = ring + (it % S) * C::kStageFloats;
      const size_t off = (((size_t)b * Sq + q0) * H + h) * D;
      cp_rows_f32<D, BQ, NT, LD>(slot, q + off, q_stride, rows);
      cp_rows_f32<D, BQ, NT, LD>(slot + BQ * LD, dout + off, q_stride, rows);
      if (threadIdx.x < 2 * BQ) {
        const int r = threadIdx.x % BQ;
        const float* src =
            (threadIdx.x < BQ ? lse : delta) + ((size_t)b * H + h) * Sq + q0;
        cp_async4(smem_addr(slot + 2 * BQ * LD + threadIdx.x),
                  src + (r < rows ? r : 0), r < rows);
      }
    }
    cp_async_commit();  // an empty group past the last tile
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) stage(s);

  // S^T / dP^T: keys ak + 16 i, queries aq + 8 j (a warp: 4 x 8; each
  // quarter-warp 2 keys x 4 queries); dV / dK: keys 4 bk + 32 (e / 4) +
  // e % 4, dims 4 bd + 64 (n / 4) + n % 4 (a warp: 4 x 8 16-byte chunks;
  // each quarter 2 x 4)
  const int qr = lane / 8, lq = lane % 8;
  const int ak = 4 * w + 2 * (qr % 2) + lq % 2, aq = 4 * (qr / 2) + lq / 2;
  const int bk = 4 * (w % 2) + 2 * (qr % 2) + lq % 2;
  const int bd = 8 * (w / 2) + 4 * (qr / 2) + lq / 2;
  const float* a_rows = (grp ? v_s : k_s) + ak * LD;
  float* x_s = grp ? ds_s : p_s;  // phase B's left operand
  const float scale_log2 = scale * kLog2e;

  float acc[8][4 * NC];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int n = 0; n < 4 * NC; ++n) acc[e][n] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile it landed; every read of tile it - 1 is done
    stage(it + S - 1);
    const float* q_t = ring + (it % S) * C::kStageFloats;
    const float* do_t = q_t + BQ * LD;
    const float* lse_t = do_t + BQ * LD;
    const float* delta_t = lse_t + BQ;
    const int g = it / per_head;
    const int q0 = (qt_first + it - g * per_head) * BQ;

    float s[4][4];  // S^T in group 0, dP^T in group 1
    dot4x4<D, LD>(s, a_rows, (grp ? do_t : q_t) + aq * LD);
    if (grp == 0) {  // p = exp(s scale - lse) as exp2, log2(e) folded in
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q_pos = q0 + aq + 8 * j;
        const float l2 = lse_t[aq + 8 * j] * kLog2e;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k_pos = k0 + ak + 16 * i;
          const bool keep = k_pos < Sk && q_pos < Sq &&
                            (!causal || q_pos >= k_pos);
          p_s[(aq + 8 * j) * LDX + ak + 16 * i] =
              keep ? exp2f(fmaf(s[i][j], scale_log2, -l2)) : 0.f;
        }
      }
    }
    __syncthreads();  // P^T complete
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dl = delta_t[aq + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (aq + 8 * j) * LDX + ak + 16 * i;
          ds_s[at] = p_s[at] * (s[i][j] - dl) * scale;
        }
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // dS^T complete
    }
    outer8<D, BQ, LD, LDX>(acc, x_s + 4 * bk, (grp ? q_t : do_t) + 4 * bd);
  }
  cp_async_wait<0>();

  float* out = grp ? dk : dv;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k_pos = k0 + 4 * bk + 32 * (e / 4) + e % 4;
    if (k_pos >= Sk) continue;
    float* o = out + (((size_t)b * Sk + k_pos) * KVH + kvh) * D + 4 * bd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(o + 64 * c) =
          make_float4(acc[e][4 * c], acc[e][4 * c + 1], acc[e][4 * c + 2],
                      acc[e][4 * c + 3]);
  }
}

// ---------------------------------------------------------------------------
// f32 forward and dq on CUDA cores: grid (H, B, ceil(Sq / BQ)), last q tile
// first
// ---------------------------------------------------------------------------
//
// What bounds them: operations, as for dkv: 4 D (forward) and 6 D (dq)
// FLOPs per visible pair and query head in f32 on CUDA cores. Both kernels
// are one skeleton built from the dkv kernel's pieces:
//   * a block of 256 threads owns 64 queries of one (b, query head). Q
//     (and dO for dq) stay in shared memory for the whole key loop; K and
//     V stream through a cp.async ring of kStages 64-key tiles, each
//     requested kStages - 1 tiles ahead. Rows are padded to D + 4 floats;
//   * thread (aq, ak), aq = 2 warp + lane % 2 and ak = lane / 2, both in
//     [0, 16), holds S (and dP) for queries aq + 16 i and keys ak + 16 j
//     (i, j < 4): dot4x4 feeds 64 FMAs from 8 reads of 16 bytes along D,
//     and a quarter-warp reads 2 Q rows and 4 K rows, in distinct bank
//     groups. A warp holds whole query rows (all 16 ak of two aq), so the
//     forward's row max and row sum are shuffles inside the warp;
//   * p (forward) or ds = p (dp - delta) scale (dq, formed in the
//     registers that hold s and dp) goes to shared memory as X^T
//     [key][4 aq + i], so a thread's 4 queries are one 16-byte read. Rows
//     of X^T are 72 floats: the 16-byte stores of a quarter-warp fall in
//     8 distinct bank groups;
//   * the output (out or dq) is held per thread as queries aq + 16 i x
//     dims 4 ak + 64 c + e, and updated one key at a time from 1 + D / 64
//     reads of 16 bytes per 4 D / 16 FMAs (outer4);
//   * exp runs as exp2 with scale * log2(e) folded into one multiply-add.
//     The forward keeps m in natural units, so lse = m + log(l) is what
//     dq and dkv read, as in the bf16 forward;
//   * only tiles across the diagonal or past Sk are masked; causal blocks
//     stop at their last query, and the heaviest start first;
//   * each output element is summed by one thread in key order: two
//     launches give the same bits.
// Two barriers a tile: one publishes the landed tile and frees the slot
// and X^T of the previous one, the other publishes X^T.
template <int D>
struct RowsF32Cfg {
  static constexpr int NT = 256;      // 8 warps
  static constexpr int BQ = 64;       // queries per block
  static constexpr int BK = 64;       // keys per tile
  static constexpr int kStages = 2;   // ring of K / V tiles
  static constexpr int LD = D + 4;    // Q, dO, K, V row stride in floats
  static constexpr int LDX = 72;      // X^T row stride: 64 queries + 8
  static constexpr int kStageFloats = 2 * BK * LD;
  // Q (forward) or Q and dO (dq), the ring, X^T
  static constexpr int kRingBytes = (kStages * kStageFloats + BK * LDX) * 4;
  static constexpr int kFwdSmemBytes = BQ * LD * 4 + kRingBytes;
  static constexpr int kDqSmemBytes = 2 * BQ * LD * 4 + kRingBytes;
  static_assert(NT == 256 && BQ == 64 && BK == 64 && D % 64 == 0,
                "the thread layout below assumes these sizes");
};

// K and V rows of key tile t into ring slot t % kStages; always commits a
// group (an empty one past the last tile)
template <int D>
__device__ __forceinline__ void stage_kv(float* ring, int t, int n_tiles,
                                         const float* k, const float* v,
                                         size_t kv_off, int Sk, int KVH) {
  using C = RowsF32Cfg<D>;
  if (t < n_tiles) {
    const int kb = t * C::BK, rows = min(C::BK, Sk - kb);
    const size_t stride = (size_t)KVH * D, off = kv_off + kb * stride;
    float* slot = ring + (t % C::kStages) * C::kStageFloats;
    cp_rows_f32<D, C::BK, C::NT, C::LD>(slot, k + off, stride, rows);
    cp_rows_f32<D, C::BK, C::NT, C::LD>(slot + C::BK * C::LD, v + off,
                                        stride, rows);
  }
  cp_async_commit();
}

// acc[i][n] += sum_{r < BK} x[r * LDX + i] * y[r * LD + dim(n)], dim(n) =
// 64 (n / 4) + n % 4: 4 queries of X^T against D / 16 dims of V or K, one
// key row at a time.
template <int D, int BK, int LD, int LDX>
__device__ __forceinline__ void outer4(float (&acc)[4][D / 16],
                                       const float* x, const float* y) {
  constexpr int NC = D / 64;
#pragma unroll 8
  for (int r = 0; r < BK; ++r) {
    const float4 u = *reinterpret_cast<const float4*>(x + r * LDX);
    const float xv[4] = {u.x, u.y, u.z, u.w};
    float yv[4 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(y + r * LD + 64 * c);
      yv[4 * c] = w.x;
      yv[4 * c + 1] = w.y;
      yv[4 * c + 2] = w.z;
      yv[4 * c + 3] = w.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4 * NC; ++n)
        acc[i][n] = fmaf(xv[i], yv[n], acc[i][n]);
  }
}

// column j of a thread's 4 x 4 tile into X^T as one 16-byte store
__device__ __forceinline__ void put_col(float* x_s, int LDX, int ak, int aq,
                                        int j, const float (&c)[4]) {
  *reinterpret_cast<float4*>(x_s + (ak + 16 * j) * LDX + 4 * aq) =
      make_float4(c[0], c[1], c[2], c[3]);
}

// max / sum over the 16 lanes of a warp that share aq (lane % 2)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 2; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 2; o < 32; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(RowsF32Cfg<D>::NT, 1)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                     int causal, float scale) {
  using C = RowsF32Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDX = C::LDX;
  constexpr int S = C::kStages, NC = D / 64;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                      // [BQ][LD]
  float* ring = q_s + BQ * LD;              // [S]: K, V [BK][LD]
  float* x_s = ring + S * C::kStageFloats;  // P^T [BK][LDX]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KVH);
  const int q_rows = min(BQ, Sq - q0);
  // causal: keys past the tile's last query are never visible
  const int n_keys = causal ? min(Sk, q0 + q_rows) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;
  const size_t kv_off = ((size_t)b * Sk * KVH + kvh) * D;

  // Q joins the group of tile 0
  cp_rows_f32<D, BQ, C::NT, LD>(q_s, q + (((size_t)b * Sq + q0) * H + h) * D,
                                (size_t)H * D, q_rows);
#pragma unroll
  for (int t = 0; t < S - 1; ++t) stage_kv<D>(ring, t, n_tiles, k, v, kv_off,
                                              Sk, KVH);

  const int aq = 2 * (threadIdx.x / 32) + threadIdx.x % 2;
  const int ak = threadIdx.x % 32 / 2;
  const float scale2 = scale * kLog2e;
  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < 4 * NC; ++n) acc[i][n] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile it landed; tile it - 1's slot and P^T are free
    stage_kv<D>(ring, it + S - 1, n_tiles, k, v, kv_off, Sk, KVH);
    const float* k_t = ring + (it % S) * C::kStageFloats;
    const int kb = it * BK;

    float s[4][4];
    dot4x4<D, LD, 16>(s, q_s + aq * LD, k_t + ak * LD);
    // only tiles across the diagonal or past Sk need the mask
    const bool edge = kb + BK > Sk || (causal && kb + BK - 1 > q0);
    uint32_t kept = 0xffffu;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k_pos = kb + ak + 16 * j;
          if (!(k_pos < Sk && (!causal || k_pos <= q0 + aq + 16 * i))) {
            kept &= ~(1u << (4 * i + j));
            s[i][j] = kNegInf;
          }
        }
    }
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = row_max16(
          fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx * scale);
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      const float mb = m_new * kLog2e;
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j][i] = (kept >> (4 * i + j)) & 1u
                      ? exp2f(fmaf(s[i][j], scale2, -mb)) : 0.f;
        sum += p[j][i];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < 4 * NC; ++n) acc[i][n] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) put_col(x_s, LDX, ak, aq, j, p[j]);
    __syncthreads();  // P^T complete
    outer4<D, BK, LD, LDX>(acc, x_s + 4 * aq, k_t + BK * LD + 4 * ak);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(row_sum16(l[i]), 1e-30f);
    const int q_pos = q0 + aq + 16 * i;
    if (q_pos >= Sq) continue;
    float* o = out + (((size_t)b * Sq + q_pos) * H + h) * D + 4 * ak;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(o + 64 * c) = make_float4(
          acc[i][4 * c] / denom, acc[i][4 * c + 1] / denom,
          acc[i][4 * c + 2] / denom, acc[i][4 * c + 3] / denom);
    if (ak == 0) lse[((size_t)b * H + h) * Sq + q_pos] = m[i] + logf(denom);
  }
}

template <int D>
__global__ void __launch_bounds__(RowsF32Cfg<D>::NT, 1)
flash_dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int H, int KVH, int causal, float scale) {
  using C = RowsF32Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDX = C::LDX;
  constexpr int S = C::kStages, NC = D / 64;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                      // [BQ][LD]
  float* do_s = q_s + BQ * LD;              // [BQ][LD]
  float* ring = do_s + BQ * LD;             // [S]: K, V [BK][LD]
  float* x_s = ring + S * C::kStageFloats;  // dS^T [BK][LDX]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KVH);
  const int q_rows = min(BQ, Sq - q0);
  const int n_keys = causal ? min(Sk, q0 + q_rows) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;
  const size_t kv_off = ((size_t)b * Sk * KVH + kvh) * D;
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;

  // Q and dO join the group of tile 0
  cp_rows_f32<D, BQ, C::NT, LD>(q_s, q + q_off, (size_t)H * D, q_rows);
  cp_rows_f32<D, BQ, C::NT, LD>(do_s, dout + q_off, (size_t)H * D, q_rows);
#pragma unroll
  for (int t = 0; t < S - 1; ++t) stage_kv<D>(ring, t, n_tiles, k, v, kv_off,
                                              Sk, KVH);

  const int aq = 2 * (threadIdx.x / 32) + threadIdx.x % 2;
  const int ak = threadIdx.x % 32 / 2;
  const float scale2 = scale * kLog2e;
  // rows past Sq: Q and dO are zero, so their ds is 0 whatever lse is
  float lse2[4], dlt[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + aq + 16 * i;
    const size_t row = ((size_t)b * H + h) * Sq + q_pos;
    lse2[i] = q_pos < Sq ? lse[row] * kLog2e : 0.f;
    dlt[i] = q_pos < Sq ? delta[row] : 0.f;
#pragma unroll
    for (int n = 0; n < 4 * NC; ++n) acc[i][n] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile it landed; tile it - 1's slot and dS^T are free
    stage_kv<D>(ring, it + S - 1, n_tiles, k, v, kv_off, Sk, KVH);
    const float* k_t = ring + (it % S) * C::kStageFloats;
    const int kb = it * BK;

    float s[4][4], dp[4][4];
    dot4x4<D, LD, 16>(s, q_s + aq * LD, k_t + ak * LD);
    dot4x4<D, LD, 16>(dp, do_s + aq * LD, k_t + BK * LD + ak * LD);
    const bool edge = kb + BK > Sk || (causal && kb + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k_pos = kb + ak + 16 * j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2f(fmaf(s[i][j], scale2, -lse2[i]));
        if (edge && !(k_pos < Sk && (!causal || k_pos <= q0 + aq + 16 * i)))
          p = 0.f;
        ds[i] = p * (dp[i][j] - dlt[i]) * scale;
      }
      put_col(x_s, LDX, ak, aq, j, ds);
    }
    __syncthreads();  // dS^T complete
    outer4<D, BK, LD, LDX>(acc, x_s + 4 * aq, k_t + 4 * ak);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + aq + 16 * i;
    if (q_pos >= Sq) continue;
    float* o = dq + (((size_t)b * Sq + q_pos) * H + h) * D + 4 * ak;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(o + 64 * c) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                      acc[i][4 * c + 3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dq on tensor cores: grid (H, B, ceil(Sq / BQ)), last q tile first
// ---------------------------------------------------------------------------

template <int D>
struct DqMmaCfg {
  static constexpr int NW = 4, NT = 32 * NW;
  static constexpr int BQ = 16 * NW;  // 64 queries, 16 per warp
  static constexpr int BK = 64;       // keys per tile
  static constexpr int LDS = D + 8;   // row stride in elements (+16 bytes)
  // q, dO once; K and V twice (double buffer)
  static constexpr int kSmemBytes = (2 * BQ + 4 * BK) * LDS * 2;
};

template <int D>
__global__ void __launch_bounds__(DqMmaCfg<D>::NT)
flash_dq_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int KVH, int causal, float scale) {
  using C = DqMmaCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDS = C::LDS, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDS]
  bf16* do_s = q_s + BQ * LDS;                     // [BQ][LDS]
  bf16* k_s = do_s + BQ * LDS;                     // [2][BK][LDS]
  bf16* v_s = k_s + 2 * BK * LDS;                  // [2][BK][LDS]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
  const bf16* k_base = k + ((size_t)b * Sk * KVH + kvh) * D;
  const bf16* v_base = v + ((size_t)b * Sk * KVH + kvh) * D;
  const int q_rows = min(BQ, Sq - q0);
  const int n_keys = causal ? min(Sk, q0 + q_rows) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;

  cp_rows<D, BQ, NT, LDS>(q_s, q + q_off, q_stride, q_rows);
  cp_rows<D, BQ, NT, LDS>(do_s, dout + q_off, q_stride, q_rows);
  if (n_tiles > 0) {
    cp_rows<D, BK, NT, LDS>(k_s, k_base, kv_stride, min(BK, Sk));
    cp_rows<D, BK, NT, LDS>(v_s, v_base, kv_stride, min(BK, Sk));
  }
  cp_async_commit();

  // this thread's rows: warp * 16 + g and + 8
  const int row0 = q0 + warp * 16;
  int q_pos[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_pos[i] = row0 + g + 8 * i;
    const size_t r = ((size_t)b * H + h) * Sq + q_pos[i];
    lse2[i] = q_pos[i] < Sq ? lse[r] * kLog2e : 0.f;
    dlt[i] = q_pos[i] < Sq ? delta[r] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = it * BK;
    if (it + 1 < n_tiles) {  // the next tile lands while this one computes
      const int nb = kb + BK, nxt = (it + 1) % 2;
      cp_rows<D, BK, NT, LDS>(k_s + nxt * BK * LDS, k_base + nb * kv_stride,
                              kv_stride, min(BK, Sk - nb));
      cp_rows<D, BK, NT, LDS>(v_s + nxt * BK * LDS, v_base + nb * kv_stride,
                              kv_stride, min(BK, Sk - nb));
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + (it % 2) * BK * LDS;
    const bf16* vs = v_s + (it % 2) * BK * LDS;

    float s[BK / 8][4], dp[BK / 8][4];
    mma_abt<D, BK / 16, LDS>(s, q_s + warp * 16 * LDS, ks, lane);
    mma_abt<D, BK / 16, LDS>(dp, do_s + warp * 16 * LDS, vs, lane);

    // only tiles across the diagonal or past Sk need the mask
    const bool edge = kb + BK > Sk || (causal && kb + BK - 1 > row0);
    uint32_t ds[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * i + c;
          const int k_pos = kb + j * 8 + 2 * t + c;
          float p = exp2f(fmaf(s[j][e], scale2, -lse2[i]));
          if (edge && !(k_pos < Sk && (!causal || k_pos <= q_pos[i])))
            p = 0.f;
          x[c] = p * (dp[j][e] - dlt[i]) * scale;
        }
        ds[j / 2][(j % 2) * 2 + i] = pack_bf16(x[0], x[1]);
      }
    mma_ab<D, BK / 16, LDS>(acc, ds, ks, lane);
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (q_pos[i] >= Sq) continue;
    bf16* o = dq + (((size_t)b * Sq + q_pos[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dkv on tensor cores: grid (KVH, B, ceil(Sk / BK)), first k tile first
// ---------------------------------------------------------------------------

template <int D>
struct DkvMmaCfg {
  static constexpr int NW = 4, NT = 32 * NW;
  static constexpr int BK = 16 * NW;  // 64 keys, 16 per warp
  static constexpr int BQ = 32;       // queries per tile
  static constexpr int LDS = D + 8;
  // K, V once; Q, dO twice (double buffer); then lse, delta twice, f32
  static constexpr int kRowsBytes = (2 * BK + 4 * BQ) * LDS * 2;
  static constexpr int kSmemBytes = kRowsBytes + 4 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(DkvMmaCfg<D>::NT)
flash_dkv_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                     int causal, float scale) {
  using C = DkvMmaCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDS = C::LDS, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BK][LDS]
  bf16* v_s = k_s + BK * LDS;                      // [BK][LDS]
  bf16* q_s = v_s + BK * LDS;                      // [2][BQ][LDS]
  bf16* do_s = q_s + 2 * BQ * LDS;                 // [2][BQ][LDS]
  float* lse_s = reinterpret_cast<float*>(smem_raw + C::kRowsBytes);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                                    // [2][BQ]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const size_t kv_off = (((size_t)b * Sk + k0) * KVH + kvh) * D;
  const int k_rows = min(BK, Sk - k0);
  // causal: queries before the tile's first key never see it
  const int qt_first = causal ? k0 / BQ : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int per_head = max(0, n_qt - qt_first);
  const int n_tiles = G * per_head;  // (head, q tile), head-major

  // stage the (head, q tile) number i into buffer i % 2
  auto stage = [&](int i) {
    const int h = kvh * G + i / per_head;
    const int q0 = (qt_first + i % per_head) * BQ;
    const int q_rows = min(BQ, Sq - q0);
    const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
    const int buf = i % 2;
    cp_rows<D, BQ, NT, LDS>(q_s + buf * BQ * LDS, q + q_off, q_stride,
                            q_rows);
    cp_rows<D, BQ, NT, LDS>(do_s + buf * BQ * LDS, dout + q_off, q_stride,
                            q_rows);
    const size_t row = ((size_t)b * H + h) * Sq + q0;
    for (int r = threadIdx.x; r < 2 * BQ; r += NT) {
      const int rr = r % BQ;
      const bool ok = rr < q_rows;
      const float* src = (r < BQ ? lse : delta) + row + (ok ? rr : 0);
      float* dst = (r < BQ ? lse_s : delta_s) + buf * BQ + rr;
      cp_async4(smem_addr(dst), src, ok);
    }
  };

  cp_rows<D, BK, NT, LDS>(k_s, k + kv_off, kv_stride, k_rows);
  cp_rows<D, BK, NT, LDS>(v_s, v + kv_off, kv_stride, k_rows);
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  const int key0 = k0 + warp * 16;  // this warp's first key
  int k_pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) k_pos[i] = key0 + g + 8 * i;
  const float scale2 = scale * kLog2e;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt_first + it % per_head) * BQ;
    const int buf = it % 2;
    const bf16* qs = q_s + buf * BQ * LDS;
    const bf16* dos = do_s + buf * BQ * LDS;
    const float* lse_b = lse_s + buf * BQ;
    const float* delta_b = delta_s + buf * BQ;

    // transposed tiles: rows are this warp's 16 keys, columns BQ queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
    mma_abt<D, BQ / 16, LDS>(st, k_s + warp * 16 * LDS, qs, lane);
    mma_abt<D, BQ / 16, LDS>(dpt, v_s + warp * 16 * LDS, dos, lane);

    // masked: past Sq or Sk, or a query before one of the warp's keys
    const bool edge = q0 + BQ > Sq || key0 + 16 > Sk ||
                      (causal && q0 < key0 + 15);
    uint32_t pt[BQ / 16][4], dst[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * i + c;
          const int col = j * 8 + 2 * t + c;
          const int q_pos = q0 + col;
          float x = exp2f(fmaf(st[j][e], scale2, -lse_b[col] * kLog2e));
          if (edge && !(k_pos[i] < Sk && q_pos < Sq &&
                        (!causal || q_pos >= k_pos[i])))
            x = 0.f;
          p[c] = x;
          ds[c] = x * (dpt[j][e] - delta_b[col]) * scale;
        }
        pt[j / 2][(j % 2) * 2 + i] = pack_bf16(p[0], p[1]);
        dst[j / 2][(j % 2) * 2 + i] = pack_bf16(ds[0], ds[1]);
      }
    mma_ab<D, BQ / 16, LDS>(dv_acc, pt, dos, lane);
    mma_ab<D, BQ / 16, LDS>(dk_acc, dst, qs, lane);
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (k_pos[i] >= Sk) continue;
    const size_t off = (((size_t)b * Sk + k_pos[i]) * KVH + kvh) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on tensor cores: grid (H, B, ceil(Sq / BQ)), last q tile first
// ---------------------------------------------------------------------------

template <int D>
struct FwdMmaCfg {
  static constexpr int NW = 4, NT = 32 * NW;
  static constexpr int BQ = 16 * NW;  // 64 queries, 16 per warp
  static constexpr int BK = 64;       // keys per tile
  static constexpr int LDS = D + 8;   // row stride in elements (+16 bytes)
  // q once (read into registers), K and V twice (double buffer)
  static constexpr int kSmemBytes = (BQ + 4 * BK) * LDS * 2;
};

template <int D>
__global__ void __launch_bounds__(FwdMmaCfg<D>::NT)
flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                     int causal, float scale) {
  using C = FwdMmaCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDS = C::LDS, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDS]
  bf16* k_s = q_s + BQ * LDS;                      // [2][BK][LDS]
  bf16* v_s = k_s + 2 * BK * LDS;                  // [2][BK][LDS]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const bf16* k_base = k + ((size_t)b * Sk * KVH + kvh) * D;
  const bf16* v_base = v + ((size_t)b * Sk * KVH + kvh) * D;
  const int q_rows = min(BQ, Sq - q0);
  // causal: keys past the tile's last query are never visible
  const int n_keys = causal ? min(Sk, q0 + q_rows) : Sk;
  const int n_tiles = (n_keys + BK - 1) / BK;

  cp_rows<D, BQ, NT, LDS>(q_s, q + (((size_t)b * Sq + q0) * H + h) * D,
                          q_stride, q_rows);
  cp_async_commit();
  if (n_tiles > 0) {
    cp_rows<D, BK, NT, LDS>(k_s, k_base, kv_stride, min(BK, Sk));
    cp_rows<D, BK, NT, LDS>(v_s, v_base, kv_stride, min(BK, Sk));
  }
  cp_async_commit();
  cp_async_wait<1>();  // q has landed; the first K/V tile may not have
  __syncthreads();
  uint32_t qa[D / 16][4];  // this warp's 16 queries, for every key tile
  ldsm_a<D, LDS>(qa, q_s + warp * 16 * LDS, lane);

  const int row0 = q0 + warp * 16;  // this warp's first query
  int q_pos[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_pos[i] = row0 + g + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = it * BK;
    if (it + 1 < n_tiles) {  // the next tile lands while this one computes
      const int nb = kb + BK, nxt = (it + 1) % 2;
      cp_rows<D, BK, NT, LDS>(k_s + nxt * BK * LDS, k_base + nb * kv_stride,
                              kv_stride, min(BK, Sk - nb));
      cp_rows<D, BK, NT, LDS>(v_s + nxt * BK * LDS, v_base + nb * kv_stride,
                              kv_stride, min(BK, Sk - nb));
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // causal: a warp whose queries all precede the tile sees none of it
    if (!causal || kb <= row0 + 15) {
      const bf16* ks = k_s + (it % 2) * BK * LDS;
      const bf16* vs = v_s + (it % 2) * BK * LDS;
      float s[BK / 8][4];
      mma_abt_frag<D, BK / 16, LDS>(s, qa, ks, lane);
      // only tiles across the diagonal or past Sk need the mask
      const bool edge = kb + BK > Sk || (causal && kb + BK - 1 > row0);
      uint32_t pa[BK / 16][4];
      softmax_tile<BK / 8, D / 8>(
          s, m, l, acc, pa, scale, edge, [&](int i, int col) {
            const int k_pos = kb + col;
            return k_pos < Sk && (!causal || k_pos <= q_pos[i]);
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
    if (q_pos[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* o = out + (((size_t)b * Sq + q_pos[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          pack_bf16(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    if (t == 0) lse[((size_t)b * H + h) * Sq + q_pos[i]] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// grid (H or KVH, B, tiles) for the tensor-core kernels: y and z are
// limited to 65535
inline bool fits_yz(int B, int tiles) { return B <= 65535 && tiles <= 65535; }

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int Sq, int Sk, int H,
                           int KVH, int causal, float scale,
                           cudaStream_t stream) {
  using C = FwdMmaCfg<D>;
  const int tiles = (Sq + C::BQ - 1) / C::BQ;
  if (!fits_yz(B, tiles)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_fwd_kernel_mma<D>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, tiles);
  flash_fwd_kernel_mma<D><<<grid, C::NT, C::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int Sq, int Sk, int H,
                           int KVH, int causal, float scale,
                           cudaStream_t stream) {
  using C = RowsF32Cfg<D>;
  const int tiles = (Sq + C::BQ - 1) / C::BQ;
  if (!fits_yz(B, tiles)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_fwd_kernel_f32<D>, C::kFwdSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, tiles);
  flash_fwd_kernel_f32<D><<<grid, C::NT, C::kFwdSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

// forward: bf16 on tensor cores, f32 on CUDA cores (no TF32)
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int Sq, int Sk, int H,
                       int KVH, int causal, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch_fwd_mma<D>(q, k, v, out, lse, B, Sq, Sk, H, KVH, causal,
                             scale, stream);
  else
    return launch_fwd_f32<D>(q, k, v, out, lse, B, Sq, Sk, H, KVH, causal,
                             scale, stream);
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int Sq, int Sk,
                          int H, int KVH, int causal, float scale,
                          cudaStream_t stream) {
  using C = DqMmaCfg<D>;
  const int tiles = (Sq + C::BQ - 1) / C::BQ;
  if (!fits_yz(B, tiles)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_dq_kernel_mma<D>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, tiles);
  flash_dq_kernel_mma<D><<<grid, C::NT, C::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int Sq, int Sk, int H, int KVH, int causal,
                           float scale, cudaStream_t stream) {
  using C = DkvMmaCfg<D>;
  const int tiles = (Sk + C::BK - 1) / C::BK;
  if (!fits_yz(B, tiles)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_dkv_kernel_mma<D>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(KVH, B, tiles);
  flash_dkv_kernel_mma<D><<<grid, C::NT, C::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, KVH,
      causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int Sq, int Sk,
                          int H, int KVH, int causal, float scale,
                          cudaStream_t stream) {
  using C = RowsF32Cfg<D>;
  const int tiles = (Sq + C::BQ - 1) / C::BQ;
  if (!fits_yz(B, tiles)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_dq_kernel_f32<D>, C::kDqSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, tiles);
  flash_dq_kernel_f32<D><<<grid, C::NT, C::kDqSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Sq, Sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

// dq and dkv: bf16 on tensor cores, f32 on CUDA cores (no TF32)
template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Sq, int Sk, int H, int KVH,
                      int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch_dq_mma<D>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KVH,
                            causal, scale, stream);
  else
    return launch_dq_f32<D>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KVH,
                            causal, scale, stream);
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int Sq, int Sk, int H, int KVH, int causal,
                           float scale, cudaStream_t stream) {
  using C = DkvF32Cfg<D>;
  const int tiles = (Sk + C::BK - 1) / C::BK;
  if (!fits_yz(B, tiles)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_dkv_kernel_f32<D>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid(KVH, B, tiles);
  flash_dkv_kernel_f32<D><<<grid, C::NT, C::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, KVH,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Sq, int Sk, int H,
                       int KVH, int causal, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch_dkv_mma<D>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H,
                             KVH, causal, scale, stream);
  else
    return launch_dkv_f32<D>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H,
                             KVH, causal, scale, stream);
}

}  // namespace

#define FLASH_DISPATCH(CALL)                                      \
  if (dtype == 0 && D == 64) return (int)CALL(float, 64);         \
  if (dtype == 0 && D == 128) return (int)CALL(float, 128);       \
  if (dtype == 1 && D == 64) return (int)CALL(__nv_bfloat16, 64); \
  if (dtype == 1 && D == 128) return (int)CALL(__nv_bfloat16, 128); \
  return (int)cudaErrorInvalidValue

// Dynamic shared memory per block of one kernel (0 forward, 1 dq, 2 dkv)
// as launched for dtype and D; -1 for what is not built.
extern "C" int flash_smem_bytes(int kernel, int dtype, int D) {
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128)) return -1;
  const bool b16 = dtype == 1, d64 = D == 64;
  switch (kernel) {
    case 0:
      if (b16)
        return d64 ? FwdMmaCfg<64>::kSmemBytes : FwdMmaCfg<128>::kSmemBytes;
      return d64 ? RowsF32Cfg<64>::kFwdSmemBytes
                 : RowsF32Cfg<128>::kFwdSmemBytes;
    case 1:
      if (b16)
        return d64 ? DqMmaCfg<64>::kSmemBytes : DqMmaCfg<128>::kSmemBytes;
      return d64 ? RowsF32Cfg<64>::kDqSmemBytes
                 : RowsF32Cfg<128>::kDqSmemBytes;
    case 2:
      if (b16)
        return d64 ? DkvMmaCfg<64>::kSmemBytes : DkvMmaCfg<128>::kSmemBytes;
      return d64 ? DkvF32Cfg<64>::kSmemBytes : DkvF32Cfg<128>::kSmemBytes;
    default:
      return -1;
  }
}

// The output must not be empty (the wrapper returns early when it is);
// Sk = 0 (forward, dq) or Sq = 0 (dkv) computes zeros.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* out, void* lse, int B, int Sq,
                         int Sk, int H, int KVH, int D, int causal,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T, DIM) \
  launch_fwd<T, DIM>(q, k, v, out, lse, B, Sq, Sk, H, KVH, causal, scale, s)
  FLASH_DISPATCH(FWD);
#undef FWD
}

extern "C" int flash_dq(int dtype, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, void* dq, int B, int Sq, int Sk,
                        int H, int KVH, int D, int causal, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, DIM)                                                          \
  launch_dq<T, DIM>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KVH, causal, \
                    scale, s)
  FLASH_DISPATCH(DQ);
#undef DQ
}

extern "C" int flash_dkv(int dtype, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B, int Sq,
                         int Sk, int H, int KVH, int D, int causal,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, DIM)                                                      \
  launch_dkv<T, DIM>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KVH, \
                     causal, scale, s)
  FLASH_DISPATCH(DKV);
#undef DKV
}

