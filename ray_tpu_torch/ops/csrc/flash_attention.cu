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
// The f32 instantiation (dtype 0) keeps CUDA-core kernels (flash_fwd_kernel,
// flash_dq_kernel, flash_dkv_kernel_f32): tensor cores in f32 would mean
// TF32, three decimal digits, far from the f32 reference. The forward and
// dq stage f32 tiles in shared memory (row stride D + 1 words) and run
// every product from 4 x 4 register tiles read one word at a time. The
// dkv kernel is built for Hopper's CUDA cores (its section says how): two
// warp groups split the four products, 16-byte shared reads feed 4-8 FMAs
// a value, and Q / dO / lse / delta stream through a cp.async ring.
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

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerVec = 4;  // elements per 16-byte vector
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  __device__ static float round(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

// max / sum over the NX consecutive lanes that share a row group
template <int NX>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = NX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int NX>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = NX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Stage ROWS rows of D elements (row r at src + r * stride) into
// dst[r * (D + 1) + d] as f32, as 16-byte loads; rows >= valid are zero.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t stride, int valid) {
  using E = Elem<T>;
  constexpr int EPV = E::kPerVec;
  constexpr int VPR = D / EPV;
  static_assert(ROWS * VPR % NT == 0, "tile split");
#pragma unroll
  for (int it = 0; it < ROWS * VPR / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int r = idx / VPR, c = idx - r * VPR;
    float vals[EPV];
    if (r < valid) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + (size_t)r * stride + c * EPV);
      E::unpack(u, vals);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) vals[e] = 0.f;
    }
    float* d = dst + r * (D + 1) + c * EPV;
#pragma unroll
    for (int e = 0; e < EPV; ++e) d[e] = vals[e];
  }
}

// acc[i][j] = sum_d A[row_i][d] * B[col_j][d], rows ty*RM + i of A and
// cols tx + NX*j of B, both staged with row stride D + 1.
template <int RM, int CN, int NX, int D>
__device__ __forceinline__ void dot_tile(float (&acc)[RM][CN],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  const float* a0 = A + ty * RM * LD;
  const float* b0 = B + tx * LD;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = a0[i * LD + d];
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = b0[j * NX * LD + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_{k < KN} P[row_i][k] * V[k][tx + NX*c]; P has row
// stride KN + 1, V row stride D + 1.
template <int RM, int CD, int NX, int D, int KN>
__device__ __forceinline__ void pv_tile(float (&acc)[RM][CD], const float* P,
                                        const float* V, int ty, int tx) {
  constexpr int LD = D + 1, LDP = KN + 1;
  const float* p0 = P + ty * RM * LDP;
  const float* v0 = V + tx;
#pragma unroll 4
  for (int k = 0; k < KN; ++k) {
    float p[RM], v[CD];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = p0[i * LDP + k];
#pragma unroll
    for (int c = 0; c < CD; ++c) v[c] = v0[k * LD + c * NX];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p[i], v[c], acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// f32 forward on CUDA cores: grid (ceil(Sq / BQ), H, B)
// ---------------------------------------------------------------------------

template <int D>
struct FwdCfg {
  static constexpr int NT = 128, NX = 8, NY = NT / NX, RM = 4;
  static constexpr int BQ = NY * RM;  // 64 query rows per block
  static constexpr int BK = 32;       // keys per tile
  static constexpr int CN = BK / NX, CD = D / NX;
  static constexpr int LD = D + 1, LDP = BK + 1;
  static constexpr int kSmemBytes =
      (BQ * LD + 2 * BK * LD + BQ * LDP) * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<D>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                 int causal, float scale) {
  using C = FwdCfg<D>;
  using E = Elem<T>;
  constexpr int RM = C::RM, CN = C::CN, CD = C::CD, NX = C::NX;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][LD]
  float* k_s = q_s + C::BQ * C::LD;   // [BK][LD]
  float* v_s = k_s + C::BK * C::LD;   // [BK][LD]
  float* p_s = v_s + C::BK * C::LD;   // [BQ][LDP]

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * C::BQ;
  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const T* k_base = k + ((size_t)b * Sk * KVH + kvh) * D;
  const T* v_base = v + ((size_t)b * Sk * KVH + kvh) * D;
  const int q_rows = min(C::BQ, Sq - q0);
  // causal: keys past the tile's last query are never visible
  const int n_keys = causal ? min(Sk, q0 + q_rows) : Sk;

  stage_rows<T, D, C::BQ, C::NT>(
      q_s, q + (((size_t)b * Sq + q0) * H + h) * D, q_stride, q_rows);

  float m[RM], l[RM], acc[RM][CD];
  int q_pos[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    q_pos[i] = q0 + ty * RM + i;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_keys; kb += C::BK) {
    __syncthreads();  // q_s staged / previous tile consumed
    const int valid = min(C::BK, Sk - kb);
    stage_rows<T, D, C::BK, C::NT>(k_s, k_base + kb * kv_stride, kv_stride,
                                   valid);
    stage_rows<T, D, C::BK, C::NT>(v_s, v_base + kb * kv_stride, kv_stride,
                                   valid);
    __syncthreads();

    float s[RM][CN];
    dot_tile<RM, CN, NX, D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool keep[CN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int k_pos = kb + tx + NX * j;
        keep[j] = k_pos < Sk && (!causal || k_pos <= q_pos[i]);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<NX>(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty * RM + i) * C::LDP + tx + NX * j] = E::round(p);
      }
      l[i] = l[i] * alpha + group_sum<NX>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<RM, CD, NX, D, C::BK>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (q_pos[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + q_pos[i]) * H + h) * D + tx;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[c * NX] = E::from_float(acc[i][c] / denom);
    if (tx == 0)
      lse[((size_t)b * H + h) * Sq + q_pos[i]] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// f32 dq on CUDA cores: grid (ceil(Sq / BQ), H, B)
// ---------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int NT = 128, NX = 8, NY = NT / NX, RM = 4;
  static constexpr int BQ = NY * RM;  // 64
  static constexpr int BK = 32;
  static constexpr int CN = BK / NX, CD = D / NX;
  static constexpr int LD = D + 1, LDP = BK + 1;
  static constexpr int kSmemBytes =
      (2 * BQ * LD + 2 * BK * LD + BQ * LDP) * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int KVH, int causal, float scale) {
  using C = DqCfg<D>;
  using E = Elem<T>;
  constexpr int RM = C::RM, CN = C::CN, CD = C::CD, NX = C::NX;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][LD]
  float* do_s = q_s + C::BQ * C::LD;   // [BQ][LD]
  float* k_s = do_s + C::BQ * C::LD;   // [BK][LD]
  float* v_s = k_s + C::BK * C::LD;    // [BK][LD]
  float* ds_s = v_s + C::BK * C::LD;   // [BQ][LDP]

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * C::BQ;
  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
  const T* k_base = k + ((size_t)b * Sk * KVH + kvh) * D;
  const T* v_base = v + ((size_t)b * Sk * KVH + kvh) * D;
  const int q_rows = min(C::BQ, Sq - q0);
  const int n_keys = causal ? min(Sk, q0 + q_rows) : Sk;

  stage_rows<T, D, C::BQ, C::NT>(q_s, q + q_off, q_stride, q_rows);
  stage_rows<T, D, C::BQ, C::NT>(do_s, dout + q_off, q_stride, q_rows);

  float acc[RM][CD], lse_r[RM], delta_r[RM];
  int q_pos[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    q_pos[i] = q0 + ty * RM + i;
    const size_t row = ((size_t)b * H + h) * Sq + q_pos[i];
    lse_r[i] = q_pos[i] < Sq ? lse[row] : 0.f;
    delta_r[i] = q_pos[i] < Sq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_keys; kb += C::BK) {
    __syncthreads();
    const int valid = min(C::BK, Sk - kb);
    stage_rows<T, D, C::BK, C::NT>(k_s, k_base + kb * kv_stride, kv_stride,
                                   valid);
    stage_rows<T, D, C::BK, C::NT>(v_s, v_base + kb * kv_stride, kv_stride,
                                   valid);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    dot_tile<RM, CN, NX, D>(s, q_s, k_s, ty, tx);
    dot_tile<RM, CN, NX, D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int k_pos = kb + tx + NX * j;
        const bool keep = k_pos < Sk && (!causal || k_pos <= q_pos[i]);
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        ds_s[(ty * RM + i) * C::LDP + tx + NX * j] = E::round(ds);
      }
    __syncthreads();
    pv_tile<RM, CD, NX, D, C::BK>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (q_pos[i] >= Sq) continue;
    T* o = dq + (((size_t)b * Sq + q_pos[i]) * H + h) * D + tx;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[c * NX] = E::from_float(acc[i][c]);
  }
}

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

// s[i][j] = sum_d a[16 i * LD + d] * b[8 j * LD + d]: 4 rows of A 16
// apart against 4 rows of B 8 apart, read 4 dims at a time.
template <int D, int LD>
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
      bv[j] = *reinterpret_cast<const float4*>(b + j * 8 * LD + d);
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

// forward: bf16 on tensor cores, f32 on CUDA cores (no TF32)
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int Sq, int Sk, int H,
                       int KVH, int causal, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_fwd_mma<D>(q, k, v, out, lse, B, Sq, Sk, H, KVH, causal,
                             scale, stream);
  } else {
    using C = FwdCfg<D>;
    cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, C::kSmemBytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
    flash_fwd_kernel<T, D><<<grid, C::NT, C::kSmemBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), Sq, Sk, H, KVH, causal, scale);
    return cudaGetLastError();
  }
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

// dq and dkv: bf16 on tensor cores, f32 on CUDA cores (no TF32)
template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Sq, int Sk, int H, int KVH,
                      int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_dq_mma<D>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KVH,
                            causal, scale, stream);
  } else {
    using C = DqCfg<D>;
    cudaError_t e = allow_smem(flash_dq_kernel<T, D>, C::kSmemBytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
    flash_dq_kernel<T, D><<<grid, C::NT, C::kSmemBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), Sq, Sk, H, KVH, causal, scale);
    return cudaGetLastError();
  }
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
      return d64 ? FwdCfg<64>::kSmemBytes : FwdCfg<128>::kSmemBytes;
    case 1:
      if (b16)
        return d64 ? DqMmaCfg<64>::kSmemBytes : DqMmaCfg<128>::kSmemBytes;
      return d64 ? DqCfg<64>::kSmemBytes : DqCfg<128>::kSmemBytes;
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

