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
// What bounds it on this card: at the Llama-3-8B training shape (causal,
// S 4096, D 128) the work is about 4 D (forward), 6 D (dq) and 8 D (dkv)
// FLOPs per visible (query, key) pair per head against a few bytes per
// pair, far above the H100's ~295 FLOP/B ridge: operations bound it.
//
// What this first design does about that, and what it does not do yet:
//   * one block owns a (b, h, 64-query tile) for the forward and for dq
//     and loops over key tiles itself; one block owns a (b, kv head,
//     64-key tile) for dkv and loops over the q tiles AND the G query
//     heads of its kv head, so dk/dv come out per kv head with their f32
//     accumulators in registers (no [B, Sk, H, D] buffers, no group sum);
//     dq and dkv stay two passes, so dq is deterministic (no atomics);
//   * causal: the key loop (forward, dq) stops at the tile's last query,
//     and the q loop (dkv) starts at the tile holding the first key, so
//     fully masked tiles are never visited;
//   * ragged lengths: the last tile is bound-checked (zero-staged rows,
//     masked scores); there are no padding copies;
//   * tiles are staged once in shared memory as f32 (row stride D + 1
//     words, so the lanes of a warp that read different rows hit
//     different banks); every product runs on CUDA cores in f32 with
//     register tiles of 4 x 4 (scores) and 4 x D/NX (accumulators).
// Not done yet (later work): tensor-core products (mma.sync / wgmma),
// TMA or cp.async staging with double buffering, a fused backward.
//
// C interface (bound with ctypes, see ray_tpu_torch/ops/_build.py): each
// entry point returns cudaGetLastError() after its launch (or the error
// of setting the dynamic shared-memory size), and cudaErrorInvalidValue
// for a dtype/head_dim it was not built for. dtype: 0 = f32, 1 = bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of ray_tpu/ops/flash_attention.py
constexpr unsigned kFull = 0xffffffffu;

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

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  // the reference's .astype(bf16) before a product: round, compute in f32
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
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
// forward: grid (ceil(Sq / BQ), H, B)
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
// dq: grid (ceil(Sq / BQ), H, B)
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
// dkv: grid (ceil(Sk / BK), KVH, B)
// ---------------------------------------------------------------------------

template <int D>
struct DkvCfg {
  static constexpr int NT = 256, NX = 16, NY = NT / NX, RM = 4;
  static constexpr int BK = NY * RM;  // 64 key rows per block
  static constexpr int BQ = 32;       // queries per tile
  static constexpr int CN = BQ / NX, CD = D / NX;
  static constexpr int LD = D + 1, LDP = BQ + 1;
  static constexpr int kSmemBytes =
      (2 * BK * LD + 2 * BQ * LD + BK * LDP + 2 * BQ) * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<D>::NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                 int causal, float scale) {
  using C = DkvCfg<D>;
  using E = Elem<T>;
  constexpr int RM = C::RM, CN = C::CN, CD = C::CD, NX = C::NX;
  extern __shared__ float smem[];
  float* k_s = smem;                   // [BK][LD]
  float* v_s = k_s + C::BK * C::LD;    // [BK][LD]
  float* q_s = v_s + C::BK * C::LD;    // [BQ][LD]
  float* do_s = q_s + C::BQ * C::LD;   // [BQ][LD]
  float* buf = do_s + C::BQ * C::LD;   // [BK][LDP]: p^T, then ds^T
  float* lse_s = buf + C::BK * C::LDP; // [BQ]
  float* delta_s = lse_s + C::BQ;      // [BQ]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int k0 = blockIdx.x * C::BK;
  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const size_t kv_off = (((size_t)b * Sk + k0) * KVH + kvh) * D;

  stage_rows<T, D, C::BK, C::NT>(k_s, k + kv_off, kv_stride,
                                 min(C::BK, Sk - k0));
  stage_rows<T, D, C::BK, C::NT>(v_s, v + kv_off, kv_stride,
                                 min(C::BK, Sk - k0));

  float dk_acc[RM][CD], dv_acc[RM][CD];
  int k_pos[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    k_pos[i] = k0 + ty * RM + i;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }
  }

  // causal: queries before the tile's first key never see it
  const int qt_first = causal ? k0 / C::BQ : 0;
  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + ((size_t)b * H + h) * Sq;
    const float* delta_h = delta + ((size_t)b * H + h) * Sq;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * C::BQ;
      const int q_rows = min(C::BQ, Sq - q0);
      const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
      __syncthreads();  // k_s/v_s staged / previous q tile consumed
      stage_rows<T, D, C::BQ, C::NT>(q_s, q + q_off, q_stride, q_rows);
      stage_rows<T, D, C::BQ, C::NT>(do_s, dout + q_off, q_stride, q_rows);
      for (int r = threadIdx.x; r < C::BQ; r += C::NT) {
        lse_s[r] = r < q_rows ? lse_h[q0 + r] : 0.f;
        delta_s[r] = r < q_rows ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are keys, columns queries
      float s[RM][CN], dp[RM][CN];
      dot_tile<RM, CN, NX, D>(s, k_s, q_s, ty, tx);
      dot_tile<RM, CN, NX, D>(dp, v_s, do_s, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int col = tx + NX * j;
          const int q_pos = q0 + col;
          const bool keep = k_pos[i] < Sk && q_pos < Sq &&
                            (!causal || q_pos >= k_pos[i]);
          const float p = keep ? expf(s[i][j] * scale - lse_s[col]) : 0.f;
          const float ds = p * (dp[i][j] - delta_s[col]) * scale;
          s[i][j] = E::round(p);
          dp[i][j] = E::round(ds);
          buf[(ty * RM + i) * C::LDP + col] = s[i][j];
        }
      __syncthreads();
      pv_tile<RM, CD, NX, D, C::BQ>(dv_acc, buf, do_s, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          buf[(ty * RM + i) * C::LDP + tx + NX * j] = dp[i][j];
      __syncthreads();
      pv_tile<RM, CD, NX, D, C::BQ>(dk_acc, buf, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (k_pos[i] >= Sk) continue;
    const size_t off = (((size_t)b * Sk + k_pos[i]) * KVH + kvh) * D + tx;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[off + c * NX] = E::from_float(dk_acc[i][c]);
      dv[off + c * NX] = E::from_float(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int Sq, int Sk, int H,
                       int KVH, int causal, float scale,
                       cudaStream_t stream) {
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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Sq, int Sk, int H, int KVH,
                      int causal, float scale, cudaStream_t stream) {
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

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Sq, int Sk, int H,
                       int KVH, int causal, float scale,
                       cudaStream_t stream) {
  using C = DkvCfg<D>;
  cudaError_t e = allow_smem(flash_dkv_kernel<T, D>, C::kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((Sk + C::BK - 1) / C::BK, KVH, B);
  flash_dkv_kernel<T, D><<<grid, C::NT, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KVH, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

#define FLASH_DISPATCH(CALL)                                      \
  if (dtype == 0 && D == 64) return (int)CALL(float, 64);         \
  if (dtype == 0 && D == 128) return (int)CALL(float, 128);       \
  if (dtype == 1 && D == 64) return (int)CALL(__nv_bfloat16, 64); \
  if (dtype == 1 && D == 128) return (int)CALL(__nv_bfloat16, 128); \
  return (int)cudaErrorInvalidValue

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
