// Tensor-core building blocks shared by the port's bf16 attention kernels
// (flash_attention.cu: forward, dq, dkv; ragged_paged_attention.cu): PTX
// wrappers for cp.async, ldmatrix and mma.sync.m16n8k16 (bf16 in, f32
// accumulate), the tile products built on them, and one key tile of the
// streaming softmax on a warp's accumulator fragments.
//
// mma.m16n8k16 fragments, lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, 4 regs of 2 bf16): a0 (row g, cols 2t, 2t+1), a1 (row g+8,
//     same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8..);
//   B (16 x 8, 2 regs): b0 (rows 2t, 2t+1 of col g), b1 (rows 2t+8, 2t+9);
//   C (16 x 8 f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C fragments of two neighbouring 8-column tiles, packed to bf16
// pairs, are exactly the A fragment of a 16-deep step over those columns.
//
// Included by each kernel source (nvcc finds it beside the including
// file); _build.py hashes it into the build key of every source that
// includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // NEG_INF of the attention family
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and r[i] receives matrix i's (row g, cols 2t, 2t+1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed: r[i] receives (rows 2t, 2t+1; col g)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b (16 x 16 bf16 times 16 x 8 bf16, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (the reference's .astype), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy ROWS rows of D bf16 (row r at src + r * stride) into dst with row
// stride LDS elements by 16-byte cp.async; rows >= valid are zero-filled
// and their source is never read (valid >= 1: row 0 stands in as the
// address).
template <int D, int ROWS, int NT, int LDS>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src,
                                        size_t stride, int valid) {
  constexpr int VPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * VPR % NT == 0, "tile split");
#pragma unroll
  for (int it = 0; it < ROWS * VPR / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int r = idx / VPR, c = idx - r * VPR;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * LDS + c * 8),
               src + (ok ? (size_t)r * stride : 0) + c * 8, ok);
  }
}

// acc[n] (n < 2 * NP, 8-column tiles) = A rows [16 x D] . B rows^T, B rows
// [16 NP x D]: S = Q K^T style, both operands with rows along D. a_s and
// b_s point at the first row; rows have stride LDS elements.
template <int D, int NP, int LDS>
__device__ __forceinline__ void mma_abt(float (&acc)[2 * NP][4],
                                        const bf16* a_s, const bf16* b_s,
                                        int lane) {
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const uint32_t a_base = smem_addr(a_s + (lane % 16) * LDS + (lane / 16) * 8);
  const uint32_t b_base = smem_addr(
      b_s + ((lane % 8) + (lane / 16) * 8) * LDS + ((lane / 8) % 2) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_base + kk * 32);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_base + (np * 16 * LDS + kk * 16) * 2);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (n < D / 8) += A . B with A the bf16 fragments a[m] of a
// [16 x 16 KM] tile and B rows [16 KM x D] in shared memory (b_s at the
// first row, stride LDS): dq += ds K, dv += p^T dO, dk += ds^T Q, out += p V.
template <int D, int KM, int LDS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[KM][4],
                                       const bf16* b_s, int lane) {
  const uint32_t b_base = smem_addr(
      b_s + ((lane % 8) + ((lane / 8) % 2) * 8) * LDS + (lane / 16) * 8);
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, b_base + (m * 16 * LDS + np * 16) * 2);
      mma_bf16(acc[2 * np], a[m], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[m], b[2], b[3]);
    }
}

// The A fragments of a [16 x D] bf16 tile in shared memory (a_s at its
// first row, stride LDS), one per 16-deep step: a query tile kept in
// registers across a key loop.
template <int D, int LDS>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[D / 16][4],
                                       const bf16* a_s, int lane) {
  const uint32_t base = smem_addr(a_s + (lane % 16) * LDS + (lane / 16) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(a[kk], base + kk * 32);
}

// mma_abt with A given as fragments (ldsm_a): S = Q K^T for a query tile
// held in registers.
template <int D, int NP, int LDS>
__device__ __forceinline__ void mma_abt_frag(float (&acc)[2 * NP][4],
                                             const uint32_t (&a)[D / 16][4],
                                             const bf16* b_s, int lane) {
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const uint32_t b_base = smem_addr(
      b_s + ((lane % 8) + (lane / 16) * 8) * LDS + ((lane / 8) % 2) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_base + (np * 16 * LDS + kk * 16) * 2);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// One key tile of the streaming softmax, on a warp's C fragments of
// S = Q K^T: 16 rows x 8 NJ keys, of which this thread holds rows g
// (i = 0) and g + 8 (i = 1), columns j * 8 + 2t + c. s holds the raw
// products q.k. keep(i, col) says whether column col is kept in row i;
// it is asked only when `edge` (a tile that crosses the diagonal or an
// edge: elsewhere every column is kept).
//   m: the row max of scale * s so far, in natural units (so that
//      lse = m + log(l) needs no conversion); exp runs as exp2 with
//      scale * log2(e) folded into one multiply-add;
//   l: THIS thread's share of the row sum of the unrounded p (the quad's
//      four shares are summed once, after the key loop: they share m);
//   acc: the f32 output accumulator, ND 8-column fragments, rescaled;
//   pa: p rounded to bf16 (the reference's p.astype(v.dtype)) and packed
//      as the A fragments of the P.V product (mma_ab).
// A masked score is the finite -1e30 and its p is set to exactly 0, so a
// row with no kept key so far keeps l = 0 and acc = 0 (never NaN).
template <int NJ, int ND, typename Keep>
__device__ __forceinline__ void softmax_tile(float (&s)[NJ][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[ND][4],
                                             uint32_t (&pa)[NJ / 2][4],
                                             float scale, bool edge,
                                             Keep keep) {
  static_assert(NJ * 4 <= 32, "one mask bit per fragment element");
  const int t = threadIdx.x % 4;
  uint32_t kept = 0xffffffffu;
  if (edge) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keep(e / 2, j * 8 + 2 * t + e % 2)) {
          kept &= ~(1u << (j * 4 + e));
          s[j][e] = kNegInf;
        }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
  float alpha[2], mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale);
    alpha[i] = exp2f((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    mb[i] = m_new * kLog2e;
  }
  const float scale2 = scale * kLog2e;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * i + c;
        p[c] = exp2f(fmaf(s[j][e], scale2, -mb[i]));
        if (!((kept >> (j * 4 + e)) & 1u)) p[c] = 0.f;
      }
      sum[i] += p[0] + p[1];
      pa[j / 2][(j % 2) * 2 + i] = pack_bf16(p[0], p[1]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// Host side: allow a kernel more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
