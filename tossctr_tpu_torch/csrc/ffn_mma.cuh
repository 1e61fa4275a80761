// Tensor-core stages of the bf16 FFN kernels (fused_ffn.cu,
// fused_ffn_bwd.cu) and of the fused block tail (fused_block_tail.cu,
// fused_block_tail_bwd.cu): one 64-column hidden chunk of the forward for
// a warp's 16 rows, the backward's hidden recompute with dh and dx for a
// warp's 16 rows, the backward's weight-gradient products, which
// contract over the rows of a shared tile, and the tail's out-projection,
// residuals and RMSNorm statistics on a warp's rows in C fragments.
//
// Every product is mma.sync.m16n8k16 with bf16 operands and fp32
// accumulators, fed by ldmatrix from shared memory.  bf16 x bf16 products
// are exact in fp32, so only the summation order differs from the fp32
// CUDA-core kernels (ffn_core.cuh); the rounding points are the Pallas
// kernels' (tossctr_tpu/ops/pallas_ffn.py:110-199).  A hidden chunk's
// accumulators never leave registers in the forward: bias, GELU, dropout
// and the bf16 rounding are applied in place and the C fragments are
// packed straight into the A fragments of the next product (the m16n8k16
// C layout is the A layout of the columns it covers).  The PTX helpers
// and the shared tiles' layout are mma_ptx.cuh's.  Helpers are called by
// every lane of a warp.
#pragma once

#include "mma_ptx.cuh"

namespace tossctr {
namespace ffn_mma {

using namespace tossctr::ptx;  // bf16, ldmatrix, mma, cp.async, tile addressing

constexpr int kChunk = 64;  // hidden columns a chunk
constexpr int kHalf = 32;   // hidden columns held in registers at a time
constexpr int kWarpRows = 16;

// gelu_tanh(h) and gelu_tanh_grad(h) of common.cuh with one tanhf: the
// same operations in the same order, so both are bit-equal to those
__device__ __forceinline__ float gelu_and_grad(float h, float* grad) {
  const float h3 = __fmul_rn(__fmul_rn(__fmul_rn(kGeluC, h), h), h);
  const float t = tanhf(__fmul_rn(kSqrt2OverPi, __fadd_rn(h, h3)));
  const float du = __fmul_rn(kSqrt2OverPi, __fadd_rn(1.0f, __fmul_rn(__fmul_rn(kGelu3C, h), h)));
  const float a = __fmul_rn(0.5f, __fadd_rn(1.0f, t));
  const float b = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, h), __fsub_rn(1.0f, __fmul_rn(t, t))), du);
  *grad = __fadd_rn(a, b);
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, t));
}

// ---- the forward: one chunk for a warp's 16 rows ----
//   acc += round_bf16(gelu_tanh(x @ W1c + b1c) * keep) @ W2c
// xa: the A fragments of the rows' x (DP columns, zero past D); w1c: the
// chunk's columns of W1 in shared memory ([DP][ld1], W1's own layout);
// w2c: the chunk's rows of W2 ([64][ld2]); b1c: the chunk's 64 biases
// (fp32, zero past F); f0: the chunk's first hidden column; row0: the
// warp's first row, both absolute (the dropout hash's coordinates).
// Columns past F have zero weights and bias, so h = 0 and g = 0 there.
template <int DP>
__device__ __forceinline__ void fwd_chunk(const uint32_t (&xa)[DP / 16][4], const bf16* w1c,
                                          int ld1, const bf16* w2c, int ld2, const float* b1c,
                                          int f0, int row0, const Dropout& drop,
                                          float (&acc)[DP / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c0 = 0; c0 < kChunk; c0 += kHalf) {
    float h[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, tile_p1(w1c, ld1, kk * 16, c0 + np * 16, lane));
        mma(h[2 * np], xa[kk], b[0], b[1]);
        mma(h[2 * np + 1], xa[kk], b[2], b[3]);
      }
    // h (C fragments of four n8 tiles) -> g as the A fragments of two k16 steps
    uint32_t ga[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j * 8 + 2 * t;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float gv = gelu_tanh(__fadd_rn(h[j][i], b1c[c + (i & 1)]));
        if (drop.on()) gv = __fmul_rn(gv, drop.ffn(row0 + g + (i >> 1) * 8, f0 + c + (i & 1)));
        v[i] = gv;
      }
      ga[j >> 1][(j & 1) * 2] = pack_bf16(v[0], v[1]);
      ga[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, tile_p1(w2c, ld2, c0 + s * 16, np * 16, lane));
        mma(acc[2 * np], ga[s], b[0], b[1]);
        mma(acc[2 * np + 1], ga[s], b[2], b[3]);
      }
  }
}

// ---- the backward: one chunk's hidden layer for a warp's 16 rows ----
//   h = x @ W1c + b1c, g = round_bf16(gelu_tanh(h) * keep)
//   dh = (dy @ W2c^T) * keep * gelu'(h) (fp32); db1p += dh
//   dx += round_bf16(dh) @ W1c^T
// dx is an accumulator the caller starts (fused_ffn: zeros; the block
// tail: its fp32 dr2, which so enters the sum before the one rounding)
// xs, dys: the warp's 16 rows of x and dy ([16][lda]); w1c, w2c, b1c, f0,
// row0 as in fwd_chunk.  g and round_bf16(dh) go to gs and dhs (the warp's
// 16 rows, [16][ldg]) for the weight-gradient products.  db1p[k][e]: this
// lane's sum of dh over its two rows at chunk column 8k + 2(lane % 4) + e.
template <int DP>
__device__ __forceinline__ void bwd_hidden(const bf16* xs, const bf16* dys, int lda,
                                           const bf16* w1c, int ld1, const bf16* w2c, int ld2,
                                           const float* b1c, int f0, int row0,
                                           const Dropout& drop, bf16* gs, bf16* dhs, int ldg,
                                           float (&dx)[DP / 8][4], float (&db1p)[8][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t xa[DP / 16][4], da[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldsm_x4(xa[kk], tile_p1(xs, lda, 0, kk * 16, lane));
    ldsm_x4(da[kk], tile_p1(dys, lda, 0, kk * 16, lane));
  }
#pragma unroll
  for (int c0 = 0; c0 < kChunk; c0 += kHalf) {
    float h[4][4] = {}, dg[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, tile_p1(w1c, ld1, kk * 16, c0 + np * 16, lane));  // W1c: [d][f]
        mma(h[2 * np], xa[kk], b[0], b[1]);
        mma(h[2 * np + 1], xa[kk], b[2], b[3]);
        ldsm_x4(b, tile_p2(w2c, ld2, c0 + np * 16, kk * 16, lane));  // W2c^T: W2c is [f][d]
        mma(dg[2 * np], da[kk], b[0], b[1]);
        mma(dg[2 * np + 1], da[kk], b[2], b[3]);
      }
    uint32_t ha[2][4];  // round_bf16(dh) as the A fragments of two k16 steps
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j * 8 + 2 * t;
      float gv[4], dh[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float gp;
        float gg = gelu_and_grad(__fadd_rn(h[j][i], b1c[c + (i & 1)]), &gp);
        float d = dg[j][i];
        if (drop.on()) {
          const float keep = drop.ffn(row0 + g + (i >> 1) * 8, f0 + c + (i & 1));
          gg = __fmul_rn(gg, keep);
          d = __fmul_rn(d, keep);
        }
        gv[i] = gg;
        dh[i] = __fmul_rn(d, gp);
        db1p[c0 / 8 + j][i & 1] += dh[i];
      }
      const uint32_t d01 = pack_bf16(dh[0], dh[1]), d23 = pack_bf16(dh[2], dh[3]);
      *reinterpret_cast<uint32_t*>(gs + g * ldg + c) = pack_bf16(gv[0], gv[1]);
      *reinterpret_cast<uint32_t*>(gs + (g + 8) * ldg + c) = pack_bf16(gv[2], gv[3]);
      *reinterpret_cast<uint32_t*>(dhs + g * ldg + c) = d01;
      *reinterpret_cast<uint32_t*>(dhs + (g + 8) * ldg + c) = d23;
      ha[j >> 1][(j & 1) * 2] = d01;
      ha[j >> 1][(j & 1) * 2 + 1] = d23;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, tile_p2(w1c, ld1, np * 16, c0 + s * 16, lane));  // W1c^T: W1c is [d][f]
        mma(dx[2 * np], ha[s], b[0], b[1]);
        mma(dx[2 * np + 1], ha[s], b[2], b[3]);
      }
  }
}

// ---- the backward's weight gradients over ``rows`` rows of shared tiles ----
// dW2c rows [16m, 16m + 16) (of the chunk's 64) += g^T dy: acc[j] is the
// n8 tile of columns 8j.. (j < DP/8).  gs [rows][ldg], dys [rows][lda].
template <int DP>
__device__ __forceinline__ void wgrad_dw2(const bf16* gs, int ldg, const bf16* dys, int lda,
                                          int rows, int m, float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k0 = 0; k0 < rows; k0 += 16) {
    uint32_t a[4];
    ldsm_x4_t(a, tile_p2(gs, ldg, k0, m * 16, lane));  // g^T: gs is [r][f]
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, tile_p1(dys, lda, k0, np * 16, lane));  // dy: [r][d]
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// dW1c rows [16m, 16m + 16) (of DP) += x^T round_bf16(dh): acc[j] is the
// n8 tile of chunk columns 8j.. (j < 8).  xs [rows][lda], dhs [rows][ldg].
__device__ __forceinline__ void wgrad_dw1(const bf16* xs, int lda, const bf16* dhs, int ldg,
                                          int rows, int m, float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k0 = 0; k0 < rows; k0 += 16) {
    uint32_t a[4];
    ldsm_x4_t(a, tile_p2(xs, lda, k0, m * 16, lane));  // x^T: xs is [r][d]
#pragma unroll
    for (int np = 0; np < kChunk / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, tile_p1(dhs, ldg, k0, np * 16, lane));  // round_bf16(dh): [r][f]
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Add a (16 x 8 n-tiles) fp32 accumulator block into a row-major fp32
// matrix p (row stride ld), rows r0 + lane's two rows, columns c0 + 8j +
// 2(lane % 4), only where row < nr and column < nc.  One float2 atomic a
// lane and pair: each entry has one owner thread, so its adds happen in
// that thread's program order and the sum repeats bit for bit.
template <int NT>
__device__ __forceinline__ void add_block(float* p, int ld, int r0, int c0, int nr, int nc,
                                          const float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    if (c >= nc) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + hr * 8;
      if (r < nr)
        atomicAdd(reinterpret_cast<float2*>(p + (size_t)r * ld + c),
                  make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]));
    }
  }
}

// ---- the fused block tail: a warp's 16 rows in C fragments ----
// A lane holds, of the rows' (16, DP) values, rows g and g + 8 at columns
// 8j + 2t and 8j + 2t + 1 of each n8 tile j (g = lane / 4, t = lane % 4):
// [j][0..1] row g, [j][2..3] row g + 8.  A row's columns lie in one quad.

// the sum over a quad's four lanes: a row's sum in the C layout
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the sum over the eight quads (the lanes of one column pair)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// 1 / sqrt(mean(r^2) + 1e-6) from a row's sum of squares, in the fp32
// kernels' operations
__device__ __forceinline__ float rms_inv(float ss, int D) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), 1e-6f)));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// two bf16 of a shared row-major tile at (row, col), col even
__device__ __forceinline__ float2 pair_at(const bf16* s, int ld, int row, int col) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(s + row * ld + col));
}

// acc += a @ B for the warp's 16 rows: a the A fragments of a (16, DP)
// tile, b a [k][n] shared tile (DP x DP, row stride ldb), as W is stored
// for x @ W
template <int DP>
__device__ __forceinline__ void rows_nn(const uint32_t (&a)[DP / 16][4], const bf16* b, int ldb,
                                        float (&acc)[DP / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t f[4];
      ldsm_x4_t(f, tile_p1(b, ldb, kk * 16, np * 16, lane));
      mma(acc[2 * np], a[kk], f[0], f[1]);
      mma(acc[2 * np + 1], a[kk], f[2], f[3]);
    }
}

// acc += a @ B^T, b an [n][k] shared tile (DP x DP): for W stored as for
// x @ W, the product with W^T
template <int DP>
__device__ __forceinline__ void rows_nt(const uint32_t (&a)[DP / 16][4], const bf16* b, int ldb,
                                        float (&acc)[DP / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t f[4];
      ldsm_x4(f, tile_p2(b, ldb, np * 16, kk * 16, lane));
      mma(acc[2 * np], a[kk], f[0], f[1]);
      mma(acc[2 * np + 1], a[kk], f[2], f[3]);
    }
}

// the tail's first half from acc = o @ Wout (C fragments):
//   r1 = round_bf16(x + round_bf16(acc + bout)), inv1 of each row,
//   y1 = round_bf16(wn1 * (r1 * inv1)) as the A fragments of the rows
// xs: the warp's 16 rows of x ([16][lda] bf16); bout, wn1: DP fp32, zero
// past D.  r1: bf16 pairs, [j][0] row g, [j][1] row g + 8.
template <int DP>
__device__ __forceinline__ void tail_norm1(const float (&acc)[DP / 8][4], const bf16* xs, int lda,
                                           const float* bout, const float* wn1, int D,
                                           uint32_t (&r1)[DP / 8][2], float (&inv1)[2],
                                           uint32_t (&ya)[DP / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float2 xv = pair_at(xs, lda, g + 8 * hr, c);
      const float v0 = round_t<bf16>(
          __fadd_rn(xv.x, round_t<bf16>(__fadd_rn(acc[j][2 * hr], bout[c]))));
      const float v1 = round_t<bf16>(
          __fadd_rn(xv.y, round_t<bf16>(__fadd_rn(acc[j][2 * hr + 1], bout[c + 1]))));
      r1[j][hr] = pack_bf16(v0, v1);
      ss[hr] = fmaf(v1, v1, fmaf(v0, v0, ss[hr]));
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) inv1[hr] = rms_inv(quad_sum(ss[hr]), D);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float2 v = unpack_bf16(r1[j][hr]);
      ya[j >> 1][(j & 1) * 2 + hr] = pack_bf16(__fmul_rn(wn1[c], __fmul_rn(v.x, inv1[hr])),
                                               __fmul_rn(wn1[c + 1], __fmul_rn(v.y, inv1[hr])));
    }
  }
}

// r2 = round_bf16(y1 + round_bf16(ff + b2)) in place of ff, and inv2 of
// each row; ya: y1 as A fragments (tail_norm1), b2: DP fp32, zero past D
template <int DP>
__device__ __forceinline__ void tail_residual2(float (&ff)[DP / 8][4],
                                               const uint32_t (&ya)[DP / 16][4], const float* b2,
                                               int D, float (&inv2)[2]) {
  const int t = threadIdx.x & 3;
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float2 y = unpack_bf16(ya[j >> 1][(j & 1) * 2 + hr]);
      const float v0 = round_t<bf16>(__fadd_rn(y.x, round_t<bf16>(__fadd_rn(ff[j][2 * hr], b2[c]))));
      const float v1 =
          round_t<bf16>(__fadd_rn(y.y, round_t<bf16>(__fadd_rn(ff[j][2 * hr + 1], b2[c + 1]))));
      ff[j][2 * hr] = v0;
      ff[j][2 * hr + 1] = v1;
      ss[hr] = fmaf(v1, v1, fmaf(v0, v0, ss[hr]));
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) inv2[hr] = rms_inv(quad_sum(ss[hr]), D);
}

}  // namespace ffn_mma
}  // namespace tossctr
