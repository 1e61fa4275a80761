// Shared FFN pieces of the four FFN kernels (fused_ffn.cu,
// fused_ffn_bwd.cu, fused_block_tail.cu, fused_block_tail_bwd.cu): the
// walk over the hidden dimension in chunks of 64 columns that computes
// drop(gelu_tanh(a @ W1 + b1)) @ W2 for a tile of 64 rows without ever
// holding the (64, F) hidden block, and the backward's dW1 / db1 and dW2
// stages of one chunk.
//
// A tile's activations live in shared memory as fp32 rows of stride AS;
// a chunk's W1 slice as (D, kChunk) and its W2 slice as (kChunk, D),
// zero past the chunk's fc real columns.  Every product runs on the CUDA
// cores in fp32 with 4x4 register tiles.  The helpers are called by all
// threads of the block.  Only forward_walk synchronises, between its
// stages; none does at its end, so the caller places the barrier before
// another thread reads what a helper wrote.
#pragma once

#include "common.cuh"

namespace tossctr {
namespace ffn {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // rows per tile
constexpr int kChunk = 64;  // hidden columns per chunk

// acc (4x4 tile at rows r0.., cols c0..) += a[r][k] * b[k][c] over k < n,
// a with row stride as, b with row stride bs (16-byte aligned rows)
__device__ __forceinline__ void tile_nn(float acc[4][4], const float* a, int as, const float* b,
                                        int bs, int r0, int c0, int n) {
  for (int k = 0; k < n; ++k) {
    float av[4], bv[4];
    load4(b + k * bs + c0, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(r0 + i) * as + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// owner-thread read-modify-write of a 4x4 tile of a partial sum (row stride ld)
__device__ __forceinline__ void add_tile(float* p, int ld, int r0, int c0, int nr, int nc,
                                         const float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i >= nr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < nc) p[(r0 + i) * ld + c0 + j] += acc[i][j];
  }
}

// the chunk f0 .. f0+fc-1 of W1 (D, F) -> wa (D, kChunk) and of W2 (F, D)
// -> wb (kChunk, D), fp32, zero past fc
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ w1, const T* __restrict__ w2,
                                            int D, int F, int f0, int fc, float* wa, float* wb) {
  for (int i = threadIdx.x; i < D * kChunk; i += kThreads) {
    const int d = i / kChunk, c = i - d * kChunk;
    wa[i] = c < fc ? to_f<T>(w1[(size_t)d * F + f0 + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < kChunk * D; i += kThreads) {
    const int f = i / D;
    wb[i] = f < fc ? to_f<T>(w2[(size_t)(f0 + f) * D + (i - f * D)]) : 0.f;
  }
}

// one chunk's hidden layer for the tile at absolute row row0:
//   h = a @ W1c + b1c (fp32), g = round_T(gelu_tanh(h) * keep)
// a (64, as), w1c (D, kChunk) with row stride kChunk; g (and h when
// kKeepH) (64, gs); columns past fc get g = 0
template <typename T, bool kKeepH>
__device__ __forceinline__ void hidden_chunk(const float* a, int as, const float* w1c,
                                             const float* b1, int D, int f0, int fc, int row0,
                                             const Dropout& drop, float* h, float* g, int gs) {
  constexpr int HT = kChunk / 4;
  for (int t = threadIdx.x; t < (kRows / 4) * HT; t += kThreads) {
    const int r0 = (t / HT) * 4, c0 = (t % HT) * 4;
    float acc[4][4] = {};
    tile_nn(acc, a, as, w1c, kChunk, r0, c0, D);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      const float bj = c < fc ? b1[f0 + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hv = __fadd_rn(acc[i][j], bj);
        float gv = 0.f;
        if (c < fc) {
          gv = gelu_tanh(hv);
          if (drop.on()) gv = __fmul_rn(gv, drop.ffn(row0 + r0 + i, f0 + c));
          gv = round_t<T>(gv);
        }
        if (kKeepH) h[(r0 + i) * gs + c] = hv;
        g[(r0 + i) * gs + c] = gv;
      }
    }
  }
}

// the forward's chunk walk for the tile at absolute row row0:
//   acc += round_T(gelu_tanh(a @ W1 + b1) * keep) @ W2
// where each of the first (64/4)*(D/4) threads owns the 4x4 tile of the
// (64, D) output at rows (tid / (D/4))*4, cols (tid % (D/4))*4 (D <= 64).
// wa, wb, g (64, gs) are scratch; a must be ready when it is called.
template <typename T>
__device__ __forceinline__ void forward_walk(const float* a, int as, const T* __restrict__ w1,
                                             const T* __restrict__ w2, const float* b1, int D,
                                             int F, int row0, const Dropout& drop, float* wa,
                                             float* wb, float* g, int gs, float acc[4][4]) {
  const int CT = D / 4;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int fc = min(kChunk, F - f0);
    __syncthreads();  // a ready / the previous chunk is done with wa, wb, g
    stage_chunk<T>(w1, w2, D, F, f0, fc, wa, wb);
    __syncthreads();
    hidden_chunk<T, false>(a, as, wa, b1, D, f0, fc, row0, drop, nullptr, g, gs);
    __syncthreads();
    if (threadIdx.x < (kRows / 4) * CT) {
      const int r0 = (threadIdx.x / CT) * 4, c0 = (threadIdx.x % CT) * 4;
      tile_nn(acc, g, gs, wb, D, r0, c0, fc);
    }
  }
}

// dW2c += g^T d over the tile's 64 rows: tiles of (kChunk, D) added to
// dw2c (the chunk's rows of dW2, row stride D) by their owner threads.
// d (64, as) is read rounded to T when kRound (the tail's dr2), as is
// otherwise (the FFN's dy, already in T).
template <typename T, bool kRound>
__device__ __forceinline__ void dw2_chunk(const float* g, const float* d, int as, int D, int fc,
                                          float* dw2c) {
  const int CT = D / 4;
  for (int t = threadIdx.x; t < (kChunk / 4) * CT; t += kThreads) {
    const int f0t = (t / CT) * 4, c0 = (t % CT) * 4;
    float acc[4][4] = {};
    for (int r = 0; r < kRows; ++r) {
      float gv[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = g[r * as + f0t + i];
      if (kRound) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = round_t<T>(d[r * as + c0 + i]);
      } else {
        load4(d + r * as + c0, dv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], dv[j], acc[i][j]);
    }
    add_tile(dw2c, D, f0t, c0, fc, D, acc);
  }
}

// dW1c += a^T round_T(dh): tiles of (D, kChunk) added to dw1c (dW1's
// columns of the chunk, row stride F); db1c += dh.  a, dh (64, as).
template <typename T>
__device__ __forceinline__ void dw1_chunk(const float* a, const float* dh, int as, int D, int F,
                                          int fc, float* dw1c, float* db1c) {
  constexpr int HT = kChunk / 4;
  for (int t = threadIdx.x; t < (D / 4) * HT; t += kThreads) {
    const int d0 = (t / HT) * 4, c0 = (t % HT) * 4;
    float acc[4][4] = {};
    for (int r = 0; r < kRows; ++r) {
      float av[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = a[r * as + d0 + i];
        hv[i] = round_t<T>(dh[r * as + c0 + i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], hv[j], acc[i][j]);
    }
    add_tile(dw1c, F, d0, c0, D, fc, acc);
  }
  if (threadIdx.x < fc) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += dh[r * as + threadIdx.x];
    db1c[threadIdx.x] += s;
  }
}

}  // namespace ffn
}  // namespace tossctr
