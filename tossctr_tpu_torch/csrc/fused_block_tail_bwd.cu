// fused_block_tail backward: gradients of the post-norm tail of one DARE
// encoder layer (out-projection, residual, RMSNorm, GELU FFN with hidden
// dropout, residual, RMSNorm), for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_ffn.py fused_block_tail, backward
// pallas_call in _tail_bwd_call (kernel _block_tail_bwd_kernel; core
// _block_tail_fwd_core / _rms_bwd / _gelu_tanh_grad).
//
// What it computes, per row n of x, o, dy: (N, D), F hidden units, after
// recomputing the forward (fused_block_tail.cu) with the rounding points
// of the Pallas kernel:
//   dr2 = rms_bwd(dy; wn2, r2)                dwn2 += dy * y_hat2
//   dW2 += round_T(g)^T round_T(dr2)          db2  += dr2
//   dh  = (round_T(dr2) @ W2^T) * keep * gelu'(h)
//   dW1 += y1^T round_T(dh)                   db1  += dh
//   dy1 = round_T(dr2 + round_T(dh) @ W1^T)
//   dr1 = rms_bwd(dy1; wn1, r1)               dwn1 += dy1 * y_hat1
//   dWout += o^T round_T(dr1)                 dbout += dr1
//   do  = round_T(round_T(dr1) @ Wout^T)      dx = round_T(dr1)
// where rms_bwd(dy; w, r) = inv * (g - y_hat * mean(g * y_hat)),
// g = dy * w, y_hat = r * inv, and keep is the forward's counter-hash
// mask, regenerated here.  The weight, bias and norm gradients are sums
// over the rows in fp32.
//
// What bounds it on the card: at the flagship shapes (N = 8192*64 rows,
// D=64, F=384, bf16) one call reads x, o and dy (201 MB) and writes dx
// and do (134 MB), ~100 us at 3.35 TB/s, and does ~168 GFLOP with the
// forward recomputed, ~170 us on the bf16 tensor cores: the arithmetic is
// the floor on paper.  In practice the CUDA-core work on the hidden layer
// is: each of the 201M hidden elements takes a tanhf twice (the forward
// recompute, then GELU and its derivative) and, with dropout, the counter
// hash twice, as in fused_ffn's pair (its backward 1.19 ms, its forward
// 0.42 ms at these shapes).
//
// Design, bf16 (tail_bwd_mma): tensor cores (ffn_mma.cuh), every product
// an mma.sync.m16n8k16 fed by ldmatrix.  Persistent blocks (the grid the
// caller names, one an SM by default) of 8 warps walk tiles of 128 rows,
// 16 a warp.  Wout, W1 and W2 (bf16, 104 KB at D = 64, F = 384) stay
// resident in shared memory for the block's whole walk: the hidden
// dimension is walked twice a tile (the forward recompute, then the
// backward), so chunks streamed by cp.async would cross L2 twice a tile;
// where the weights do not fit beside the tile buffers (F above 384 at
// D = 64) they are loaded in panels of 64-column chunks, all warps in
// step, twice a tile.  A tile:
//   1. each warp copies its rows of o, x and dy (cp.async, zeros past N);
//   2. the forward recompute in registers: a = o @ Wout on mma.sync, r1,
//      RMSNorm 1 with each row's sums over its quad's lanes, y1 packed
//      into A fragments (and stored for the backward), the FFN forward
//      over every chunk (ffn_mma.cuh fwd_chunk: the hidden chunk never
//      leaves registers), r2 and inv2.  The norm-2 backward needs the
//      whole r2 row, so no hidden chunk's backward can start before;
//   3. the norm-2 backward in registers: dr2 (fp32), stored rounded for
//      the FFN stretch; its columns' sums of dy * y_hat2 and dr2;
//   4. the FFN stretch, fused_ffn's backward (bwd_hidden: the hidden
//      chunk recomputed, dh, round(dh) @ W1c^T), with the fp32 dr2 as
//      the starting accumulator of dy1 = round(dr2 + round(dh) @ W1^T);
//      then the block's warps contract over the tile's rows for the
//      chunk's dW2 (warps 0-3) and dW1 (warps 4-7);
//   5. the norm-1 backward in registers: dr1, dx = round(dr1), do =
//      round(round(dr1) @ Wout^T) on mma.sync, round(dr1) stored; then
//      dWout = o^T round(dr1) over the tile's rows (warps 0-3).
// Weight-gradient blocks are flushed once a tile into the block's fp32
// partial buffer in device memory with float2 atomics that have one
// owner thread an entry, so they repeat bit for bit; the column sums
// (dwn2, db2, dwn1, dbout) stay in shared memory, one owner lane an entry,
// until the block's walk ends; db1 sums the unrounded dh per lane, then
// across lanes and warps in a fixed order.  A second kernel (common.cuh
// reduce_partials) adds the partials in block order, so the weight
// gradients repeat bit for bit, and a row's dx and do do not depend on
// the grid.  The dropout mask is regenerated from the counter hash.  D
// is padded to a multiple of 16 and F to one of 64 with zeros.
//
// fp32 (block_tail_bwd_kernel): exact fp32 on the CUDA cores.  As the
// forward's fp32 kernel, a block works on a tile of 64 rows and walks the
// hidden dimension in chunks of 64 (ffn_core.cuh), the forward recomputed
// once to get r2, then each chunk's h and g beside dh; 4x4 register
// tiles; the same per-block partials, once per tile.
#include "ffn_core.cuh"
#include "ffn_mma.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::gelu_tanh_grad;
using tossctr::round_t;
using tossctr::to_f;
using tossctr::ffn::add_tile;
using tossctr::ffn::kChunk;
using tossctr::ffn::kRows;
using tossctr::ffn::kThreads;
using tossctr::ffn::tile_nn;

constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-6f;

struct Layout {
  int AS;
  int bout, wn1, wn2, b2, b1, inv1, inv2;
  int r1, o, y1, r2, dy, h, wa, wb, total;  // offsets in floats
  __host__ __device__ Layout(int D, int F) {
    AS = (D > kChunk ? D : kChunk) + 4;  // row stride of every (64, *) buffer
    bout = 0;
    wn1 = bout + align4(D);
    wn2 = wn1 + align4(D);
    b2 = wn2 + align4(D);
    b1 = b2 + align4(D);
    inv1 = b1 + align4(F);
    inv2 = inv1 + kRows;
    const int act = align4(kRows * AS);
    r1 = inv2 + kRows;  // x, then r1, then dr1
    o = r1 + act;       // o
    y1 = o + act;       // y1
    r2 = y1 + act;      // r2, then dr2
    dy = r2 + act;      // dy, then each chunk's g, then dy1
    h = dy + act;       // each chunk's h, then dh
    wa = h + act;       // Wout (D, D) or the W1 chunk (D, kChunk)
    wb = wa + align4(D * (D > kChunk ? D : kChunk));  // the W2 chunk (kChunk, D)
    total = wb + align4(kChunk * D);
  }
};

struct Partials {  // offsets in one block's partial buffer, in floats
  int dwout, dbout, dwn1, dw1, db1, dw2, db2, dwn2, total;
  __host__ __device__ Partials(int D, int F) {
    dwout = 0;
    dbout = dwout + D * D;
    dwn1 = dbout + D;
    dw1 = dwn1 + D;
    db1 = dw1 + D * F;
    dw2 = db1 + F;
    db2 = dw2 + F * D;
    dwn2 = db2 + D;
    total = dwn2 + D;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_tail_bwd_kernel(const T* __restrict__ x, const T* __restrict__ o,
                      const T* __restrict__ wout, const float* __restrict__ bout,
                      const float* __restrict__ wn1, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ wn2,
                      const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dout,
                      float* __restrict__ partials, int N, int D, int F, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(D, F);
  const Partials P(D, F);
  const int AS = L.AS;
  float* bout_s = smem + L.bout;
  float* wn1_s = smem + L.wn1;
  float* wn2_s = smem + L.wn2;
  float* b2_s = smem + L.b2;
  float* b1_s = smem + L.b1;
  float* inv1 = smem + L.inv1;
  float* inv2 = smem + L.inv2;
  float* r1_s = smem + L.r1;
  float* o_s = smem + L.o;
  float* y1_s = smem + L.y1;
  float* r2_s = smem + L.r2;
  float* dy_s = smem + L.dy;
  float* g_s = smem + L.dy;
  float* h_s = smem + L.h;
  float* wa = smem + L.wa;
  float* wb = smem + L.wb;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* part = partials + (size_t)blockIdx.x * P.total;

  for (int i = tid; i < D; i += kThreads) {
    bout_s[i] = bout[i];
    wn1_s[i] = wn1[i];
    wn2_s[i] = wn2[i];
    b2_s[i] = b2[i];
  }
  for (int i = tid; i < F; i += kThreads) b1_s[i] = b1[i];
  for (int i = tid; i < P.total; i += kThreads) part[i] = 0.f;

  const int CT = D / 4;                   // column tiles of a (64, D) output
  const int out_tiles = (kRows / 4) * CT;  // <= kThreads: D <= 64
  const int HT = kChunk / 4;              // column tiles of a (64, kChunk) chunk
  const int n_tiles = (N + kRows - 1) / kRows;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    const int nrows = min(kRows, N - row0);
    __syncthreads();  // the previous tile is done with every buffer
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const bool in = r < nrows;
      const size_t g = (size_t)(row0 + r) * D + c;
      r1_s[r * AS + c] = in ? to_f<T>(x[g]) : 0.f;
      o_s[r * AS + c] = in ? to_f<T>(o[g]) : 0.f;
      dy_s[r * AS + c] = in ? to_f<T>(dy[g]) : 0.f;
    }
    for (int i = tid; i < D * D; i += kThreads) wa[i] = to_f<T>(wout[i]);
    __syncthreads();

    // ---- r1 = round_T(x + round_T(o @ Wout + bout)), in place of x ----
    for (int t = tid; t < out_tiles; t += kThreads) {
      const int r0 = (t / CT) * 4, c0 = (t % CT) * 4;
      float acc[4][4] = {};
      tile_nn(acc, o_s, AS, wa, D, r0, c0, D);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p = r1_s + (r0 + i) * AS + c0 + j;
          const float a = round_t<T>(__fadd_rn(acc[i][j], bout_s[c0 + j]));
          *p = round_t<T>(__fadd_rn(*p, a));
        }
    }
    __syncthreads();
    // ---- norm 1: inv1 per row, y1 = round_T(wn1 * r1 * inv1) ----
    for (int r = warp; r < kRows; r += kWarps) {
      const float* row = r1_s + r * AS;
      float ss = 0.f;
      for (int c = lane; c < D; c += 32) ss = fmaf(row[c], row[c], ss);
      ss = tossctr::warp_sum(ss);
      const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), kEps)));
      if (lane == 0) inv1[r] = inv;
      for (int c = lane; c < D; c += 32)
        y1_s[r * AS + c] = round_t<T>(__fmul_rn(wn1_s[c], __fmul_rn(row[c], inv)));
    }

    // ---- forward FFN: ff accumulates in registers over the chunks ----
    float acc1[4][4] = {};  // ff here, dy1's FFN term in the backward pass
    tossctr::ffn::forward_walk<T>(y1_s, AS, w1, w2, b1_s, D, F, row0, drop, wa, wb, h_s, AS,
                                  acc1);
    // ---- r2 = round_T(y1 + round_T(ff + b2)) ----
    if (tid < out_tiles) {
      const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + i, c = c0 + j;
          const float f = round_t<T>(__fadd_rn(acc1[i][j], b2_s[c]));
          r2_s[r * AS + c] = round_t<T>(__fadd_rn(y1_s[r * AS + c], f));
          acc1[i][j] = 0.f;
        }
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const float* row = r2_s + r * AS;
      float ss = 0.f;
      for (int c = lane; c < D; c += 32) ss = fmaf(row[c], row[c], ss);
      ss = tossctr::warp_sum(ss);
      if (lane == 0)
        inv2[r] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), kEps)));
    }
    __syncthreads();
    // ---- norm 2 backward: dwn2 += dy * y_hat2 (one owner thread a column) ----
    if (tid < D) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r)
        s = fmaf(dy_s[r * AS + tid], __fmul_rn(r2_s[r * AS + tid], inv2[r]), s);
      part[P.dwn2 + tid] += s;
    }
    __syncthreads();
    // dr2 = inv2 * (g - y_hat2 * mean(g * y_hat2)), g = dy * wn2, in place of r2
    for (int r = warp; r < kRows; r += kWarps) {
      float* row = r2_s + r * AS;
      const float* dyr = dy_s + r * AS;
      const float inv = inv2[r];
      float m = 0.f;
      for (int c = lane; c < D; c += 32)
        m += __fmul_rn(__fmul_rn(dyr[c], wn2_s[c]), __fmul_rn(row[c], inv));
      m = __fdiv_rn(tossctr::warp_sum(m), (float)D);
      for (int c = lane; c < D; c += 32) {
        const float yh = __fmul_rn(row[c], inv);
        const float g = __fmul_rn(dyr[c], wn2_s[c]);
        row[c] = __fmul_rn(inv, __fsub_rn(g, __fmul_rn(yh, m)));
      }
    }
    __syncthreads();
    if (tid < D) {  // db2 += dr2
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += r2_s[r * AS + tid];
      part[P.db2 + tid] += s;
    }

    // ---- FFN backward over the chunks ----
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      const int fc = min(kChunk, F - f0);
      __syncthreads();  // the previous chunk is done with wa, wb, g_s, h_s
      tossctr::ffn::stage_chunk<T>(w1, w2, D, F, f0, fc, wa, wb);
      __syncthreads();
      // h = y1 @ W1c + b1c (fp32) into h_s, g = round_T(gelu(h) * keep) into g_s
      tossctr::ffn::hidden_chunk<T, true>(y1_s, AS, wa, b1_s, D, f0, fc, row0, drop, h_s, g_s, AS);
      __syncthreads();
      tossctr::ffn::dw2_chunk<T, true>(g_s, r2_s, AS, D, fc, part + P.dw2 + (size_t)f0 * D);
      // dh = (round_T(dr2) @ W2c^T) * keep * gelu'(h), in place of h
      for (int t = tid; t < (kRows / 4) * HT; t += kThreads) {
        const int r0 = (t / HT) * 4, c0 = (t % HT) * 4;
        float acc[4][4] = {};
        for (int c = 0; c < D; ++c) {
          float dv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i] = round_t<T>(r2_s[(r0 + i) * AS + c]);
            wv[i] = wb[(c0 + i) * D + c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dv[i], wv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + j;
            float* hp = h_s + (r0 + i) * AS + c;
            float dg = acc[i][j];
            if (drop.on()) dg = __fmul_rn(dg, drop.ffn(row0 + r0 + i, f0 + c));
            *hp = c < fc ? __fmul_rn(dg, gelu_tanh_grad(*hp)) : 0.f;
          }
      }
      __syncthreads();
      tossctr::ffn::dw1_chunk<T>(y1_s, h_s, AS, D, F, fc, part + P.dw1 + f0, part + P.db1 + f0);
      // dy1's FFN term += round_T(dh) @ W1c^T, in registers
      if (tid < out_tiles) {
        const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
        for (int f = 0; f < fc; ++f) {
          float hv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hv[i] = round_t<T>(h_s[(r0 + i) * AS + f]);
            wv[i] = wa[(c0 + i) * kChunk + f];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(hv[i], wv[j], acc1[i][j]);
        }
      }
    }
    __syncthreads();  // every chunk is done with g_s
    // ---- dy1 = round_T(dr2 + FFN term) into g_s ----
    if (tid < out_tiles) {
      const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + i, c = c0 + j;
          g_s[r * AS + c] = round_t<T>(__fadd_rn(r2_s[r * AS + c], acc1[i][j]));
        }
    }
    __syncthreads();
    // ---- norm 1 backward: dwn1 += dy1 * y_hat1, dr1 in place of r1 ----
    if (tid < D) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r)
        s = fmaf(g_s[r * AS + tid], __fmul_rn(r1_s[r * AS + tid], inv1[r]), s);
      part[P.dwn1 + tid] += s;
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      float* row = r1_s + r * AS;
      const float* dyr = g_s + r * AS;
      const float inv = inv1[r];
      float m = 0.f;
      for (int c = lane; c < D; c += 32)
        m += __fmul_rn(__fmul_rn(dyr[c], wn1_s[c]), __fmul_rn(row[c], inv));
      m = __fdiv_rn(tossctr::warp_sum(m), (float)D);
      for (int c = lane; c < D; c += 32) {
        const float yh = __fmul_rn(row[c], inv);
        const float g = __fmul_rn(dyr[c], wn1_s[c]);
        row[c] = __fmul_rn(inv, __fsub_rn(g, __fmul_rn(yh, m)));
      }
    }
    for (int i = tid; i < D * D; i += kThreads) wa[i] = to_f<T>(wout[i]);
    __syncthreads();
    // ---- dx = round_T(dr1), dbout += dr1 ----
    for (int i = tid; i < nrows * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      dx[(size_t)row0 * D + i] = from_f<T>(r1_s[r * AS + c]);
    }
    if (tid < D) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += r1_s[r * AS + tid];
      part[P.dbout + tid] += s;
    }
    // ---- dWout += o^T round_T(dr1): tiles of (D, D) ----
    for (int t = tid; t < CT * CT; t += kThreads) {
      const int d0 = (t / CT) * 4, c0 = (t % CT) * 4;
      float acc[4][4] = {};
      for (int r = 0; r < kRows; ++r) {
        float ov[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ov[i] = o_s[r * AS + d0 + i];
          dv[i] = round_t<T>(r1_s[r * AS + c0 + i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ov[i], dv[j], acc[i][j]);
      }
      add_tile(part + P.dwout, D, d0, c0, D, D, acc);
    }
    // ---- do = round_T(round_T(dr1) @ Wout^T) ----
    for (int t = tid; t < out_tiles; t += kThreads) {
      const int r0 = (t / CT) * 4, c0 = (t % CT) * 4;
      float acc[4][4] = {};
      for (int c = 0; c < D; ++c) {
        float dv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = round_t<T>(r1_s[(r0 + i) * AS + c]);
          wv[i] = wa[(c0 + i) * D + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dv[i], wv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r0 + i >= nrows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dout[(size_t)(row0 + r0 + i) * D + c0 + j] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* const* in, void* dx, void* dout, float* partials, float* grads,
           int blocks, int N, int D, int F, Dropout drop, int device, void* stream) {
  const Layout L(D, F);
  const size_t smem = (size_t)L.total * sizeof(float);
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e = tossctr::prepare_launch(block_tail_bwd_kernel<T>, kThreads, smem, blocks,
                                          device, 0, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  block_tail_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const float*>(in[3]), static_cast<const float*>(in[4]),
      static_cast<const T*>(in[5]), static_cast<const float*>(in[6]),
      static_cast<const T*>(in[7]), static_cast<const float*>(in[8]),
      static_cast<const float*>(in[9]), static_cast<const T*>(in[10]), static_cast<T*>(dx),
      static_cast<T*>(dout), partials, N, D, F, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, blocks, Partials(D, F).total, grads, s);
}

// ---- bf16: the tensor-core kernel ----

namespace tc {

using tossctr::ffn_mma::kChunk;
using tossctr::ffn_mma::kWarpRows;
using tossctr::ptx::bf16;
using tossctr::ptx::round_up;
using tossctr::ptx::row_stride;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * kWarpRows;  // rows of a block's tile: 16 a warp
constexpr int kSums = 4;                   // column sums a warp keeps: dwn2, db2, dwn1, dbout

struct Layout {  // offsets in bytes; panel: hidden columns of W1, W2 held at once
  int lda, ldh, ld1, ld2;
  int vec, b1, db1, sums, wout, w1, w2, o, y1, d, g, dh, total;
  __host__ __device__ Layout(int DP, int F, int panel) {
    lda = row_stride(DP);      // o, y1, round(dr2), round(dr1), x, dy, Wout
    ldh = row_stride(kChunk);  // a chunk's g and round(dh)
    ld1 = row_stride(panel);
    ld2 = row_stride(DP);
    vec = 0;                                // bout, wn1, b2, wn2: DP fp32 each
    b1 = vec + 4 * DP * 4;
    db1 = b1 + round_up(F, kChunk) * 4;     // each warp's db1 over a chunk
    sums = db1 + kWarps * kChunk * 4;       // each warp's column sums
    wout = sums + kWarps * kSums * DP * 4;  // Wout (DP, DP)
    w1 = wout + DP * lda * 2;               // W1's panel columns (DP, panel)
    w2 = w1 + DP * ld1 * 2;                 // W2's panel rows (panel, DP)
    o = w2 + panel * ld2 * 2;               // the tile's o
    y1 = o + kTile * lda * 2;               // y1
    d = y1 + kTile * lda * 2;               // round(dr2), then round(dr1)
    g = d + kTile * lda * 2;                // dy (row stride lda), then a chunk's g
    dh = g + kTile * ldh * 2;               // x (row stride lda), then a chunk's round(dh)
    total = dh + kTile * ldh * 2;
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
tail_bwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ o,
             const bf16* __restrict__ wout, const float* __restrict__ bout,
             const float* __restrict__ wn1, const bf16* __restrict__ w1,
             const float* __restrict__ b1, const bf16* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ wn2,
             const bf16* __restrict__ dy, bf16* __restrict__ dx, bf16* __restrict__ dout,
             float* __restrict__ partials, int N, int D, int F, int panel, Dropout drop) {
  using namespace tossctr::ffn_mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(DP, F, panel);
  const Partials P(D, F);
  float* bout_s = reinterpret_cast<float*>(smem + L.vec);
  float* wn1_s = bout_s + DP;
  float* b2_s = wn1_s + DP;
  float* wn2_s = b2_s + DP;
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* db1s = reinterpret_cast<float*>(smem + L.db1);
  float* sums = reinterpret_cast<float*>(smem + L.sums);
  bf16* wout_s = reinterpret_cast<bf16*>(smem + L.wout);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2);
  bf16* os = reinterpret_cast<bf16*>(smem + L.o);
  bf16* y1s = reinterpret_cast<bf16*>(smem + L.y1);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.d);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g);
  bf16* dhs = reinterpret_cast<bf16*>(smem + L.dh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int FP = round_up(F, kChunk), n_panels = (FP + panel - 1) / panel;
  const int n_tiles = (N + kTile - 1) / kTile;
  const int r0 = warp * kWarpRows;  // the warp's first row in a tile
  float* part = partials + (size_t)blockIdx.x * P.total;
  float* my_sums = sums + warp * kSums * DP;  // [dwn2 | db2 | dwn1 | dbout], DP each

  for (int i = tid; i < P.total; i += kThreads) part[i] = 0.f;
  for (int i = tid; i < DP; i += kThreads) {
    const bool in = i < D;
    bout_s[i] = in ? bout[i] : 0.f;
    wn1_s[i] = in ? wn1[i] : 0.f;
    b2_s[i] = in ? b2[i] : 0.f;
    wn2_s[i] = in ? wn2[i] : 0.f;
  }
  for (int i = tid; i < FP; i += kThreads) b1s[i] = i < F ? b1[i] : 0.f;
  for (int i = tid; i < kWarps * kSums * DP; i += kThreads) sums[i] = 0.f;
  auto load_panel = [&](int p) {  // every thread; W1 columns / W2 rows p*panel ..
    const int c0 = p * panel;
    copy_async(w1s, L.ld1, w1 + c0, F, DP, panel, D, F - c0, tid, kThreads);
    copy_async(w2s, L.ld2, w2 + (size_t)c0 * D, D, panel, DP, F - c0, D, tid, kThreads);
  };
  auto next_panel = [&](int p) {  // with more than one panel, at each panel of a walk
    __syncthreads();  // every warp is done with the previous panel
    load_panel(p);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  copy_async(wout_s, L.lda, wout, D, DP, DP, D, D, tid, kThreads);
  if (n_panels == 1) load_panel(0);  // once for every tile of the block
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * kTile + r0;  // the warp's first absolute row
    const int ok = N - row;             // rows of the warp that exist
    const size_t src = ok > 0 ? (size_t)row * D : 0;
    bf16* xs = dhs + r0 * L.lda;  // x and dy staged in the chunk buffers, row stride lda
    bf16* dys = gs + r0 * L.lda;
    copy_async(os + r0 * L.lda, L.lda, o + src, D, kWarpRows, DP, ok, D, lane, 32);
    copy_async(xs, L.lda, x + src, D, kWarpRows, DP, ok, D, lane, 32);
    copy_async(dys, L.lda, dy + src, D, kWarpRows, DP, ok, D, lane, 32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // ---- the forward recompute: a, r1, y1, the FFN, r2 (registers) ----
    uint32_t r1[DP / 8][2], ya[DP / 16][4];
    float inv1[2], inv2[2];
    float acc[DP / 8][4] = {};  // a, then the FFN output, r2, dr2, dy1
    {
      uint32_t oa[DP / 16][4];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldsm_x4(oa[kk], tile_p1(os + r0 * L.lda, L.lda, 0, kk * 16, lane));
      rows_nn<DP>(oa, wout_s, L.lda, acc);
    }
    tail_norm1<DP>(acc, xs, L.lda, bout_s, wn1_s, D, r1, inv1, ya);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        acc[j][2 * hr] = acc[j][2 * hr + 1] = 0.f;
        *reinterpret_cast<uint32_t*>(y1s + (r0 + g + 8 * hr) * L.lda + j * 8 + 2 * t) =
            ya[j >> 1][(j & 1) * 2 + hr];
      }
    for (int p = 0; p < n_panels; ++p) {
      if (n_panels > 1) next_panel(p);
      for (int c = 0, f0 = p * panel; c < panel && f0 < FP; c += kChunk, f0 += kChunk)
        fwd_chunk<DP>(ya, w1s + c, L.ld1, w2s + c * L.ld2, L.ld2, b1s + f0, f0, row, drop, acc);
    }
    tail_residual2<DP>(acc, ya, b2_s, D, inv2);

    // ---- norm 2 backward: dr2 = inv2 * (gw - y_hat2 * mean(gw * y_hat2)),
    // gw = dy * wn2, in place of r2; dwn2 += dy * y_hat2, db2 += dr2 ----
    {
      float m[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int c = j * 8 + 2 * t;
          const float2 dv = pair_at(dys, L.lda, g + 8 * hr, c);
          m[hr] += __fmul_rn(__fmul_rn(dv.x, wn2_s[c]), __fmul_rn(acc[j][2 * hr], inv2[hr]));
          m[hr] += __fmul_rn(__fmul_rn(dv.y, wn2_s[c + 1]),
                             __fmul_rn(acc[j][2 * hr + 1], inv2[hr]));
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) m[hr] = __fdiv_rn(quad_sum(m[hr]), (float)D);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + 2 * t + e;
          float sw = 0.f, sb = 0.f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float dv = __bfloat162float(dys[(g + 8 * hr) * L.lda + c]);
            const float yh = __fmul_rn(acc[j][2 * hr + e], inv2[hr]);
            const float dr = __fmul_rn(inv2[hr],
                                       __fsub_rn(__fmul_rn(dv, wn2_s[c]), __fmul_rn(yh, m[hr])));
            sw = fmaf(dv, yh, sw);
            sb += dr;
            acc[j][2 * hr + e] = dr;
          }
          sw = column_sum(sw);
          sb = column_sum(sb);
          if (g == 0) {
            my_sums[c] += sw;
            my_sums[DP + c] += sb;
          }
        }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(ds + (r0 + g + 8 * hr) * L.lda + j * 8 + 2 * t) =
              pack_bf16(acc[j][2 * hr], acc[j][2 * hr + 1]);
    }
    __syncthreads();  // y1 and round(dr2) of every warp stored; x and dy read

    // ---- the FFN stretch: dy1 = dr2 + round(dh) @ W1^T in acc; dW2, dW1, db1 ----
    for (int p = 0; p < n_panels; ++p) {
      if (n_panels > 1) next_panel(p);
      for (int c = 0, f0 = p * panel; c < panel && f0 < FP; c += kChunk, f0 += kChunk) {
        float db1p[8][2] = {};
        bwd_hidden<DP>(y1s + r0 * L.lda, ds + r0 * L.lda, L.lda, w1s + c, L.ld1,
                       w2s + c * L.ld2, L.ld2, b1s + f0, f0, row, drop, gs + r0 * L.ldh,
                       dhs + r0 * L.ldh, L.ldh, acc, db1p);
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = column_sum(db1p[k][e]);
            if (g == 0) db1s[warp * kChunk + k * 8 + 2 * t + e] = v;
          }
        __syncthreads();  // the chunk's g and round(dh) of every warp stored
        float wg[8][4] = {};  // this warp's block of dW2c (warps 0-3) or dW1c (4-7)
        if (warp < kChunk / kWarpRows) {
          wgrad_dw2<DP>(gs, L.ldh, ds, L.lda, kTile, warp, wg);
          add_block<DP / 8>(part + P.dw2, D, f0 + warp * kWarpRows, 0, F, D, wg);
        } else if (warp - kChunk / kWarpRows < DP / 16) {
          const int m = warp - kChunk / kWarpRows;
          wgrad_dw1(y1s, L.lda, dhs, L.ldh, kTile, m, wg);
          add_block<8>(part + P.dw1, F, m * kWarpRows, f0, D, F, wg);
        }
        if (tid < kChunk && f0 + tid < F) {
          float sum = 0.f;
          for (int w = 0; w < kWarps; ++w) sum += db1s[w * kChunk + tid];
          part[P.db1 + f0 + tid] += sum;
        }
        __syncthreads();  // g, round(dh) and db1s read
      }
    }

    // ---- norm 1 backward: dy1 = round(acc), dr1 = inv1 * (gw - y_hat1 *
    // mean(gw * y_hat1)), gw = dy1 * wn1; dwn1 += dy1 * y_hat1, dbout += dr1 ----
    {
      float m[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int c = j * 8 + 2 * t;
          const float2 rv = unpack_bf16(r1[j][hr]);
          acc[j][2 * hr] = round_t<bf16>(acc[j][2 * hr]);
          acc[j][2 * hr + 1] = round_t<bf16>(acc[j][2 * hr + 1]);
          m[hr] += __fmul_rn(__fmul_rn(acc[j][2 * hr], wn1_s[c]), __fmul_rn(rv.x, inv1[hr]));
          m[hr] += __fmul_rn(__fmul_rn(acc[j][2 * hr + 1], wn1_s[c + 1]),
                             __fmul_rn(rv.y, inv1[hr]));
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) m[hr] = __fdiv_rn(quad_sum(m[hr]), (float)D);
      uint32_t da[DP / 16][4];  // round(dr1) as A fragments
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        float dr[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + 2 * t + e;
          float sw = 0.f, sb = 0.f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float2 rv = unpack_bf16(r1[j][hr]);
            const float yh = __fmul_rn(e ? rv.y : rv.x, inv1[hr]);
            const float dv = acc[j][2 * hr + e];
            dr[hr][e] = __fmul_rn(inv1[hr],
                                  __fsub_rn(__fmul_rn(dv, wn1_s[c]), __fmul_rn(yh, m[hr])));
            sw = fmaf(dv, yh, sw);
            sb += dr[hr][e];
          }
          sw = column_sum(sw);
          sb = column_sum(sb);
          if (g == 0) {
            my_sums[2 * DP + c] += sw;
            my_sums[3 * DP + c] += sb;
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t v = pack_bf16(dr[hr][0], dr[hr][1]);
          const int c = j * 8 + 2 * t, r = row + g + 8 * hr;
          da[j >> 1][(j & 1) * 2 + hr] = v;
          *reinterpret_cast<uint32_t*>(ds + (r0 + g + 8 * hr) * L.lda + c) = v;
          if (r < N && c < D) *reinterpret_cast<uint32_t*>(dx + (size_t)r * D + c) = v;
          acc[j][2 * hr] = acc[j][2 * hr + 1] = 0.f;
        }
      }
      // ---- do = round(round(dr1) @ Wout^T) ----
      rows_nt<DP>(da, wout_s, L.lda, acc);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int c = j * 8 + 2 * t, r = row + g + 8 * hr;
          if (r < N && c < D)
            *reinterpret_cast<uint32_t*>(dout + (size_t)r * D + c) =
                pack_bf16(acc[j][2 * hr], acc[j][2 * hr + 1]);
        }
    }
    __syncthreads();  // round(dr1) of every warp stored
    // ---- dWout += o^T round(dr1) over the tile's rows ----
    if (warp < DP / 16) {
      float wg[8][4] = {};
      wgrad_dw2<DP>(os, L.lda, ds, L.lda, kTile, warp, wg);
      add_block<DP / 8>(part + P.dwout, D, warp * kWarpRows, 0, D, D, wg);
    }
    __syncthreads();  // o and round(dr1) read before the next tile's copies
  }
  cp_async_wait<0>();
  // ---- the column sums: the warps in order ----
  for (int i = tid; i < kSums * DP; i += kThreads) {
    const int q = i / DP, c = i - q * DP;
    if (c >= D) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sums[(w * kSums + q) * DP + c];
    part[(q == 0 ? P.dwn2 : q == 1 ? P.db2 : q == 2 ? P.dwn1 : P.dbout) + c] = s;
  }
}

template <int DP>
int launch(const void* const* in, void* dx, void* dout, float* partials, float* grads,
           int blocks, int N, int D, int F, Dropout drop, int device, void* stream) {
  const size_t optin = tossctr::smem_optin(device);
  int panel = round_up(F, kChunk);  // all of W1 and W2 if they fit, else the most that does
  while (panel > kChunk && (size_t)Layout(DP, F, panel).total > optin) panel -= kChunk;
  const size_t smem = (size_t)Layout(DP, F, panel).total;
  if (smem > optin) return (int)cudaErrorInvalidConfiguration;
  auto kern = tail_bwd_mma<DP>;
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, blocks, device, 0, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<blocks, kThreads, smem, s>>>(
      static_cast<const bf16*>(in[0]), static_cast<const bf16*>(in[1]),
      static_cast<const bf16*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const bf16*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const bf16*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<const float*>(in[9]),
      static_cast<const bf16*>(in[10]), static_cast<bf16*>(dx), static_cast<bf16*>(dout),
      partials, N, D, F, panel, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, blocks, Partials(D, F).total, grads, s);
}

// D padded to the next multiple of 16
int launch_bf16(const void* const* in, void* dx, void* dout, float* partials, float* grads,
                int blocks, int N, int D, int F, Dropout drop, int device, void* stream) {
  if (D <= 16) return launch<16>(in, dx, dout, partials, grads, blocks, N, D, F, drop, device, stream);
  if (D <= 32) return launch<32>(in, dx, dout, partials, grads, blocks, N, D, F, drop, device, stream);
  if (D <= 48) return launch<48>(in, dx, dout, partials, grads, blocks, N, D, F, drop, device, stream);
  return launch<64>(in, dx, dout, partials, grads, blocks, N, D, F, drop, device, stream);
}

}  // namespace tc

bool shape_ok(int N, int D, int F) {
  return N >= 0 && D >= 4 && D % 4 == 0 && (kRows / 4) * (D / 4) <= kThreads && F >= 4 &&
         F % 4 == 0;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); x, o, wout, w1, w2, dy, dx and do share it; biases and norm
// weights are float32.  blocks: the grid, one
// block an SM (each walks row tiles with a stride of the grid; a block
// with none writes zeros).  partials: (blocks, n) fp32 scratch; grads:
// (n) fp32 out = [dWout (D, D) | dbout (D) | dwn1 (D) | dW1 (D, F) |
// db1 (F) | dW2 (F, D) | db2 (D) | dwn2 (D)].
// Dropout: keep_thresh (0 = off), keep_scale, seed, as the forward got
// them.  D <= 64, D and F multiples of 4.  Returns a cudaError_t code.
extern "C" int tossctr_fused_block_tail_bwd(const void* x, const void* o, const void* wout,
                                            const void* bout, const void* wn1, const void* w1,
                                            const void* b1, const void* w2, const void* b2,
                                            const void* wn2, const void* dy, void* dx,
                                            void* dout, void* partials, void* grads, int blocks,
                                            int N, int D, int F, unsigned keep_thresh,
                                            float keep_scale, unsigned seed, int dtype,
                                            int device, void* stream) {
  if (!shape_ok(N, D, F) || blocks < 1) return (int)cudaErrorInvalidValue;
  const void* in[] = {x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dy};
  const Dropout drop(keep_thresh, keep_scale, seed);
  float* p = static_cast<float*>(partials);
  float* g = static_cast<float*>(grads);
  if (dtype == 0)
    return launch<float>(in, dx, dout, p, g, blocks, N, D, F, drop, device, stream);
  if (dtype == 1) return tc::launch_bf16(in, dx, dout, p, g, blocks, N, D, F, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
