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
// D=64, F=384) one call reads x, o and dy (201 MB) and writes dx and do
// (134 MB), ~100 us at 3.35 TB/s, and does ~170 GFLOP (~170 us on the bf16
// tensor cores): the floor is the arithmetic, on paper.
//
// Design: as the forward, a block works on a tile of 64 rows and walks
// the hidden dimension in chunks of 64, so the (64, F) hidden block never
// exists whole.  The forward is recomputed once to get r2 (the FFN output
// accumulates in registers); the backward pass then recomputes each
// chunk's h and g beside dh, so nothing of the hidden layer touches
// device memory.  The blocks are persistent (one an SM) and walk row
// tiles; each block sums its weight gradients into its own fp32 partial
// buffer in device memory (L2-resident: 215 KB a block at flagship
// shapes), one owner thread per entry, and a second kernel
// (common.cuh reduce_partials) adds the partials in block order, so the
// result repeats bit for bit (fp32 atomics would not).  Products run on
// the CUDA cores in fp32; the tensor cores are the next step for speed.
#include "common.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::gelu_tanh;
using tossctr::gelu_tanh_grad;
using tossctr::load4;
using tossctr::round_t;
using tossctr::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;   // rows per tile
constexpr int kChunk = 64;  // hidden columns per chunk
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
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      const int fc = min(kChunk, F - f0);
      __syncthreads();  // y1 ready / the previous chunk is done with wa, wb, h_s
      for (int i = tid; i < D * kChunk; i += kThreads) {
        const int d = i / kChunk, c = i - d * kChunk;
        wa[i] = c < fc ? to_f<T>(w1[(size_t)d * F + f0 + c]) : 0.f;
      }
      for (int i = tid; i < kChunk * D; i += kThreads) {
        const int f = i / D;
        wb[i] = f < fc ? to_f<T>(w2[(size_t)(f0 + f) * D + (i - f * D)]) : 0.f;
      }
      __syncthreads();
      for (int t = tid; t < (kRows / 4) * HT; t += kThreads) {
        const int r0 = (t / HT) * 4, c0 = (t % HT) * 4;
        float acc[4][4] = {};
        tile_nn(acc, y1_s, AS, wa, kChunk, r0, c0, D);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const float bj = c < fc ? b1_s[f0 + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float g = 0.f;
            if (c < fc) {
              g = gelu_tanh(__fadd_rn(acc[i][j], bj));
              if (drop.on()) g = __fmul_rn(g, drop.ffn(row0 + r0 + i, f0 + c));
              g = round_t<T>(g);
            }
            h_s[(r0 + i) * AS + c] = g;
          }
        }
      }
      __syncthreads();
      if (tid < out_tiles) {
        const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
        tile_nn(acc1, h_s, AS, wb, D, r0, c0, fc);
      }
    }
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
      for (int i = tid; i < D * kChunk; i += kThreads) {
        const int d = i / kChunk, c = i - d * kChunk;
        wa[i] = c < fc ? to_f<T>(w1[(size_t)d * F + f0 + c]) : 0.f;
      }
      for (int i = tid; i < kChunk * D; i += kThreads) {
        const int f = i / D;
        wb[i] = f < fc ? to_f<T>(w2[(size_t)(f0 + f) * D + (i - f * D)]) : 0.f;
      }
      __syncthreads();
      // h = y1 @ W1c + b1c (fp32) into h_s, g = round_T(gelu(h) * keep) into g_s
      for (int t = tid; t < (kRows / 4) * HT; t += kThreads) {
        const int r0 = (t / HT) * 4, c0 = (t % HT) * 4;
        float acc[4][4] = {};
        tile_nn(acc, y1_s, AS, wa, kChunk, r0, c0, D);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const float bj = c < fc ? b1_s[f0 + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hv = __fadd_rn(acc[i][j], bj);
            float g = 0.f;
            if (c < fc) {
              g = gelu_tanh(hv);
              if (drop.on()) g = __fmul_rn(g, drop.ffn(row0 + r0 + i, f0 + c));
              g = round_t<T>(g);
            }
            h_s[(r0 + i) * AS + c] = hv;
            g_s[(r0 + i) * AS + c] = g;
          }
        }
      }
      __syncthreads();
      // dW2c += g^T round_T(dr2): tiles of (kChunk, D)
      for (int t = tid; t < HT * CT; t += kThreads) {
        const int f0t = (t / CT) * 4, c0 = (t % CT) * 4;
        float acc[4][4] = {};
        for (int r = 0; r < kRows; ++r) {
          float gv[4], dv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            gv[i] = g_s[r * AS + f0t + i];
            dv[i] = round_t<T>(r2_s[r * AS + c0 + i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], dv[j], acc[i][j]);
        }
        add_tile(part + P.dw2 + (size_t)f0 * D, D, f0t, c0, fc, D, acc);
      }
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
      // dW1c += y1^T round_T(dh): tiles of (D, kChunk); db1c += dh
      for (int t = tid; t < CT * HT; t += kThreads) {
        const int d0 = (t / HT) * 4, c0 = (t % HT) * 4;
        float acc[4][4] = {};
        for (int r = 0; r < kRows; ++r) {
          float yv[4], hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            yv[i] = y1_s[r * AS + d0 + i];
            hv[i] = round_t<T>(h_s[r * AS + c0 + i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(yv[i], hv[j], acc[i][j]);
        }
        add_tile(part + P.dw1 + f0, F, d0, c0, D, fc, acc);
      }
      if (tid < fc) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) s += h_s[r * AS + tid];
        part[P.db1 + f0 + tid] += s;
      }
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

bool shape_ok(int N, int D, int F) {
  return N >= 0 && D >= 4 && D % 4 == 0 && (kRows / 4) * (D / 4) <= kThreads && F >= 4 &&
         F % 4 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, o, wout, w1, w2, dy, dx and do
// share it; biases and norm weights are float32).  blocks: the grid, one
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
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, dx, dout, p, g, blocks, N, D, F, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
