// fused_ffn backward: gradients of the GELU FFN of one DARE encoder
// layer's separate-kernel branch, drop(gelu_tanh(x @ W1 + b1)) @ W2 + b2,
// for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_ffn.py fused_ffn, backward pallas_call
// in _bwd_call (kernel _ffn_bwd_kernel; core _hidden / _gelu_tanh_grad).
//
// What it computes, per row n of x, dy: (N, D), F hidden units, after
// recomputing the forward's hidden layer (fused_ffn.cu), with the
// rounding points of the Pallas kernel:
//   h    = x @ W1 + b1                     g = round_T(gelu_tanh(h) * keep)
//   dW2 += g^T dy                          db2 += dy
//   dh   = (dy @ W2^T) * keep * gelu'(h)   (fp32)
//   dW1 += x^T round_T(dh)                 db1 += dh
//   dx   = round_T(round_T(dh) @ W1^T)
// keep is the forward's counter-hash mask of (absolute row, hidden
// column, seed), regenerated here.  dW1, db1, dW2 and db2 are sums over
// the rows in fp32.
//
// What bounds it on the card: at the flagship shapes (N = 8192*64 rows,
// D=64, F=384, bf16) one call reads x and dy (134 MB) and writes dx
// (67 MB), ~60 us at 3.35 TB/s, and does ~129 GFLOP with the hidden
// layer recomputed, ~130 us on the bf16 tensor cores: the floor is the
// arithmetic, on paper.
//
// Design: fused_block_tail_bwd.cu's FFN stretch without the out-projection
// and the norms; the hidden recompute and the dW1 / dW2 stages are
// ffn_core.cuh's, shared with it.  A block works on a tile of 64 rows and
// walks the hidden dimension in chunks of 64, recomputing each chunk's h
// and g beside dh, so nothing of the hidden layer touches device memory.
// dx accumulates in registers over the chunks.  The W1 chunk is staged
// twice (as is for h, transposed for dx) and the W2 chunk transposed, so
// every product reads its weights as conflict-free float4 rows.  The
// blocks are persistent (one an SM) and walk row tiles; each block sums
// its weight gradients into its own fp32 partial buffer in device memory
// (L2-resident: 194 KB a block at flagship shapes), one owner thread per
// entry, and a second kernel (common.cuh reduce_partials) adds the
// partials in block order, so the result repeats bit for bit (fp32 atomics
// would not).  Rows past N are loaded as zeros, which add nothing to the
// sums (their dy is 0), and are never written.  Products run on the CUDA
// cores in fp32; the tensor cores are the next step for speed.
#include "ffn_core.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::gelu_tanh_grad;
using tossctr::load4;
using tossctr::round_t;
using tossctr::to_f;
using tossctr::ffn::kChunk;
using tossctr::ffn::kRows;
using tossctr::ffn::kThreads;
using tossctr::ffn::tile_nn;

struct Layout {
  int AS;
  int b1, x, dy, h, g, w1, w1t, w2t, total;  // offsets in floats
  __host__ __device__ Layout(int D, int F) {
    AS = (D > kChunk ? D : kChunk) + 4;  // row stride of every (64, *) buffer
    b1 = 0;
    const int act = align4(kRows * AS);
    x = b1 + align4(F);
    dy = x + act;
    h = dy + act;    // each chunk's h, then dh
    g = h + act;     // each chunk's g
    w1 = g + act;    // the W1 chunk (D, kChunk)
    w1t = w1 + align4(D * kChunk);   // the W1 chunk transposed (kChunk, D)
    w2t = w1t + align4(kChunk * D);  // the W2 chunk transposed (D, kChunk)
    total = w2t + align4(D * kChunk);
  }
};

struct Partials {  // offsets in one block's partial buffer, in floats
  int dw1, db1, dw2, db2, total;
  __host__ __device__ Partials(int D, int F) {
    dw1 = 0;
    db1 = dw1 + D * F;
    dw2 = db1 + F;
    db2 = dw2 + F * D;
    total = db2 + D;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ partials, int N, int D, int F, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(D, F);
  const Partials P(D, F);
  const int AS = L.AS;
  float* b1_s = smem + L.b1;
  float* x_s = smem + L.x;
  float* dy_s = smem + L.dy;
  float* h_s = smem + L.h;
  float* g_s = smem + L.g;
  float* w1_s = smem + L.w1;
  float* w1t = smem + L.w1t;
  float* w2t = smem + L.w2t;
  const int tid = threadIdx.x;
  float* part = partials + (size_t)blockIdx.x * P.total;

  for (int i = tid; i < F; i += kThreads) b1_s[i] = b1[i];
  for (int i = tid; i < P.total; i += kThreads) part[i] = 0.f;

  const int CT = D / 4;                    // column tiles of a (64, D) output
  const int out_tiles = (kRows / 4) * CT;  // <= kThreads: D <= 64
  const int HT = kChunk / 4;               // column tiles of a (64, kChunk) chunk
  const int n_tiles = (N + kRows - 1) / kRows;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    const int nrows = min(kRows, N - row0);
    __syncthreads();  // the previous tile is done with every buffer
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const bool in = r < nrows;
      const size_t gi = (size_t)(row0 + r) * D + c;
      x_s[r * AS + c] = in ? to_f<T>(x[gi]) : 0.f;
      dy_s[r * AS + c] = in ? to_f<T>(dy[gi]) : 0.f;
    }
    __syncthreads();
    if (tid < D) {  // db2 += dy
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += dy_s[r * AS + tid];
      part[P.db2 + tid] += s;
    }

    float acc_dx[4][4] = {};  // dx over the chunks, in registers
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      const int fc = min(kChunk, F - f0);
      __syncthreads();  // the previous chunk is done with the weights, h_s, g_s
      for (int i = tid; i < D * kChunk; i += kThreads) {
        const int d = i / kChunk, c = i - d * kChunk;
        const float w = c < fc ? to_f<T>(w1[(size_t)d * F + f0 + c]) : 0.f;
        w1_s[i] = w;
        w1t[c * D + d] = w;
      }
      for (int i = tid; i < kChunk * D; i += kThreads) {
        const int f = i / D, c = i - f * D;
        w2t[c * kChunk + f] = f < fc ? to_f<T>(w2[(size_t)(f0 + f) * D + c]) : 0.f;
      }
      __syncthreads();
      // h = x @ W1c + b1c (fp32) into h_s, g = round_T(gelu(h) * keep) into g_s
      tossctr::ffn::hidden_chunk<T, true>(x_s, AS, w1_s, b1_s, D, f0, fc, row0, drop, h_s, g_s, AS);
      __syncthreads();
      tossctr::ffn::dw2_chunk<T, false>(g_s, dy_s, AS, D, fc, part + P.dw2 + (size_t)f0 * D);
      // dh = (dy @ W2c^T) * keep * gelu'(h), in place of h
      for (int t = tid; t < (kRows / 4) * HT; t += kThreads) {
        const int r0 = (t / HT) * 4, c0 = (t % HT) * 4;
        float acc[4][4] = {};
        tile_nn(acc, dy_s, AS, w2t, kChunk, r0, c0, D);
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
      tossctr::ffn::dw1_chunk<T>(x_s, h_s, AS, D, F, fc, part + P.dw1 + f0, part + P.db1 + f0);
      // dx += round_T(dh) @ W1c^T, in registers
      if (tid < out_tiles) {
        const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
        for (int f = 0; f < fc; ++f) {
          float hv[4], wv[4];
          load4(w1t + f * D + c0, wv);
#pragma unroll
          for (int i = 0; i < 4; ++i) hv[i] = round_t<T>(h_s[(r0 + i) * AS + f]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc_dx[i][j] = fmaf(hv[i], wv[j], acc_dx[i][j]);
        }
      }
    }
    // ---- dx = round_T(acc), rows past N not written ----
    if (tid < out_tiles) {
      const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r0 + i >= nrows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dx[(size_t)(row0 + r0 + i) * D + c0 + j] = from_f<T>(acc_dx[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
           void* dx, float* partials, float* grads, int blocks, int N, int D, int F,
           Dropout drop, int device, void* stream) {
  const Layout L(D, F);
  const size_t smem = (size_t)L.total * sizeof(float);
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e = tossctr::prepare_launch(ffn_bwd_kernel<T>, kThreads, smem, blocks, device, 0,
                                          &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ffn_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(dy), static_cast<T*>(dx), partials, N, D,
      F, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, blocks, Partials(D, F).total, grads, s);
}

bool shape_ok(int N, int D, int F) {
  return N >= 0 && D >= 4 && D % 4 == 0 && (kRows / 4) * (D / 4) <= kThreads && F >= 4 &&
         F % 4 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, dy and dx share it; b1 is
// float32).  blocks: the grid, one block an SM (each walks row tiles with
// a stride of the grid; a block with none writes zeros).  partials:
// (blocks, n) fp32 scratch; grads: (n) fp32 out = [dW1 (D, F) | db1 (F) |
// dW2 (F, D) | db2 (D)].  Dropout: keep_thresh (0 = off), keep_scale,
// seed, as the forward got them.  D <= 64, D and F multiples of 4.
// Returns a cudaError_t code.
extern "C" int tossctr_fused_ffn_bwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* dy, void* dx, void* partials,
                                     void* grads, int blocks, int N, int D, int F,
                                     unsigned keep_thresh, float keep_scale, unsigned seed,
                                     int dtype, int device, void* stream) {
  if (!shape_ok(N, D, F) || blocks < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  float* p = static_cast<float*>(partials);
  float* g = static_cast<float*>(grads);
  if (dtype == 0)
    return launch<float>(x, w1, b1, w2, dy, dx, p, g, blocks, N, D, F, drop, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, w2, dy, dx, p, g, blocks, N, D, F, drop, device,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
