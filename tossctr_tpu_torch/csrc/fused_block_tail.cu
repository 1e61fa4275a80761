// fused_block_tail forward: the post-norm tail of one DARE encoder layer
// (out-projection, residual, RMSNorm, GELU FFN, residual, RMSNorm) in one
// kernel, for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_ffn.py fused_block_tail, forward
// pallas_call in _tail_fwd_call (kernel _block_tail_fwd_kernel; core
// _block_tail_fwd_core / _rms_fwd / _gelu_tanh).
//
// What it computes, per row n of x, o: (N, D), with F hidden units:
//   a  = round_T(o @ Wout + bout)          r1 = round_T(x + a)
//   y1 = round_T(wn1 * (r1 * rsqrt(mean(r1^2) + 1e-6)))
//   g  = round_T(gelu_tanh(y1 @ W1 + b1) * keep)   (h, gelu, product fp32)
//   ff = round_T(g @ W2 + b2)              r2 = round_T(y1 + ff)
//   y  = round_T(wn2 * (r2 * rsqrt(mean(r2^2) + 1e-6)))
// with every product summed in fp32 -- the rounding points of the Pallas
// kernel.  keep is the counter-hash dropout mask of (row n, hidden column,
// seed) scaled by 1/(1-p) (common.cuh Dropout); without dropout it is 1
// and is not computed.
//
// What bounds it on the card: at the flagship shapes (N = 8192*64 rows,
// D=64, F=384) one call reads x and o (134 MB) and writes y (67 MB),
// ~60 us at 3.35 TB/s, and does 56 GFLOP, ~57 us on the bf16 tensor
// cores: memory and compute floors are about equal.
//
// Design: a block owns a tile of 64 rows.  The (64, F) hidden block never
// exists whole: F is walked in chunks of 64 columns, each chunk's W1 and
// W2 slices are staged in shared memory, the chunk's GELU output is
// rounded into shared memory and immediately multiplied into the (64, D)
// FFN accumulator that each thread keeps in registers.  Residuals and
// both norms stay in shared memory, so device memory sees x and o once
// and y once; the 104 KB of bf16 weights are re-read from L2 per tile.
// Products run on the CUDA cores in fp32 with 4x4 register tiles; the
// tensor cores are the next step for speed.
#include "common.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::gelu_tanh;
using tossctr::load4;
using tossctr::round_t;
using tossctr::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;   // rows per block
constexpr int kChunk = 64;  // hidden columns per chunk
constexpr float kEps = 1e-6f;

struct Layout {
  int AS, GS;
  int bout, wn1, wn2, b2, b1, xa, ob, y1, wa, wb, total;  // offsets in floats
  __host__ __device__ Layout(int D, int F) {
    AS = D + 4;       // activation row stride: 4 rows apart land in other banks
    GS = kChunk + 4;  // GELU-chunk row stride
    bout = 0;
    wn1 = bout + align4(D);
    wn2 = wn1 + align4(D);
    b2 = wn2 + align4(D);
    b1 = b2 + align4(D);
    xa = b1 + align4(F);
    const int act = align4(kRows * (AS > GS ? AS : GS));
    ob = xa + act;     // o tile, later r2
    y1 = ob + act;     // r1, normalised in place into y1
    wa = y1 + act;     // Wout (D, D), later the W1 chunk (D, kChunk)
    const int wa_floats = align4(D * (D > kChunk ? D : kChunk));
    wb = wa + wa_floats;  // W2 chunk (kChunk, D)
    total = wb + align4(kChunk * D);
  }
};

// in-place RMSNorm of the tile's rows: buf[r] = round_T(w * (buf[r] * inv_rms))
template <typename T>
__device__ __forceinline__ void rms_rows(float* buf, const float* w, int D, int AS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = buf + r * AS;
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) ss = fmaf(row[c], row[c], ss);
    ss = tossctr::warp_sum(ss);
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), kEps)));
    for (int c = lane; c < D; c += 32) row[c] = round_t<T>(__fmul_rn(w[c], __fmul_rn(row[c], inv)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_tail_fwd_kernel(const T* __restrict__ x, const T* __restrict__ o,
                      const T* __restrict__ wout, const float* __restrict__ bout,
                      const float* __restrict__ wn1, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ wn2,
                      T* __restrict__ y, int N, int D, int F, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(D, F);
  const int AS = L.AS, GS = L.GS;
  float* bout_s = smem + L.bout;
  float* wn1_s = smem + L.wn1;
  float* wn2_s = smem + L.wn2;
  float* b2_s = smem + L.b2;
  float* b1_s = smem + L.b1;
  float* x_s = smem + L.xa;   // x tile, later the GELU chunk
  float* g_s = smem + L.xa;
  float* o_s = smem + L.ob;   // o tile, later r2
  float* r2_s = smem + L.ob;
  float* y1_s = smem + L.y1;
  float* wa = smem + L.wa;
  float* wb = smem + L.wb;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, N - row0);

  for (int i = tid; i < D; i += kThreads) {
    bout_s[i] = bout[i];
    wn1_s[i] = wn1[i];
    wn2_s[i] = wn2[i];
    b2_s[i] = b2[i];
  }
  for (int i = tid; i < F; i += kThreads) b1_s[i] = b1[i];
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const bool in = r < nrows;
    const size_t g = (size_t)(row0 + r) * D + c;
    x_s[r * AS + c] = in ? to_f<T>(x[g]) : 0.f;
    o_s[r * AS + c] = in ? to_f<T>(o[g]) : 0.f;
  }
  for (int i = tid; i < D * D; i += kThreads) wa[i] = to_f<T>(wout[i]);
  __syncthreads();

  const int CT = D / 4;                  // output column tiles
  const int out_tiles = (kRows / 4) * CT;

  // ---- r1 = round_T(x + round_T(o @ Wout + bout)) into y1_s ----
  for (int t = tid; t < out_tiles; t += kThreads) {
    const int r0 = (t / CT) * 4, c0 = (t % CT) * 4;
    float acc[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float w[4], ov[4];
      load4(wa + d * D + c0, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = o_s[(r0 + i) * AS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ov[i], w[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + i, c = c0 + j;
        const float a = round_t<T>(__fadd_rn(acc[i][j], bout_s[c]));
        y1_s[r * AS + c] = round_t<T>(__fadd_rn(x_s[r * AS + c], a));
      }
  }
  __syncthreads();
  rms_rows<T>(y1_s, wn1_s, D, AS);  // y1 = norm1(r1)

  // ---- FFN over hidden chunks; ff accumulates in registers ----
  // each of the first out_tiles threads owns one 4x4 tile of the (64, D)
  // FFN output for the whole chunk walk (the launch requires D <= 64)
  float ff[4][4] = {};
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int fc = min(kChunk, F - f0);
    __syncthreads();  // y1 ready / previous chunk done with wa, wb, g_s
    for (int i = tid; i < D * kChunk; i += kThreads) {
      const int d = i / kChunk, c = i - d * kChunk;
      wa[i] = c < fc ? to_f<T>(w1[(size_t)d * F + f0 + c]) : 0.f;
    }
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int f = i / D;
      wb[i] = f < fc ? to_f<T>(w2[(size_t)(f0 + f) * D + (i - f * D)]) : 0.f;
    }
    __syncthreads();
    // g = round_T(gelu(y1 @ W1[:, chunk] + b1[chunk]) * keep)
    const int HT = kChunk / 4;
    for (int t = tid; t < (kRows / 4) * HT; t += kThreads) {
      const int r0 = (t / HT) * 4, c0 = (t % HT) * 4;
      float acc[4][4] = {};
      for (int d = 0; d < D; ++d) {
        float w[4], yv[4];
        load4(wa + d * kChunk + c0, w);
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = y1_s[(r0 + i) * AS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(yv[i], w[j], acc[i][j]);
      }
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
          g_s[(r0 + i) * GS + c] = g;
        }
      }
    }
    __syncthreads();
    // ff += g @ W2[chunk, :]
    if (tid < out_tiles) {
      const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
      for (int f = 0; f < fc; ++f) {
        float w[4], gv[4];
        load4(wb + f * D + c0, w);
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = g_s[(r0 + i) * GS + f];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ff[i][j] = fmaf(gv[i], w[j], ff[i][j]);
      }
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
        const float f = round_t<T>(__fadd_rn(ff[i][j], b2_s[c]));
        r2_s[r * AS + c] = round_t<T>(__fadd_rn(y1_s[r * AS + c], f));
      }
  }
  __syncthreads();
  rms_rows<T>(r2_s, wn2_s, D, AS);  // y = norm2(r2)
  __syncthreads();
  for (int i = tid; i < nrows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    y[(size_t)row0 * D + i] = from_f<T>(r2_s[r * AS + c]);
  }
}

template <typename T>
int launch(const void* x, const void* o, const void* wout, const void* bout, const void* wn1,
           const void* w1, const void* b1, const void* w2, const void* b2, const void* wn2,
           void* y, int N, int D, int F, Dropout drop, int device, void* stream) {
  const Layout L(D, F);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kern = block_tail_fwd_kernel<T>;
  const int blocks = (N + kRows - 1) / kRows;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, blocks, device, 0, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(o), static_cast<const T*>(wout),
      static_cast<const float*>(bout), static_cast<const float*>(wn1),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wn2), static_cast<T*>(y), N, D,
      F, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, o, wout, w1, w2 and y share it;
// biases and norm weights are float32).  D must be a multiple of 4 with
// (64/4)*(D/4) <= 256 output tiles, i.e. D <= 64; F a multiple of 4.
// Dropout: keep_thresh (0 = off), keep_scale, seed (common.cuh Dropout).
// Returns a cudaError_t code, 0 on success.
extern "C" int tossctr_fused_block_tail_fwd(const void* x, const void* o, const void* wout,
                                            const void* bout, const void* wn1, const void* w1,
                                            const void* b1, const void* w2, const void* b2,
                                            const void* wn2, void* y, int N, int D, int F,
                                            unsigned keep_thresh, float keep_scale,
                                            unsigned seed, int dtype, int device,
                                            void* stream) {
  if (N < 0 || D < 4 || D % 4 != 0 || (kRows / 4) * (D / 4) > kThreads || F < 4 || F % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (dtype == 0)
    return launch<float>(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, y, N, D, F, drop, device,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, y, N, D, F, drop,
                                 device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
