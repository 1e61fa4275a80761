// fused_ffn forward: the GELU FFN of one DARE encoder layer's
// separate-kernel branch, drop(gelu_tanh(x @ W1 + b1)) @ W2 + b2, in one
// kernel, for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_ffn.py fused_ffn, forward pallas_call in
// _fwd_call (kernel _ffn_fwd_kernel; core _hidden / _gelu_tanh).
//
// What it computes, per row n of x: (N, D), with F hidden units:
//   h  = x @ W1 + b1                        (fp32 sums of the T inputs)
//   g  = round_T(gelu_tanh(h) * keep)       (gelu and the product fp32)
//   y  = round_T(g @ W2 + b2)               (fp32 sums)
// which are the rounding points of the Pallas kernel.  keep is the
// counter-hash dropout mask of (absolute row n, hidden column, seed)
// scaled by 1/(1-p) (common.cuh Dropout::ffn); without dropout it is 1
// and is not computed.
//
// What bounds it on the card: at the flagship shapes (N = 8192*64 rows,
// D=64, F=384, bf16) one call reads x (67 MB) and writes y (67 MB),
// ~40 us at 3.35 TB/s, and does 51.5 GFLOP, ~52 us on the bf16 tensor
// cores: the floor is the arithmetic, on paper.
//
// Design: fused_block_tail.cu's FFN stretch (ffn_core.cuh forward_walk,
// which both run) without the out-projection and the norms.  A block owns
// a tile of 64 rows; the (64, F) hidden block never exists whole: F is
// walked in chunks of 64 columns, each chunk's W1 and W2 slices are staged
// in shared memory, the chunk's GELU output is rounded into shared memory
// and multiplied at once into the (64, D) output accumulator that each
// thread keeps in registers.  Device memory sees x once and y once; the
// 98 KB of bf16 weights are re-read from L2 per tile.  Rows past N are
// loaded as zeros and never written.  Products run on the CUDA cores in
// fp32 with 4x4 register tiles; the tensor cores are the next step for
// speed.
#include "ffn_core.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::to_f;
using tossctr::ffn::kChunk;
using tossctr::ffn::kRows;
using tossctr::ffn::kThreads;

struct Layout {
  int AS, GS;
  int b2, b1, xa, g, wa, wb, total;  // offsets in floats
  __host__ __device__ Layout(int D, int F) {
    AS = D + 4;       // x row stride: 4 rows apart land in other banks
    GS = kChunk + 4;  // GELU-chunk row stride
    b2 = 0;
    b1 = b2 + align4(D);
    xa = b1 + align4(F);
    g = xa + align4(kRows * AS);
    wa = g + align4(kRows * GS);     // the W1 chunk (D, kChunk)
    wb = wa + align4(D * kChunk);    // the W2 chunk (kChunk, D)
    total = wb + align4(kChunk * D);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ y,
               int N, int D, int F, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(D, F);
  const int AS = L.AS, GS = L.GS;
  float* b2_s = smem + L.b2;
  float* b1_s = smem + L.b1;
  float* x_s = smem + L.xa;
  float* g_s = smem + L.g;
  float* wa = smem + L.wa;
  float* wb = smem + L.wb;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, N - row0);

  for (int i = tid; i < D; i += kThreads) b2_s[i] = b2[i];
  for (int i = tid; i < F; i += kThreads) b1_s[i] = b1[i];
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    x_s[r * AS + c] = r < nrows ? to_f<T>(x[(size_t)(row0 + r) * D + c]) : 0.f;
  }

  const int CT = D / 4;  // output column tiles
  const int out_tiles = (kRows / 4) * CT;
  float acc_y[4][4] = {};  // this thread's tile of the (64, D) output
  tossctr::ffn::forward_walk<T>(x_s, AS, w1, w2, b1_s, D, F, row0, drop, wa, wb, g_s, GS, acc_y);

  // ---- y = round_T(acc + b2), rows past N not written ----
  if (tid < out_tiles) {
    const int r0 = (tid / CT) * 4, c0 = (tid % CT) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= nrows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[(size_t)(row0 + r0 + i) * D + c0 + j] = from_f<T>(__fadd_rn(acc_y[i][j], b2_s[c0 + j]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, int N, int D, int F, Dropout drop, int device, void* stream) {
  const Layout L(D, F);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kern = ffn_fwd_kernel<T>;
  const int blocks = (N + kRows - 1) / kRows;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, blocks, device, 0, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<T*>(y), N, D, F,
      drop);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2 and y share it; b1, b2 are
// float32).  D a multiple of 4 with (64/4)*(D/4) <= 256 output tiles,
// i.e. D <= 64; F a multiple of 4.  Dropout: keep_thresh (0 = off),
// keep_scale, seed (common.cuh Dropout).  Returns a cudaError_t code.
extern "C" int tossctr_fused_ffn_fwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* y, int N, int D,
                                     int F, unsigned keep_thresh, float keep_scale,
                                     unsigned seed, int dtype, int device, void* stream) {
  if (N < 0 || D < 4 || D % 4 != 0 || (kRows / 4) * (D / 4) > kThreads || F < 4 || F % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (dtype == 0) return launch<float>(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
