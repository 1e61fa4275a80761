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
// cores.  Neither is the floor in practice: the epilogue is.  Each of the
// 201M hidden elements takes a tanhf and, with dropout, a ~17-operation
// counter hash on the CUDA cores, an estimated 0.2-0.4 ms from instruction
// counts.
//
// Design, bf16 (ffn_fwd_mma): tensor cores (ffn_mma.cuh).  Persistent
// blocks, one an SM, of 16 warps; each warp walks 16-row tiles on its
// own.  W1 and W2 are loaded into shared memory once per block (96 KB of
// bf16 at the flagship, rows padded against bank conflicts); where they
// do not fit beside the x buffers (F above ~700 at D = 64) the block
// loads them in panels of 64-column chunks, all warps in step.  A warp's
// next x tile is copied with cp.async while it computes the current one.
// For each 64-column hidden chunk, x @ W1c runs on mma.sync into fp32
// registers, which take bias, GELU, dropout and the bf16 rounding in place
// and become the A fragments of g @ W2c: the hidden layer never leaves
// registers.  y accumulates in registers over the chunks.  D is padded to
// a multiple of 16 and F to one of 64 with zeros in shared memory.
//
// fp32 (ffn_fwd_kernel): exact fp32 on the CUDA cores, fused_block_tail.cu's
// FFN stretch (ffn_core.cuh forward_walk) without the out-projection and
// the norms: a block owns a tile of 64 rows and walks F in chunks of 64,
// staging each chunk's weights in shared memory; 4x4 register tiles.
#include "ffn_core.cuh"
#include "ffn_mma.cuh"

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

// ---- bf16: the tensor-core kernel ----

namespace tc {

using tossctr::ptx::bf16;
using tossctr::ffn_mma::kChunk;
using tossctr::ffn_mma::kWarpRows;
using tossctr::ptx::round_up;
using tossctr::ptx::row_stride;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

struct Layout {  // offsets in bytes; panel: hidden columns of W1, W2 held at once
  int ldx, ld1, ld2;
  int b1, b2, w1, w2, x, total;
  __host__ __device__ Layout(int DP, int F, int panel) {
    ldx = row_stride(DP);
    ld1 = row_stride(panel);
    ld2 = row_stride(DP);
    b1 = 0;
    b2 = b1 + round_up(F, kChunk) * 4;
    w1 = b2 + DP * 4;             // W1's panel columns (DP, panel)
    w2 = w1 + DP * ld1 * 2;       // W2's panel rows (panel, DP)
    x = w2 + panel * ld2 * 2;     // two (16, DP) x tiles a warp
    total = x + kWarps * 2 * kWarpRows * ldx * 2;
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
            const float* __restrict__ b1, const bf16* __restrict__ w2,
            const float* __restrict__ b2, bf16* __restrict__ y, int N, int D, int F, int panel,
            Dropout drop) {
  using namespace tossctr::ffn_mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(DP, F, panel);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* xw = reinterpret_cast<bf16*>(smem + L.x) + warp * 2 * kWarpRows * L.ldx;
  const int FP = round_up(F, kChunk);
  const int n_panels = (FP + panel - 1) / panel;
  const int n_tiles = (N + kWarpRows - 1) / kWarpRows;
  const int stride = gridDim.x * kWarps;

  for (int i = tid; i < FP; i += kThreads) b1s[i] = i < F ? b1[i] : 0.f;
  for (int i = tid; i < DP; i += kThreads) b2s[i] = i < D ? b2[i] : 0.f;
  auto load_panel = [&](int p) {  // every thread; W1 columns / W2 rows p*panel ..
    const int c0 = p * panel;
    copy_async(w1s, L.ld1, w1 + c0, F, DP, panel, D, F - c0, tid, kThreads);
    copy_async(w2s, L.ld2, w2 + (size_t)c0 * D, D, panel, DP, F - c0, D, tid, kThreads);
  };
  auto load_x = [&](int tile, bf16* dst) {  // the warp's lanes
    const int r0 = tile * kWarpRows;
    copy_async(dst, L.ldx, x + (size_t)r0 * D, D, kWarpRows, DP, N - r0, D, lane, 32);
  };
  if (n_panels == 1) load_panel(0);  // once for every tile of the block
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Rounds of one tile a warp; the bound is the block's, so that every
  // warp meets the panel barriers
  int buf = 0;
  if (blockIdx.x * kWarps + warp < n_tiles) load_x(blockIdx.x * kWarps + warp, xw);
  cp_async_commit();
  for (int base = blockIdx.x * kWarps; base < n_tiles; base += stride, buf ^= 1) {
    const int tile = base + warp;
    const bool active = tile < n_tiles;
    if (tile + stride < n_tiles) load_x(tile + stride, xw + (buf ^ 1) * kWarpRows * L.ldx);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    uint32_t xa[DP / 16][4];
    if (active) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldsm_x4(xa[kk], tile_p1(xw + buf * kWarpRows * L.ldx, L.ldx, 0, kk * 16, lane));
    }
    __syncwarp();
    float acc[DP / 8][4] = {};
    for (int p = 0; p < n_panels; ++p) {
      if (n_panels > 1) {
        __syncthreads();  // every warp is done with the previous panel
        load_panel(p);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!active) continue;
      const int pc = min(panel, FP - p * panel);
      for (int c = 0; c < pc; c += kChunk)
        fwd_chunk<DP>(xa, w1s + c, L.ld1, w2s + c * L.ld2, L.ld2, b1s + p * panel + c,
                      p * panel + c, tile * kWarpRows, drop, acc);
    }
    if (!active) continue;
    // ---- y = round_bf16(acc + b2), rows past N and columns past D not written ----
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (c >= D) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = tile * kWarpRows + g + hr * 8;
        if (r < N)
          *reinterpret_cast<uint32_t*>(y + (size_t)r * D + c) = pack_bf16(
              __fadd_rn(acc[j][2 * hr], b2s[c]), __fadd_rn(acc[j][2 * hr + 1], b2s[c + 1]));
      }
    }
  }
  cp_async_wait<0>();
}

template <int DP>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* y,
           int N, int D, int F, Dropout drop, int device, void* stream) {
  const size_t optin = tossctr::smem_optin(device);
  int panel = round_up(F, kChunk);  // all of W1 and W2 if they fit, else the most that does
  while (panel > kChunk && (size_t)Layout(DP, F, panel).total > optin) panel -= kChunk;
  const size_t smem = (size_t)Layout(DP, F, panel).total;
  if (smem > optin) return (int)cudaErrorInvalidConfiguration;
  auto kern = ffn_fwd_mma<DP>;
  const int n_tiles = (N + kWarpRows - 1) / kWarpRows;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, (n_tiles + kWarps - 1) / kWarps,
                                          device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(y), N, D, F,
      panel, drop);
  return (int)cudaGetLastError();
}

// D padded to the next multiple of 16
int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* y, int N, int D, int F, Dropout drop, int device, void* stream) {
  if (D <= 16) return launch<16>(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
  if (D <= 32) return launch<32>(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
  if (D <= 48) return launch<48>(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
  return launch<64>(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); x, w1, w2 and y share it; b1, b2 are float32.  D a multiple of
// 4 with (64/4)*(D/4) <= 256 output tiles, i.e. D <= 64; F a multiple of
// 4.  Dropout: keep_thresh (0 = off), keep_scale, seed (common.cuh
// Dropout).  Returns a cudaError_t code.
extern "C" int tossctr_fused_ffn_fwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* y, int N, int D,
                                     int F, unsigned keep_thresh, float keep_scale,
                                     unsigned seed, int dtype, int device, void* stream) {
  if (N < 0 || D < 4 || D % 4 != 0 || (kRows / 4) * (D / 4) > kThreads || F < 4 || F % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (dtype == 0) return launch<float>(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
  if (dtype == 1) return tc::launch_bf16(x, w1, b1, w2, b2, y, N, D, F, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
