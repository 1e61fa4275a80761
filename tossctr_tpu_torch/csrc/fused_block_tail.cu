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
// D=64, F=384, bf16) one call reads x and o (134 MB) and writes y (67 MB),
// ~60 us at 3.35 TB/s, and does 56 GFLOP, ~57 us on the bf16 tensor
// cores: memory and compute floors are about equal.  Neither is the floor
// in practice: as in fused_ffn's forward (0.42 ms at these shapes), each
// of the 201M hidden elements takes a tanhf and, with dropout, the
// counter hash on the CUDA cores.
//
// Design, bf16 (tail_fwd_mma): tensor cores (ffn_mma.cuh).  Persistent
// blocks, one an SM, of 16 warps; each warp walks 16-row tiles on its own
// and keeps its rows in registers from start to end: no activation makes
// a round trip through shared memory.  Wout, W1 and W2 are loaded into
// shared memory once per block (114 KB of bf16 at the flagship, rows
// padded against bank conflicts), instead of re-read from L2 every tile;
// where W1 and W2 do not fit beside the warps' buffers (F above 512 at D
// = 64) the block loads them in panels of 64-column chunks, all warps in
// step.  A warp's tile: o and x copied with cp.async (zeros past N); a =
// o @ Wout on mma.sync; r1 and RMSNorm 1 in the C fragments, each row's
// sum of squares over its quad's lanes; y1 packed into A fragments; for
// each 64-column hidden chunk, y1 @ W1c on mma.sync, bias, GELU, dropout
// and the bf16 rounding in place, packed into the A fragments of the
// product with W2c (ffn_mma.cuh fwd_chunk), the FFN output accumulating
// in registers; then b2, r2, RMSNorm 2 and y, written from the C
// fragments.  The warp copies its next tile's o and x as soon as it has
// read the current ones, so the copy overlaps the FFN.  D is padded to a
// multiple of 16 and F to one of 64 with zeros.  Serving (dropout off)
// and training (on) run the same kernel.
//
// fp32 (block_tail_fwd_kernel): exact fp32 on the CUDA cores.  A block
// owns a tile of 64 rows.  The (64, F) hidden block never exists whole:
// F is walked in chunks of 64 columns, each chunk's W1 and W2 slices are
// staged in shared memory, the chunk's GELU output is rounded into
// shared memory and immediately multiplied into the (64, D) FFN
// accumulator that each thread keeps in registers.  Residuals and both
// norms stay in shared memory; 4x4 register tiles.
#include "ffn_core.cuh"
#include "ffn_mma.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::load4;
using tossctr::round_t;
using tossctr::to_f;
using tossctr::ffn::kChunk;
using tossctr::ffn::kRows;
using tossctr::ffn::kThreads;

constexpr int kWarps = kThreads / 32;
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

  // ---- FFN over hidden chunks; each of the first out_tiles threads
  // keeps its 4x4 tile of the (64, D) FFN output in registers ----
  float ff[4][4] = {};
  tossctr::ffn::forward_walk<T>(y1_s, AS, w1, w2, b1_s, D, F, row0, drop, wa, wb, g_s, GS, ff);

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


// ---- bf16: the tensor-core kernel ----

namespace tc {

using tossctr::ffn_mma::kChunk;
using tossctr::ffn_mma::kWarpRows;
using tossctr::ptx::bf16;
using tossctr::ptx::round_up;
using tossctr::ptx::row_stride;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

struct Layout {  // offsets in bytes; panel: hidden columns of W1, W2 held at once
  int lda, ld1, ld2;
  int vec, b1, wout, w1, w2, x, total;
  __host__ __device__ Layout(int DP, int F, int panel) {
    lda = row_stride(DP);
    ld1 = row_stride(panel);
    ld2 = row_stride(DP);
    vec = 0;                             // bout, wn1, b2, wn2: DP fp32 each
    b1 = vec + 4 * DP * 4;
    wout = b1 + round_up(F, kChunk) * 4;  // Wout (DP, DP)
    w1 = wout + DP * lda * 2;            // W1's panel columns (DP, panel)
    w2 = w1 + DP * ld1 * 2;              // W2's panel rows (panel, DP)
    x = w2 + panel * ld2 * 2;            // each warp's (16, DP) o and x tiles
    total = x + kWarps * 2 * kWarpRows * lda * 2;
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
tail_fwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ o,
             const bf16* __restrict__ wout, const float* __restrict__ bout,
             const float* __restrict__ wn1, const bf16* __restrict__ w1,
             const float* __restrict__ b1, const bf16* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ wn2, bf16* __restrict__ y,
             int N, int D, int F, int panel, Dropout drop) {
  using namespace tossctr::ffn_mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(DP, F, panel);
  float* bout_s = reinterpret_cast<float*>(smem + L.vec);
  float* wn1_s = bout_s + DP;
  float* b2_s = wn1_s + DP;
  float* wn2_s = b2_s + DP;
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  bf16* wout_s = reinterpret_cast<bf16*>(smem + L.wout);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* ow = reinterpret_cast<bf16*>(smem + L.x) + warp * 2 * kWarpRows * L.lda;
  bf16* xw = ow + kWarpRows * L.lda;
  const int FP = round_up(F, kChunk), n_panels = (FP + panel - 1) / panel;
  const int n_tiles = (N + kWarpRows - 1) / kWarpRows;
  const int stride = gridDim.x * kWarps;

  for (int i = tid; i < DP; i += kThreads) {
    const bool in = i < D;
    bout_s[i] = in ? bout[i] : 0.f;
    wn1_s[i] = in ? wn1[i] : 0.f;
    b2_s[i] = in ? b2[i] : 0.f;
    wn2_s[i] = in ? wn2[i] : 0.f;
  }
  for (int i = tid; i < FP; i += kThreads) b1s[i] = i < F ? b1[i] : 0.f;
  auto load_panel = [&](int p) {  // every thread; W1 columns / W2 rows p*panel ..
    const int c0 = p * panel;
    copy_async(w1s, L.ld1, w1 + c0, F, DP, panel, D, F - c0, tid, kThreads);
    copy_async(w2s, L.ld2, w2 + (size_t)c0 * D, D, panel, DP, F - c0, D, tid, kThreads);
  };
  auto load_rows = [&](int tile) {  // the warp's lanes: the tile's o and x, zeros past N
    const int r0 = tile * kWarpRows;
    copy_async(ow, L.lda, o + (size_t)r0 * D, D, kWarpRows, DP, N - r0, D, lane, 32);
    copy_async(xw, L.lda, x + (size_t)r0 * D, D, kWarpRows, DP, N - r0, D, lane, 32);
  };
  copy_async(wout_s, L.lda, wout, D, DP, DP, D, D, tid, kThreads);
  if (n_panels == 1) load_panel(0);  // once for every tile of the block
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Rounds of one tile a warp; the bound is the block's, so that every
  // warp meets the panel barriers
  if (blockIdx.x * kWarps + warp < n_tiles) load_rows(blockIdx.x * kWarps + warp);
  cp_async_commit();
  for (int base = blockIdx.x * kWarps; base < n_tiles; base += stride) {
    const int tile = base + warp, row = tile * kWarpRows;
    const bool active = tile < n_tiles;
    cp_async_wait<0>();
    __syncwarp();
    uint32_t ya[DP / 16][4];
    float acc[DP / 8][4] = {};  // a, then the FFN output, r2
    if (active) {
      uint32_t oa[DP / 16][4], r1[DP / 8][2];
      float inv1[2];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(oa[kk], tile_p1(ow, L.lda, 0, kk * 16, lane));
      rows_nn<DP>(oa, wout_s, L.lda, acc);
      tail_norm1<DP>(acc, xw, L.lda, bout_s, wn1_s, D, r1, inv1, ya);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    __syncwarp();  // the tile's o and x read: the buffers take the next tile's
    if (tile + stride < n_tiles) load_rows(tile + stride);
    cp_async_commit();
    for (int p = 0; p < n_panels; ++p) {
      if (n_panels > 1) {
        __syncthreads();  // every warp is done with the previous panel
        load_panel(p);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!active) continue;
      for (int c = 0, f0 = p * panel; c < panel && f0 < FP; c += kChunk, f0 += kChunk)
        fwd_chunk<DP>(ya, w1s + c, L.ld1, w2s + c * L.ld2, L.ld2, b1s + f0, f0, row, drop, acc);
    }
    if (!active) continue;
    // ---- r2 = round(y1 + round(ff + b2)), y = round(wn2 * (r2 * inv2)) ----
    float inv2[2];
    tail_residual2<DP>(acc, ya, b2_s, D, inv2);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (c >= D) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row + g + 8 * hr;
        if (r < N)
          *reinterpret_cast<uint32_t*>(y + (size_t)r * D + c) =
              pack_bf16(__fmul_rn(wn2_s[c], __fmul_rn(acc[j][2 * hr], inv2[hr])),
                        __fmul_rn(wn2_s[c + 1], __fmul_rn(acc[j][2 * hr + 1], inv2[hr])));
      }
    }
  }
  cp_async_wait<0>();
}

template <int DP>
int launch(const void* x, const void* o, const void* wout, const void* bout, const void* wn1,
           const void* w1, const void* b1, const void* w2, const void* b2, const void* wn2,
           void* y, int N, int D, int F, Dropout drop, int device, void* stream) {
  const size_t optin = tossctr::smem_optin(device);
  int panel = round_up(F, kChunk);  // all of W1 and W2 if they fit, else the most that does
  while (panel > kChunk && (size_t)Layout(DP, F, panel).total > optin) panel -= kChunk;
  const size_t smem = (size_t)Layout(DP, F, panel).total;
  if (smem > optin) return (int)cudaErrorInvalidConfiguration;
  auto kern = tail_fwd_mma<DP>;
  const int n_tiles = (N + kWarpRows - 1) / kWarpRows;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, (n_tiles + kWarps - 1) / kWarps,
                                          device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout), static_cast<const float*>(wn1),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wn2), static_cast<bf16*>(y), N, D,
      F, panel, drop);
  return (int)cudaGetLastError();
}

// D padded to the next multiple of 16
int launch_bf16(const void* x, const void* o, const void* wout, const void* bout,
                const void* wn1, const void* w1, const void* b1, const void* w2, const void* b2,
                const void* wn2, void* y, int N, int D, int F, Dropout drop, int device,
                void* stream) {
  if (D <= 16)
    return launch<16>(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, y, N, D, F, drop, device, stream);
  if (D <= 32)
    return launch<32>(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, y, N, D, F, drop, device, stream);
  if (D <= 48)
    return launch<48>(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, y, N, D, F, drop, device, stream);
  return launch<64>(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, y, N, D, F, drop, device, stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); x, o, wout, w1, w2 and y share it; biases and norm weights are
// float32.  D must be a multiple of 4 with
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
    return tc::launch_bf16(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, y, N, D, F, drop, device,
                           stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
