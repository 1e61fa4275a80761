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
//   dW1 += x^T round_T(dh)                 db1 += dh (unrounded)
//   dx   = round_T(round_T(dh) @ W1^T)
// keep is the forward's counter-hash mask of (absolute row, hidden
// column, seed), regenerated here.  dW1, db1, dW2 and db2 are sums over
// the rows in fp32.
//
// What bounds it on the card: at the flagship shapes (N = 8192*64 rows,
// D=64, F=384, bf16) one call reads x and dy (134 MB) and writes dx
// (67 MB), ~60 us at 3.35 TB/s, and does ~129 GFLOP with the hidden
// layer recomputed, ~130 us on the bf16 tensor cores.  The epilogue sets
// the floor in practice: each of the 201M hidden elements takes a tanhf,
// GELU and its derivative and, with dropout, the counter hash on the CUDA
// cores, an estimated 0.3-0.5 ms from instruction counts.
//
// Design, bf16 (ffn_bwd_mma): tensor cores (ffn_mma.cuh), every product an
// mma.sync fed by ldmatrix; an operand that needs transposing is read with
// ldmatrix.trans from its row-major bf16 tile.  Persistent blocks (the
// grid the caller names, one an SM by default) of 8 warps walk
// super-tiles of 256 rows, whose x and dy stay in shared memory (bf16)
// while the block walks the hidden dimension in chunks of 64: chunk
// outer, rows inner.  A chunk's W1 and W2 slices are double-buffered with
// cp.async, the next one loading while the current one computes.  For a
// chunk, each warp recomputes h and g for its 16 rows of a 128-row
// sub-tile in registers, forms dh beside them, adds round(dh) @ W1c^T to
// its rows' dx (registers, over all chunks) and writes g and round(dh) to
// shared memory; then the block's warps contract over the sub-tile's rows
// for the chunk's dW2 (warps 0-3) and dW1 (warps 4-7), accumulated in
// registers over the super-tile's two sub-tiles.  Only then is the chunk
// flushed into the block's fp32 partial buffer in device memory, with
// float2 atomics that have one owner thread an entry (so they repeat bit
// for bit): once per 256 rows, against once per 64 rows before.  db1 sums
// the unrounded dh per lane, then across lanes and warps in a fixed order;
// db2 sums dy's columns in fixed row groups.  A second kernel
// (common.cuh reduce_partials) adds the partials in block order, so the
// weight gradients repeat bit for bit, and a row's dx does not depend on
// the grid.  Rows past N are loaded as zeros (their dy is 0, so they add
// nothing), D is padded to a multiple of 16 and F to one of 64 with zeros.
//
// fp32 (ffn_bwd_kernel): exact fp32 on the CUDA cores,
// fused_block_tail_bwd.cu's FFN stretch without the out-projection and the
// norms (ffn_core.cuh's hidden recompute and dW1 / dW2 stages): blocks walk
// 64-row tiles, each walking F in chunks of 64 with the chunk's weights
// staged (W1 twice, as is and transposed, W2 transposed) and 4x4 register
// tiles; weight gradients go to the same per-block partials, once per tile.
#include "ffn_core.cuh"
#include "ffn_mma.cuh"

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

// ---- bf16: the tensor-core kernel ----

namespace tc {

using tossctr::ptx::bf16;
using tossctr::ffn_mma::kChunk;
using tossctr::ffn_mma::kWarpRows;
using tossctr::ptx::round_up;
using tossctr::ptx::row_stride;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSub = kWarps * kWarpRows;  // rows of a sub-tile: 16 a warp
constexpr int kSubs = 2;                  // sub-tiles of a super-tile
constexpr int kSuper = kSub * kSubs;      // rows a block holds, and flushes once a chunk
constexpr int kGroups = kThreads / 64;    // db2: 64 columns x kGroups row groups

struct Layout {  // offsets in bytes
  int lda, ldg, ld1, ld2;
  int b1, db1, db2, x, dy, g, dh, w1, w2, total;
  __host__ __device__ Layout(int DP, int F) {
    lda = row_stride(DP);
    ldg = row_stride(kChunk);
    ld1 = row_stride(kChunk);
    ld2 = row_stride(DP);
    b1 = 0;
    db1 = b1 + round_up(F, kChunk) * 4;
    db2 = db1 + kWarps * kChunk * 4;   // each warp's db1 over the chunk
    x = db2 + kGroups * 64 * 4;        // each row group's db2
    dy = x + kSuper * lda * 2;         // the super-tile's x and dy
    g = dy + kSuper * lda * 2;         // a sub-tile's g and round(dh)
    dh = g + kSub * ldg * 2;
    w1 = dh + kSub * ldg * 2;          // two buffers of a chunk's W1 columns (DP, 64)
    w2 = w1 + 2 * DP * ld1 * 2;        // and of its W2 rows (64, DP)
    total = w2 + 2 * kChunk * ld2 * 2;
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
            const float* __restrict__ b1, const bf16* __restrict__ w2,
            const bf16* __restrict__ dy, bf16* __restrict__ dx, float* __restrict__ partials,
            int N, int D, int F, Dropout drop) {
  using namespace tossctr::ffn_mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(DP, F);
  const Partials P(D, F);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* db1s = reinterpret_cast<float*>(smem + L.db1);
  float* db2s = reinterpret_cast<float*>(smem + L.db2);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* dys = reinterpret_cast<bf16*>(smem + L.dy);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g);
  bf16* dhs = reinterpret_cast<bf16*>(smem + L.dh);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int FP = round_up(F, kChunk), n_chunks = FP / kChunk;
  const int n_super = (N + kSuper - 1) / kSuper;
  float* part = partials + (size_t)blockIdx.x * P.total;

  for (int i = tid; i < P.total; i += kThreads) part[i] = 0.f;
  for (int i = tid; i < FP; i += kThreads) b1s[i] = i < F ? b1[i] : 0.f;
  auto load_weights = [&](int c, int buf) {  // chunk c's W1 columns and W2 rows
    const int f0 = c * kChunk;
    copy_async(w1s + buf * DP * L.ld1, L.ld1, w1 + f0, F, DP, kChunk, D, F - f0, tid, kThreads);
    copy_async(w2s + buf * kChunk * L.ld2, L.ld2, w2 + (size_t)f0 * D, D, kChunk, DP, F - f0,
               D, tid, kThreads);
  };

  const int col = tid & 63, grp = tid >> 6;  // db2: this thread's column and row group
  float db2p = 0.f;
  int step = 0;  // chunks walked by the block: the weights of step k are in buffer k & 1
  if ((int)blockIdx.x < n_super) load_weights(0, 0);
  cp_async_commit();
  for (int st = blockIdx.x; st < n_super; st += gridDim.x) {
    const int row0 = st * kSuper;
    copy_async(xs, L.lda, x + (size_t)row0 * D, D, kSuper, DP, N - row0, D, tid, kThreads);
    copy_async(dys, L.lda, dy + (size_t)row0 * D, D, kSuper, DP, N - row0, D, tid, kThreads);
    cp_async_commit();
    float dxa[kSubs][DP / 8][4] = {};  // dx of the warp's rows of each sub-tile
    for (int c = 0; c < n_chunks; ++c, ++step) {
      const int f0 = c * kChunk;
      if (c + 1 < n_chunks)
        load_weights(c + 1, (step + 1) & 1);
      else if (st + (int)gridDim.x < n_super)
        load_weights(0, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // all but the prefetch just issued: x, dy, this chunk's weights
      __syncthreads();
      if (c == 0 && col < D) {  // db2 += dy over this group's rows
        for (int r = grp * (kSuper / kGroups); r < (grp + 1) * (kSuper / kGroups); ++r)
          db2p += __bfloat162float(dys[r * L.lda + col]);
      }
      const bf16* w1c = w1s + (step & 1) * DP * L.ld1;
      const bf16* w2c = w2s + (step & 1) * kChunk * L.ld2;
      float acc[8][4] = {};   // this warp's block of dW2c (warps 0-3) or dW1c (4-7)
      float db1p[8][2] = {};
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        const int r0 = s * kSub + warp * kWarpRows;
        bwd_hidden<DP>(xs + r0 * L.lda, dys + r0 * L.lda, L.lda, w1c, L.ld1, w2c, L.ld2,
                       b1s + f0, f0, row0 + r0, drop, gs + warp * kWarpRows * L.ldg,
                       dhs + warp * kWarpRows * L.ldg, L.ldg, dxa[s], db1p);
        if (s == kSubs - 1) {  // the warp's db1 over the super-tile: lanes of one column summed
#pragma unroll
          for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = column_sum(db1p[k][e]);
              if (g == 0) db1s[warp * kChunk + k * 8 + 2 * t + e] = v;
            }
        }
        __syncthreads();  // g, round(dh) of the sub-tile written
        if (warp < kChunk / kWarpRows)
          wgrad_dw2<DP>(gs, L.ldg, dys + s * kSub * L.lda, L.lda, kSub, warp, acc);
        else if (warp - kChunk / kWarpRows < DP / 16)
          wgrad_dw1(xs + s * kSub * L.lda, L.lda, dhs, L.ldg, kSub, warp - kChunk / kWarpRows,
                    acc);
        __syncthreads();  // the sub-tile's g, round(dh) read
      }
      // ---- flush the chunk's weight gradients of the super-tile ----
      if (warp < kChunk / kWarpRows)
        add_block<DP / 8>(part + P.dw2, D, f0 + warp * kWarpRows, 0, F, D, acc);
      else if (warp - kChunk / kWarpRows < DP / 16)
        add_block<8>(part + P.dw1, F, (warp - kChunk / kWarpRows) * kWarpRows, f0, D, F, acc);
      if (tid < kChunk && f0 + tid < F) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += db1s[w * kChunk + tid];
        part[P.db1 + f0 + tid] += sum;
      }
    }
    // ---- dx = round_bf16(acc), rows past N and columns past D not written ----
#pragma unroll
    for (int s = 0; s < kSubs; ++s)
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = j * 8 + 2 * t;
        if (c >= D) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = row0 + s * kSub + warp * kWarpRows + g + hr * 8;
          if (r < N)
            *reinterpret_cast<uint32_t*>(dx + (size_t)r * D + c) =
                pack_bf16(dxa[s][j][2 * hr], dxa[s][j][2 * hr + 1]);
        }
      }
  }
  cp_async_wait<0>();
  // ---- db2: the row groups' sums in group order ----
  db2s[grp * 64 + col] = db2p;
  __syncthreads();
  if (tid < D) {
    float sum = 0.f;
    for (int q = 0; q < kGroups; ++q) sum += db2s[q * 64 + tid];
    part[P.db2 + tid] = sum;
  }
}

template <int DP>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
           void* dx, float* partials, float* grads, int blocks, int N, int D, int F,
           Dropout drop, int device, void* stream) {
  const size_t smem = (size_t)Layout(DP, F).total;
  auto kern = ffn_bwd_mma<DP>;
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, blocks, device, 0, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<blocks, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      partials, N, D, F, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, blocks, Partials(D, F).total, grads, s);
}

// D padded to the next multiple of 16
int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                void* dx, float* partials, float* grads, int blocks, int N, int D, int F,
                Dropout drop, int device, void* stream) {
  if (D <= 16)
    return launch<16>(x, w1, b1, w2, dy, dx, partials, grads, blocks, N, D, F, drop,
                      device, stream);
  if (D <= 32)
    return launch<32>(x, w1, b1, w2, dy, dx, partials, grads, blocks, N, D, F, drop,
                      device, stream);
  if (D <= 48)
    return launch<48>(x, w1, b1, w2, dy, dx, partials, grads, blocks, N, D, F, drop,
                      device, stream);
  return launch<64>(x, w1, b1, w2, dy, dx, partials, grads, blocks, N, D, F, drop,
                    device, stream);
}

}  // namespace tc

bool shape_ok(int N, int D, int F) {
  return N >= 0 && D >= 4 && D % 4 == 0 && (kRows / 4) * (D / 4) <= kThreads && F >= 4 &&
         F % 4 == 0;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); x, w1, w2, dy and dx share it; b1 is float32.  blocks: the
// grid, one block an SM (each walks row tiles with a stride of the grid;
// a block with none writes zeros).  partials: (blocks, n) fp32 scratch;
// grads: (n) fp32 out = [dW1 (D, F) | db1 (F) | dW2 (F, D) | db2 (D)].
// Dropout: keep_thresh (0 = off), keep_scale, seed, as the forward got
// them.  D <= 64, D and F multiples of 4.  Returns a cudaError_t code.
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
    return tc::launch_bf16(x, w1, b1, w2, dy, dx, p, g, blocks, N, D, F, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
