// fused_mha_qkv backward: gradients of the fused qkv projection +
// multi-head attention of one DARE encoder layer, for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_attention.py fused_mha_qkv, backward
// pallas_call in _bwd_call_qkv (kernel _attn_bwd_kernel_packed_qkv; core
// _qkv_project / _packed_group_scores / _packed_attend_bwd).
//
// What it computes, per batch row b (x, do: (B, K, D); H heads of width
// dh = D / H), with the rounding points of the Pallas kernel:
//   q, k, v = round_T(x[b] @ Wqkv + bqkv)                 (recomputed)
//   p_h     = softmax(q_h k_h^T * scale + bias)            (fp32, not rounded)
//   dv_h    = round_T(p_h * keep_h)^T @ do_h
//   dp_h    = (do_h @ v_h^T) * keep_h
//   ds_h    = p_h * (dp_h - rowsum(dp_h * p_h))            (fp32)
//   dbias  += ds_h                                          (unscaled, fp32)
//   dk_h    = round_T(ds_h * scale)^T @ q_h,  dq_h = round_T(ds_h * scale) @ k_h
//   dx[b]   = round_T(round_T([dq|dk|dv]) @ Wqkv^T)
//   dWqkv  += x[b]^T @ round_T([dq|dk|dv]),  dbqkv += colsum([dq|dk|dv])
// keep_h is the forward's counter-hash mask, regenerated here.  dWqkv,
// dbqkv and dbias are sums over the batch in fp32.
//
// What bounds it on the card: at the flagship shapes (B=8192, K=64, D=64,
// H=8) one call reads x and do (134 MB) and writes dx (67 MB), ~60 us at
// 3.35 TB/s, and does ~60 GFLOP (~61 us on the bf16 tensor cores): memory
// and compute floors are about equal.  In practice the elementwise work of
// the 268M score elements on the CUDA cores (expf, the division, the keep
// hash, ds, dbias: ~30 lane instructions an element, ~0.3 ms) sets it, as
// in fused_mha_bwd.cu.
//
// Design, bf16 at K <= 128 (mha_qkv_bwd_mma): every product on the
// tensor cores (mma.sync, bf16 operands, fp32 sums).  One persistent block
// an SM walks batch rows with Wqkv (bf16, each head's columns padded to 8
// or 16) resident; a row's x and do come in whole with cp.async into bf16
// slabs, the next row's do while dWqkv and dx compute.  Per row: q, k, v =
// round(x Wqkv + b) on mma into slabs; the attention core of mha_mma.cuh
// (fused_mha_bwd.cu's: (query tile, head) units with the scores, softmax,
// ds and dq in registers, (key tile, head) units for dk and dv, dbias in
// owner-lane registers); then dWqkv += x^T round([dq|dk|dv]) on mma, one
// owner thread an entry, and dx = round([dq|dk|dv] Wqkv^T) through a
// staging tile to 16-byte stores.  dbqkv sums the unrounded dq, dk, dv
// from the units' fragments into shared slots, one owner warp a (tile,
// head).  K is padded to 64 or 128:
//   - 64 (the flagship): 16 warps in two halves that take alternate head
//     groups, each half with its own barrier, so the halves' barriers do
//     not wait on each other, as two blocks of 8 warps would not; dWqkv's
//     sums in shared memory (registers would not leave the core its 128);
//     the bias and two buffers of x resident (the next row's x loads while
//     the current row computes); 223 KB;
//   - 128 (K = 120): 8 warps; dWqkv's sums added once a row into the
//     block's partial in device memory (one owner thread an entry, so in a
//     fixed order); the bias read from device memory, one buffer of x;
//     208 KB.
// At the end each block writes its fp32 partials once; a second kernel
// (common.cuh reduce_partials) adds them in block order, so the result
// repeats bit for bit (fp32 atomics would not), and a row's dx does not
// depend on the grid.
//
// fp32 (and bf16 above K = 128): the CUDA cores.  The row-resident kernel
// (fp32, K <= 64): as the forward, one persistent block walks batch rows
// with Wqkv and the bias resident in shared memory, and a row's x, do, q,
// k, v, their gradients and one head's (K, K) P and dS never leave shared
// memory (one block an SM); each thread keeps its 4x4 tiles of dWqkv in
// registers and its dbqkv column, the block's dbias lives in shared
// memory with one owner thread per entry.  The key-tiled kernel (above K
// = 64, and at any K in fp32 when the caller asks): x, Wqkv and an fp32
// dx accumulator stay resident for the row, and each head is projected,
// run through mha_core.cuh head_bwd_tiled (queries in tiles of QT rows: 64
// at K = 120, 32 at K = 152) and folded into dx, dWqkv and dbqkv before
// the next; dWqkv is held in 4x2 register tiles assigned head by head,
// and the block's dbias partial lives in device memory (one
// read-modify-write an entry a row and head, by one thread).  Shared
// memory grows as QT x K.  Same rounding points, same mask, same
// block-order reduction; dx sums a head's 3 x dh columns at a time.
// Products in fp32 4x4 register tiles.
#include "mha_core.cuh"
#include "mha_mma.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::round_t;
using tossctr::to_f;
using tossctr::mha::kThreads;
constexpr int kMaxDim = 64;  // D <= 64; the row-resident kernel K <= 64
// dWqkv register tiles per thread: (64/4) * (192/4) tiles over 256 threads
constexpr int kMaxWTiles = (kMaxDim / 4) * (3 * kMaxDim / 4) / kThreads;

struct Layout {
  int K4, XS, KS, VS;
  int w, b, bias, dbias, qT, kT, v, dout, dq, dk, a, ds, total;  // offsets in floats
  __host__ __device__ Layout(int K, int D, int elem_bytes) {
    K4 = align4(K);
    XS = D + 1;  // x row stride
    KS = K + 1;  // score row stride
    VS = D + 1;  // row stride of v, do, dq, dk, dv
    const int w_floats = align4((D * 3 * D * elem_bytes + 3) / 4);
    w = 0;
    b = w + w_floats;
    bias = b + align4(3 * D);
    dbias = bias + align4(K * K);
    qT = dbias + align4(K * K);
    kT = qT + D * K4;
    v = kT + D * K4;  // v, later dv
    dout = v + align4(K4 * VS);
    dq = dout + align4(K4 * VS);
    dk = dq + align4(K4 * VS);
    a = dk + align4(K4 * VS);  // x (projection, weight grads) / one head's P
    ds = a + align4(K4 * XS > K4 * KS ? K4 * XS : K4 * KS);
    total = ds + align4(K4 * KS);
  }
};

__host__ __device__ inline int partial_floats(int K, int D) { return D * 3 * D + 3 * D + K * K; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_qkv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                   const float* __restrict__ bqkv, const T* __restrict__ bias,
                   const T* __restrict__ dout, T* __restrict__ dx, float* __restrict__ partials,
                   int B, int K, int D, int H, float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(K, D, (int)sizeof(T));
  const int D3 = 3 * D;
  const int dh = D / H;
  const int K4 = L.K4, XS = L.XS, KS = L.KS, VS = L.VS;
  T* w_s = reinterpret_cast<T*>(smem + L.w);
  float* b_s = smem + L.b;
  float* bias_s = smem + L.bias;
  float* dbias_s = smem + L.dbias;
  float* qT = smem + L.qT;    // (D, K4): q transposed
  float* kT = smem + L.kT;    // (D, K4): k transposed
  float* v_s = smem + L.v;    // (K4, VS): v, each head's columns replaced by dv
  float* do_s = smem + L.dout;
  float* dq_s = smem + L.dq;  // fp32, rounded where read
  float* dk_s = smem + L.dk;
  float* x_s = smem + L.a;    // (K4, XS)
  float* p_s = smem + L.a;    // (K, KS): P, then round_T(P * keep)
  float* ds_s = smem + L.ds;  // (K, KS): dp * keep, then round_T(ds * scale)
  const int tid = threadIdx.x;

  for (int i = tid; i < D * D3; i += kThreads) w_s[i] = wqkv[i];
  for (int i = tid; i < D3; i += kThreads) b_s[i] = bqkv[i];
  for (int i = tid; i < K * K; i += kThreads) {
    bias_s[i] = to_f<T>(bias[i]);
    dbias_s[i] = 0.f;
  }

  const int CT = D3 / 4;  // column tiles of dWqkv
  const int KT = K4 / 4;
  const int w_tiles = (D / 4) * CT;
  float dw[kMaxWTiles][4][4];
#pragma unroll
  for (int s = 0; s < kMaxWTiles; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dw[s][i][j] = 0.f;
  float db = 0.f;  // thread tid < 3D owns dbqkv[tid]

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const size_t off = (size_t)row * K * D;
    __syncthreads();  // the previous row is done with every buffer
    tossctr::mha::load_rows(x + off, K, D, K4, XS, x_s);
    tossctr::mha::load_rows(dout + off, K, D, K4, VS, do_s);
    __syncthreads();
    tossctr::mha::project_qkv<T>(x_s, XS, w_s, b_s, K4, D, qT, kT, v_s, VS);  // recomputed
    for (int h = 0; h < H; ++h)
      tossctr::mha::head_bwd<T>(qT, kT, bias_s, v_s, do_s, dq_s, dk_s, VS, p_s, ds_s, KS,
                                dbias_s, K, K4, h * dh, dh, scale, row, h, drop);

    // ---- x again (its buffer held P), for dWqkv ----
    tossctr::mha::load_rows(x + off, K, D, K4, XS, x_s);
    if (tid < D3) {  // dbqkv sums the unrounded dq, dk, dv
      const int which = tid / D, col = tid - which * D;
      const float* g = which == 0 ? dq_s : (which == 1 ? dk_s : v_s);
      for (int k = 0; k < K; ++k) db += g[k * VS + col];
    }
    __syncthreads();

    // ---- dx = round_T(round_T([dq|dk|dv]) @ Wqkv^T): 4x4 tiles; a warp
    // spans rows, so the Wqkv reads are broadcasts ----
    for (int t = tid; t < KT * (D / 4); t += kThreads) {
      const int d0 = (t / KT) * 4, k0 = (t % KT) * 4;
      float acc[4][4] = {};
      for (int c = 0; c < D3; ++c) {
        const int which = c / D, col = c - which * D;
        const float* g = which == 0 ? dq_s : (which == 1 ? dk_s : v_s);
        float gv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i] = round_t<T>(g[(k0 + i) * VS + col]);
          wv[i] = to_f<T>(w_s[(d0 + i) * D3 + c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], wv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + i >= K) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) dx[off + (size_t)(k0 + i) * D + d0 + j] = from_f<T>(acc[i][j]);
      }
    }

    // ---- dWqkv += x^T round_T([dq|dk|dv]) into the register tiles ----
#pragma unroll
    for (int s = 0; s < kMaxWTiles; ++s) {
      const int t = tid + s * kThreads;
      if (t < w_tiles) {
        const int d0 = (t / CT) * 4, c0 = (t % CT) * 4;
        const int which = c0 / D, col0 = c0 - which * D;
        const float* g = which == 0 ? dq_s : (which == 1 ? dk_s : v_s);
        for (int k = 0; k < K; ++k) {
          float xv[4], gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xv[i] = x_s[k * XS + d0 + i];
            gv[i] = round_t<T>(g[k * VS + col0 + i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dw[s][i][j] = fmaf(xv[i], gv[j], dw[s][i][j]);
        }
      }
    }
  }

  // ---- this block's partial sums: dWqkv (D, 3D), dbqkv (3D), dbias (K, K) ----
  __syncthreads();
  float* part = partials + (size_t)blockIdx.x * partial_floats(K, D);
#pragma unroll
  for (int s = 0; s < kMaxWTiles; ++s) {
    const int t = tid + s * kThreads;
    if (t < w_tiles) {
      const int d0 = (t / CT) * 4, c0 = (t % CT) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[(d0 + i) * D3 + c0 + j] = dw[s][i][j];
    }
  }
  if (tid < D3) part[D * D3 + tid] = db;
  for (int i = tid; i < K * K; i += kThreads) part[D * D3 + D3 + i] = dbias_s[i];
}

bool shape_ok(int B, int K, int D, int H) {
  return B >= 0 && K >= 1 && D >= 4 && D <= kMaxDim && D % 4 == 0 && H >= 1 && D % H == 0;
}

// Shared memory of the key-tiled kernel, in floats: Wqkv and bqkv, the
// row's x and fp32 dx accumulator, a query tile's bias rows, P and dS,
// and one head's seven (dh, K4) tensors.
struct TiledLayout {
  int K4, XS, KS, QT;
  int w, b, x, dx, bias, p, ds, heads, total;  // offsets in floats
  __host__ __device__ TiledLayout(int K, int D, int dh, int elem_bytes, int QT_) {
    K4 = align4(K);
    XS = D + 1;
    KS = K + 1;
    QT = QT_;
    w = 0;
    b = w + align4((D * 3 * D * elem_bytes + 3) / 4);
    x = b + align4(3 * D);
    dx = x + align4(K4 * XS);
    bias = dx + align4(K4 * XS);
    p = bias + align4(QT * K);
    ds = p + align4(QT * KS);
    heads = ds + align4(QT * KS);
    total = heads + tossctr::mha::kHeadTensors * dh * K4;
  }
};

// dWqkv of the key-tiled kernel: 4x2 tiles (4 rows d, 2 columns c), head
// by head: tile u belongs to head u / per_head, and thread t holds tiles
// t, t + 256, ...  (3 D^2 / 8 tiles: 6 a thread at D = 64)
constexpr int kTiledWSlots = (kMaxDim / 4) * (3 * kMaxDim / 2) / kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_qkv_bwd_tiled_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                         const float* __restrict__ bqkv, const T* __restrict__ bias,
                         const T* __restrict__ dout, T* __restrict__ dx,
                         float* __restrict__ partials, int B, int K, int D, int H, int QT,
                         float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int D3 = 3 * D;
  const int dh = D / H;
  const TiledLayout L(K, D, dh, (int)sizeof(T), QT);
  const int K4 = L.K4, XS = L.XS;
  const bool resident = QT >= K;  // one tile: the bias is staged once
  T* w_s = reinterpret_cast<T*>(smem + L.w);
  float* b_s = smem + L.b;
  float* x_s = smem + L.x;    // (K4, XS)
  float* dx_s = smem + L.dx;  // (K4, XS) fp32 sums over the heads
  float* bias_s = smem + L.bias;
  const tossctr::mha::HeadTiles a(smem + L.heads, dh, K4);
  float* part = partials + (size_t)blockIdx.x * partial_floats(K, D);
  float* dbias = part + D * D3 + D3;  // this block's partial, in device memory
  const int tid = threadIdx.x;

  for (int i = tid; i < D * D3; i += kThreads) w_s[i] = wqkv[i];
  for (int i = tid; i < D3; i += kThreads) b_s[i] = bqkv[i];
  for (int i = tid; i < K * K; i += kThreads) {
    dbias[i] = 0.f;
    if (resident) bias_s[i] = to_f<T>(bias[i]);
  }

  const int KT = K4 / 4;
  const int pairs = 3 * dh / 2;           // column pairs of a head
  const int per_head = (D / 4) * pairs;   // dWqkv tiles of a head
  float dw[kTiledWSlots][4][2];
#pragma unroll
  for (int s = 0; s < kTiledWSlots; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[s][i][0] = dw[s][i][1] = 0.f;
  float db = 0.f;  // thread tid < 3D owns dbqkv[tid]

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const size_t off = (size_t)row * K * D;
    __syncthreads();  // the previous row is done with x_s and dx_s
    tossctr::mha::load_rows(x + off, K, D, K4, XS, x_s);
    for (int i = tid; i < K4 * XS; i += kThreads) dx_s[i] = 0.f;
    for (int h = 0; h < H; ++h) {
      const int hd = h * dh;
      __syncthreads();  // x is staged; the previous head is done with the head's tensors
      tossctr::mha::project_head<T>(x_s, XS, w_s, b_s, K4, D, hd, dh, a.qT, a.kT, a.vT);
      tossctr::mha::load_head(dout + off, K, D, K4, hd, dh, a.doT);
      tossctr::mha::head_bwd_tiled<T>(a, bias, bias_s, resident, smem + L.p, smem + L.ds, L.KS,
                                      QT, dbias, K, K4, dh, scale, row, h, drop);
      const float* g3[3] = {a.dqT, a.dkT, a.dvT};

      // ---- dbqkv sums the unrounded dq, dk, dv of the head's columns ----
      if (tid < D3) {
        const int which = tid / D, col = tid - which * D;
        if (col >= hd && col < hd + dh) {
          const float* g = g3[which] + (col - hd) * K4;
          for (int k = 0; k < K; ++k) db += g[k];
        }
      }
      // ---- dx += round_T(g_h) @ Wqkv[:, head columns]^T: 4x4 tiles (k, d) ----
      for (int t = tid; t < KT * (D / 4); t += kThreads) {
        const int d0 = (t / KT) * 4, k0 = (t % KT) * 4;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dx_s[(k0 + i) * XS + d0 + j];
        for (int which = 0; which < 3; ++which) {
          for (int e = 0; e < dh; ++e) {
            const int c = which * D + hd + e;
            float gv[4], wv[4];
            tossctr::load4(g3[which] + e * K4 + k0, gv);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gv[i] = round_t<T>(gv[i]);
              wv[i] = to_f<T>(w_s[(d0 + i) * D3 + c]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], wv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dx_s[(k0 + i) * XS + d0 + j] = acc[i][j];
      }
      // ---- dWqkv += x^T round_T(g_h) into this head's register tiles ----
#pragma unroll
      for (int s = 0; s < kTiledWSlots; ++s) {
        const int u = tid + s * kThreads;
        if (u < H * per_head && u / per_head == h) {
          const int r = u - h * per_head;
          const int d0 = (r / pairs) * 4, cl = (r % pairs) * 2;
          const int which = cl / dh, e0 = cl - which * dh;
          const float* g = g3[which] + e0 * K4;
          for (int k = 0; k < K; ++k) {
            float xv[4];
            const float g0 = round_t<T>(g[k]), g1 = round_t<T>(g[K4 + k]);
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = x_s[k * XS + d0 + i];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dw[s][i][0] = fmaf(xv[i], g0, dw[s][i][0]);
              dw[s][i][1] = fmaf(xv[i], g1, dw[s][i][1]);
            }
          }
        }
      }
    }
    __syncthreads();
    // ---- dx = round_T(the fp32 sums over the heads) ----
    for (int i = tid; i < K * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      dx[off + i] = from_f<T>(dx_s[r * XS + c]);
    }
  }

  // ---- this block's partial dWqkv (D, 3D) and dbqkv (3D); dbias is
  // already in place ----
#pragma unroll
  for (int s = 0; s < kTiledWSlots; ++s) {
    const int u = tid + s * kThreads;
    if (u < H * per_head) {
      const int h = u / per_head, r = u - h * per_head;
      const int d0 = (r / pairs) * 4, cl = (r % pairs) * 2;
      const int which = cl / dh, e0 = cl - which * dh;
      const int c = which * D + h * dh + e0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[(d0 + i) * D3 + c] = dw[s][i][0];
        part[(d0 + i) * D3 + c + 1] = dw[s][i][1];
      }
    }
  }
  if (tid < D3) part[D * D3 + tid] = db;
}

// the row-resident kernel (fp32, K <= 64)
int launch_resident(const void* x, const void* wqkv, const void* bqkv, const void* bias,
                    const void* dout, void* dx, float* partials, float* grads, int max_blocks,
                    int B, int K, int D, int H, float scale, Dropout drop, int device,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  const size_t smem = (size_t)Layout(K, D, (int)sizeof(float)).total * sizeof(float);
  cudaError_t e = tossctr::prepare_launch(mha_qkv_bwd_kernel<float>, kThreads, smem, max_blocks,
                                          device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  mha_qkv_bwd_kernel<float><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<float*>(dx), partials, B, K, D, H, scale,
      drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, grid, partial_floats(K, D), grads, s);
}

// the key-tiled kernel (fp32 at any K; bf16 above K = 128)
template <typename T>
int launch_tiled(const void* x, const void* wqkv, const void* bqkv, const void* bias,
                 const void* dout, void* dx, float* partials, float* grads, int max_blocks,
                 int B, int K, int D, int H, float scale, Dropout drop, int device,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  const int dh = D / H;
  const int QT = tossctr::mha::pick_query_tile(
      align4(K), tossctr::smem_optin(device),
      [&](int qt) { return TiledLayout(K, D, dh, (int)sizeof(T), qt); });
  if (QT == 0) return (int)cudaErrorInvalidValue;  // no tile fits: refused before launch
  const size_t smem = (size_t)TiledLayout(K, D, dh, (int)sizeof(T), QT).total * sizeof(float);
  cudaError_t e = tossctr::prepare_launch(mha_qkv_bwd_tiled_kernel<T>, kThreads, smem,
                                          max_blocks, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  mha_qkv_bwd_tiled_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(bias), static_cast<const T*>(dout), static_cast<T*>(dx), partials,
      B, K, D, H, QT, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, grid, partial_floats(K, D), grads, s);
}

// ---- bf16 at K <= 128: the tensor-core kernel ----

namespace tc {

using tossctr::mha_mma::Geo;
using tossctr::mha_mma::kMaxKP;
using tossctr::mha_mma::ldp;
using tossctr::ptx::bf16;
using tossctr::ptx::round_up;
using tossctr::ptx::row_stride;
// dWqkv (DP, 3 NQ) in 16 x 16 units: at most (64 / 16) x (3 * 64 / 16)
constexpr int kWUnits = 48;

// The kernel's form at KP = 64: two halves of mha_mma's 8 warps, each with
// its own barrier through a row's head groups, dWqkv summed in shared
// memory, the bias and two buffers of x resident.  At KP = 128 one half:
// the row's P and dS buffers double, and dWqkv goes to the block's partial
// in device memory, the bias is read from device memory, x has one buffer.
template <int KP>
struct Form {
  static constexpr bool kWide = KP > 64;
  static constexpr int kHalves = kWide ? 1 : 2;
  static constexpr int kWarps = kHalves * tossctr::mha_mma::kWarps;
  static constexpr int kThreads = kWarps * 32;
};

template <int KP>
struct Layout {  // offsets in bytes
  int DP, LX, LW, LDW;
  int w, b, bias, x, dout, q, k, v, dq, p, ds, sums, dw, total;
  __host__ __device__ explicit Layout(const Geo& g) {
    using F = Form<KP>;
    DP = round_up(g.D, 16);  // x's columns, Wqkv's rows, padded with zeros
    LX = row_stride(DP);
    LW = row_stride(3 * g.NQ);
    LDW = 3 * g.NQ + 8;  // fp32: a quad's float2 pairs of 8 rows in two wavefronts
    const int slab = KP * g.RS * 2;
    w = 0;                                                    // Wqkv (DP, 3 NQ) bf16
    b = w + DP * LW * 2;                                      // bqkv (3 NQ) fp32
    bias = b + round_up(3 * g.NQ * 4, 16);                    // (KP, ldp(KP)) bf16
    x = bias + (F::kWide ? 0 : KP * ldp(KP) * 2);             // (KP, LX) buffers of x
    dout = x + (F::kWide ? 1 : 2) * KP * LX * 2;              // do's slab
    q = dout + slab;
    k = q + slab;  // k, then dk head by head; v, then dv
    v = k + slab;
    dq = v + slab;
    p = dq + slab;  // round(p * keep) of a 16-row unit a warp; the dx staging tile;
    ds = p + F::kWarps * 16 * ldp(KP) * 2;    // with ds, the dbias flush's scratch
    sums = ds + F::kWarps * 16 * ldp(KP) * 2;  // (KP / 16, 3, NQ) fp32: dbqkv by tile
    dw = sums + (KP / 16) * 3 * g.NQ * 4;      // (DP, LDW) fp32: the block's dWqkv
    total = dw + (F::kWide ? 0 : DP * LDW * 4);
  }
};

template <int KP, int DHP>
__global__ void __launch_bounds__(Form<KP>::kThreads, 1)
mha_qkv_bwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                const bf16* __restrict__ dout, bf16* __restrict__ dx,
                float* __restrict__ partials, int B, int K, int D, int H, float scale,
                Dropout drop) {
  using namespace tossctr::mha_mma;
  using F = Form<KP>;
  constexpr int kWarpsF = F::kWarps, kThreadsF = F::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(K, D, H);
  const Layout<KP> L(geo);
  const int NQ = geo.NQ, RS = geo.RS, QT = geo.QT, DP = L.DP, LX = L.LX, LW = L.LW, D3 = 3 * D;
  bf16* w_s = reinterpret_cast<bf16*>(smem + L.w);
  float* b_s = reinterpret_cast<float*>(smem + L.b);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + L.bias);
  bf16* x_s = reinterpret_cast<bf16*>(smem + L.x);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* dqs = reinterpret_cast<bf16*>(smem + L.dq);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + L.p);
  bf16* dsbuf = reinterpret_cast<bf16*>(smem + L.ds);
  float* sums = reinterpret_cast<float*>(smem + L.sums);
  float* dw_s = reinterpret_cast<float*>(smem + L.dw);
  float* part = partials + (size_t)blockIdx.x * partial_floats(K, D);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int half = warp / tossctr::mha_mma::kWarps;
  auto grad = [&](int which) -> const bf16* {  // [dq|dk|dv] after a row's heads
    return which == 0 ? dqs : (which == 1 ? ks : vs);
  };

  // zeros everywhere: pad rows and columns are never written with anything else
  for (int i = tid; i < L.total / 16; i += kThreadsF)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (F::kWide)
    for (int i = tid; i < D * D3; i += kThreadsF) part[i] = 0.f;  // dWqkv's sums
  __syncthreads();
  for (int i = tid; i < D * D3; i += kThreadsF) {
    const int d = i / D3;
    w_s[d * LW + padded_col(geo, i - d * D3)] = wqkv[i];
  }
  for (int i = tid; i < D3; i += kThreadsF) b_s[padded_col(geo, i)] = bqkv[i];
  if constexpr (!F::kWide)
    for (int i = tid; i < K * K; i += kThreadsF) {
      const int r = i / K;
      bias_s[r * ldp(KP) + i - r * K] = bias[i];
    }
  if ((int)blockIdx.x < B) {
    stage_x(x_s, LX, x + (size_t)blockIdx.x * K * D, K, D);
    stage_heads(do_s, dout + (size_t)blockIdx.x * K * D, geo);
  }
  cp_async_commit();

  const int npairs = 3 * NQ / 16;  // 16-column pairs of [q|k|v]
  const int mt = DP / 16;          // 16-row tiles of Wqkv
  float db[KP / 8][4] = {};
  int it = 0;
  for (int row = blockIdx.x; row < B; row += gridDim.x, ++it) {
    const int next = row + gridDim.x;
    const bf16* xb = x_s + (F::kWide ? 0 : (it & 1) * KP * LX);
    cp_async_wait<0>();
    __syncthreads();  // this row's x and do are in; the previous row is done with every buffer
    if (!F::kWide && next < B)
      stage_x(x_s + ((it + 1) & 1) * KP * LX, LX, x + (size_t)next * K * D, K, D);
    cp_async_commit();

    project_qkv_mma<kWarpsF>(xb, LX, w_s, LW, b_s, qs, ks, vs, geo, DP);
    __syncthreads();

    if constexpr (F::kWide)
      row_grads<KP, DHP>(qs, ks, vs, do_s, bias, K, dqs, pbuf, dsbuf, db, sums, geo, row, scale,
                         drop, half, F::kHalves);
    else
      row_grads<KP, DHP>(qs, ks, vs, do_s, bias_s, ldp(KP), dqs, pbuf, dsbuf, db, sums, geo,
                         row, scale, drop, half, F::kHalves);
    __syncthreads();  // every head is done: do's slab is free
    if (next < B) stage_heads(do_s, dout + (size_t)next * K * D, geo);
    cp_async_commit();

    // ---- dWqkv += x^T round([dq|dk|dv]): unit (16 rows of Wqkv, 16
    // columns), each entry of the block's sums owned by one thread ----
    for (int u = warp; u < mt * npairs; u += kWarpsF) {
      const int m = u % mt, np = u / mt, which = (16 * np) / NQ;
      const int col = 16 * np - which * NQ;
      float acc[2][4] = {};
      for (int kk = 0; kk < QT; ++kk) {
        uint32_t a[4], b[4];
        ldsm_x4_t(a, tile_p2(xb, LX, 16 * kk, 16 * m, lane));  // x^T: x is [r][d]
        ldsm_x4_t(b, tile_p1(grad(which), RS, 16 * kk, col, lane));
        mma(acc[0], a, b[0], b[1]);
        mma(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int d = 16 * m + g + 8 * hr, pc = 16 * np + 8 * jj + 2 * t;
          if constexpr (!F::kWide) {
            float2* e = reinterpret_cast<float2*>(dw_s + d * L.LDW + pc);
            const float2 o = *e;
            *e = make_float2(o.x + acc[jj][2 * hr], o.y + acc[jj][2 * hr + 1]);
          } else {
            const int r = pc - which * NQ, h = r / DHP, e = r - h * DHP;
            if (d < D && h < H && e < geo.dh) {
              float* dst = part + d * D3 + which * D + h * geo.dh + e;
              atomicAdd(dst, acc[jj][2 * hr]);
              atomicAdd(dst + 1, acc[jj][2 * hr + 1]);
            }
          }
        }
    }

    // ---- dx = round(round([dq|dk|dv]) Wqkv^T) into the staging tile ----
    bf16* stage = pbuf;  // (KP, LX): free until the next row's heads
    for (int u = warp; u < QT * mt; u += kWarpsF) {
      const int m = u % QT, np = u / QT;
      float acc[2][4] = {};
      for (int kk = 0; kk < npairs; ++kk) {
        const int which = (16 * kk) / NQ;
        uint32_t a[4], b[4];
        ldsm_x4(a, tile_p1(grad(which), RS, 16 * m, 16 * kk - which * NQ, lane));
        ldsm_x4(b, tile_p2(w_s, LW, 16 * np, 16 * kk, lane));  // Wqkv^T: Wqkv is [n][k]
        mma(acc[0], a, b[0], b[1]);
        mma(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = 16 * np + 8 * jj + 2 * t, r = 16 * m + g;
        *reinterpret_cast<uint32_t*>(stage + r * LX + c) = pack_bf16(acc[jj][0], acc[jj][1]);
        *reinterpret_cast<uint32_t*>(stage + (r + 8) * LX + c) =
            pack_bf16(acc[jj][2], acc[jj][3]);
      }
    }
    __syncthreads();  // dx staged; x's one buffer (KP = 128) is free
    if (F::kWide && next < B) stage_x(x_s, LX, x + (size_t)next * K * D, K, D);
    cp_async_commit();
    {
      const int pe = piece(D), per_row = D / pe;
      bf16* dst = dx + (size_t)row * K * D;
      for (int i = tid; i < K * per_row; i += kThreadsF) {
        const int r = i / per_row, c = (i - r * per_row) * pe;
        if (pe == 8)
          *reinterpret_cast<uint4*>(dst + r * D + c) =
              *reinterpret_cast<const uint4*>(stage + r * LX + c);
        else
          *reinterpret_cast<uint2*>(dst + r * D + c) =
              *reinterpret_cast<const uint2*>(stage + r * LX + c);
      }
    }
  }
  cp_async_wait<0>();

  // ---- this block's partials: dWqkv (D, 3D), dbqkv (3D), dbias (K, K) ----
  flush_dbias<KP>(db, reinterpret_cast<float*>(smem + L.p), geo, part + D * D3 + D3);
  if constexpr (!F::kWide)
    for (int i = tid; i < D * D3; i += kThreadsF) {
      const int d = i / D3;
      part[i] = dw_s[d * L.LDW + padded_col(geo, i - d * D3)];
    }
  for (int c = tid; c < D3; c += kThreadsF) {
    const int pc = padded_col(geo, c), which = pc / NQ, r = pc - which * NQ;
    float sum = 0.f;
    for (int tile = 0; tile < QT; ++tile) sum += sums[(tile * 3 + which) * NQ + r];
    part[D * D3 + c] = sum;
  }
}

template <int KP, int DHP>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* bias,
           const void* dout, void* dx, float* partials, float* grads, int max_blocks, int B,
           int K, int D, int H, float scale, Dropout drop, int device, void* stream) {
  constexpr int threads = Form<KP>::kThreads;
  const size_t smem = (size_t)Layout<KP>(Geo(K, D, H)).total;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(mha_qkv_bwd_mma<KP, DHP>, threads, smem, max_blocks,
                                          device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mha_qkv_bwd_mma<KP, DHP><<<grid, threads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx), partials, B, K, D, H, scale,
      drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, grid, partial_floats(K, D), grads, s);
}

// K padded to 64 or 128, the head to 8 or 16 columns
int launch_bf16(const void* x, const void* wqkv, const void* bqkv, const void* bias,
                const void* dout, void* dx, float* partials, float* grads, int max_blocks,
                int B, int K, int D, int H, float scale, Dropout drop, int device,
                void* stream) {
  const bool narrow = D / H <= 8;
  if (K <= 64)
    return narrow ? launch<64, 8>(x, wqkv, bqkv, bias, dout, dx, partials, grads, max_blocks, B,
                                  K, D, H, scale, drop, device, stream)
                  : launch<64, 16>(x, wqkv, bqkv, bias, dout, dx, partials, grads, max_blocks,
                                   B, K, D, H, scale, drop, device, stream);
  return narrow ? launch<128, 8>(x, wqkv, bqkv, bias, dout, dx, partials, grads, max_blocks, B,
                                 K, D, H, scale, drop, device, stream)
                : launch<128, 16>(x, wqkv, bqkv, bias, dout, dx, partials, grads, max_blocks, B,
                                  K, D, H, scale, drop, device, stream);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// the shapes the kernel takes: K <= 128, 4 <= dh <= 16, dh % 4 == 0, dWqkv
// in at most kWUnits units, and x, dx (do) aligned for 16-byte copies
// where D (dh) is a multiple of 8, else 8-byte ones
bool takes(int K, int D, int H, const void* x, const void* dout, const void* dx) {
  if (K > kMaxKP || !tossctr::mha_mma::head_ok(D / H)) return false;
  const Geo g(K, D, H);
  if ((round_up(D, 16) / 16) * (3 * g.NQ / 16) > kWUnits) return false;
  const int xb = D % 8 == 0 ? 16 : 8, db = (D / H) % 8 == 0 ? 16 : 8;
  return aligned(x, xb) && aligned(dx, xb) && aligned(dout, db);
}

}  // namespace tc
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, bias, do and dx share it;
// bqkv is float32).  max_blocks: the most blocks the grid may have
// (persistent blocks, as many as fit on the SMs, each walking batch rows
// with a stride of the grid; a block with none writes zeros).  partials:
// (max_blocks, D*3D + 3D + K*K) fp32 scratch; grads: (D*3D + 3D + K*K)
// fp32 out = [dWqkv (D, 3D) | dbqkv (3D) | dbias (K, K)].  Dropout:
// keep_thresh (0 = off), keep_scale, seed, as the forward got them.
// bf16 runs the tensor-core kernel for K <= 128 (head width D / H a
// multiple of 4 from 4 to 16, x, do and dx 16-byte aligned, 8 where D or
// dh is not a multiple of 8) and the key-tiled one above; fp32 runs the
// row-resident kernel for K <= 64 and the key-tiled one above, and tiled
// = 1 asks for the key-tiled one at any K (bf16 ignores it).  D <= 64, D
// % 4 == 0; the key-tiled kernel also dh % 4 == 0.  Returns a cudaError_t
// code; a shape the kernels do not take, or whose layout does not fit a
// block's shared memory, is refused before any launch.
extern "C" int tossctr_fused_mha_qkv_bwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* bias, const void* dout, void* dx,
                                         void* partials, void* grads, int max_blocks, int B,
                                         int K, int D, int H, float scale, unsigned keep_thresh,
                                         float keep_scale, unsigned seed, int tiled, int dtype,
                                         int device, void* stream) {
  if (!shape_ok(B, K, D, H) || max_blocks < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  float* p = static_cast<float*>(partials);
  float* g = static_cast<float*>(grads);
  if (dtype == 1 && K <= tc::kMaxKP) {
    if (!tc::takes(K, D, H, x, dout, dx)) return (int)cudaErrorInvalidValue;
    return tc::launch_bf16(x, wqkv, bqkv, bias, dout, dx, p, g, max_blocks, B, K, D, H, scale,
                           drop, device, stream);
  }
  const bool use_tiled = tiled != 0 || K > kMaxDim;
  if (use_tiled && (D / H) % 4 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !use_tiled)
    return launch_resident(x, wqkv, bqkv, bias, dout, dx, p, g, max_blocks, B, K, D, H, scale,
                           drop, device, stream);
  if (dtype == 0)
    return launch_tiled<float>(x, wqkv, bqkv, bias, dout, dx, p, g, max_blocks, B, K, D, H,
                               scale, drop, device, stream);
  return launch_tiled<__nv_bfloat16>(x, wqkv, bqkv, bias, dout, dx, p, g, max_blocks, B, K, D,
                                     H, scale, drop, device, stream);
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
