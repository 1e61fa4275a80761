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
// and compute floors are about equal.
//
// Design: as the forward, one persistent block walks batch rows with Wqkv
// and the bias resident in shared memory, and a row's x, do, q, k, v,
// their gradients and one head's (K, K) P and dS never leave shared
// memory (190 KB a block in bf16: one block an SM).  The weight gradients
// are sums over the whole batch: each thread keeps its 4x4 tiles of dWqkv
// in registers and its dbqkv column, the block's dbias lives in shared
// memory with one owner thread per entry, and at the end every block
// writes its fp32 partial sums to a scratch buffer; a second kernel
// (common.cuh reduce_partials) adds the partials in block order, so the
// result repeats bit for bit (fp32 atomics would not).  Products run on
// the CUDA cores in fp32; the tensor cores are the next step for speed.
//
// That row-resident kernel takes K <= 64.  Above it, and at any K when
// the caller asks, the key-tiled kernel runs: x, Wqkv and an fp32 dx
// accumulator stay resident for the row, and each head is projected,
// run through mha_core.cuh head_bwd_tiled (queries in tiles of QT rows:
// 64 at K = 120, 32 at K = 152) and folded into dx, dWqkv and dbqkv
// before the next; dWqkv is held in 4x2 register tiles assigned head by
// head, and the block's dbias partial lives in device memory (one
// read-modify-write an entry a row and head, by one thread).  Shared
// memory grows as QT x K.  Same rounding points, same mask, same
// block-order reduction; dx sums a head's 3 x dh columns at a time.
#include "mha_core.cuh"

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

template <typename T>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* bias,
           const void* dout, void* dx, float* partials, float* grads, int max_blocks, int B,
           int K, int D, int H, float scale, Dropout drop, bool tiled, int device,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t e;
  if (!tiled) {
    const size_t smem = (size_t)Layout(K, D, (int)sizeof(T)).total * sizeof(float);
    e = tossctr::prepare_launch(mha_qkv_bwd_kernel<T>, kThreads, smem, max_blocks, device, 1,
                                &grid);
    if (e != cudaSuccess) return (int)e;
    mha_qkv_bwd_kernel<T><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
        static_cast<const T*>(bias), static_cast<const T*>(dout), static_cast<T*>(dx), partials,
        B, K, D, H, scale, drop);
  } else {
    const int dh = D / H;
    const int QT = tossctr::mha::pick_query_tile(
        align4(K), tossctr::smem_optin(device),
        [&](int qt) { return TiledLayout(K, D, dh, (int)sizeof(T), qt); });
    if (QT == 0) return (int)cudaErrorInvalidValue;  // no tile fits: refused before launch
    const size_t smem = (size_t)TiledLayout(K, D, dh, (int)sizeof(T), QT).total * sizeof(float);
    e = tossctr::prepare_launch(mha_qkv_bwd_tiled_kernel<T>, kThreads, smem, max_blocks, device,
                                1, &grid);
    if (e != cudaSuccess) return (int)e;
    mha_qkv_bwd_tiled_kernel<T><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
        static_cast<const T*>(bias), static_cast<const T*>(dout), static_cast<T*>(dx), partials,
        B, K, D, H, QT, scale, drop);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, grid, partial_floats(K, D), grads, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, bias, do and dx share it;
// bqkv is float32).  max_blocks: the most blocks the grid may have
// (persistent blocks, as many as fit on the SMs, each walking batch rows
// with a stride of the grid; a block with none writes zeros).  partials:
// (max_blocks, D*3D + 3D + K*K) fp32 scratch; grads: (D*3D + 3D + K*K)
// fp32 out = [dWqkv (D, 3D) | dbqkv (3D) | dbias (K, K)].  Dropout:
// keep_thresh (0 = off), keep_scale, seed, as the forward got them.
// tiled: 0 runs the row-resident kernel for K <= 64 and the key-tiled one
// above, 1 the key-tiled one at any K.  D <= 64, D % 4 == 0; the
// key-tiled kernel also dh % 4 == 0.  Returns a cudaError_t code; a shape
// whose layout does not fit a block's shared memory is refused before
// any launch.
extern "C" int tossctr_fused_mha_qkv_bwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* bias, const void* dout, void* dx,
                                         void* partials, void* grads, int max_blocks, int B,
                                         int K, int D, int H, float scale, unsigned keep_thresh,
                                         float keep_scale, unsigned seed, int tiled, int dtype,
                                         int device, void* stream) {
  if (!shape_ok(B, K, D, H) || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const bool use_tiled = tiled != 0 || K > kMaxDim;
  if (use_tiled && (D / H) % 4 != 0) return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  float* p = static_cast<float*>(partials);
  float* g = static_cast<float*>(grads);
  if (dtype == 0)
    return launch<float>(x, wqkv, bqkv, bias, dout, dx, p, g, max_blocks, B, K, D, H, scale,
                         drop, use_tiled, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wqkv, bqkv, bias, dout, dx, p, g, max_blocks, B, K, D, H,
                                 scale, drop, use_tiled, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
