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
#include "common.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::load4;
using tossctr::round_t;
using tossctr::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 64;  // D <= 64 and K <= 64
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
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < D * D3; i += kThreads) w_s[i] = wqkv[i];
  for (int i = tid; i < D3; i += kThreads) b_s[i] = bqkv[i];
  for (int i = tid; i < K * K; i += kThreads) {
    bias_s[i] = to_f<T>(bias[i]);
    dbias_s[i] = 0.f;
  }

  const int CT = D3 / 4;  // column tiles of the (K4, 3D) projection and of dWqkv
  const int proj_tiles = (K4 / 4) * CT;
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
    for (int i = tid; i < K4 * D; i += kThreads) {
      const int k = i / D, d = i - k * D;
      const bool in = k < K;
      x_s[k * XS + d] = in ? to_f<T>(x[off + i]) : 0.f;
      do_s[k * VS + d] = in ? to_f<T>(dout[off + i]) : 0.f;
    }
    __syncthreads();

    // ---- recompute q, k, v = round_T(x @ Wqkv + b) ----
    for (int t = tid; t < proj_tiles; t += kThreads) {
      const int k0 = (t / CT) * 4, c0 = (t % CT) * 4;
      float acc[4][4] = {};
      for (int d = 0; d < D; ++d) {
        float w[4], xv[4];
        load4(w_s + d * D3 + c0, w);
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = x_s[(k0 + i) * XS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], w[j], acc[i][j]);
      }
      const int which = c0 / D, col0 = c0 - which * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bj = b_s[c0 + j];
        const int col = col0 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float val = round_t<T>(__fadd_rn(acc[i][j], bj));
          const int k = k0 + i;
          if (which == 0)
            qT[col * K4 + k] = val;
          else if (which == 1)
            kT[col * K4 + k] = val;
          else
            v_s[k * VS + col] = val;
        }
      }
    }
    __syncthreads();

    for (int h = 0; h < H; ++h) {
      const int hd = h * dh;
      // ---- scores s = (q_h k_h^T) * scale + bias into p_s ----
      for (int t = tid; t < KT * KT; t += kThreads) {
        const int i0 = (t / KT) * 4, j0 = (t % KT) * 4;
        float acc[4][4] = {};
        for (int e = 0; e < dh; ++e) {
          float qv[4], kv[4];
          load4(qT + (hd + e) * K4 + i0, qv);
          load4(kT + (hd + e) * K4 + j0, kv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = i0 + i;
          if (qi >= K) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = j0 + j;
            if (kj < K)
              p_s[qi * KS + kj] = __fadd_rn(__fmul_rn(acc[i][j], scale), bias_s[qi * K + kj]);
          }
        }
      }
      __syncthreads();

      // ---- fp32 softmax per query row (one warp a row) ----
      for (int qi = warp; qi < K; qi += kWarps) {
        float* sr = p_s + qi * KS;
        float m = __int_as_float(0xff800000);  // -inf
        for (int j = lane; j < K; j += 32) m = fmaxf(m, sr[j]);
        m = tossctr::warp_max(m);
        float sum = 0.f;
        for (int j = lane; j < K; j += 32) {
          const float e = expf(sr[j] - m);
          sr[j] = e;
          sum += e;
        }
        sum = tossctr::warp_sum(sum);
        for (int j = lane; j < K; j += 32) sr[j] = __fdiv_rn(sr[j], sum);
      }

      // ---- dp = (do_h v_h^T) * keep into ds_s ----
      for (int t = tid; t < KT * KT; t += kThreads) {
        const int i0 = (t / KT) * 4, j0 = (t % KT) * 4;
        float acc[4][4] = {};
        for (int e = 0; e < dh; ++e) {
          float dv[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i] = do_s[(i0 + i) * VS + hd + e];
            vv[i] = v_s[(j0 + i) * VS + hd + e];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dv[i], vv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = i0 + i;
          if (qi >= K) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = j0 + j;
            if (kj >= K) continue;
            const float dp = acc[i][j];
            ds_s[qi * KS + kj] = drop.on() ? __fmul_rn(dp, drop.attn(row, qi, kj, h)) : dp;
          }
        }
      }
      __syncthreads();

      // ---- ds = p * (dp - sum(dp * p)), dbias += ds, then ds_s =
      // round_T(ds * scale) and p_s = round_T(p * keep); one warp a row,
      // so each dbias entry has one owner thread ----
      for (int qi = warp; qi < K; qi += kWarps) {
        float* pr = p_s + qi * KS;
        float* dr = ds_s + qi * KS;
        float r = 0.f;
        for (int j = lane; j < K; j += 32) r += __fmul_rn(dr[j], pr[j]);
        r = tossctr::warp_sum(r);
        for (int j = lane; j < K; j += 32) {
          const float p = pr[j];
          const float ds = __fmul_rn(p, __fsub_rn(dr[j], r));
          dbias_s[qi * K + j] += ds;
          dr[j] = round_t<T>(__fmul_rn(ds, scale));
          pr[j] = round_t<T>(drop.on() ? __fmul_rn(p, drop.attn(row, qi, j, h)) : p);
        }
      }
      __syncthreads();

      // ---- dv_h = pd^T do_h (over v_h's columns), dk_h = ds^T q_h,
      // dq_h = ds k_h; fp32, rounded where read.  A warp shares one
      // column, so q, k and do are broadcast reads ----
      for (int t = tid; t < K * dh; t += kThreads) {
        const int e = t / K, j = t - e * K, col = hd + e;
        const float* qc = qT + col * K4;
        const float* kc = kT + col * K4;
        float dv = 0.f, dk = 0.f, dq = 0.f;
        for (int i = 0; i < K; ++i) {
          dv = fmaf(p_s[i * KS + j], do_s[i * VS + col], dv);
          dk = fmaf(ds_s[i * KS + j], qc[i], dk);
          dq = fmaf(ds_s[j * KS + i], kc[i], dq);
        }
        v_s[j * VS + col] = dv;
        dk_s[j * VS + col] = dk;
        dq_s[j * VS + col] = dq;
      }
      __syncthreads();
    }

    // ---- x again (its buffer held P), for dWqkv ----
    for (int i = tid; i < K4 * D; i += kThreads) {
      const int k = i / D, d = i - k * D;
      x_s[k * XS + d] = k < K ? to_f<T>(x[off + i]) : 0.f;
    }
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

template <typename T>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* bias,
           const void* dout, void* dx, float* partials, float* grads, int blocks, int B, int K,
           int D, int H, float scale, Dropout drop, int device, void* stream) {
  const Layout L(K, D, (int)sizeof(T));
  const size_t smem = (size_t)L.total * sizeof(float);
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e = tossctr::prepare_launch(mha_qkv_bwd_kernel<T>, kThreads, smem, blocks, device,
                                          0, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mha_qkv_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(bias), static_cast<const T*>(dout), static_cast<T*>(dx), partials,
      B, K, D, H, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, blocks, partial_floats(K, D), grads, s);
}

bool shape_ok(int B, int K, int D, int H) {
  return B >= 0 && K >= 1 && K <= kMaxDim && D >= 4 && D <= kMaxDim && D % 4 == 0 && H >= 1 &&
         D % H == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, bias, do and dx share it;
// bqkv is float32).  blocks: the grid, one block an SM (each walks batch
// rows with a stride of the grid; a block with none writes zeros).
// partials: (blocks, D*3D + 3D + K*K) fp32 scratch;
// grads: (D*3D + 3D + K*K) fp32 out = [dWqkv (D, 3D) | dbqkv (3D) |
// dbias (K, K)].  Dropout: keep_thresh (0 = off), keep_scale, seed, as the
// forward got them.  K <= 64, D <= 64.  Returns a cudaError_t code.
extern "C" int tossctr_fused_mha_qkv_bwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* bias, const void* dout, void* dx,
                                         void* partials, void* grads, int blocks, int B, int K,
                                         int D, int H, float scale, unsigned keep_thresh,
                                         float keep_scale, unsigned seed, int dtype, int device,
                                         void* stream) {
  if (!shape_ok(B, K, D, H) || blocks < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  float* p = static_cast<float*>(partials);
  float* g = static_cast<float*>(grads);
  if (dtype == 0)
    return launch<float>(x, wqkv, bqkv, bias, dout, dx, p, g, blocks, B, K, D, H, scale, drop,
                         device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wqkv, bqkv, bias, dout, dx, p, g, blocks, B, K, D, H, scale,
                                 drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
