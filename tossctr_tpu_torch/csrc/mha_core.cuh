// Shared attention core of the four attention kernels (fused_mha_qkv.cu,
// fused_mha_qkv_bwd.cu, fused_mha.cu, fused_mha_bwd.cu): loading one
// batch row into shared memory, the qkv projection, and one head's
// forward and backward.
//
// Shapes: q, k, v (B, K, D) with H heads of width dh = D / H, the bias
// (K, K) shared by every head and batch row.  One block works on one
// batch row at a time.  q and k live transposed as fp32 (D, K4), K4 =
// align4(K), so the score tile reads them as float4 rows; v (and do in
// the backward) as fp32 rows of stride VS.  No score, probability or
// output of a row or column >= K is computed, and no value of a row >= K
// is read: the softmax runs over the K real key columns only, which is
// what the Pallas kernel's -1e9 mask on its padded columns (K rounded up
// to 8) computes, since exp of the masked scores is exactly 0.
//
// Every helper is called by all threads of the block and ends with the
// block synchronised where its results are read by other threads.
#pragma once

#include "common.cuh"

namespace tossctr {
namespace mha {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// src (K, D) of one batch row -> dst (D, K4) fp32, transposed, rows k >= K zero
template <typename T>
__device__ __forceinline__ void load_transposed(const T* __restrict__ src, int K, int D, int K4,
                                                float* dst) {
  for (int i = threadIdx.x; i < K4 * D; i += kThreads) {
    const int k = i / D, d = i - k * D;
    dst[d * K4 + k] = k < K ? to_f<T>(src[i]) : 0.f;
  }
}

// src (K, D) of one batch row -> dst (K4, stride) fp32, rows k >= K zero
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int K, int D, int K4,
                                          int stride, float* dst) {
  for (int i = threadIdx.x; i < K4 * D; i += kThreads) {
    const int k = i / D, d = i - k * D;
    dst[k * stride + d] = k < K ? to_f<T>(src[i]) : 0.f;
  }
}

// q, k, v = round_T(x @ Wqkv + bqkv) with 4x4 register tiles: x (K4, XS)
// fp32, Wqkv (D, 3D) in T, bqkv (3D) fp32 -> qT, kT (D, K4) and v (K4, VS).
// D % 4 == 0, so a tile's four columns belong to one of q, k, v.
template <typename T>
__device__ __forceinline__ void project_qkv(const float* x, int XS, const T* w, const float* b,
                                            int K4, int D, float* qT, float* kT, float* v,
                                            int VS) {
  const int D3 = 3 * D;
  const int CT = D3 / 4;  // column tiles
  for (int t = threadIdx.x; t < (K4 / 4) * CT; t += kThreads) {
    const int k0 = (t / CT) * 4, c0 = (t % CT) * 4;
    float acc[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float wv[4], xv[4];
      load4(w + d * D3 + c0, wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = x[(k0 + i) * XS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    const int which = c0 / D, col0 = c0 - which * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = b[c0 + j];
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
          v[k * VS + col] = val;
      }
    }
  }
  __syncthreads();
}

// s[qi][kj] = (q_h k_h^T)[qi][kj] * scale + bias[qi][kj] for qi, kj < K, in
// fp32 with 4x4 register tiles; q_h, k_h are the columns hd .. hd+dh-1 of
// qT, kT (D, K4); s has row stride KS
__device__ __forceinline__ void head_scores(const float* qT, const float* kT,
                                            const float* bias, int K, int K4, int hd, int dh,
                                            float scale, float* s, int KS) {
  const int KT = K4 / 4;
  for (int t = threadIdx.x; t < KT * KT; t += kThreads) {
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
        if (kj < K) s[qi * KS + kj] = __fadd_rn(__fmul_rn(acc[i][j], scale), bias[qi * K + kj]);
      }
    }
  }
}

// fp32 softmax of each score row in place (one warp a row), then
// s[qi][j] = finish(qi, j, p) for the probability p
template <typename Finish>
__device__ __forceinline__ void softmax_rows(float* s, int K, int KS, Finish finish) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int qi = warp; qi < K; qi += kWarps) {
    float* sr = s + qi * KS;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < K; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < K; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < K; j += 32) sr[j] = finish(qi, j, __fdiv_rn(sr[j], sum));
  }
}

// One head's forward on batch row `row`:
//   p_h = round_T(softmax(q_h k_h^T * scale + bias) * keep_h)   (fp32 before rounding)
//   out[:, hd:hd+dh] = round_T(p_h @ v_h)                        (fp32 sums)
// v (K4, VS); s (K4, KS) scratch, KS odd for the P.V pass; out (K, D) in T.
template <typename T>
__device__ __forceinline__ void head_fwd(const float* qT, const float* kT, const float* bias,
                                         const float* v, int VS, float* s, int KS, int K, int K4,
                                         int D, int hd, int dh, float scale, int row, int h,
                                         const Dropout& drop, T* __restrict__ out) {
  head_scores(qT, kT, bias, K, K4, hd, dh, scale, s, KS);
  __syncthreads();
  if (drop.on()) {
    softmax_rows(s, K, KS, [=](int qi, int j, float p) {
      return round_t<T>(__fmul_rn(p, drop.attn(row, qi, j, h)));
    });
  } else {
    softmax_rows(s, K, KS, [](int, int, float p) { return round_t<T>(p); });
  }
  __syncthreads();

  // ---- o_h = p_h @ v_h: 2-row x 1-column tiles ----
  for (int t = threadIdx.x; t < (K4 / 2) * dh; t += kThreads) {
    const int i0 = (t / dh) * 2, e = t % dh;
    const float* p0 = s + i0 * KS;
    const float* p1 = p0 + KS;
    const float* vc = v + hd + e;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < K; ++j) {
      const float vv = vc[j * VS];
      a0 = fmaf(p0[j], vv, a0);
      a1 = fmaf(p1[j], vv, a1);
    }
    if (i0 < K) out[i0 * D + hd + e] = from_f<T>(a0);
    if (i0 + 1 < K) out[(i0 + 1) * D + hd + e] = from_f<T>(a1);
  }
  __syncthreads();
}

// One head's backward on batch row `row`, with the rounding points of the
// Pallas kernels:
//   p_h    = softmax(q_h k_h^T * scale + bias)        (fp32, not rounded)
//   dp_h   = (do_h @ v_h^T) * keep_h
//   ds_h   = p_h * (dp_h - rowsum(dp_h * p_h))        (fp32)
//   dbias += ds_h                                      (unscaled, fp32)
//   dv_h   = round_T(p_h * keep_h)^T @ do_h     -> v's columns of head h
//   dk_h   = round_T(ds_h * scale)^T @ q_h      -> dk (fp32, not rounded)
//   dq_h   = round_T(ds_h * scale) @ k_h        -> dq (fp32, not rounded)
// v, dout, dq, dk (K4, VS); p, ds (K4, KS) scratch; dbias (K, K) with one
// owner thread per entry (the warp of its query row), so the block's sum
// is in a fixed order.
template <typename T>
__device__ __forceinline__ void head_bwd(const float* qT, const float* kT, const float* bias,
                                         float* v, const float* dout, float* dq, float* dk,
                                         int VS, float* p, float* ds, int KS, float* dbias,
                                         int K, int K4, int hd, int dh, float scale, int row,
                                         int h, const Dropout& drop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KT = K4 / 4;
  head_scores(qT, kT, bias, K, K4, hd, dh, scale, p, KS);
  __syncthreads();
  softmax_rows(p, K, KS, [](int, int, float pv) { return pv; });

  // ---- dp = (do_h v_h^T) * keep into ds ----
  for (int t = threadIdx.x; t < KT * KT; t += kThreads) {
    const int i0 = (t / KT) * 4, j0 = (t % KT) * 4;
    float acc[4][4] = {};
    for (int e = 0; e < dh; ++e) {
      float dv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i] = dout[(i0 + i) * VS + hd + e];
        vv[i] = v[(j0 + i) * VS + hd + e];
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
        ds[qi * KS + kj] = drop.on() ? __fmul_rn(dp, drop.attn(row, qi, kj, h)) : dp;
      }
    }
  }
  __syncthreads();

  // ---- ds = p * (dp - sum(dp * p)), dbias += ds, then ds = round_T(ds *
  // scale) and p = round_T(p * keep); one warp a row ----
  for (int qi = warp; qi < K; qi += kWarps) {
    float* pr = p + qi * KS;
    float* dr = ds + qi * KS;
    float r = 0.f;
    for (int j = lane; j < K; j += 32) r += __fmul_rn(dr[j], pr[j]);
    r = warp_sum(r);
    for (int j = lane; j < K; j += 32) {
      const float pv = pr[j];
      const float d = __fmul_rn(pv, __fsub_rn(dr[j], r));
      dbias[qi * K + j] += d;
      dr[j] = round_t<T>(__fmul_rn(d, scale));
      pr[j] = round_t<T>(drop.on() ? __fmul_rn(pv, drop.attn(row, qi, j, h)) : pv);
    }
  }
  __syncthreads();

  // ---- dv_h = pd^T do_h (over v_h's columns), dk_h = ds^T q_h, dq_h =
  // ds k_h, fp32.  A warp shares one column, so q, k and do are broadcast
  // reads ----
  for (int t = threadIdx.x; t < K * dh; t += kThreads) {
    const int e = t / K, j = t - e * K, col = hd + e;
    const float* qc = qT + col * K4;
    const float* kc = kT + col * K4;
    float a_dv = 0.f, a_dk = 0.f, a_dq = 0.f;
    for (int i = 0; i < K; ++i) {
      a_dv = fmaf(p[i * KS + j], dout[i * VS + col], a_dv);
      a_dk = fmaf(ds[i * KS + j], qc[i], a_dk);
      a_dq = fmaf(ds[j * KS + i], kc[i], a_dq);
    }
    v[j * VS + col] = a_dv;
    dk[j * VS + col] = a_dk;
    dq[j * VS + col] = a_dq;
  }
  __syncthreads();
}

}  // namespace mha
}  // namespace tossctr
