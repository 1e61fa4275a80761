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
//
// The forwards walk a row's queries in tiles of QT rows (the scores and
// the bias rows of one tile in shared memory); with QT >= K the tile is
// the whole row.  The backward here is the CUDA-core kernels' (fp32 at any
// K, bf16 above K = 128; mha_mma.cuh holds the bf16 tensor-core stages)
// and comes in two forms: row-resident (head_bwd, fused_mha_qkv_bwd.cu's
// fp32 kernel for K <= 64) and key-tiled (head_bwd_tiled, any K); both run
// the same dS stage (ds_rows) and gradient sums (grad_sums).
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

// out[i][kj] = epi(i, kj, sum_e aT[e][q0 + i] * bT[e][kj]) for the local
// rows i < n (queries q0 .. q0 + n - 1) and kj < K, in fp32 with 4x4
// register tiles over e = e0 .. e0 + ne - 1 in order; aT, bT (., K4)
// transposed, q0 a multiple of 4; out has row stride KS
template <typename Epi>
__device__ __forceinline__ void tile_nt(const float* aT, const float* bT, int q0, int n, int K,
                                        int K4, int e0, int ne, float* out, int KS, Epi epi) {
  const int KT = K4 / 4;
  for (int t = threadIdx.x; t < (align4(n) / 4) * KT; t += kThreads) {
    const int i0 = (t / KT) * 4, j0 = (t % KT) * 4;
    float acc[4][4] = {};
    for (int e = e0; e < e0 + ne; ++e) {
      float av[4], bv[4];
      load4(aT + e * K4 + q0 + i0, av);
      load4(bT + e * K4 + j0, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = j0 + j;
        if (kj < K) out[r * KS + kj] = epi(r, kj, acc[i][j]);
      }
    }
  }
}

// s[i][kj] = (q_h k_h^T)[q0 + i][kj] * scale + bias[i][kj] for the local
// rows i < n; q_h, k_h are the columns hd .. hd+dh-1 of qT, kT (D, K4);
// bias holds the rows q0 .. q0 + n - 1 of the (K, K) bias
__device__ __forceinline__ void head_scores(const float* qT, const float* kT,
                                            const float* bias, int q0, int n, int K, int K4,
                                            int hd, int dh, float scale, float* s, int KS) {
  tile_nt(qT, kT, q0, n, K, K4, hd, dh, s, KS, [=](int r, int kj, float a) {
    return __fadd_rn(__fmul_rn(a, scale), bias[r * K + kj]);
  });
}

// fp32 softmax of the local score rows i < n in place (one warp a row),
// then s[i][j] = finish(q0 + i, j, p) for the probability p
template <typename Finish>
__device__ __forceinline__ void softmax_rows(float* s, int n, int K, int KS, int q0,
                                             Finish finish) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kWarps) {
    float* sr = s + i * KS;
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
    for (int j = lane; j < K; j += 32) sr[j] = finish(q0 + i, j, __fdiv_rn(sr[j], sum));
  }
}

// One head's forward on the queries q0 .. q0 + n - 1 of batch row `row`:
//   p_h = round_T(softmax(q_h k_h^T * scale + bias) * keep_h)   (fp32 before rounding)
//   out[q0:q0+n, hd:hd+dh] = round_T(p_h @ v_h)                  (fp32 sums)
// bias: those rows of the (K, K) bias; v (K4, VS); s (align4(n), KS)
// scratch, KS odd for the P.V pass; out (K, D) in T.  A call with q0 = 0
// and n = K is the whole head.
template <typename T>
__device__ __forceinline__ void head_fwd(const float* qT, const float* kT, const float* bias,
                                         const float* v, int VS, float* s, int KS, int q0,
                                         int n, int K, int K4, int D, int hd, int dh,
                                         float scale, int row, int h, const Dropout& drop,
                                         T* __restrict__ out) {
  head_scores(qT, kT, bias, q0, n, K, K4, hd, dh, scale, s, KS);
  __syncthreads();
  if (drop.on()) {
    softmax_rows(s, n, K, KS, q0, [=](int qi, int j, float p) {
      return round_t<T>(__fmul_rn(p, drop.attn(row, qi, j, h)));
    });
  } else {
    softmax_rows(s, n, K, KS, q0, [](int, int, float p) { return round_t<T>(p); });
  }
  __syncthreads();

  // ---- o_h = p_h @ v_h: 2-row x 1-column tiles ----
  for (int t = threadIdx.x; t < (align4(n) / 2) * dh; t += kThreads) {
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
    if (i0 < n) out[(q0 + i0) * D + hd + e] = from_f<T>(a0);
    if (i0 + 1 < n) out[(q0 + i0 + 1) * D + hd + e] = from_f<T>(a1);
  }
  __syncthreads();
}

// A strided fp32 view of one head's (keys, dh) tensor: element (k, e) at
// ptr[k * rs + e * cs].  A row-resident (K4, VS) tensor is {ptr + hd, VS,
// 1}, a transposed (D, K4) one {ptr + hd * K4, 1, K4}, a staged head's
// (dh, K4) one {ptr, 1, K4}.
template <typename F>
struct View {
  F* ptr;
  int rs, cs;
  __device__ F& at(int k, int e) const { return ptr[k * rs + e * cs]; }
};

// The dS stage of the backward on the local rows i < n (queries q0 + i),
// one warp a row: ds = p * (dp - rowsum(dp * p)) (fp32, ds holds dp on
// entry), dbias_rows[i][j] += ds (one owner thread an entry, row stride
// K), then ds = round_T(ds * scale) and p = round_T(p * keep).  Ends
// synchronised.
template <typename T>
__device__ __forceinline__ void ds_rows(float* p, float* ds, int KS, int q0, int n, int K,
                                        float* dbias_rows, float scale, int row, int h,
                                        const Dropout& drop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kWarps) {
    float* pr = p + i * KS;
    float* dr = ds + i * KS;
    float* gb = dbias_rows + (size_t)i * K;
    float r = 0.f;
    for (int j = lane; j < K; j += 32) r += __fmul_rn(dr[j], pr[j]);
    r = warp_sum(r);
    for (int j = lane; j < K; j += 32) {
      const float pv = pr[j];
      const float d = __fmul_rn(pv, __fsub_rn(dr[j], r));
      gb[j] += d;
      dr[j] = round_t<T>(__fmul_rn(d, scale));
      pr[j] = round_t<T>(drop.on() ? __fmul_rn(pv, drop.attn(row, q0 + i, j, h)) : pv);
    }
  }
  __syncthreads();
}

// The gradient sums of the backward over the local rows i < n (queries
// q0 + i), p and ds rounded by ds_rows: dv_h += p^T do_h and dk_h += ds^T
// q_h over the rows in query order (added to what the earlier rows left
// when q0 > 0), dq_h[q0 + i] = ds k_h; fp32.  A warp shares one column e,
// so do, q and k are broadcast reads.  When the rows are the whole head
// (n == K) a thread sums its key's dv, dk and its query's dq in one pass.
// Ends synchronised.
__device__ __forceinline__ void grad_sums(const float* p, const float* ds, int KS, int q0,
                                          int n, int K, int dh, View<const float> dout,
                                          View<const float> q, View<const float> k,
                                          View<float> dv, View<float> dk, View<float> dq) {
  const bool whole = n == K;
  for (int t = threadIdx.x; t < K * dh; t += kThreads) {
    const int e = t / K, j = t - e * K;
    float a_dv = q0 ? dv.at(j, e) : 0.f, a_dk = q0 ? dk.at(j, e) : 0.f, a_dq = 0.f;
    for (int i = 0; i < n; ++i) {
      a_dv = fmaf(p[i * KS + j], dout.at(q0 + i, e), a_dv);
      a_dk = fmaf(ds[i * KS + j], q.at(q0 + i, e), a_dk);
      if (whole) a_dq = fmaf(ds[j * KS + i], k.at(i, e), a_dq);
    }
    dv.at(j, e) = a_dv;
    dk.at(j, e) = a_dk;
    if (whole) dq.at(j, e) = a_dq;
  }
  if (!whole) {
    for (int t = threadIdx.x; t < n * dh; t += kThreads) {
      const int e = t / n, i = t - e * n;
      const float* dr = ds + i * KS;
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc = fmaf(dr[j], k.at(j, e), acc);
      dq.at(q0 + i, e) = acc;
    }
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
  const int KT = K4 / 4;
  head_scores(qT, kT, bias, 0, K, K, K4, hd, dh, scale, p, KS);
  __syncthreads();
  softmax_rows(p, K, K, KS, 0, [](int, int, float pv) { return pv; });

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

  ds_rows<T>(p, ds, KS, 0, K, K, dbias, scale, row, h, drop);
  grad_sums(p, ds, KS, 0, K, K, dh, {dout + hd, VS, 1}, {qT + hd * K4, 1, K4},
            {kT + hd * K4, 1, K4}, {v + hd, VS, 1}, {dk + hd, VS, 1}, {dq + hd, VS, 1});
}

// ---- the key-tiled backward: per-head staging, query tiles ----
// The row-resident backward above keeps a row's q, k, v, do, their
// gradients and a head's whole (K, K) P and dS in shared memory, which
// fits for K <= 64 (with the qkv projection's x and Wqkv).  The tiled backward stages one head at a time as
// (dh, K4) fp32 tensors and walks the head's queries in tiles of QT rows,
// so shared memory grows as QT x K instead of K x K; dv and dk add the
// tiles' terms in query order, dbias is the block's fp32 partial in
// device memory.

// One head's tensors, fp32 (dh, K4), transposed; rows k >= K of the
// inputs are zero (or, for projected ones, finite and never read into a
// result)
struct HeadTiles {
  float *qT, *kT, *vT, *doT;  // the head's inputs
  float *dqT, *dkT, *dvT;     // its gradients, fp32 sums
  __device__ HeadTiles(float* base, int dh, int K4)
      : qT(base), kT(base + dh * K4), vT(base + 2 * dh * K4), doT(base + 3 * dh * K4),
        dqT(base + 4 * dh * K4), dkT(base + 5 * dh * K4), dvT(base + 6 * dh * K4) {}
};
constexpr int kHeadTensors = 7;

// The largest query tile QT of {K4, 64, 32, 16, 8} (<= K4) whose layout
// make(QT) fits in max_bytes of shared memory; 0 if none does.
template <typename MakeLayout>
inline int pick_query_tile(int K4, size_t max_bytes, MakeLayout make) {
  const int cands[] = {K4, 64, 32, 16, 8};
  for (int qt : cands)
    if (qt <= K4 && (size_t)make(qt).total * sizeof(float) <= max_bytes) return qt;
  return 0;
}

// src (K, D) of one batch row, columns hd .. hd+dh-1 -> dst (dh, K4) fp32,
// transposed, rows k >= K zero
template <typename T>
__device__ __forceinline__ void load_head(const T* __restrict__ src, int K, int D, int K4, int hd,
                                          int dh, float* dst) {
  for (int i = threadIdx.x; i < K4 * dh; i += kThreads) {
    const int k = i / dh, e = i - k * dh;
    dst[e * K4 + k] = k < K ? to_f<T>(src[k * D + hd + e]) : 0.f;
  }
}

// One head's q, k, v = round_T(x @ Wqkv + bqkv) over its columns hd ..
// hd+dh-1 of each of q, k, v, as project_qkv computes them (4x4 tiles,
// fp32 sums over d in order) -> qT, kT, vT (dh, K4).  dh % 4 == 0.
template <typename T>
__device__ __forceinline__ void project_head(const float* x, int XS, const T* w, const float* b,
                                             int K4, int D, int hd, int dh, float* qT, float* kT,
                                             float* vT) {
  const int D3 = 3 * D;
  const int CT = 3 * dh / 4;  // column tiles of the head
  for (int t = threadIdx.x; t < (K4 / 4) * CT; t += kThreads) {
    const int k0 = (t / CT) * 4, ct = t % CT;
    const int which = ct / (dh / 4), e0 = (ct % (dh / 4)) * 4;
    const int c0 = which * D + hd + e0;
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
    float* dst = which == 0 ? qT : (which == 1 ? kT : vT);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = b[c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[(e0 + j) * K4 + k0 + i] = round_t<T>(__fadd_rn(acc[i][j], bj));
    }
  }
  __syncthreads();
}

// One head's backward on batch row `row` with the rounding points of
// head_bwd, its queries in tiles of QT rows.  a: the head's staged
// tensors (dqT, dkT, dvT are written).  bias_t (QT, K) fp32 holds a
// tile's rows of the (K, K) bias, staged here from `bias` unless
// `resident` (QT >= K: the whole bias, staged once by the caller).  p,
// ds (QT, KS) scratch.  dbias: the block's (K, K) fp32 partial in device
// memory; each (row, head) adds its dS to an entry in one
// read-modify-write by one thread, so the sum runs in row, then head
// order.  Called by all threads; ends synchronised.
template <typename T>
__device__ __forceinline__ void head_bwd_tiled(const HeadTiles& a, const T* __restrict__ bias,
                                               float* bias_t, bool resident, float* p, float* ds,
                                               int KS, int QT, float* dbias, int K, int K4,
                                               int dh, float scale, int row, int h,
                                               const Dropout& drop) {
  // rows k >= K of the gradients stay zero: the callers' tiles read them
  for (int i = threadIdx.x; i < dh * K4; i += kThreads) a.dqT[i] = a.dkT[i] = a.dvT[i] = 0.f;
  for (int q0 = 0; q0 < K; q0 += QT) {
    const int n = min(QT, K - q0);
    __syncthreads();  // the previous tile is done with bias_t, p and ds
    if (!resident)
      for (int i = threadIdx.x; i < n * K; i += kThreads) bias_t[i] = to_f<T>(bias[q0 * K + i]);
    __syncthreads();
    // ---- p = softmax(scores) (fp32), dp = (do_h v_h^T) * keep into ds ----
    head_scores(a.qT, a.kT, bias_t, q0, n, K, K4, 0, dh, scale, p, KS);
    tile_nt(a.doT, a.vT, q0, n, K, K4, 0, dh, ds, KS, [=](int r, int kj, float dp) {
      return drop.on() ? __fmul_rn(dp, drop.attn(row, q0 + r, kj, h)) : dp;
    });
    __syncthreads();
    softmax_rows(p, n, K, KS, q0, [](int, int, float pv) { return pv; });
    __syncthreads();

    ds_rows<T>(p, ds, KS, q0, n, K, dbias + (size_t)q0 * K, scale, row, h, drop);
    grad_sums(p, ds, KS, q0, n, K, dh, {a.doT, 1, K4}, {a.qT, 1, K4}, {a.kT, 1, K4},
              {a.dvT, 1, K4}, {a.dkT, 1, K4}, {a.dqT, 1, K4});
  }
}

}  // namespace mha
}  // namespace tossctr
