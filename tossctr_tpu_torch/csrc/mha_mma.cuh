// Tensor-core stages of the bf16 attention backward kernels
// (fused_mha_bwd.cu mha_bwd_mma, fused_mha_qkv_bwd.cu mha_qkv_bwd_mma) at
// K <= 128: a batch row's slabs staged whole, one (16-query tile, head)
// unit's scores, softmax, dS, dbias and dq in one warp's registers, and
// one (16-key tile, head) unit's dk and dv.
//
// Every product is mma.sync with bf16 operands and fp32 accumulators
// (mma_ptx.cuh), fed by ldmatrix from row-major bf16 tiles.  A head of dh
// <= 8 columns is a k8 contraction (m16n8k8), one of 9-16 a k16 one; the
// head's columns are padded to DHP = 8 or 16 with zeros in the slabs.
// bf16 x bf16 products are exact in fp32, so only the order of the fp32
// sums differs from the CUDA-core stages (mha_core.cuh); the rounding
// points are the Pallas kernels' (tossctr_tpu/ops/pallas_attention.py
// _packed_attend_bwd):
//   p    = softmax(q_h k_h^T * scale + bias)     fp32, not rounded (expf and
//                                                the correctly rounded division:
//                                                div_rn)
//   dp   = (do_h v_h^T) * keep
//   ds   = p * (dp - rowsum(dp * p))             fp32; dbias += ds
//   dq_h = round(ds * scale) k_h,  dk_h = round(ds * scale)^T q_h,
//   dv_h = round(p * keep)^T do_h                fp32 sums
//
// A query tile's scores live in C fragments (16 rows x KP keys: KP / 2
// registers a lane); the row statistics come from quad shuffles; dp is
// formed twice, 16 keys at a time (once for the row sums, once for ds),
// and the keep hash runs once an element, its decisions kept as bits.
// round(ds * scale) leaves the registers as the A fragments of dq = dS
// k_h (the C layout of two n8 tiles is the A layout of a k16 step) and,
// with round(p * keep), as bf16 rows of two shared buffers, which the
// key-tile units read back with ldmatrix.trans for the products that
// contract over queries.  dbias has one owner lane an entry: a warp
// keeps the sums of its query tile over every head and row it takes in
// registers, and the copies of a tile are added in warp order at the end
// (flush_dbias), so a call repeats bit for bit.
//
// Padding: K to KP = 64 or 128 queries and keys.  Key columns >= K are -inf before
// the exp (p = 0, so ds = 0 and round(p * keep) = 0 there); query rows
// >= K get ds = 0 and round(p * keep) = 0, so they add nothing to dbias,
// dk or dv; slab rows past the staged ones are zero or finite.
#pragma once

#include "mma_ptx.cuh"

namespace tossctr {
namespace mha_mma {

using namespace tossctr::ptx;  // bf16, ldmatrix, mma, cp.async, tile addressing

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// queries and keys padded to KP = 64 or 128: the kernels take K <= 128.  A
// query tile's scores are KP / 8 n-tiles, its dq KP / 16 k16 steps; a row
// has at most KP / 16 query (and key) tiles
constexpr int kMaxKP = 128;
__host__ __device__ constexpr int pad_k(int K) { return K <= 64 ? 64 : 128; }
// row stride of a (., KP) bf16 tile: the bias and the P, dS buffers
__host__ __device__ constexpr int ldp(int KP) { return row_stride(KP); }

// head widths the kernels take: dh % 4 == 0, 4 <= dh <= 16
__host__ __device__ inline bool head_ok(int dh) { return dh >= 4 && dh <= 16 && dh % 4 == 0; }

// One batch row's geometry.  Slabs hold a (K, D) tensor head by head: head
// h in columns h * DHP .. h * DHP + dh - 1 of a row NQ wide (NQ a multiple
// of 16), stride RS.  A row's QT query tiles and H heads are walked in
// groups of G heads: unit u < units = G * QT of a group is the warp u,
// query (and key) tile u % QT of head group * G + u / QT.  QT <= kWarps.
struct Geo {
  int K, D, H, dh, DHP, NQ, RS, QT, G, groups, units;
  __host__ __device__ Geo(int K_, int D_, int H_) : K(K_), D(D_), H(H_) {
    dh = D / H;
    DHP = dh <= 8 ? 8 : 16;
    NQ = round_up(H * DHP, 16);
    RS = row_stride(NQ);
    QT = (K + 15) / 16;
    G = kWarps / QT < H ? kWarps / QT : H;
    groups = (H + G - 1) / G;
    units = G * QT;
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// e / l rounded to nearest, given r = __frcp_rn(l): RN(e r) corrected once
// with its exact residual (Markstein), which is the correctly rounded
// quotient wherever it is a normal float, as __fdiv_rn's is, at three
// instructions instead of __fdiv_rn's call with its range checks
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-l, q, e), r, q);
}

// a barrier of the kWarps warps of one half of a block (id 1 + half)
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "n"(kThreads) : "memory");
}

// elements a copy piece of a (., n) bf16 row: 16 bytes where n % 8 == 0, else 8
__device__ __forceinline__ int piece(int n) { return n % 8 == 0 ? 8 : 4; }

// cp.async of one batch row's (K, D) bf16 tensor into a slab (head h in
// columns h * DHP ..); rows >= K and the pad columns are not written
__device__ __forceinline__ void stage_heads(bf16* dst, const bf16* __restrict__ src,
                                            const Geo& g) {
  const int pe = piece(g.dh), per_row = g.D / pe;
  for (int i = threadIdx.x; i < g.K * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * pe, h = c / g.dh;
    bf16* d = dst + r * g.RS + h * g.DHP + (c - h * g.dh);
    if (pe == 8)
      cp_async16(d, src + (size_t)r * g.D + c);
    else
      cp_async8(d, src + (size_t)r * g.D + c, true);
  }
}

// the inverse: a slab's rows < K to device memory, (K, D)
__device__ __forceinline__ void store_heads(bf16* __restrict__ dst, const bf16* src,
                                            const Geo& g) {
  const int pe = piece(g.dh), per_row = g.D / pe;
  for (int i = threadIdx.x; i < g.K * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * pe, h = c / g.dh;
    const bf16* s = src + r * g.RS + h * g.DHP + (c - h * g.dh);
    if (pe == 8)
      *reinterpret_cast<uint4*>(dst + (size_t)r * g.D + c) = *reinterpret_cast<const uint4*>(s);
    else
      *reinterpret_cast<uint2*>(dst + (size_t)r * g.D + c) = *reinterpret_cast<const uint2*>(s);
  }
}

// c[j] (j < NJ, NJ even) = the 16 rows q0.. of slab a times the 8 rows
// k0 + 8j.. of slab b, contracted over the head's columns hc .. hc + DHP - 1
template <int DHP, int NJ>
__device__ __forceinline__ void head_product(const bf16* a, const bf16* b, int ld, int q0, int k0,
                                             int hc, float (&c)[NJ][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  if constexpr (DHP == 8) {
    uint32_t af[2];
    ldsm_x2(af, tile_x2(a, ld, q0, hc, lane));
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      uint32_t bf[2];
      ldsm_x2(bf, tile_x2(b, ld, k0 + 16 * p, hc, lane));  // [n][k]: k8 B of n-tiles 2p, 2p+1
      mma_k8(c[2 * p], af, bf[0]);
      mma_k8(c[2 * p + 1], af, bf[1]);
    }
  } else {
    uint32_t af[4];
    ldsm_x4(af, tile_p1(a, ld, q0, hc, lane));
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      uint32_t bf[4];
      ldsm_x4(bf, tile_p2(b, ld, k0 + 16 * p, hc, lane));
      mma(c[2 * p], af, bf[0], bf[1]);
      mma(c[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// the k16 B fragments of rows r0 .. r0 + 15 of a slab at the head's
// columns hc ..: n-tile nt (of DHP / 8) is {b[2 nt], b[2 nt + 1]}
template <int DHP>
__device__ __forceinline__ void head_b(uint32_t (&b)[DHP / 4], const bf16* s, int ld, int r0,
                                       int hc) {
  const int lane = threadIdx.x & 31;
  if constexpr (DHP == 8) {
    uint32_t r[2];
    ldsm_x2_t(r, tile_x2(s, ld, r0, hc, lane));
    b[0] = r[0];
    b[1] = r[1];
  } else {
    uint32_t r[4];
    ldsm_x4_t(r, tile_p1(s, ld, r0, hc, lane));
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = r[i];
  }
}

// Add the column sums of a C fragment's rows (those flagged ok) to sum[0],
// sum[1], the lane's two columns; lanes 0-3 add.  Called by the whole warp.
__device__ __forceinline__ void add_col_sums(const float (&c)[4], float* sum, bool ok0,
                                             bool ok1) {
  float c0 = (ok0 ? c[0] : 0.f) + (ok1 ? c[2] : 0.f);
  float c1 = (ok0 ? c[1] : 0.f) + (ok1 ? c[3] : 0.f);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, o);
    c1 += __shfl_xor_sync(0xffffffffu, c1, o);
  }
  if ((threadIdx.x & 31) < 4) {
    sum[0] += c0;
    sum[1] += c1;
  }
}

// One (query tile, head) unit, by one warp: the queries q0 .. q0 + 15 of
// head h (columns hc = h * DHP) of batch row `row`.  q, k, v, dout:
// slabs; bias: the (K, K) bias with row stride bias_ld (shared memory or
// device memory; rows and columns >= K are not read).  Writes round(dq)
// into the slab dq, round(ds * scale) and round(p * keep) into the unit's
// 16 rows of the dS and P buffers (row stride ldp(KP)), adds ds to db (the
// lane's entries of the tile's rows) and, where dq_sum is given, the
// unrounded dq's column sums to dq_sum[0 .. DHP).
template <int KP, int DHP>
__device__ __forceinline__ void query_tile_grads(const bf16* q, const bf16* k, const bf16* v,
                                                 const bf16* dout, const bf16* bias, int bias_ld,
                                                 bf16* dq, bf16* pb, bf16* dsb,
                                                 float (&db)[KP / 8][4], float* dq_sum,
                                                 const Geo& geo, int q0, int h, int row,
                                                 float scale, const Dropout& drop) {
  constexpr int NT = KP / 8, LDP = ldp(KP);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int K = geo.K, RS = geo.RS, hc = h * DHP;
  const int r0 = q0 + g, r1 = r0 + 8;  // the lane's two query rows
  const bool ok0 = r0 < K, ok1 = r1 < K;
  const float ninf = __int_as_float(0xff800000);

  // ---- p = softmax(q_h k_h^T * scale + bias) over the K keys (fp32) ----
  float p[NT][4];
  head_product<DHP, NT>(q, k, RS, q0, 0, hc, p);
  float m0 = ninf, m1 = ninf;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = 8 * j + 2 * t + (i & 1), qr = i < 2 ? r0 : r1;
      const float b = kc < K && qr < K ? __bfloat162float(bias[qr * bias_ld + kc]) : 0.f;
      const float s = kc < K ? __fadd_rn(__fmul_rn(p[j][i], scale), b) : ninf;
      p[j][i] = s;
      if (i < 2)
        m0 = fmaxf(m0, s);
      else
        m1 = fmaxf(m1, s);
    }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(p[j][i] - (i < 2 ? m0 : m1));
      p[j][i] = e;
      if (i < 2)
        l0 += e;
      else
        l1 += e;
    }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[j][i] = i < 2 ? div_rn(p[j][i], l0, rl0) : div_rn(p[j][i], l1, rl1);

  // ---- the row sums of dp * p, dp = (do_h v_h^T) * keep; bit 4j + i of
  // kept (32 a word): element (j, i) is kept ----
  uint32_t kept[KP / 64] = {};
  float s0 = 0.f, s1 = 0.f;
  // Dropout::attn's hash argument at the lane's rows and key 2t; key 2t + c
  // adds c * kMixK (the same unsigned sums, so the same decisions)
  const uint32_t hx0 = (uint32_t)row * kMixR + (uint32_t)r0 * kMixQ + (uint32_t)(2 * t) * kMixK +
                       (uint32_t)h * kMixH + drop.seed_mix;
  const uint32_t hx1 = hx0 + 8u * kMixQ;
#pragma unroll
  for (int pp = 0; pp < KP / 16; ++pp) {
    if (16 * pp < K) {
      float dp[2][4];
      head_product<DHP, 2>(dout, v, RS, q0, 16 * pp, hc, dp);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * pp + jj;
          float d = dp[jj][i];
          if (drop.on()) {
            const uint32_t hx = (i < 2 ? hx0 : hx1) + (uint32_t)(8 * j + (i & 1)) * kMixK;
            const bool keep = fmix32(hx) >= drop.thresh;
            if (keep) kept[j / 8] |= 1u << (4 * (j % 8) + i);
            d = __fmul_rn(d, keep ? drop.scale : 0.f);
          }
          const float x = __fmul_rn(d, p[j][i]);
          if (i < 2)
            s0 += x;
          else
            s1 += x;
        }
    }
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);

  // ---- ds = p (dp - rowsum) (fp32) into db; round(ds * scale) as the A
  // fragments of dq = dS k_h and into the dS buffer; round(p * keep) into
  // the P buffer ----
  float dqa[DHP / 8][4] = {};
#pragma unroll
  for (int pp = 0; pp < KP / 16; ++pp) {
    if (16 * pp < K) {
      float dp[2][4];
      head_product<DHP, 2>(dout, v, RS, q0, 16 * pp, hc, dp);
      uint32_t a[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * pp + jj;
        float dsv[4], pdv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = i < 2 ? ok0 : ok1;
          float d = dp[jj][i], pk = p[j][i];
          if (drop.on()) {
            const float kv = (kept[j / 8] >> (4 * (j % 8) + i)) & 1u ? drop.scale : 0.f;
            d = __fmul_rn(d, kv);
            pk = __fmul_rn(pk, kv);
          }
          const float ds = ok ? __fmul_rn(p[j][i], __fsub_rn(d, i < 2 ? s0 : s1)) : 0.f;
          db[j][i] += ds;
          dsv[i] = __fmul_rn(ds, scale);
          pdv[i] = ok ? pk : 0.f;
        }
        const int c = 8 * j + 2 * t;
        const uint32_t d01 = pack_bf16(dsv[0], dsv[1]), d23 = pack_bf16(dsv[2], dsv[3]);
        a[2 * jj] = d01;
        a[2 * jj + 1] = d23;
        *reinterpret_cast<uint32_t*>(dsb + g * LDP + c) = d01;
        *reinterpret_cast<uint32_t*>(dsb + (g + 8) * LDP + c) = d23;
        *reinterpret_cast<uint32_t*>(pb + g * LDP + c) = pack_bf16(pdv[0], pdv[1]);
        *reinterpret_cast<uint32_t*>(pb + (g + 8) * LDP + c) = pack_bf16(pdv[2], pdv[3]);
      }
      uint32_t b[DHP / 4];
      head_b<DHP>(b, k, RS, 16 * pp, hc);  // k_h rows of the panel's keys: [k][n]
#pragma unroll
      for (int nt = 0; nt < DHP / 8; ++nt) mma(dqa[nt], a, b[2 * nt], b[2 * nt + 1]);
    }
  }

  // ---- round(dq) into the slab; the unrounded dq's column sums ----
#pragma unroll
  for (int nt = 0; nt < DHP / 8; ++nt) {
    const int c = hc + 8 * nt + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + r0 * RS + c) = pack_bf16(dqa[nt][0], dqa[nt][1]);
    *reinterpret_cast<uint32_t*>(dq + r1 * RS + c) = pack_bf16(dqa[nt][2], dqa[nt][3]);
    if (dq_sum) add_col_sums(dqa[nt], dq_sum + 8 * nt + 2 * t, ok0, ok1);
  }
}

// One (key tile, head) unit, by one warp, after the query-tile units of
// the head: dk_h and dv_h of the keys k0 .. k0 + 15 over the QT query
// tiles, dk = round(ds * scale)^T q_h and dv = round(p * keep)^T do_h from
// the head's dS and P buffers (rows 0 .. 16 QT - 1, stride ldp(KP)), fp32.
// Writes round(dk), round(dv) into the slabs dk, dv at the head's columns
// (the caller's k and v slabs: no unit reads k_h or v_h any more) and,
// where given, adds the unrounded column sums to dk_sum, dv_sum.
template <int KP, int DHP>
__device__ __forceinline__ void key_tile_grads(const bf16* q, const bf16* dout, const bf16* pb,
                                               const bf16* dsb, const Geo& geo, int k0, int h,
                                               bf16* dk, bf16* dv, float* dk_sum,
                                               float* dv_sum) {
  constexpr int LDP = ldp(KP);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int RS = geo.RS, hc = h * DHP;
  float dka[DHP / 8][4] = {}, dva[DHP / 8][4] = {};
  for (int qq = 0; qq < geo.QT; ++qq) {
    uint32_t as[4], ap[4], bq[DHP / 4], bo[DHP / 4];
    ldsm_x4_t(as, tile_p2(dsb, LDP, 16 * qq, k0, lane));  // dS^T: the buffer is [q][key]
    ldsm_x4_t(ap, tile_p2(pb, LDP, 16 * qq, k0, lane));
    head_b<DHP>(bq, q, RS, 16 * qq, hc);
    head_b<DHP>(bo, dout, RS, 16 * qq, hc);
#pragma unroll
    for (int nt = 0; nt < DHP / 8; ++nt) {
      mma(dka[nt], as, bq[2 * nt], bq[2 * nt + 1]);
      mma(dva[nt], ap, bo[2 * nt], bo[2 * nt + 1]);
    }
  }
  const int r0 = k0 + g, r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < DHP / 8; ++nt) {
    const int c = hc + 8 * nt + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + r0 * RS + c) = pack_bf16(dka[nt][0], dka[nt][1]);
    *reinterpret_cast<uint32_t*>(dk + r1 * RS + c) = pack_bf16(dka[nt][2], dka[nt][3]);
    *reinterpret_cast<uint32_t*>(dv + r0 * RS + c) = pack_bf16(dva[nt][0], dva[nt][1]);
    *reinterpret_cast<uint32_t*>(dv + r1 * RS + c) = pack_bf16(dva[nt][2], dva[nt][3]);
    if (dk_sum) {
      add_col_sums(dka[nt], dk_sum + 8 * nt + 2 * t, r0 < geo.K, r1 < geo.K);
      add_col_sums(dva[nt], dv_sum + 8 * nt + 2 * t, r0 < geo.K, r1 < geo.K);
    }
  }
}

// One batch row's head groups, by one half of the block (kWarps warps):
// half `half` of `halves` takes the groups half, half + halves, ...; for
// each, the query-tile units, a barrier of the half, the key-tile units, a
// barrier of the half.  Units are indexed by the warp within the half;
// the P and dS buffers hold one 16-row unit a warp of the block.  sums (or
// null): the fp32 column sums (KP / 16, 3, NQ) of dq, dk, dv, each entry
// owned by the warp of its (tile, head) unit.  bias, bias_ld as
// query_tile_grads takes them.  On entry the slabs are staged and
// synchronised.
template <int KP, int DHP>
__device__ __forceinline__ void row_grads(const bf16* q, bf16* k, bf16* v, const bf16* dout,
                                          const bf16* bias, int bias_ld, bf16* dq, bf16* pbuf,
                                          bf16* dsbuf, float (&db)[KP / 8][4], float* sums,
                                          const Geo& geo, int row, float scale,
                                          const Dropout& drop, int half, int halves) {
  constexpr int LDP = ldp(KP);
  const int bw = threadIdx.x >> 5, warp = bw - half * kWarps;
  const int slot = warp / geo.QT, tile = warp - slot * geo.QT;
  bf16* pb = pbuf + bw * 16 * LDP;
  bf16* dsb = dsbuf + bw * 16 * LDP;
  const int head0 = (half * kWarps + slot * geo.QT) * 16 * LDP;  // the slot's first buffer row
  for (int grp = half; grp < geo.groups; grp += halves) {
    const int h = grp * geo.G + slot;
    const bool on = warp < geo.units && h < geo.H;
    float* s = sums ? sums + tile * 3 * geo.NQ + h * DHP : nullptr;
    if (on)
      query_tile_grads<KP, DHP>(q, k, v, dout, bias, bias_ld, dq, pb, dsb, db, s, geo,
                                16 * tile, h, row, scale, drop);
    half_sync(half);
    if (on)
      key_tile_grads<KP, DHP>(q, dout, pbuf + head0, dsbuf + head0, geo, 16 * tile, h, k, v,
                              s ? s + geo.NQ : nullptr, s ? s + 2 * geo.NQ : nullptr);
    half_sync(half);
  }
}

// The block's dbias partial (K, K) fp32: warp w of the block, whose warp
// in its half is l = w % kWarps < units, holds in db the sums of query
// tile l % QT over the heads it took; the copies of a tile are added in
// warp order.  scratch: 16 * KP floats a warp of the block, shared memory
// that nothing else uses any more.  Called by all threads.
template <int KP>
__device__ __forceinline__ void flush_dbias(const float (&db)[KP / 8][4], float* scratch,
                                            const Geo& geo, float* __restrict__ part) {
  const int bw = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  __syncthreads();
  if (bw % kWarps < geo.units) {
    float* s = scratch + bw * 16 * KP;
#pragma unroll
    for (int j = 0; j < KP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[(g + (i >> 1) * 8) * KP + 8 * j + 2 * t + (i & 1)] = db[j][i];
  }
  __syncthreads();
  const int K = geo.K;
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) {
    const int qr = e / K, kc = e - qr * K, tile = qr >> 4;
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) {
      const int l = w % kWarps;
      if (l < geo.units && l % geo.QT == tile) sum += scratch[(w * 16 + (qr & 15)) * KP + kc];
    }
    part[e] = sum;
  }
}

}  // namespace mha_mma
}  // namespace tossctr
