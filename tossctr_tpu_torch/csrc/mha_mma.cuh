// The warp-unit stages of the bf16 attention kernels: the forwards
// (fused_mha.cu mha_fwd_mma, fused_mha_qkv.cu mha_qkv_fwd_chain) at K <=
// 160 and the backwards (fused_mha_bwd.cu mha_bwd_mma, fused_mha_qkv_bwd.cu
// mha_qkv_bwd_mma) at K <= 128.  A batch row's q, k, v (and do) come in
// whole as bf16 slabs, each head's columns padded to DHP = 8 or 16 with
// zeros; a warp takes one (16-query tile, head) unit at a time.  The
// stages:
//   - the softmax stage (softmax_frag, every unit of both directions): a
//     query tile's raw scores in C fragments to probabilities in
//     registers (scale and bias, row max, exp, the row sum in the
//     CUDA-core kernels' order: row_sum, and the correctly rounded
//     division: div_rn); tile_softmax forms the scores on mma first;
//   - the tensor-core forward unit (query_tile_fwd, fused_mha):
//     round(p * keep) packed from the softmax's C fragments straight into
//     the A fragments of P.V, the output rounded once into the q slab at
//     the head's columns;
//   - the FFMA-chain forward unit and projection (query_tile_fwd_chain,
//     project_qkv_chain, fused_mha_qkv): the same unit and q|k|v =
//     round(x Wqkv + b) with every fp32 sum an FFMA chain in the order of
//     the CUDA-core kernels (mha_core.cuh) and of the plain version on the
//     card, so bit-equal to them (fused_mha_qkv.cu says why it must be,
//     for now); they run on the CUDA cores, not on the tensor cores;
//   - the projection on mma.sync (project_qkv_mma: the qkv backward's
//     recompute of q, k, v), whose sums run in another order than the
//     forward's chains, so its q, k, v may lie 1 bf16 ulp from theirs;
//   - the backward's (16-query tile, head) unit (query_tile_grads: dS,
//     dbias, dq), its (16-key tile, head) unit (key_tile_grads: dk, dv),
//     their walk over a row (row_grads) and the dbias flush.
//
// The tensor-core stages run every product as mma.sync with bf16 operands
// and fp32 accumulators (mma_ptx.cuh), fed by ldmatrix from row-major bf16
// tiles: a head of dh <= 8 columns is a k8 contraction (m16n8k8), one of
// 9-16 a k16 one.  bf16 x bf16 products are exact in fp32, so only the
// order of the fp32 sums differs from the CUDA-core stages; the rounding
// points are the Pallas kernels' (tossctr_tpu/ops/pallas_attention.py
// _packed_attend_fwd, _packed_attend_bwd):
//   p    = softmax(q_h k_h^T * scale + bias)     fp32, not rounded (expf and
//                                                the correctly rounded division:
//                                                div_rn)
//   out  = round(round(p * keep) v_h)            fp32 sums (forward)
//   dp   = (do_h v_h^T) * keep
//   ds   = p * (dp - rowsum(dp * p))             fp32; dbias += ds
//   dq_h = round(ds * scale) k_h,  dk_h = round(ds * scale)^T q_h,
//   dv_h = round(p * keep)^T do_h                fp32 sums
//
// A query tile's scores live in C fragments (16 rows x KP keys: KP / 2
// registers a lane); the row statistics come from quad shuffles; the keep
// hash runs once an element, its argument hoisted.  The C layout of two
// n8 tiles is the A layout of one k16 step, so round(p * keep) (forward)
// and round(ds * scale) (backward) leave the registers as A fragments; the
// chain unit passes the quad's round(p * keep) by shuffles instead.  In
// the backward dp is formed twice, 16 keys at a time (once for the row
// sums, once for ds), the keep decisions kept as bits; round(ds * scale)
// and round(p * keep) also go, as bf16 rows, to two shared buffers, which
// the key-tile units read back with ldmatrix.trans for the products that
// contract over queries.  dbias has one owner lane an entry: a warp
// keeps the sums of its query tile over every head and row it takes in
// registers, and the copies of a tile are added in warp order at the end
// (flush_dbias), so a call repeats bit for bit.
//
// Padding: K to KP = 64, 128 (both directions) or 160 (the forwards)
// queries and keys.  Key columns >= K are -inf before the exp (p = 0, so
// round(p * keep) = 0 and ds = 0 there); query rows >= K get finite
// values that no output keeps (the backward sets their ds and
// round(p * keep) to 0, so they add nothing to dbias, dk or dv); slab
// rows past the staged ones are zero or finite.
#pragma once

#include "mma_ptx.cuh"

namespace tossctr {
namespace mha_mma {

using namespace tossctr::ptx;  // bf16, ldmatrix, mma, cp.async, tile addressing

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// queries and keys padded to KP = 64 or 128: the backwards take K <= 128,
// the forwards (which keep no dbias beside the scores) K <= 160.  A query
// tile's scores are KP / 8 n-tiles, its P.V or dq KP / 16 k16 steps; a row
// has at most KP / 16 query (and key) tiles
constexpr int kMaxKP = 128;
constexpr int kMaxKPFwd = 160;
// the forwards' head-padded width H * DHP (the slabs' columns) at most this
constexpr int kMaxFwdNQ = 64;
// row stride of a (., KP) bf16 tile: the bias and the P, dS buffers
__host__ __device__ constexpr int ldp(int KP) { return row_stride(KP); }

// head widths the kernels take: dh % 4 == 0, 4 <= dh <= 16
__host__ __device__ inline bool head_ok(int dh) { return dh >= 4 && dh <= 16 && dh % 4 == 0; }

// One batch row's geometry.  Slabs hold a (K, D) tensor head by head: head
// h in columns h * DHP .. h * DHP + dh - 1 of a row NQ wide (NQ a multiple
// of 16), stride RS; a row has QT query (and key) tiles of 16.
struct Geo {
  int K, D, H, dh, DHP, NQ, RS, QT;
  __host__ __device__ Geo(int K_, int D_, int H_) : K(K_), D(D_), H(H_) {
    dh = D / H;
    DHP = dh <= 8 ? 8 : 16;
    NQ = round_up(H * DHP, 16);
    RS = row_stride(NQ);
    QT = (K + 15) / 16;
  }
};

// The shapes the forwards' warp-unit kernels take: K <= kMaxKPFwd, a head
// width head_ok takes, and the H heads, each padded to DHP columns, at
// most kMaxFwdNQ wide (their slabs and the bias tile fit a block)
__host__ __device__ inline bool fwd_unit_shape(const Geo& g) {
  return g.K <= kMaxKPFwd && head_ok(g.dh) && g.H * g.DHP <= kMaxFwdNQ;
}

// The backward's walk of a row: its two kinds of unit meet at a barrier
// per head group, so the H heads go in groups of G: unit u < units = G *
// QT of a group is the warp u, query (and key) tile u % QT of head group *
// G + u / QT.  Needs QT <= kWarps (K <= 128).  The forward has no key-tile
// phase and walks its units freely.
struct BwdGroups {
  int G, n, units;
  __device__ explicit BwdGroups(const Geo& g) {
    G = kWarps / g.QT < g.H ? kWarps / g.QT : g.H;
    n = (g.H + G - 1) / G;
    units = G * g.QT;
  }
};

// Wqkv's columns, head-padded: natural column c of [q|k|v] -> which * NQ +
// h * DHP + e
__host__ __device__ inline int padded_col(const Geo& g, int c) {
  const int which = c / g.D, col = c - which * g.D, h = col / g.dh;
  return which * g.NQ + h * g.DHP + (col - h * g.dh);
}

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

// cp.async of one batch row's (K, D) x into a (., ld) buffer of rows
// (rows >= K not written)
__device__ __forceinline__ void stage_x(bf16* dst, int ld, const bf16* __restrict__ src, int K,
                                        int D) {
  const int pe = piece(D), per_row = D / pe;
  for (int i = threadIdx.x; i < K * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * pe;
    if (pe == 8)
      cp_async16(dst + r * ld + c, src + (size_t)r * D + c);
    else
      cp_async8(dst + r * ld + c, src + (size_t)r * D + c, true);
  }
}

// The forwards' bias tile: the (K, K) bias into a (KP, ldp(KP)) bf16 tile
// of shared memory, -inf in the columns >= K, zeros in the rows >= K
// below the others (tile_softmax's kTile).  Called by all threads.
template <int KP>
__device__ __forceinline__ void stage_bias_tile(bf16* dst, const bf16* __restrict__ bias,
                                                int K) {
  const bf16 ninf = __float2bfloat16_rn(__int_as_float(0xff800000));
  for (int i = threadIdx.x; i < KP * KP; i += blockDim.x) {
    const int r = i / KP, c = i - r * KP;
    dst[r * ldp(KP) + c] = c >= K ? ninf : (r < K ? bias[r * K + c] : __float2bfloat16_rn(0.f));
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

// The row sum of a unit's e = exp(s - max) over the keys, for the lane's
// row g (HALF 0: i < 2) or g + 8 (HALF 1), in the CUDA-core kernels' order
// (mha_core.cuh softmax_rows: lane l of a warp adds the keys l, l + 32, ...
// in turn, then warp_sum's butterfly over lane bits 4, 3, 2, 1, 0), which
// is the plain version's on the card: so the sum, and every probability,
// is bit-equal to theirs.  Key 8 j + 2 t + c of the C layout has lane bits
// (j % 4, t, c): the chains over j / 4 and bits 4, 3 run in the lane's
// registers, bits 2 and 1 across the quad, bit 0 last.  Keys past K hold
// e = 0, which adds nothing.
template <int NT, int HALF>
__device__ __forceinline__ float row_sum(const float (&e)[NT][4]) {
  static_assert(NT % 4 == 0, "a key tile is a multiple of 32 keys");
  float part[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float s[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      s[jj] = e[jj][2 * HALF + c];
#pragma unroll
      for (int j = jj + 4; j < NT; j += 4) s[jj] = __fadd_rn(s[jj], e[j][2 * HALF + c]);
    }
    float x = __fadd_rn(__fadd_rn(s[0], s[2]), __fadd_rn(s[1], s[3]));
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
    part[c] = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  }
  return __fadd_rn(part[0], part[1]);
}

// The softmax stage of a (16-query tile, head) unit, shared by every unit
// of the forwards and the backwards: from the raw scores q_h k_h^T in C
// fragments (p[j][i]: query q0 + g + 8 (i >> 1), key 8 j + 2 t + (i & 1))
// to p = softmax(scores * scale + bias) over the K keys, fp32: expf, the
// row sum (row_sum), then one __frcp_rn a row and div_rn.  Keys >= K get p
// = 0; rows >= K finite values.  bias: the (K, K) bias with row stride
// bias_ld, in shared or device memory, read where row and column are < K;
// or, with kTile, a (KP, ldp(KP)) tile in shared memory whose columns >= K
// hold -inf and whose rows >= K are finite elsewhere, read whole, two keys
// a load (the forwards': stage_bias_tile): the same scores, -inf + finite
// being -inf.
template <int KP, bool kTile>
__device__ __forceinline__ void softmax_frag(float (&p)[KP / 8][4], const bf16* bias,
                                             int bias_ld, const Geo& geo, int q0, float scale) {
  constexpr int NT = KP / 8;
  const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int K = geo.K;
  const int r0 = q0 + g, r1 = r0 + 8;  // the lane's two query rows
  const float ninf = __int_as_float(0xff800000);
  float m0 = ninf, m1 = ninf;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = 8 * j + 2 * t + (i & 1), qr = i < 2 ? r0 : r1;
      float s;
      if constexpr (kTile) {
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + qr * bias_ld + (kc & ~1)));
        s = __fadd_rn(__fmul_rn(p[j][i], scale), i & 1 ? b.y : b.x);
      } else {
        const float b = kc < K && qr < K ? __bfloat162float(bias[qr * bias_ld + kc]) : 0.f;
        s = kc < K ? __fadd_rn(__fmul_rn(p[j][i], scale), b) : ninf;
      }
      p[j][i] = s;
      if (i < 2)
        m0 = fmaxf(m0, s);
      else
        m1 = fmaxf(m1, s);
    }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[j][i] = expf(p[j][i] - (i < 2 ? m0 : m1));
  const float l0 = row_sum<NT, 0>(p), l1 = row_sum<NT, 1>(p);
  const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[j][i] = i < 2 ? div_rn(p[j][i], l0, rl0) : div_rn(p[j][i], l1, rl1);
}

// The tensor-core units' softmax stage: the scores of the queries q0 ..
// q0 + 15 against every key, contracted over head h's columns hc = h * DHP
// of the slabs q and k on mma (head_product), then softmax_frag.
template <int KP, int DHP, bool kTile = false>
__device__ __forceinline__ void tile_softmax(const bf16* q, const bf16* k, const bf16* bias,
                                             int bias_ld, const Geo& geo, int q0, int hc,
                                             float scale, float (&p)[KP / 8][4]) {
  head_product<DHP, KP / 8>(q, k, geo.RS, q0, 0, hc, p);
  softmax_frag<KP, kTile>(p, bias, bias_ld, geo, q0, scale);
}

// Dropout::attn's hash argument at a unit's lane: batch row `row`, query
// r0 (the lane's first row), key 2t, head h; row r0 + 8 adds 8 kMixQ, key
// 2t + c adds c kMixK (the same unsigned sums, so the same decisions)
__device__ __forceinline__ uint32_t hash_base(int row, int r0, int h, const Dropout& drop) {
  const uint32_t t = threadIdx.x & 3;
  return (uint32_t)row * kMixR + (uint32_t)r0 * kMixQ + 2u * t * kMixK + (uint32_t)h * kMixH +
         drop.seed_mix;
}

// The forward's (16-query tile, head) unit, by one warp: the queries q0 ..
// q0 + 15 of head h (columns hc = h * DHP) of batch row `row`:
//   out_h = round(round(softmax(q_h k_h^T * scale + bias) * keep) v_h)
// round(p * keep) packed from the softmax's C fragments into the A
// fragments of P.V (16 keys a k16 step, the key panels past K skipped),
// fp32 sums, the output rounded once into the slab `out` at the head's
// columns, rows q0 .. q0 + 15.  `out` may be the q slab: the unit is the
// only reader of those entries and reads them before it writes.  bias:
// the bias tile of tile_softmax's kTile (stage_bias_tile).
template <int KP, int DHP>
__device__ __forceinline__ void query_tile_fwd(const bf16* q, const bf16* k, const bf16* v,
                                               const bf16* bias, bf16* out, const Geo& geo,
                                               int q0, int h, int row, float scale,
                                               const Dropout& drop) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int K = geo.K, RS = geo.RS, hc = h * DHP;
  const int r0 = q0 + g, r1 = r0 + 8;
  float p[KP / 8][4];
  tile_softmax<KP, DHP, true>(q, k, bias, ldp(KP), geo, q0, hc, scale, p);
  const uint32_t hx0 = hash_base(row, r0, h, drop), hx1 = hx0 + 8u * kMixQ;
  float o[DHP / 8][4] = {};
#pragma unroll
  for (int pp = 0; pp < KP / 16; ++pp) {
    if (16 * pp < K) {
      uint32_t a[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * pp + jj;
        float pk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = p[j][i];
          if (drop.on()) {
            const uint32_t hx = (i < 2 ? hx0 : hx1) + (uint32_t)(8 * j + (i & 1)) * kMixK;
            pk[i] = __fmul_rn(pk[i], fmix32(hx) >= drop.thresh ? drop.scale : 0.f);
          }
        }
        a[2 * jj] = pack_bf16(pk[0], pk[1]);
        a[2 * jj + 1] = pack_bf16(pk[2], pk[3]);
      }
      uint32_t b[DHP / 4];
      head_b<DHP>(b, v, RS, 16 * pp, hc);  // v_h rows of the panel's keys: [k][n]
#pragma unroll
      for (int nt = 0; nt < DHP / 8; ++nt) mma(o[nt], a, b[2 * nt], b[2 * nt + 1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < DHP / 8; ++nt) {
    const int c = hc + 8 * nt + 2 * t;
    *reinterpret_cast<uint32_t*>(out + r0 * RS + c) = pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(out + r1 * RS + c) = pack_bf16(o[nt][2], o[nt][3]);
  }
}

// n (4, 8 or 16) bf16 at p, 8-byte aligned (16 where n % 8 == 0), as fp32
template <int N>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&o)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        o[i + 2 * k] = f.x;
        o[i + 2 * k + 1] = f.y;
      }
    }
  } else {
    static_assert(N == 4 || N == 2, "2, 4 or a multiple of 8");
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      o[i] = f.x;
      o[i + 1] = f.y;
    }
  }
}

// The qkv backward's projection (its recompute of q, k, v) on mma.sync:
// q|k|v = round(x Wqkv + b) into the slabs q, k, v for the 16 QT rows of x
// (bf16 (., lx), zeros past row K and past column D up to DP, a multiple
// of 16).  Wqkv: bf16 (DP, lw) with head-padded columns (padded_col),
// zeros in the pad; b: fp32 (3 NQ), likewise.  A unit is 16 rows x 16
// padded columns; warp w of the block's NW takes the units w, w + NW, ...
// Its fp32 sums run in the tensor cores' order, not in the forward's
// (project_qkv_chain), so the two may round 1 bf16 ulp apart.
template <int NW>
__device__ __forceinline__ void project_qkv_mma(const bf16* x, int lx, const bf16* w, int lw,
                                                const float* b, bf16* q, bf16* k, bf16* v,
                                                const Geo& geo, int DP) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int NQ = geo.NQ, RS = geo.RS, QT = geo.QT;
  const int npairs = 3 * NQ / 16, mt = DP / 16;  // 16-column pairs of [q|k|v]; 16-row tiles of Wqkv
  for (int u = warp; u < QT * npairs; u += NW) {
    const int m = u % QT, np = u / QT;
    float acc[2][4] = {};
    for (int kk = 0; kk < mt; ++kk) {
      uint32_t a[4], bb[4];
      ldsm_x4(a, tile_p1(x, lx, 16 * m, 16 * kk, lane));
      ldsm_x4_t(bb, tile_p1(w, lw, 16 * kk, 16 * np, lane));  // Wqkv: [k][n]
      mma(acc[0], a, bb[0], bb[1]);
      mma(acc[1], a, bb[2], bb[3]);
    }
    const int which = (16 * np) / NQ;
    bf16* dst = which == 0 ? q : (which == 1 ? k : v);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 16 * np + 8 * jj + 2 * t;
      const float b0 = b[c], b1 = b[c + 1];
      const int col = c - which * NQ, r = 16 * m + g;
      *reinterpret_cast<uint32_t*>(dst + r * RS + col) =
          pack_bf16(__fadd_rn(acc[jj][0], b0), __fadd_rn(acc[jj][1], b1));
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * RS + col) =
          pack_bf16(__fadd_rn(acc[jj][2], b0), __fadd_rn(acc[jj][3], b1));
    }
  }
}

// The qkv forward's projection, bit-equal to the CUDA-core kernels'
// (mha_core.cuh project_qkv) and to the plain version's on the card:
// q|k|v = round(x Wqkv + b), each sum an FFMA chain over d = 0 .. D - 1 in
// order, into the slabs q, k, v for the 16 QT rows of x (bf16 (., lx),
// zeros past row K and column D).  Wqkv: bf16 (DP, lw) with head-padded
// columns (padded_col), zeros in the pad; b: fp32 (3 NQ), likewise.  A
// thread a tile of 4 rows x 8 padded columns (one head of 8, or half of
// one of 16), 4 d's a step.
__device__ __forceinline__ void project_qkv_chain(const bf16* x, int lx, const bf16* w, int lw,
                                                  const float* b, bf16* q, bf16* k, bf16* v,
                                                  const Geo& geo) {
  const int NQ = geo.NQ, RS = geo.RS, cols8 = 3 * NQ / 8;
  for (int u = threadIdx.x; u < 4 * geo.QT * cols8; u += blockDim.x) {
    const int rg = u / cols8, r = 4 * rg, c = 8 * (u - rg * cols8);
    float acc[4][8] = {};
    for (int d0 = 0; d0 < geo.D; d0 += 4) {
      float xs[4][4], ws[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_bf16<4>(x + (r + i) * lx + d0, xs[i]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) load_bf16<8>(w + (d0 + dd) * lw + c, ws[dd]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jc = 0; jc < 8; ++jc) acc[i][jc] = __fmaf_rn(xs[i][dd], ws[dd][jc], acc[i][jc]);
    }
    const int which = c / NQ, col = c - which * NQ;
    bf16* dst = (which == 0 ? q : (which == 1 ? k : v)) + r * RS + col;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t o[4];
#pragma unroll
      for (int jc = 0; jc < 8; jc += 2)
        o[jc / 2] =
            pack_bf16(__fadd_rn(acc[i][jc], b[c + jc]), __fadd_rn(acc[i][jc + 1], b[c + jc + 1]));
      *reinterpret_cast<uint4*>(dst + i * RS) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The qkv forward's (16-query tile, head) unit, by one warp: what
// query_tile_fwd computes, bit-equal to the CUDA-core kernels
// (mha_core.cuh head_fwd) and to the plain version on the card, because
// every fp32 sum runs in their order: the scores as FFMA chains over the
// head's columns in order (then softmax_frag, whose row sum keeps their
// order too), P.V as FFMA chains over the keys in order.  The lane's rows
// g and g + 8 take their scores in the C layout (key 8 j + 2 t + c), so
// round(p * keep) leaves the softmax packed, a bf16 pair a key pair; for
// P.V each lane takes DHP / 4 of the head's columns for both rows and
// walks the keys in order, the quad's four key pairs of each 8 by
// shuffles.  The output is rounded once into `out` (the q slab may be
// it) at the head's columns; bias: stage_bias_tile's tile.
template <int KP, int DHP>
__device__ __forceinline__ void query_tile_fwd_chain(const bf16* q, const bf16* k,
                                                     const bf16* v, const bf16* bias, bf16* out,
                                                     const Geo& geo, int q0, int h, int row,
                                                     float scale, const Dropout& drop) {
  constexpr int NT = KP / 8, NC = DHP / 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int K = geo.K, RS = geo.RS, hc = h * DHP;
  const int r0 = q0 + g, r1 = r0 + 8;

  // ---- the scores: FFMA chains over the head's columns ----
  float p[NT][4];
  {
    float qa[DHP], qb[DHP];
    load_bf16<DHP>(q + r0 * RS + hc, qa);
    load_bf16<DHP>(q + r1 * RS + hc, qb);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float kv[DHP];
        load_bf16<DHP>(k + (8 * j + 2 * t + c) * RS + hc, kv);
        float a = 0.f, b = 0.f;  // the pad columns are zeros: they add exactly nothing
#pragma unroll
        for (int e = 0; e < DHP; ++e) {
          a = __fmaf_rn(qa[e], kv[e], a);
          b = __fmaf_rn(qb[e], kv[e], b);
        }
        p[j][c] = a;
        p[j][2 + c] = b;
      }
  }
  softmax_frag<KP, true>(p, bias, ldp(KP), geo, q0, scale);

  // ---- round(p * keep): pr[j][0] row g, pr[j][1] row g + 8, keys 8 j + 2 t, + 1 ----
  uint32_t pr[NT][2];
  const uint32_t hx0 = hash_base(row, r0, h, drop), hx1 = hx0 + 8u * kMixQ;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float pk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pk[i] = p[j][i];
      if (drop.on()) {
        const uint32_t hx = (i < 2 ? hx0 : hx1) + (uint32_t)(8 * j + (i & 1)) * kMixK;
        pk[i] = __fmul_rn(pk[i], fmix32(hx) >= drop.thresh ? drop.scale : 0.f);
      }
    }
    pr[j][0] = pack_bf16(pk[0], pk[1]);
    pr[j][1] = pack_bf16(pk[2], pk[3]);
  }

  // ---- out = round(P v_h): FFMA chains over the keys 0, 1, 2, ... ----
  const int c0 = hc + NC * t, quad = lane & ~3;
  float o0[NC] = {}, o1[NC] = {};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j < K) {
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const uint32_t a = __shfl_sync(0xffffffffu, pr[j][0], quad | tt);
        const uint32_t b = __shfl_sync(0xffffffffu, pr[j][1], quad | tt);
        const float2 pa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
        const float2 pb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float vv[NC];
          load_bf16<NC>(v + (8 * j + 2 * tt + c) * RS + c0, vv);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            o0[n] = __fmaf_rn(c ? pa.y : pa.x, vv[n], o0[n]);
            o1[n] = __fmaf_rn(c ? pb.y : pb.x, vv[n], o1[n]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NC; n += 2) {
    *reinterpret_cast<uint32_t*>(out + r0 * RS + c0 + n) = pack_bf16(o0[n], o0[n + 1]);
    *reinterpret_cast<uint32_t*>(out + r1 * RS + c0 + n) = pack_bf16(o1[n], o1[n + 1]);
  }
}

// The backward's (query tile, head) unit, by one warp: the queries q0 ..
// q0 + 15 of head h (columns hc = h * DHP) of batch row `row`.  q, k, v, dout:
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
  float p[NT][4];
  tile_softmax<KP, DHP>(q, k, bias, bias_ld, geo, q0, hc, scale, p);

  // ---- the row sums of dp * p, dp = (do_h v_h^T) * keep; bit 4j + i of
  // kept (32 a word): element (j, i) is kept ----
  uint32_t kept[KP / 64] = {};
  float s0 = 0.f, s1 = 0.f;
  const uint32_t hx0 = hash_base(row, r0, h, drop), hx1 = hx0 + 8u * kMixQ;
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

// One batch row's head groups (BwdGroups), by one half of the block
// (kWarps warps): half `half` of `halves` takes the groups half, half +
// halves, ...; for each, the query-tile units, a barrier of the half, the
// key-tile units, a barrier of the half.  Units are indexed by the warp within the half;
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
  const BwdGroups gr(geo);
  for (int grp = half; grp < gr.n; grp += halves) {
    const int h = grp * gr.G + slot;
    const bool on = warp < gr.units && h < geo.H;
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
  const int warps = blockDim.x >> 5, units = BwdGroups(geo).units;
  __syncthreads();
  if (bw % kWarps < units) {
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
      if (l < units && l % geo.QT == tile) sum += scratch[(w * 16 + (qr & 15)) * KP + kc];
    }
    part[e] = sum;
  }
}

}  // namespace mha_mma
}  // namespace tossctr
