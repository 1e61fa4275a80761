// fm_cross backward: gradients of the QNN-alpha multi-head low-rank FM
// cross (fm_cross.cu), for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_kernels.py fm_cross_pallas, backward
// pallas_call in _fm_bwd_call (kernel _fm_bwd_kernel).
//
// What it computes, per batch row b and head h, from z, U, V and the
// output's gradient g (B, H*P), with the Pallas kernel's rounding points
// (everything fp32; z, U, V, g are values of the storage type T):
//   A     = z[b] @ U_h,  s = sum_f A,  quad = s^2 - sum_f A^2   (recomputed)
//   dV_h += quad^T g_h                      (quad not rounded)
//   dquad = g_h @ V_h^T
//   dA    = 2 dquad (s - A)                 (F, R)
//   dz[b] = round_T(sum_h dA_h @ U_h^T)     (the heads added in order)
//   dU_h += z[b]^T dA_h
// dU and dV are sums over the batch in fp32.
//
// What bounds it on the card: at the flagship shapes (B=8192, F=200,
// D=64, H=6, R=16, P=192, bf16) one call reads z and g (229 MB) and writes
// dz (210 MB), ~131 us at 3.35 TB/s, against ~61 GFLOP (~61 us on the
// bf16 tensor cores): it is bound by the bytes.
//
// Two main kernels, each followed by the same two deterministic passes.
//
// fm_bwd_mma_kernel (bf16, the shapes fm_mma.cuh Dims::ok takes; the
// wrapper routes by ops/fm_cross.py fm_mma_kernel; built with its loop
// counts fixed for the flagship's shape, with bounds for every other):
// one persistent block an SM (8 warps, 228 KB of shared memory and 219
// registers a thread at the flagship) walks groups of 8 batch rows, one a
// warp, with U and V resident in shared memory.  Every product runs on
// the tensor cores with bf16 operands and fp32 sums: at the flagship's
// shape A, dz and dU as wgmma over a warpgroup's 4 rows (A and dU with
// both operands in shared memory in wgmma's canonical layout, dz with
// dA's halves from registers); dquad, and every product at any other
// shape, as mma.sync m16n8k16.  dA needs s = sum_f A before a group's
// first row, so each group's z passes twice; a 2-stage cp.async ring
// holds in each stage m-tile i of the group in sweep 2 and of the next
// group in sweep 1, so the first pass runs beside the second (its bytes
// read again from device memory where L2 no longer holds them: the
// kernel is not bound by the bytes):
//   sweep 1: each warp adds its row's z over f (fp32, in f order); at the
//     group's sweep 2's first step s = (sum_f z) U in fp32 on the CUDA
//     cores (the same products z U summed in another order), and dquad =
//     g V^T for the group's rows (g's bf16 rows staged by cp.async during
//     sweep 1, V resident; the products exact);
//   sweep 2, m-tile by m-tile: each warp recomputes its row's A = z U (at
//     the flagship its warpgroup's, from a canonical copy of the z tiles
//     made from their A fragments), adds A*A into column sums for quad,
//     forms dA = 2 dquad (s - A) in fp32 in registers (padded rows of F
//     masked to 0), splits it into bf16 hi = round(dA) and lo = round(dA
//     - hi), and adds dz += hi U^T + lo U^T (the C fragment of two n8
//     tiles is the A fragment of one k16 step), so dA enters dz within
//     ~2^-16 of fp32, as the Pallas kernel's fp32 product has it; dz is
//     rounded to bf16 once.  The hi and lo halves go to shared memory, in
//     wgmma's canonical layout; after a __syncthreads each warpgroup adds
//     its 48-column half of dU += z^T hi + z^T lo over the 8 warps' rows
//     with wgmma m64n48k16 (at any other shape each warp adds its own
//     16x16 units with mma.sync); dU stays in registers for the block's
//     life;
//   at the group's end: quad = s^2 - sum_f A^2 in fp32 (unrounded) to the
//     quad scratch buffer for the dV pass.
//
// fm_bwd_kernel (fp32, and bf16 at the shapes the tensor-core kernel does
// not take): one persistent block an SM walks batch rows.  A row's z, A
// (then dA, in place) and g stay in shared memory (198 KB a block at the
// flagship shapes) with U in two layouts; dz comes out of 4x4 register
// tiles on the CUDA cores, and each thread keeps its 4x4 tiles of dU in
// registers across the rows; each row's quad (H*R fp32) goes to the quad
// scratch buffer.
//
// In both, A is recomputed from z, not kept from the forward: the forward
// never writes it, and storing it would cost the (B, H, F, R) fp32 tensor
// in device memory that the kernel pair exists to avoid.  Device memory
// sees g and dz once and z once (the tensor-core kernel: twice at most).
// At the end every block writes its fp32 partial dU to a
// scratch buffer that a second kernel (common.cuh reduce_partials) adds
// in block order.  dV needs only quad and g: fm_dv_kernel sums quad^T g
// over fixed chunks of rows, the chunks again added in order.  No
// atomics, so the bits repeat from run to run.
#include "fm_cross.cuh"
#include "fm_mma.cuh"

namespace {

using tossctr::align4;
using tossctr::from_f;
using tossctr::load4;
using tossctr::to_f;
using tossctr::fm::Dims;
using tossctr::fm::kMaxC;
using tossctr::fm::kMaxD;
using tossctr::fm::kThreads;

// dU register tiles per thread: (64/4) * (128/4) tiles over 256 threads
constexpr int kMaxUTiles = (kMaxD / 4) * (kMaxC / 4) / kThreads;

struct Layout {
  int Z, A, UD, UC, gs, ps, psq, s, dq, total;  // offsets in floats
  __host__ __device__ explicit Layout(const Dims& L) {
    Z = 0;
    A = Z + L.F4 * L.DS;       // A, then dA in place (F4, CS)
    UD = A + L.F4 * L.CS;      // U as (D4, C4)
    UC = UD + L.D4 * L.C4;     // U as (C4, DS)
    gs = UC + L.C4 * L.DS;     // the row's g (H*P)
    ps = gs + align4(L.H * L.P);
    psq = ps + L.groups * L.C4;
    s = psq + L.groups * L.C4;  // column sums of A
    dq = s + L.C4;              // dquad
    total = dq + L.C4;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_bwd_kernel(const T* __restrict__ z, const T* __restrict__ U, const T* __restrict__ V,
              const T* __restrict__ g, T* __restrict__ dz, float* __restrict__ quad_out,
              float* __restrict__ partials, Dims L) {
  extern __shared__ __align__(16) float smem[];
  const Layout S(L);
  float* Z = smem + S.Z;
  float* A = smem + S.A;
  float* UD = smem + S.UD;
  float* UC = smem + S.UC;
  float* gs = smem + S.gs;
  float* ps = smem + S.ps;
  float* psq = smem + S.psq;
  float* s_s = smem + S.s;
  float* dq_s = smem + S.dq;
  const int tid = threadIdx.x;
  const int HP = L.H * L.P;
  const int DT = L.D4 / 4;  // 4-column tiles of dz
  const int u_tiles = DT * L.n_ct;

  tossctr::fm::load_u<T>(U, L, UD, UC);
  float du[kMaxUTiles][4][4];
#pragma unroll
  for (int k = 0; k < kMaxUTiles; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) du[k][i][j] = 0.f;

  for (int row = blockIdx.x; row < L.B; row += gridDim.x) {
    __syncthreads();  // the previous row is done with every buffer
    tossctr::fm::load_row<T>(z, row, L, Z);
    for (int o = tid; o < HP; o += kThreads) gs[o] = to_f<T>(g[(size_t)row * HP + o]);
    __syncthreads();

    // ---- A = z U (kept), its column sums ----
    tossctr::fm::a_tiles(Z, UD, L, ps, psq, A);
    __syncthreads();

    // ---- s, quad (to the dV pass), dquad = g_h V_h^T per column ----
    for (int c = tid; c < L.C4; c += kThreads) {
      float s = 0.f, dquad = 0.f;
      if (c < L.C) {
        float sq;
        tossctr::fm::column_sums(ps, psq, L, c, &s, &sq);
        quad_out[(size_t)row * L.C + c] = __fsub_rn(__fmul_rn(s, s), sq);
        const int h = c / L.R;
        const float* gh = gs + h * L.P;
        const T* v = V + (size_t)c * L.P;  // V[h][r][:], c = h*R + r
        for (int p = 0; p < L.P; ++p) dquad = fmaf(gh[p], to_f<T>(v[p]), dquad);
      }
      s_s[c] = s;
      dq_s[c] = dquad;
    }
    __syncthreads();

    // ---- dA = 2 dquad (s - A) in place; the padding rows stay 0 ----
    for (int i = tid; i < L.F4 * L.C4; i += kThreads) {
      const int f = i / L.C4, c = i - f * L.C4;
      float* a = A + f * L.CS + c;
      *a = f < L.F ? __fmul_rn(__fmul_rn(2.f, dq_s[c]), __fsub_rn(s_s[c], *a)) : 0.f;
    }
    __syncthreads();

    // ---- dz = sum_h dA_h U_h^T: 4x4 tiles; a warp spans d, so the dA
    // reads are broadcasts ----
    for (int t = tid; t < (L.F4 / 4) * DT; t += kThreads) {
      const int f0 = (t / DT) * 4, d0 = (t - (t / DT) * DT) * 4;
      float acc[4][4] = {};
      for (int h = 0; h < L.H; ++h) {
        float hacc[4][4] = {};
        for (int r = 0; r < L.R; ++r) {
          const int c = h * L.R + r;
          float a[4], u[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = A[(f0 + i) * L.CS + c];
          load4(UC + c * L.DS + d0, u);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) hacc[i][j] = fmaf(a[i], u[j], hacc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], hacc[i][j]);
      }
      T* out = dz + (size_t)row * L.F * L.D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = f0 + i;
        if (f >= L.F) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d0 + j < L.D) out[f * L.D + d0 + j] = from_f<T>(acc[i][j]);
      }
    }

    // ---- dU += z^T dA into the register tiles ----
#pragma unroll
    for (int k = 0; k < kMaxUTiles; ++k) {
      const int t = tid + k * kThreads;
      if (t < u_tiles) {
        const int d0 = (t / L.n_ct) * 4, c0 = (t - (t / L.n_ct) * L.n_ct) * 4;
        for (int f = 0; f < L.F; ++f) {
          float zv[4], av[4];
          load4(Z + f * L.DS + d0, zv);
          load4(A + f * L.CS + c0, av);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) du[k][i][j] = fmaf(zv[i], av[j], du[k][i][j]);
        }
      }
    }
  }

  // ---- this block's partial dU, laid out as (H, D, R) ----
  float* part = partials + (size_t)blockIdx.x * L.H * L.D * L.R;
#pragma unroll
  for (int k = 0; k < kMaxUTiles; ++k) {
    const int t = tid + k * kThreads;
    if (t < u_tiles) {
      const int d0 = (t / L.n_ct) * 4, c0 = (t - (t / L.n_ct) * L.n_ct) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + i, c = c0 + j;
          if (d < L.D && c < L.C)
            part[(size_t)(c / L.R) * L.D * L.R + d * L.R + c % L.R] = du[k][i][j];
        }
    }
  }
}

// dV partials: part[chunk][h, r, p] = sum over the chunk's rows b, in
// order, of quad[b, h*R + r] * g[b, h*P + p].  A thread takes one (h, p)
// and kDvRows consecutive r, so it reads each g value once for all of
// them (the quad values are the same for the warp's threads: one read,
// through L1).
constexpr int kDvRows = 8;

template <typename T>
__global__ void fm_dv_kernel(const float* __restrict__ quad, const T* __restrict__ g,
                             float* __restrict__ part, int rows_per_chunk, Dims L) {
  const int rb = (L.R + kDvRows - 1) / kDvRows;  // blocks of r
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= L.H * rb * L.P) return;
  const int hr = o / L.P, p = o - hr * L.P;
  const int h = hr / rb, r0 = (hr - h * rb) * kDvRows;
  const int b0 = blockIdx.y * rows_per_chunk;
  const int b1 = min(L.B, b0 + rows_per_chunk);
  const size_t HP = (size_t)L.H * L.P;
  float acc[kDvRows] = {};
  const float* q = quad + (size_t)b0 * L.C + h * L.R + r0;
  for (int b = b0; b < b1; ++b, q += L.C) {
    const float gv = to_f<T>(g[b * HP + h * L.P + p]);
#pragma unroll
    for (int j = 0; j < kDvRows; ++j)
      if (r0 + j < L.R) acc[j] = fmaf(q[j], gv, acc[j]);
  }
  float* out = part + (size_t)blockIdx.y * L.H * L.R * L.P + ((size_t)h * L.R + r0) * L.P + p;
#pragma unroll
  for (int j = 0; j < kDvRows; ++j)
    if (r0 + j < L.R) out[(size_t)j * L.P] = acc[j];
}

// ---- the tensor-core kernel ----

namespace mm = tossctr::fm_mma;
using mm::bf16;
using mm::kRows;
using mm::kWarps;
using tossctr::ptx::ldsm_x2;
using tossctr::ptx::ldsm_x4;
using tossctr::ptx::ldsm_x4_t;
using tossctr::ptx::mma;
using tossctr::ptx::pack_bf16;
using tossctr::ptx::tile_p1;
using tossctr::ptx::tile_p2;

// hi = round_bf16(v), lo = round_bf16(v - hi): v = hi + lo within ~2^-16 |v|
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
}

// NP k16 steps over the padded columns (CP = 16 NP) and DT over D (DP =
// 16 DT); EXACT: the shape has them all, else they are bounds and the
// loops stop at the shape's (mm::Dims)
template <int NP, int DT, bool EXACT>
__global__ void __launch_bounds__(mm::kThreads, 1)
fm_bwd_mma_kernel(const bf16* __restrict__ z, const bf16* __restrict__ U,
                  const bf16* __restrict__ V, const bf16* __restrict__ gin,
                  bf16* __restrict__ dz, float* __restrict__ quad_out,
                  float* __restrict__ partials, mm::Dims L) {
  constexpr int S = mm::kBwdStages;
  constexpr int KU = (DT * NP + kWarps - 1) / kWarps;  // dU units a warp, at most
  constexpr int SC = (16 * NP + 31) / 32;              // columns of s a lane, at most
  constexpr bool kDuWgmma = EXACT;  // the flagship's dU products on wgmma (6 n8 tiles a warpgroup)
  static_assert(!kDuWgmma || (NP == 6 && DT == 4), "dU's wgmma is m64n48: D = 64, H*R = 96");
  constexpr bool kDzWgmma = EXACT;  // and its dz products (m64n64k16, dA from registers)
  static_assert(!kDzWgmma || DT == 4, "dz's wgmma is m64n64: D = 64");
  constexpr bool kAWgmma = EXACT;  // and its A = z U (m64n96k16)
  static_assert(!kAWgmma || (NP == 6 && DT == 4), "A's wgmma is m64n96: D = 64, H*R = 96");
  extern __shared__ __align__(16) float smem_f[];  // one declaration a source
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const mm::BwdLayout M(L);
  bf16* Us = reinterpret_cast<bf16*>(smem + M.U);
  bf16* Vs = reinterpret_cast<bf16*>(smem + M.V);
  bf16* ring = reinterpret_cast<bf16*>(smem + M.ring);
  bf16* zcs = reinterpret_cast<bf16*>(smem + M.zc);
  bf16* ucs = reinterpret_cast<bf16*>(smem + M.uc);
  bf16* his = reinterpret_cast<bf16*>(smem + M.hi);
  bf16* los = reinterpret_cast<bf16*>(smem + M.lo);
  bf16* gs = reinterpret_cast<bf16*>(smem + M.g);
  float* s_s = reinterpret_cast<float*>(smem + M.s);
  float* dq_s = reinterpret_cast<float*>(smem + M.dq);
  const bf16* zero = reinterpret_cast<const bf16*>(smem + M.zero);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tile_elems = kWarps * 16 * L.LDZ;  // a stage: [0] sweep 2's tile, [1] sweep 1's
  const int HP = L.H * L.P;
  const int np = EXACT ? NP : L.NT / 2, dt = EXACT ? DT : L.DT;

  mm::load_weights(U, V, L, Us, Vs);
  if constexpr (kDzWgmma)
    for (int i = tid; i < L.DP * L.CP; i += mm::kThreads) {
      const int d = i / L.CP, c = i - d * L.CP;
      ucs[mm::canon_u(d, c, L.DP)] = Us[d * L.LDU + c];
    }
  for (int i = tid; i < 2 * kRows * L.CP; i += mm::kThreads) s_s[i] = 0.f;  // s_s, dq_s
  if (tid < 4) reinterpret_cast<uint32_t*>(smem + M.zero)[tid] = 0u;
  // this warp's units of dU: (16 d, 16 c) units u = (d / 16) * np + c / 16,
  // a run of at most KU of them a warp; zc, hc: a unit's first column in a
  // z tile and in a dA half (-1: no unit)
  const int n_units = dt * np, per = (n_units + kWarps - 1) / kWarps;
  int zc[KU], hc[KU];
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    const int u = w * per + k;
    const bool ok = k < per && u < n_units;
    zc[k] = ok ? (u / np) * 16 : -1;
    hc[k] = ok ? (u - (u / np) * np) * 16 : -1;
  }
  float du[KU][2][4] = {};

  // Phase p of the block's groups: m-tile i of its group p - 1 (sweep 2)
  // and of its group p (sweep 1) in one stage, so the sum over f of the
  // next group runs beside this one's products
  const int n_groups =
      blockIdx.x < L.groups ? (L.groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = n_groups > 0 ? (n_groups + 1) * L.MT : 0;
  auto load = [&](int q) {
    const int p = q / L.MT, i = q - p * L.MT;
    bf16* stage = ring + (q % S) * 2 * tile_elems;
    if (p > 0) mm::load_stage(z, L, blockIdx.x + (p - 1) * gridDim.x, i, stage);
    if (p < n_groups) mm::load_stage(z, L, blockIdx.x + p * gridDim.x, i, stage + tile_elems);
  };
  auto load_g = [&](int G) {  // group G's g rows, heads padded to PP; zeros past P and B
    const int pieces = L.H * (L.PP / 4);
    for (int p = tid; p < kRows * pieces; p += mm::kThreads) {
      const int r = p / pieces, rem = p - r * pieces;
      const int h = rem / (L.PP / 4), p4 = (rem - h * (L.PP / 4)) * 4;
      const int b = G * kRows + r;
      const bool ok = b < L.B && p4 < L.P;
      tossctr::ptx::cp_async8(gs + r * L.LDG + h * L.PP + p4,
                              ok ? gin + (size_t)b * HP + h * L.P + p4 : gin, ok);
    }
  };
  for (int q = 0; q < S - 1; ++q) {
    if (q < steps) load(q);
    tossctr::ptx::cp_async_commit();
  }
  if (steps > 0) {
    load_g(blockIdx.x);
    tossctr::ptx::cp_async_commit();
  }

  float zs[2] = {0.f, 0.f};  // sum over f of this lane's two columns 2 lane, 2 lane + 1
  float sq[2 * NP][2] = {};  // this lane's column sums of A*A
  for (int q = 0; q < steps; ++q) {
    const int p = q / L.MT, i = q - p * L.MT;
    const int G = blockIdx.x + (p - 1) * gridDim.x;  // sweep 2's group
    tossctr::ptx::cp_async_wait<0>();  // stage q (and group p - 1's g) landed
    __syncthreads();                   // for every thread; stage q - 1 is free
    if (q + 1 < steps) load(q + 1);
    tossctr::ptx::cp_async_commit();
    const bf16* zt = ring + (q % S) * 2 * tile_elems + w * 16 * L.LDZ;
    const int row = G * kRows + w;
    float* sw = s_s + w * L.CP;
    float* qw = dq_s + w * L.CP;

    if (i == 0 && p > 0) {
      // ---- group p - 1's dquad = g V^T: (8 rows, 8 columns of one head) units ----
      for (int u = w; u < L.C / 8; u += kWarps) {
        const int h = u / (L.R / 8), r0 = (u - h * (L.R / 8)) * 8;
        float acc[4] = {};
        for (int kp = 0; kp < L.PP; kp += 16) {
          uint32_t a[4], b[2];
          ldsm_x4(a, mm::rows8_p1(gs, L.LDG, h * L.PP + kp, lane, zero));
          ldsm_x2(b, mm::n8_k16(Vs, L.LDV, h * L.R + r0, kp, lane));
          mma(acc, a, b[0], b[1]);
        }
        *reinterpret_cast<float2*>(dq_s + g * L.CP + h * L.R + r0 + 2 * t) =
            make_float2(acc[0], acc[1]);
      }
      // ---- its s = (sum_f z) U for this warp's row ----
      float sacc[SC] = {};
      for (int d = 0; d < L.D; ++d) {
        const float zd = __shfl_sync(0xffffffffu, (d & 1) ? zs[1] : zs[0], d >> 1);
#pragma unroll
        for (int cc = 0; cc < SC; ++cc) {
          const int c = lane + 32 * cc;
          if (c < L.CP) sacc[cc] = fmaf(zd, __bfloat162float(Us[d * L.LDU + c]), sacc[cc]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < SC; ++cc)
        if (lane + 32 * cc < L.CP) sw[lane + 32 * cc] = sacc[cc];
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) sq[n][0] = sq[n][1] = 0.f;
      __syncthreads();  // dquad written; g free
      if (p < n_groups) load_g(blockIdx.x + p * gridDim.x);
      tossctr::ptx::cp_async_commit();
    }

    if (p < n_groups) {  // ---- sweep 1 of group p: sum z over f ----
      if (i == 0) zs[0] = zs[1] = 0.f;
      if (2 * lane < L.DP) {
        const bf16* z1 = zt + tile_elems;
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
          const float2 v = tossctr::ffn_mma::pair_at(z1, L.LDZ, r, 2 * lane);
          zs[0] = __fadd_rn(zs[0], v.x);
          zs[1] = __fadd_rn(zs[1], v.y);
        }
      }
    }
    if (p == 0) continue;

    // ---- sweep 2 of group p - 1: A recomputed, dA = 2 dquad (s - A), dz
    // += dA U^T; dA staged.  Each k16 step's fragments are loaded together
    // ahead of its mma ----
    uint32_t za[DT][4];
#pragma unroll
    for (int kd = 0; kd < DT; ++kd)
      if (EXACT || kd < dt) ldsm_x4(za[kd], tile_p1(zt, L.LDZ, 0, kd * 16, lane));
    float accA[48];  // A = z U of the warpgroup's 64 rows (wgmma at the flagship)
    if constexpr (kDuWgmma || kAWgmma) {  // the tile again, canonical: [r] rows 8 (r & 1) + g
#pragma unroll
      for (int kd = 0; kd < DT; ++kd)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<uint32_t*>(
              zcs + mm::canon_z(w, 8 * (r & 1) + g, kd * 16 + 8 * (r >> 1) + 2 * t, L.DP)) =
              za[kd][r];
    }
    if constexpr (kAWgmma) {
      mm::fence_proxy_async();
      mm::warpgroup_sync(w >> 2);  // the warpgroup's 4 tiles written
      mm::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DT; ++kd)
        mm::wgmma_m64n96k16_st(accA,
                               mm::gmma_desc(zcs + mm::canon_z(w & ~3, 0, kd * 16, L.DP),
                                             1024, 128),
                               mm::gmma_desc(ucs + mm::canon_u(kd * 16, 0, L.DP), 128,
                                             (L.DP / 8) * 128),
                               kd > 0);
      mm::wgmma_commit();
      mm::wgmma_wait_all();
    }
    const bool v0 = i * 16 + g < L.F, v1 = i * 16 + g + 8 < L.F;
    bf16* hw = his + w * 16 * L.CP;
    bf16* lw = los + w * 16 * L.CP;
    float dzacc[2 * DT][4] = {};
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      if (!EXACT && jp >= np) break;
      uint32_t ub[DT][4], ut[DT][4];  // U as [k = d][n = c], as [n = d][k = c]
#pragma unroll
      for (int kd = 0; kd < DT; ++kd)
        if (EXACT || kd < dt) {
          if constexpr (!kAWgmma) ldsm_x4_t(ub[kd], tile_p1(Us, L.LDU, kd * 16, jp * 16, lane));
          if constexpr (!kDzWgmma) ldsm_x4(ut[kd], tile_p2(Us, L.LDU, kd * 16, jp * 16, lane));
        }
      float a[2][4] = {};
      if constexpr (kAWgmma) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x) a[e][x] = accA[(2 * jp + e) * 4 + x];
      } else {
#pragma unroll
        for (int kd = 0; kd < DT; ++kd)
          if (EXACT || kd < dt) {
            mma(a[0], za[kd], ub[kd][0], ub[kd][1]);
            mma(a[1], za[kd], ub[kd][2], ub[kd][3]);
          }
      }
      uint32_t hi[4], lo[4];  // the A fragment of k16 step jp: [2e] row g, [2e + 1] row g + 8
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = jp * 16 + e * 8 + 2 * t;
        const float2 sv = *reinterpret_cast<const float2*>(sw + c);
        const float2 qv = *reinterpret_cast<const float2*>(qw + c);
        const float s2[2] = {sv.x, sv.y}, q2[2] = {__fmul_rn(2.f, qv.x), __fmul_rn(2.f, qv.y)};
        float d[2][2];  // [row half][column]
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float& acc = sq[2 * jp + e][jj];
          acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(a[e][jj], a[e][jj])),
                          __fmul_rn(a[e][2 + jj], a[e][2 + jj]));
          d[0][jj] = v0 ? __fmul_rn(q2[jj], __fsub_rn(s2[jj], a[e][jj])) : 0.f;
          d[1][jj] = v1 ? __fmul_rn(q2[jj], __fsub_rn(s2[jj], a[e][2 + jj])) : 0.f;
        }
        split_bf16(d[0][0], d[0][1], &hi[2 * e], &lo[2 * e]);
        split_bf16(d[1][0], d[1][1], &hi[2 * e + 1], &lo[2 * e + 1]);
      }
      if constexpr (kDzWgmma) {  // the warpgroup's 64 rows: dz += hi U^T + lo U^T
        const uint64_t b = mm::gmma_desc(ucs + mm::canon_u(0, jp * 16, L.DP),
                                         (L.DP / 8) * 128, 128);
        mm::wgmma_fence();
        mm::wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(&dzacc[0][0]), hi, b);
        mm::wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(&dzacc[0][0]), lo, b);
        mm::wgmma_commit();
      } else {
#pragma unroll
        for (int nd = 0; nd < DT; ++nd)
          if (EXACT || nd < dt) {
            mma(dzacc[2 * nd], hi, ut[nd][0], ut[nd][1]);
            mma(dzacc[2 * nd + 1], hi, ut[nd][2], ut[nd][3]);
            mma(dzacc[2 * nd], lo, ut[nd][0], ut[nd][1]);
            mma(dzacc[2 * nd + 1], lo, ut[nd][2], ut[nd][3]);
          }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int o = mm::canon(g + 8 * hr, jp * 16 + e * 8 + 2 * t);
          *reinterpret_cast<uint32_t*>(hw + o) = hi[2 * e + hr];
          *reinterpret_cast<uint32_t*>(lw + o) = lo[2 * e + hr];
        }
    }
    if constexpr (kDzWgmma) mm::wgmma_wait_all();
    if (row < L.B) {
      bf16* out = dz + (size_t)row * L.F * L.D;
#pragma unroll
      for (int nd = 0; nd < 2 * DT; ++nd) {
        const int d = nd * 8 + 2 * t;
        if (d >= L.D) continue;  // D % 8 == 0: the whole n-tile is past D
        if (v0)
          *reinterpret_cast<uint32_t*>(out + (size_t)(i * 16 + g) * L.D + d) =
              pack_bf16(dzacc[nd][0], dzacc[nd][1]);
        if (v1)
          *reinterpret_cast<uint32_t*>(out + (size_t)(i * 16 + g + 8) * L.D + d) =
              pack_bf16(dzacc[nd][2], dzacc[nd][3]);
      }
    }
    mm::fence_proxy_async();  // the staged tiles, to wgmma
    __syncthreads();          // every warp's dA halves staged

    // ---- dU += z^T hi + z^T lo over the 8 warps' 16 rows, in warp order:
    // the step's 256 products an entry summed in fresh accumulators, then
    // added to dU in fp32 (a chain of ~70,000 products into one
    // accumulator would carry the tensor core's truncated sums) ----
    float step[KU][2][4] = {};
    if constexpr (kDuWgmma) {
      // the flagship: a warpgroup's (64 d, 48 c) half of dU, wgmma from the
      // canonical tiles (z^T and dA both M- or N-major)
      float(&acc)[24] = *reinterpret_cast<float(*)[24]>(&step[0][0][0]);
      const int cw = (w >> 2) * 48;  // the warpgroup's first column
      mm::wgmma_fence();
#pragma unroll
      for (int ws = 0; ws < kWarps; ++ws) {
        const uint64_t a = mm::gmma_desc(zcs + mm::canon_z(ws, 0, 0, L.DP), 128, 1024);
        const int o = ws * 16 * L.CP + mm::canon(0, cw);
        mm::wgmma_m64n48k16_tt(acc, a, mm::gmma_desc(his + o, 128, 256), 1);
        mm::wgmma_m64n48k16_tt(acc, a, mm::gmma_desc(los + o, 128, 256), 1);
      }
      mm::wgmma_commit();
      mm::wgmma_wait_all();
    } else {
      // any other shape: each warp its units, mma.sync; a warp's fragments
      // for one source warp loaded together ahead of its mma
      for (int ws = 0; ws < kWarps; ++ws) {
        const bf16* zw = ring + (q % S) * 2 * tile_elems + ws * 16 * L.LDZ;
        const bf16* hs = his + ws * 16 * L.CP;
        const bf16* ls = los + ws * 16 * L.CP;
        const int hr = lane & 15, hcol = (lane >> 4) * 8;  // tile_p1's row and column
        uint32_t zT[KU][4], bh[KU][4], bl[KU][4];
#pragma unroll
        for (int k = 0; k < KU; ++k) {
          if (zc[k] < 0) break;
          if (k > 0 && zc[k] == zc[k - 1]) {
#pragma unroll
            for (int x = 0; x < 4; ++x) zT[k][x] = zT[k - 1][x];
          } else {  // z^T: the A fragment of d rows zc.. over the 16 f
            ldsm_x4_t(zT[k], tile_p2(zw, L.LDZ, 0, zc[k], lane));
          }
          ldsm_x4_t(bh[k], hs + mm::canon(hr, hc[k] + hcol));  // dA as [k = f][n = c]
          ldsm_x4_t(bl[k], ls + mm::canon(hr, hc[k] + hcol));
        }
#pragma unroll
        for (int k = 0; k < KU; ++k) {
          if (zc[k] < 0) break;
          mma(step[k][0], zT[k], bh[k][0], bh[k][1]);
          mma(step[k][1], zT[k], bh[k][2], bh[k][3]);
          mma(step[k][0], zT[k], bl[k][0], bl[k][1]);
          mma(step[k][1], zT[k], bl[k][2], bl[k][3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KU; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) du[k][e][x] = __fadd_rn(du[k][e][x], step[k][e][x]);

    if (i == L.MT - 1 && row < L.B) {  // ---- quad = s^2 - sum_f A^2, unrounded ----
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
        if (!EXACT && n >= 2 * np) break;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float sqv = tossctr::ffn_mma::column_sum(sq[n][jj]);
          const int c = n * 8 + 2 * t + jj;
          if (g == 0 && c < L.C)
            quad_out[(size_t)row * L.C + c] = __fsub_rn(__fmul_rn(sw[c], sw[c]), sqv);
        }
      }
    }
  }

  // ---- this block's partial dU, laid out as (H, D, R).  The wgmma
  // accumulator: n8 tile j = 2k + e of the warpgroup's 48 columns, rows 16
  // (w % 4) + g (+ 8); mma.sync's units: (16 d, 16 c) at zc, hc ----
  float* part = partials + (size_t)blockIdx.x * L.H * L.D * L.R;
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    if (!kDuWgmma && zc[k] < 0) break;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d0 = kDuWgmma ? 16 * (w & 3) : zc[k];
        const int c0 = kDuWgmma ? (w >> 2) * 48 + 16 * k : hc[k];
        const int d = d0 + g + 8 * (x >> 1), c = c0 + 8 * e + 2 * t + (x & 1);
        if (d < L.D && c < L.C)
          part[((size_t)(c / L.R) * L.D + d) * L.R + c % L.R] = du[k][e][x];
      }
  }
}

// the dV pass and the two reductions, after either main kernel
template <typename T>
int finish(const void* g, float* quad, float* part_u, float* part_v, float* grads, int blocks,
           int chunks, const Dims& L, cudaStream_t s) {
  const int n_u = L.H * L.D * L.R, n_v = L.H * L.R * L.P;
  const int rows_per_chunk = (L.B + chunks - 1) / chunks;
  const int n_dv = L.H * ((L.R + kDvRows - 1) / kDvRows) * L.P;  // fm_dv_kernel's threads
  fm_dv_kernel<T><<<dim3((n_dv + 255) / 256, chunks), 256, 0, s>>>(
      quad, static_cast<const T*>(g), part_v, rows_per_chunk, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = tossctr::launch_reduce(part_u, blocks, n_u, grads, s);
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(part_v, chunks, n_v, grads + n_u, s);
}

template <typename T>
int launch(const void* z, const void* U, const void* V, const void* g, void* dz, float* quad,
           float* part_u, float* part_v, float* grads, int blocks, int chunks, const Dims& L,
           int device, void* stream) {
  const size_t smem = (size_t)Layout(L).total * sizeof(float);
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e =
      tossctr::prepare_launch(fm_bwd_kernel<T>, kThreads, smem, blocks, device, 0, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fm_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<const T*>(g), static_cast<T*>(dz), quad, part_u, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return finish<T>(g, quad, part_u, part_v, grads, blocks, chunks, L, s);
}

int launch_mma(const void* z, const void* U, const void* V, const void* g, void* dz,
               float* quad, float* part_u, float* part_v, float* grads, int blocks, int chunks,
               const mm::Dims& M, const Dims& L, int device, void* stream) {
  const size_t smem = (size_t)mm::BwdLayout(M).total;
  if (smem > tossctr::smem_optin(device)) return (int)cudaErrorInvalidValue;
  // the flagship's shape with its loop counts fixed, every other one with bounds
  auto kern = mm::flagship(M) ? fm_bwd_mma_kernel<6, 4, true>
                              : fm_bwd_mma_kernel<mm::kMaxNT / 2, mm::kMaxDT, false>;
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e = tossctr::prepare_launch(kern, mm::kThreads, smem, blocks, device, 0, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<blocks, mm::kThreads, smem, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(U), static_cast<const bf16*>(V),
      static_cast<const bf16*>(g), static_cast<bf16*>(dz), quad, part_u, M);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return finish<__nv_bfloat16>(g, quad, part_u, part_v, grads, blocks, chunks, L, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, U, V, g and dz share it).
// blocks: the grid, one block an SM (each walks batch rows, or groups of 8
// rows, with a stride of the grid; a block with none writes zeros).
// chunks: the row chunks of the dV sums, 1 <= chunks <= B.  mma: run the
// tensor-core kernel (bf16 only, the shapes fm_mma.cuh Dims::ok takes).
// Scratch, fp32: quad (B, H*R), part_u (blocks, H*D*R), part_v (chunks,
// H*R*P); grads (H*D*R + H*R*P) fp32 out = [dU (H, D, R) | dV (H, R, P)].
// D <= 64, H*R <= 128.  Returns a cudaError_t code.
extern "C" int tossctr_fm_cross_bwd(const void* z, const void* U, const void* V, const void* g,
                                    void* dz, void* quad, void* part_u, void* part_v,
                                    void* grads, int blocks, int chunks, int B, int F, int D,
                                    int H, int R, int P, int mma, int dtype, int device,
                                    void* stream) {
  const Dims L(B, F, D, H, R, P);
  if (!L.ok() || blocks < 1 || chunks < 1 || chunks > B) return (int)cudaErrorInvalidValue;
  float* q = static_cast<float*>(quad);
  float* pu = static_cast<float*>(part_u);
  float* pv = static_cast<float*>(part_v);
  float* gr = static_cast<float*>(grads);
  if (mma) {
    const mm::Dims M(B, F, D, H, R, P);
    if (dtype != 1 || !M.ok()) return (int)cudaErrorInvalidValue;
    return launch_mma(z, U, V, g, dz, q, pu, pv, gr, blocks, chunks, M, L, device, stream);
  }
  if (dtype == 0)
    return launch<float>(z, U, V, g, dz, q, pu, pv, gr, blocks, chunks, L, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(z, U, V, g, dz, q, pu, pv, gr, blocks, chunks, L, device,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
