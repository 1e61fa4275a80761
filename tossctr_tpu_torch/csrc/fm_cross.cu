// fm_cross forward: the QNN-alpha multi-head low-rank FM cross, for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_kernels.py fm_cross_pallas, forward
// pallas_call in _fm_fwd_call (kernel _fm_fwd_kernel).
//
// What it computes, per batch row b and head h (z (B, F, D), U (H, D, R),
// V (H, R, P), all of one storage type T), with the Pallas kernel's
// rounding points:
//   A      = z[b] @ U_h                       (F, R), fp32 sums of T values
//   quad   = (sum_f A)^2 - sum_f A^2          (R,)  fp32
//   out_h  = round_T(quad) @ V_h              (P,)  fp32 sums
//   out[b, h*P:(h+1)*P] = round_T(out_h)
//
// What bounds it on the card: at the flagship shapes (B=8192, F=200,
// D=64, H=6, R=16, P=192, bf16) one call reads z (210 MB) and writes out
// (19 MB), ~68 us at 3.35 TB/s, against ~20 GFLOP (~21 us on the bf16
// tensor cores): it is bound by the bytes.
//
// Two kernels.  The plain path materialises A (B, H, F, R) in device
// memory; in both, A never leaves the block.
//
// fm_fwd_mma_kernel (bf16, the shapes fm_mma.cuh Dims::ok takes; the
// wrapper routes by ops/fm_cross.py fm_mma_kernel; built with its loop
// counts fixed for the flagship's shape, with bounds for every other):
// persistent blocks of 8 warps, two an SM (109 KB of shared memory each
// at the flagship; 128 registers a thread), walk groups of 8 batch rows,
// one a warp, m-tile by m-tile through a 3-stage cp.async ring (2 stages,
// 37 KB a block, in flight while one is used), with U and V resident in
// shared memory.  A warp forms its row's A = z U on the tensor cores (mma.sync m16n8k16,
// bf16 operands, fp32 sums: bf16 products are exact, so only the order of
// the sums is not the Pallas kernel's) and adds A and A*A into per-lane
// column sums; at the group's end the eight row lanes of each column add
// in a fixed shuffle order, quad is rounded to bf16 into a shared (8, C)
// tile, and the block forms out_h = quad_h V_h on the tensor cores, one
// (8 rows, 16 columns) unit a warp at a time, rounded to bf16 once.
//
// fm_fwd_kernel (fp32, and bf16 at the shapes the tensor-core kernel does
// not take): a block holds U (all heads, fp32) in shared memory and walks
// batch rows: it stages z[b] in shared memory, forms A with 4x4 register
// tiles on the CUDA cores, and keeps only each thread's column sums of A
// and A^2, added over thread groups in a fixed order; quad (H*R values)
// then meets V, read through the cache.
#include "fm_cross.cuh"
#include "fm_mma.cuh"

namespace {

using tossctr::from_f;
using tossctr::round_t;
using tossctr::to_f;
using tossctr::fm::Dims;
using tossctr::fm::kThreads;

struct Layout {
  int Z, UD, ps, psq, quad, total;  // offsets in floats
  __host__ __device__ explicit Layout(const Dims& L) {
    Z = 0;
    UD = Z + L.F4 * L.DS;
    ps = UD + L.D4 * L.C4;
    psq = ps + L.groups * L.C4;
    quad = psq + L.groups * L.C4;
    total = quad + L.C4;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_fwd_kernel(const T* __restrict__ z, const T* __restrict__ U, const T* __restrict__ V,
              T* __restrict__ out, Dims L) {
  extern __shared__ __align__(16) float smem[];
  const Layout S(L);
  float* Z = smem + S.Z;
  float* UD = smem + S.UD;
  float* ps = smem + S.ps;
  float* psq = smem + S.psq;
  float* quad = smem + S.quad;
  const int tid = threadIdx.x;
  const int HP = L.H * L.P;

  tossctr::fm::load_u<T>(U, L, UD, nullptr);
  for (int row = blockIdx.x; row < L.B; row += gridDim.x) {
    __syncthreads();  // the previous row is done with Z and quad
    tossctr::fm::load_row<T>(z, row, L, Z);
    __syncthreads();
    tossctr::fm::a_tiles(Z, UD, L, ps, psq, nullptr);
    __syncthreads();
    for (int c = tid; c < L.C; c += kThreads) {
      float s, sq;
      tossctr::fm::column_sums(ps, psq, L, c, &s, &sq);
      quad[c] = round_t<T>(__fsub_rn(__fmul_rn(s, s), sq));
    }
    __syncthreads();
    for (int o = tid; o < HP; o += kThreads) {
      const int h = o / L.P, p = o - h * L.P;
      const float* q = quad + h * L.R;
      const T* v = V + (size_t)h * L.R * L.P + p;
      float acc = 0.f;
      for (int r = 0; r < L.R; ++r) acc = fmaf(q[r], to_f<T>(v[(size_t)r * L.P]), acc);
      out[(size_t)row * HP + o] = from_f<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* z, const void* U, const void* V, void* out, const Dims& L, int blocks,
           int device, void* stream) {
  const size_t smem = (size_t)Layout(L).total * sizeof(float);
  int grid = 0;
  const int want = blocks > 0 && blocks < L.B ? blocks : L.B;
  cudaError_t e = tossctr::prepare_launch(fm_fwd_kernel<T>, kThreads, smem, want, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  fm_fwd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<T*>(out), L);
  return (int)cudaGetLastError();
}

// ---- the tensor-core kernel ----

namespace mm = tossctr::fm_mma;
using mm::bf16;
using mm::kRows;
using mm::kWarps;
using tossctr::ptx::ldsm_x2;
using tossctr::ptx::ldsm_x2_t;
using tossctr::ptx::ldsm_x4;
using tossctr::ptx::ldsm_x4_t;
using tossctr::ptx::mma;
using tossctr::ptx::mma_k8;
using tossctr::ptx::pack_bf16;
using tossctr::ptx::tile_p1;

// NP k16 steps over the padded columns (CP = 16 NP) and DT over D (DP =
// 16 DT); EXACT: the shape has them all, else they are bounds and the
// loops stop at the shape's (mm::Dims)
template <int NP, int DT, bool EXACT>
__global__ void __launch_bounds__(mm::kThreads, 2)
fm_fwd_mma_kernel(const bf16* __restrict__ z, const bf16* __restrict__ U,
                  const bf16* __restrict__ V, bf16* __restrict__ out, mm::Dims L) {
  constexpr int S = mm::kFwdStages;
  extern __shared__ __align__(16) float smem_f[];  // one declaration a source
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const mm::FwdLayout M(L);
  bf16* Us = reinterpret_cast<bf16*>(smem + M.U);
  bf16* Vs = reinterpret_cast<bf16*>(smem + M.V);
  bf16* ring = reinterpret_cast<bf16*>(smem + M.ring);
  bf16* qt = reinterpret_cast<bf16*>(smem + M.quad);
  const bf16* zero = reinterpret_cast<const bf16*>(smem + M.zero);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int stage_elems = kWarps * 16 * L.LDZ;
  const int HP = L.H * L.P;
  const int np = EXACT ? NP : L.NT / 2, dt = EXACT ? DT : L.DT;

  mm::load_weights(U, V, L, Us, Vs);
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem + M.zero)[threadIdx.x] = 0u;
  // this block's groups: blockIdx.x, + gridDim.x, ...; MT steps each
  const int n_groups =
      blockIdx.x < L.groups ? (L.groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = n_groups * L.MT;
  for (int q = 0; q < S - 1; ++q) {
    if (q < steps)
      mm::load_stage(z, L, blockIdx.x + (q / L.MT) * gridDim.x, q % L.MT,
                     ring + q * stage_elems);
    tossctr::ptx::cp_async_commit();
  }

  float s[2 * NP][2], sq[2 * NP][2];  // this lane's column sums of A and A*A
  for (int q = 0; q < steps; ++q) {
    const int k = q / L.MT, i = q - k * L.MT;
    tossctr::ptx::cp_async_wait<S - 2>();
    __syncthreads();  // stage q landed for every thread; stage q - 1 is free
    {
      const int qn = q + S - 1;
      if (qn < steps)
        mm::load_stage(z, L, blockIdx.x + (qn / L.MT) * gridDim.x, qn % L.MT,
                       ring + (qn % S) * stage_elems);
      tossctr::ptx::cp_async_commit();
    }
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) s[n][0] = s[n][1] = sq[n][0] = sq[n][1] = 0.f;
    }
    // ---- A = z U for the warp's 16 rows of m-tile i, into the sums ----
    const bf16* zt = ring + (q % S) * stage_elems + w * 16 * L.LDZ;
    uint32_t za[DT][4];
#pragma unroll
    for (int kd = 0; kd < DT; ++kd)
      if (EXACT || kd < dt) ldsm_x4(za[kd], tile_p1(zt, L.LDZ, 0, kd * 16, lane));
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      if (!EXACT && jp >= np) break;
      uint32_t ub[DT][4];  // loaded together ahead of their mma
#pragma unroll
      for (int kd = 0; kd < DT; ++kd)
        if (EXACT || kd < dt) ldsm_x4_t(ub[kd], tile_p1(Us, L.LDU, kd * 16, jp * 16, lane));
      float a[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < DT; ++kd)
        if (EXACT || kd < dt) {
          mma(a[0], za[kd], ub[kd][0], ub[kd][1]);
          mma(a[1], za[kd], ub[kd][2], ub[kd][3]);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // columns 2t + j; rows g, then g + 8
          float& sv = s[2 * jp + e][j];
          float& qv = sq[2 * jp + e][j];
          sv = __fadd_rn(__fadd_rn(sv, a[e][j]), a[e][2 + j]);
          qv = __fadd_rn(__fadd_rn(qv, __fmul_rn(a[e][j], a[e][j])),
                         __fmul_rn(a[e][2 + j], a[e][2 + j]));
        }
    }
    if (i != L.MT - 1) continue;

    // ---- the group's end: quad = s^2 - sum A^2, rounded to bf16 ----
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
      if (!EXACT && n >= 2 * np) break;
      float qd[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sv = tossctr::ffn_mma::column_sum(s[n][j]);
        qd[j] = __fsub_rn(__fmul_rn(sv, sv), tossctr::ffn_mma::column_sum(sq[n][j]));
      }
      if (g == 0)
        *reinterpret_cast<uint32_t*>(qt + w * L.LDA + n * 8 + 2 * t) = pack_bf16(qd[0], qd[1]);
    }
    __syncthreads();
    // ---- out_h = quad_h V_h: (8 rows, 16 columns of P) units ----
    const int G = blockIdx.x + k * gridDim.x;
    const int row = G * kRows + g;
    const int PT = L.PP / 16;
    for (int u = w; u < L.H * PT; u += kWarps) {
      const int h = u / PT, pn = u - h * PT;
      float acc[2][4] = {};
      int kr = 0;
      for (; kr + 16 <= L.R; kr += 16) {
        uint32_t a[4], b[4];
        ldsm_x4(a, mm::rows8_p1(qt, L.LDA, h * L.R + kr, lane, zero));
        ldsm_x4_t(b, tile_p1(Vs, L.LDV, h * L.R + kr, pn * 16, lane));
        mma(acc[0], a, b[0], b[1]);
        mma(acc[1], a, b[2], b[3]);
      }
      if (kr < L.R) {  // R % 16 == 8: one k8 step
        uint32_t a[2], b[2];
        ldsm_x2(a, mm::rows8_x2(qt, L.LDA, h * L.R + kr, lane, zero));
        ldsm_x2_t(b, mm::k8_pair(Vs, L.LDV, h * L.R + kr, pn * 16, lane));
        mma_k8(acc[0], a, b[0]);
        mma_k8(acc[1], a, b[1]);
      }
      if (row < L.B)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = pn * 16 + e * 8 + 2 * t;  // P % 4 == 0: p < P means p + 1 < P
          if (p < L.P)
            *reinterpret_cast<uint32_t*>(out + (size_t)row * HP + h * L.P + p) =
                pack_bf16(acc[e][0], acc[e][1]);
        }
    }
  }
}

int launch_mma(const void* z, const void* U, const void* V, void* out, const mm::Dims& L,
               int blocks, int device, void* stream) {
  const size_t smem = (size_t)mm::FwdLayout(L).total;
  if (smem > tossctr::smem_optin(device)) return (int)cudaErrorInvalidValue;
  // the flagship's shape with its loop counts fixed, every other one with bounds
  auto kern = mm::flagship(L) ? fm_fwd_mma_kernel<6, 4, true>
                              : fm_fwd_mma_kernel<mm::kMaxNT / 2, mm::kMaxDT, false>;
  int grid = 0;
  const int want = blocks > 0 && blocks < L.groups ? blocks : L.groups;
  cudaError_t e = tossctr::prepare_launch(kern, mm::kThreads, smem, want, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, mm::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(U), static_cast<const bf16*>(V),
      static_cast<bf16*>(out), L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, U, V and out share it).  out is
// (B, H*P), head-major within a row.  D <= 64, H*R <= 128.  blocks: at
// most this many blocks (0: as many as fit on the SMs); the output does
// not depend on it.  mma: run the tensor-core kernel (bf16 only, the
// shapes fm_mma.cuh Dims::ok takes).  Returns a cudaError_t code.
extern "C" int tossctr_fm_cross_fwd(const void* z, const void* U, const void* V, void* out,
                                    int B, int F, int D, int H, int R, int P, int blocks, int mma,
                                    int dtype, int device, void* stream) {
  if (mma) {
    const mm::Dims L(B, F, D, H, R, P);
    if (dtype != 1 || !L.ok()) return (int)cudaErrorInvalidValue;
    return launch_mma(z, U, V, out, L, blocks, device, stream);
  }
  const Dims L(B, F, D, H, R, P);
  if (!L.ok()) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(z, U, V, out, L, blocks, device, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(z, U, V, out, L, blocks, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
