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
// Design: one persistent block an SM (the grid comes from the caller,
// sized from the SM count) walks batch rows.  A is recomputed from z, not
// kept from the forward: the forward never writes it, and storing it
// would cost the (B, H, F, R) fp32 tensor in device memory that the
// kernel pair exists to avoid.  A row's z, A (then dA, in place) and g
// stay in shared memory (198 KB a block at the flagship shapes) with U in
// two layouts, so device memory sees z, g and dz once.  dz comes out of
// 4x4 register tiles per row; each thread keeps its 4x4 tiles of dU in
// registers across the rows, and at the end every block writes its fp32
// partial dU to a scratch buffer that a second kernel (common.cuh
// reduce_partials) adds in block order.  dV needs only quad and g: the
// block writes each row's quad (H*R fp32) to a scratch buffer, and a third
// kernel sums quad^T g over fixed chunks of rows, the chunks again added
// in order.  No atomics, so the bits repeat from run to run.  Products run
// on the CUDA cores in fp32; the tensor cores are the next step for speed.
#include "fm_cross.cuh"

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
// order, of quad[b, h*R + r] * g[b, h*P + p]
template <typename T>
__global__ void fm_dv_kernel(const float* __restrict__ quad, const T* __restrict__ g,
                             float* __restrict__ part, int rows_per_chunk, Dims L) {
  const int n = L.H * L.R * L.P;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int c = o / L.P, p = o - c * L.P;  // c = h*R + r
  const int h = c / L.R;
  const int b0 = blockIdx.y * rows_per_chunk;
  const int b1 = min(L.B, b0 + rows_per_chunk);
  const size_t HP = (size_t)L.H * L.P;
  float acc = 0.f;
  for (int b = b0; b < b1; ++b)
    acc = fmaf(quad[(size_t)b * L.C + c], to_f<T>(g[b * HP + h * L.P + p]), acc);
  part[(size_t)blockIdx.y * n + o] = acc;
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
  const int n_u = L.H * L.D * L.R, n_v = L.H * L.R * L.P;
  const int rows_per_chunk = (L.B + chunks - 1) / chunks;
  fm_dv_kernel<T><<<dim3((n_v + 255) / 256, chunks), 256, 0, s>>>(
      quad, static_cast<const T*>(g), part_v, rows_per_chunk, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = tossctr::launch_reduce(part_u, blocks, n_u, grads, s);
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(part_v, chunks, n_v, grads + n_u, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, U, V, g and dz share it).
// blocks: the grid, one block an SM (each walks batch rows with a stride of
// the grid; a block with none writes zeros).  chunks: the row chunks of
// the dV sums, 1 <= chunks <= B.  Scratch, fp32: quad (B, H*R),
// part_u (blocks, H*D*R), part_v (chunks, H*R*P); grads (H*D*R + H*R*P)
// fp32 out = [dU (H, D, R) | dV (H, R, P)].  D <= 64, H*R <= 128.
// Returns a cudaError_t code.
extern "C" int tossctr_fm_cross_bwd(const void* z, const void* U, const void* V, const void* g,
                                    void* dz, void* quad, void* part_u, void* part_v,
                                    void* grads, int blocks, int chunks, int B, int F, int D,
                                    int H, int R, int P, int dtype, int device, void* stream) {
  const Dims L(B, F, D, H, R, P);
  if (!L.ok() || blocks < 1 || chunks < 1 || chunks > B) return (int)cudaErrorInvalidValue;
  float* q = static_cast<float*>(quad);
  float* pu = static_cast<float*>(part_u);
  float* pv = static_cast<float*>(part_v);
  float* gr = static_cast<float*>(grads);
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
