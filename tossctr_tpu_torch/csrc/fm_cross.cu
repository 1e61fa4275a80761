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
// Design: the plain path materialises A (B, H, F, R) in device memory; here
// A never leaves the block.  A block holds U (all heads, fp32) in shared
// memory and walks batch rows: it stages z[b] in shared memory, forms A
// with 4x4 register tiles, and keeps only each thread's column sums of A
// and A^2, added over thread groups in a fixed order; quad (H*R values)
// then meets V, read through the cache.  Device memory sees z once and
// out once.  Products run on the CUDA cores in fp32; the tensor cores are
// the next step for speed.
#include "fm_cross.cuh"

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
int launch(const void* z, const void* U, const void* V, void* out, const Dims& L, int device,
           void* stream) {
  const size_t smem = (size_t)Layout(L).total * sizeof(float);
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(fm_fwd_kernel<T>, kThreads, smem, L.B, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  fm_fwd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<T*>(out), L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, U, V and out share it).  out is
// (B, H*P), head-major within a row.  D <= 64, H*R <= 128.  Returns a
// cudaError_t code.
extern "C" int tossctr_fm_cross_fwd(const void* z, const void* U, const void* V, void* out,
                                    int B, int F, int D, int H, int R, int P, int dtype,
                                    int device, void* stream) {
  const Dims L(B, F, D, H, R, P);
  if (!L.ok()) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(z, U, V, out, L, device, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(z, U, V, out, L, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
