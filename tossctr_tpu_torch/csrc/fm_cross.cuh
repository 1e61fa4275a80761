// Shared pieces of the QNN-alpha FM-cross kernels (fm_cross.cu,
// fm_cross_bwd.cu): the shared-memory shapes of one batch row and the
// A = z U_h product with its column sums.
//
// Shapes: z (B, F, D), U (H, D, R), V (H, R, P); the H heads' R columns
// are taken together as C = H*R columns c = h*R + r.  One block works on
// one batch row at a time: z[b] lives in shared memory as fp32 (F4, DS)
// with zero padding to F4 = align4(F) rows and D4 = align4(D) columns,
// and U as fp32 (D4, C4) with zero padding, so A's padded rows and
// columns are 0 and add nothing to the sums.
#pragma once

#include "common.cuh"

namespace tossctr {
namespace fm {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;   // the width of a QNN token
constexpr int kMaxC = 128;  // H * R

struct Dims {
  int B, F, D, H, R, P;
  int C, C4, F4, D4;
  int DS;      // row stride of z in shared memory
  int CS;      // row stride of A in shared memory
  int n_ct;    // 4-column tiles of A
  int groups;  // thread groups over A's 4-row tiles, each group covering every column tile
  __host__ __device__ Dims(int B_, int F_, int D_, int H_, int R_, int P_)
      : B(B_), F(F_), D(D_), H(H_), R(R_), P(P_) {
    C = H * R;
    C4 = align4(C);
    F4 = align4(F);
    D4 = align4(D);
    DS = D4 + 4;
    CS = C4 + 4;
    n_ct = C4 / 4;
    groups = kThreads / n_ct;
  }
  __host__ bool ok() const {
    return B >= 1 && F >= 1 && D >= 1 && D <= kMaxD && H >= 1 && R >= 1 && C <= kMaxC && P >= 1;
  }
};

// z[b] -> Z (F4, DS) fp32, zero-padded
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ z, size_t row, const Dims& L,
                                         float* Z) {
  const T* zr = z + row * (size_t)L.F * L.D;
  for (int i = threadIdx.x; i < L.F4 * L.D4; i += kThreads) {
    const int f = i / L.D4, d = i - f * L.D4;
    Z[f * L.DS + d] = (f < L.F && d < L.D) ? to_f<T>(zr[f * L.D + d]) : 0.f;
  }
}

// U (H, D, R) -> UD (D4, C4) fp32 [d][h*R + r]; with UC != nullptr also
// UC (C4, DS) [h*R + r][d]; zero-padded
template <typename T>
__device__ __forceinline__ void load_u(const T* __restrict__ U, const Dims& L, float* UD,
                                       float* UC) {
  for (int i = threadIdx.x; i < L.D4 * L.C4; i += kThreads) {
    const int d = i / L.C4, c = i - d * L.C4;
    float u = 0.f;
    if (d < L.D && c < L.C) u = to_f<T>(U[(size_t)(c / L.R) * L.D * L.R + d * L.R + c % L.R]);
    UD[i] = u;
    if (UC != nullptr) UC[c * L.DS + d] = u;
  }
  if (UC != nullptr)
    for (int i = threadIdx.x; i < L.C4 * (L.DS - L.D4); i += kThreads) {
      const int c = i / (L.DS - L.D4);
      UC[c * L.DS + L.D4 + i % (L.DS - L.D4)] = 0.f;
    }
}

// A = Z UD in fp32 over 4x4 register tiles.  Thread t takes column tile
// t % n_ct and the row tiles t / n_ct, + groups, ...; it sums its tiles'
// A and A*A per column into ps, psq (groups, C4), and with A_out !=
// nullptr stores A there as (F4, CS).  The caller adds the groups' sums
// in group order after a __syncthreads().
__device__ __forceinline__ void a_tiles(const float* Z, const float* UD, const Dims& L,
                                        float* ps, float* psq, float* A_out) {
  const int t = threadIdx.x;
  const int grp = t / L.n_ct, c0 = (t - grp * L.n_ct) * 4;
  if (grp >= L.groups) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  for (int f0 = grp * 4; f0 < L.F4; f0 += L.groups * 4) {
    float acc[4][4] = {};
    for (int d = 0; d < L.D4; ++d) {
      float u[4], zv[4];
      load4(UD + d * L.C4 + c0, u);
#pragma unroll
      for (int i = 0; i < 4; ++i) zv[i] = Z[(f0 + i) * L.DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(zv[i], u[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = __fadd_rn(s[j], acc[i][j]);
        q[j] = __fadd_rn(q[j], __fmul_rn(acc[i][j], acc[i][j]));
      }
    if (A_out != nullptr)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(A_out + (f0 + i) * L.CS + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ps[grp * L.C4 + c0 + j] = s[j];
    psq[grp * L.C4 + c0 + j] = q[j];
  }
}

// column c's sums of A and A*A from a_tiles' group partials, in group order
__device__ __forceinline__ void column_sums(const float* ps, const float* psq, const Dims& L,
                                            int c, float* s, float* sq) {
  float a = 0.f, b = 0.f;
  for (int g = 0; g < L.groups; ++g) {
    a = __fadd_rn(a, ps[g * L.C4 + c]);
    b = __fadd_rn(b, psq[g * L.C4 + c]);
  }
  *s = a;
  *sq = b;
}

}  // namespace fm
}  // namespace tossctr
