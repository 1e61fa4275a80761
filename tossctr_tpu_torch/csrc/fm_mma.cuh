// Tensor-core pieces of the bf16 FM-cross kernels (fm_fwd_mma_kernel in
// fm_cross.cu, fm_bwd_mma_kernel in fm_cross_bwd.cu): the shapes they
// take, their shared-memory layouts, the z ring, the fragment addressing
// of tiles with eight live rows, and the wgmma pieces of the flagship
// backward's A, dz and dU products (the canonical layouts without swizzle,
// their descriptors, fences, the three shapes).
//
// A block of kWarps warps walks groups of kRows = kWarps batch rows, one
// row a warp, in lockstep: step i of a group holds m-tile i (z rows 16i
// .. 16i + 15, all D columns) of each of the group's rows in one stage of
// a cp.async ring, so every warp runs the same products on its own row
// between two __syncthreads.  The H heads' R columns are taken together
// as C = H*R columns c = h*R + r, padded with zeros to CP (a multiple of
// 16); D is padded to DP and P to PP, multiples of 16.  Padding is zero in
// shared memory (U's and V's extra rows and columns, the ring's rows past
// F and past B, through cp.async's zero fill), so it adds nothing to any
// sum.  Helpers are called by every lane of a warp.
#pragma once

#include "ffn_mma.cuh"  // column_sum, unpack_bf16; mma_ptx.cuh

namespace tossctr {
namespace fm_mma {

using namespace tossctr::ptx;  // bf16, ldmatrix, mma, cp.async, tile addressing

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kWarps;  // batch rows of a group, one a warp
constexpr int kFwdStages = 3;  // ring stages: 2 in flight while one is used
constexpr int kBwdStages = 2;  // each two tiles: sweep 2's and sweep 1's
constexpr int kMaxNT = 16;  // n8 tiles of CP (H*R <= 128)
constexpr int kMaxDT = 4;   // k16 steps of DP (D <= 64)

struct Dims {
  int B, F, D, H, R, P, C;
  int CP, DP, PP;  // C, D and P padded to 16
  int NT, DT, MT;  // n8 tiles of CP, k16 steps of DP, m16 tiles of F
  int LDZ, LDU, LDV, LDA, LDG;  // shared row strides (elements)
  int groups;
  __host__ __device__ Dims(int B_, int F_, int D_, int H_, int R_, int P_)
      : B(B_), F(F_), D(D_), H(H_), R(R_), P(P_) {
    C = H * R;
    CP = round_up(C, 16);
    DP = round_up(D, 16);
    PP = round_up(P, 16);
    NT = CP / 8;
    DT = DP / 16;
    MT = (F + 15) / 16;
    LDZ = row_stride(DP);  // a ring tile: (16, DP)
    LDU = row_stride(CP);  // U: (DP, CP) [d][c]
    LDV = row_stride(PP);  // V: (C, PP) [c][p]
    LDA = row_stride(CP);  // the forward's quad tile: (8, CP)
    LDG = row_stride(H * PP);  // the backward's g tile: (kRows, H*PP), heads padded
    groups = (B + kRows - 1) / kRows;
  }
  // the shapes the kernels take (the wrapper routes every other shape to
  // the CUDA-core kernels): 16-byte pieces of z rows, whole n8 tiles of
  // each head's columns, 8-byte pieces of g rows
  __host__ bool ok() const {
    return B >= 1 && F >= 1 && D >= 8 && D <= 64 && D % 8 == 0 && H >= 1 && R >= 8 &&
           R % 8 == 0 && C <= 128 && P >= 4 && P % 4 == 0;
  }
};

// the flagship's QNN shape (H*R = 96, D = 64): the kernels are built for it
// with their loop counts fixed, and with bounds for every other shape
__host__ inline bool flagship(const Dims& L) { return L.NT == 12 && L.DT == 4; }

// shared-memory layouts, byte offsets (every region a multiple of 16 bytes)
struct FwdLayout {
  int U, V, ring, quad, zero, total;
  __host__ __device__ explicit FwdLayout(const Dims& L) {
    U = 0;
    V = U + 2 * L.DP * L.LDU;
    ring = V + 2 * L.C * L.LDV;
    quad = ring + 2 * kFwdStages * kWarps * 16 * L.LDZ;  // round_bf16(quad) of the group's rows
    zero = quad + 2 * kRows * L.LDA;
    total = zero + 16;
  }
};

// the backward's staged tiles (16 rows of a warp) in wgmma's canonical
// layout without swizzle: 8x8 core matrices of 128 contiguous bytes,
// column group-major, the two row groups of a column group adjacent
__host__ __device__ constexpr int canon(int row, int col) {
  return ((col >> 3) * 2 + (row >> 3)) * 64 + (row & 7) * 8 + (col & 7);
}

// z's tiles in the canonical layout, a warpgroup's 64 rows (its 4 warps'
// 16) at a time: core matrices (8 rows, 8 d), d group-major, so one
// descriptor serves a warpgroup's A = z U (K-major, the 64 rows as M)
// and one warp's z^T for dU (M-major, its 16 rows as K)
__host__ __device__ constexpr int canon_z(int w, int r, int d, int DP) {
  return (w >> 2) * 64 * DP + ((d >> 3) * 8 + 2 * (w & 3) + (r >> 3)) * 64 + (r & 7) * 8 +
         (d & 7);
}

// U in the canonical layout for wgmma as the dz product's K-major B:
// (DP, CP) [d][c], core matrices (8 d, 8 c) column group-major
__host__ __device__ constexpr int canon_u(int d, int c, int DP) {
  return ((c >> 3) * (DP >> 3) + (d >> 3)) * 64 + (d & 7) * 8 + (c & 7);
}

struct BwdLayout {
  int U, V, ring, zc, uc, hi, lo, g, s, dq, zero, total;
  __host__ __device__ explicit BwdLayout(const Dims& L) {
    U = 0;
    V = U + 2 * L.DP * L.LDU;
    ring = V + 2 * L.C * L.LDV;
    zc = round_up(ring + 2 * kBwdStages * 2 * kWarps * 16 * L.LDZ, 128);  // z, canonical
    uc = zc + 2 * kWarps * 16 * L.DP;  // U, canonical (canon_u)
    hi = uc + 2 * L.DP * L.CP;         // dA's bf16 hi half, a warp's (16, CP), canonical
    lo = hi + 2 * kWarps * 16 * L.CP;  // and its lo half
    g = lo + 2 * kWarps * 16 * L.CP;
    s = g + 2 * kRows * L.LDG;   // fp32 (kRows, CP): s of each row
    dq = s + 4 * kRows * L.CP;   // fp32 (kRows, CP): dquad of each row
    zero = dq + 4 * kRows * L.CP;
    total = zero + 16;
  }
};

// U (H, D, R) -> Us (DP, LDU) [d][h*R + r]; V (H, R, P) -> Vs (C, LDV)
// [h*R + r][p]; zeros past D, C and P
__device__ __forceinline__ void load_weights(const bf16* __restrict__ U,
                                             const bf16* __restrict__ V, const Dims& L, bf16* Us,
                                             bf16* Vs) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < L.DP * L.CP; i += kThreads) {
    const int d = i / L.CP, c = i - d * L.CP;
    const int h = c / L.R, r = c - h * L.R;
    Us[d * L.LDU + c] = d < L.D && c < L.C ? U[((size_t)h * L.D + d) * L.R + r] : zero;
  }
  for (int i = threadIdx.x; i < L.C * L.PP; i += kThreads) {
    const int c = i / L.PP, p = i - c * L.PP;
    Vs[c * L.LDV + p] = p < L.P ? V[(size_t)c * L.P + p] : zero;
  }
}

// cp.async of one ring stage: m-tile i of the kRows rows of group G,
// warp w's rows at w * 16 * LDZ; zeros past F, D and B
__device__ __forceinline__ void load_stage(const bf16* __restrict__ z, const Dims& L, int G,
                                           int i, bf16* stage) {
  const int per_row = L.DP / 8;  // 16-byte pieces of a tile row
  for (int p = threadIdx.x; p < kRows * 16 * per_row; p += kThreads) {
    const int rr = p / per_row, d0 = (p - rr * per_row) * 8;
    const int b = G * kRows + (rr >> 4), f = i * 16 + (rr & 15);
    const bool ok = b < L.B && f < L.F && d0 < L.D;
    const bf16* src = ok ? z + ((size_t)b * L.F + f) * L.D + d0 : z;
    cp_async16z(stage + rr * L.LDZ + d0, src, ok);
  }
}

// ---- wgmma (sm_90a): the backward's dU products ----

// a shared operand's descriptor: canonical layout without swizzle, lbo and
// sbo the byte strides between core matrices along K and along M or N
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// shared-memory stores of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 48 fp32, a warpgroup's) = A B (+ d if accumulate): A (64 x 16)
// and B (16 x 48) bf16 in shared memory, both M- or N-major (transposed)
__device__ __forceinline__ void wgmma_m64n48k16_tt(float (&d)[24], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 fp32, a warpgroup's) += A B: A (64 x 16 bf16) in registers,
// a warp's 16 rows as an mma.sync A fragment; B (16 x 64) in shared
// memory, K-major
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 96 fp32, a warpgroup's) = A B: A (64 x 16) K-major and B (16 x
// 96) N-major (transposed), bf16 in shared memory
__device__ __forceinline__ void wgmma_m64n96k16_st(float (&d)[48], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the named barrier of warpgroup wg (4 warps); __syncthreads is barrier 0
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// ldmatrix row addresses of a 16-row A operand whose rows 8-15 are zero
// (a group's kRows = 8 rows): rows 8-15 read the 16-byte zero block.
// x4 at (row 0, col0) as tile_p1 lays it out -> an m16n8k16 A fragment
__device__ __forceinline__ const bf16* rows8_p1(const bf16* s, int ld, int col0, int lane,
                                                const bf16* zero) {
  return (lane & 8) ? zero : s + (lane & 7) * ld + col0 + (lane >> 4) * 8;
}

// x2 at (row 0, col0) -> an m16n8k8 A fragment
__device__ __forceinline__ const bf16* rows8_x2(const bf16* s, int ld, int col0, int lane,
                                                const bf16* zero) {
  return (lane & 8) ? zero : s + (lane & 7) * ld + col0;
}

// x2.trans of the (8, 16) tile at (k0, n0) of a [k][n] tile -> the
// m16n8k8 B fragments of n-tiles 0 ({r0}) and 1 ({r1})
__device__ __forceinline__ const bf16* k8_pair(const bf16* s, int ld, int k0, int n0,
                                               int lane) {
  return s + (k0 + (lane & 7)) * ld + n0 + ((lane >> 3) & 1) * 8;
}

// x2 of the (8, 16) tile at (n0, k0) of an [n][k] tile -> the k16 B
// fragment {r0, r1} of one n-tile
__device__ __forceinline__ const bf16* n8_k16(const bf16* s, int ld, int n0, int k0, int lane) {
  return s + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
}

}  // namespace fm_mma
}  // namespace tossctr
