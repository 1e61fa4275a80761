// Tensor-core building blocks shared by the bf16 kernels (ffn_mma.cuh,
// mha_mma.cuh): ldmatrix, mma.sync with bf16 operands and fp32
// accumulators, cp.async, bf16 packing, and the addressing of ldmatrix
// over row-major bf16 tiles in shared memory.
//
// Shared tiles are bf16, row-major, with rows 16 bytes longer than their
// data (row_stride), so the eight 16-byte rows that one ldmatrix phase
// reads fall in eight different bank groups.  A transposed operand is
// read with ldmatrix.trans from the row-major tile; nothing is stored
// transposed.  Helpers are called by every lane of a warp.
#pragma once

#include "common.cuh"

namespace tossctr {
namespace ptx {

using bf16 = __nv_bfloat16;

// shared row stride (elements) of a bf16 tile ``cols`` wide
__host__ __device__ constexpr int row_stride(int cols) { return cols + 8; }

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- PTX ----

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 fp32) += a (16x8 bf16, row) * b (8x8 bf16, col)
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// 16 bytes global -> shared, asynchronous, past L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 8 bytes global -> shared, asynchronous; zeros where !ok
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two fp32 -> one register of two bf16 (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- ldmatrix addressing ----
// x2 of the 16x8 tile at (row0, col0): (rows 0-7), (rows 8-15); lanes
// 16-31 repeat lanes 0-15 (their addresses are not read).  ldsm_x2 of a
// [m][k] tile -> an m16n8k8 A fragment; of an [n][k] tile -> the k8 B
// fragments of n-tiles 0 and 1; ldsm_x2_t of a [k][n] tile -> the k16 B
// fragment {r0, r1} of one n-tile.
__device__ __forceinline__ const bf16* tile_x2(const bf16* s, int ld, int row0, int col0,
                                               int lane) {
  return s + (row0 + (lane & 15)) * ld + col0;
}

// x4 of the 16x16 tile at (row0, col0):
// p1: the four 8x8 matrices are (rows 0-7, cols 0-7), (8-15, 0-7),
// (0-7, 8-15), (8-15, 8-15).  ldsm_x4 of a [m][k] tile -> an A fragment;
// ldsm_x4_t of a [k][n] tile -> B fragments of n-tiles 0 ({r0, r1}) and 1
// ({r2, r3}).
__device__ __forceinline__ const bf16* tile_p1(const bf16* s, int ld, int row0, int col0,
                                               int lane) {
  return s + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}

// p2: (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
// ldsm_x4_t of a [k][m] tile -> an A fragment (the tile's transpose);
// ldsm_x4 of a [n][k] tile -> B fragments of n-tiles 0 and 1.
__device__ __forceinline__ const bf16* tile_p2(const bf16* s, int ld, int row0, int col0,
                                               int lane) {
  return s + (row0 + (lane >> 4) * 8 + (lane & 7)) * ld + col0 + ((lane >> 3) & 1) * 8;
}

// cp.async of a (rows, cols) bf16 region from global (row stride ld) into
// shared (row stride lds) in 8-byte pieces, by threads i0, i0 + step, ...;
// zeros at rows >= rows_ok or columns >= cols_ok.  cols, cols_ok and ld
// are multiples of 4, so a piece is all in or all out.
__device__ __forceinline__ void copy_async(bf16* dst, int lds, const bf16* src, int ld, int rows,
                                           int cols, int rows_ok, int cols_ok, int i0,
                                           int step) {
  const int per_row = cols >> 2;
  for (int i = i0; i < rows * per_row; i += step) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    const bool ok = r < rows_ok && c < cols_ok;
    cp_async8(dst + r * lds + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

}  // namespace ptx
}  // namespace tossctr
