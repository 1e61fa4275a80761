// table_sweep: the scatter probe's in-place sweeps of a bf16 table, for
// sm_90a.
//
// Replaces: exp/scatter_probe.py, the pallas_call over _sweep_kernel in
// probe_dense_sweep (B: every (16, W) block of the table) and the one
// over _sparse_kernel in probe_sparse (C: the blocks whose ids a
// scalar-prefetched list names).
//
// What it computes: the (V, D) bf16 table is viewed as (V*D/W, W) rows of
// W elements and cut into blocks of 16 rows, that is into runs of 16*W
// consecutive elements; the last block is partial where V*D is not a
// multiple of 16*W.  Every element x of a swept block becomes
// round_bf16(x + c), c the probe's marker 0.001 rounded to bf16 (passed
// in as that fp32 value), in place.  B sweeps every block.  C sweeps the
// blocks of a device list of int32 ids: an id equal to its predecessor in
// the list is skipped (the probe pads the list with repeats of its last
// id, and a repeat adds nothing, as the TPU's same-index steps elide
// their DMAs), and an id outside the table is skipped.
//
// What bounds it on the card: bytes.  B reads and writes the whole table
// once: 2.56 GB at (10M, 64) bf16, 0.76 ms at 3.35 TB/s; 5.12 GB at the
// flagship's lane-fused (10M, 128), 1.53 ms.  C moves 2 x 32*W bytes a
// listed block.  One add an element.
//
// Design: the TPU grid walks the blocks one after another on one core;
// here one CUDA block of 256 threads takes one (16, W) block (B: the
// grid is the table's blocks; C: the list's entries), and all run at
// once over the SMs.  A thread moves 16 bytes (8 bf16) a load and a
// store, neighbouring threads on neighbouring addresses, with four loads
// in flight before their stores; an element tail that is not a multiple
// of 8 (a partial last block) goes element by element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;   // rows of W elements a block, the probe's BlockSpec (16, W)
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

__device__ __forceinline__ uint32_t add2(uint32_t u, float c) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(__fadd_rn(f.x, c), __fadd_rn(f.y, c));
  return *reinterpret_cast<uint32_t*>(&h);
}

// elements [start, end) of the table += c, by the whole thread block
__device__ __forceinline__ void sweep_range(__nv_bfloat16* __restrict__ t, size_t start,
                                            size_t end, float c) {
  const size_t nvec = (end - start) / 8;
  uint4* v = reinterpret_cast<uint4*>(t + start);  // start is a multiple of 16*W
  for (size_t i0 = threadIdx.x; i0 < nvec; i0 += (size_t)kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = i0 + (size_t)u * kThreads;
      if (i < nvec) r[u] = v[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = i0 + (size_t)u * kThreads;
      if (i < nvec) {
        r[u].x = add2(r[u].x, c);
        r[u].y = add2(r[u].y, c);
        r[u].z = add2(r[u].z, c);
        r[u].w = add2(r[u].w, c);
        v[i] = r[u];
      }
    }
  }
  for (size_t i = start + nvec * 8 + threadIdx.x; i < end; i += kThreads)
    t[i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(t[i]), c));
}

// B: CUDA block b sweeps table block b
__global__ void __launch_bounds__(kThreads)
dense_sweep_kernel(__nv_bfloat16* __restrict__ t, size_t n, size_t block, float c) {
  const size_t start = (size_t)blockIdx.x * block;
  sweep_range(t, start, start + block < n ? start + block : n, c);
}

// C: CUDA block i sweeps table block ids[i], unless it repeats ids[i - 1]
__global__ void __launch_bounds__(kThreads)
sparse_sweep_kernel(__nv_bfloat16* __restrict__ t, size_t n, size_t block,
                    const int* __restrict__ ids, long long n_blocks, float c) {
  const int i = blockIdx.x;
  const int b = ids[i];
  if ((i > 0 && ids[i - 1] == b) || b < 0 || b >= n_blocks) return;
  const size_t start = (size_t)b * block;
  sweep_range(t, start, start + block < n ? start + block : n, c);
}

}  // namespace

// table: n bf16 elements (the (V, D) table, contiguous, 16-byte aligned),
// swept in place in blocks of 16*W elements with add (a bf16 value as
// fp32).  ids == NULL: every block (B); else the n_ids int32 block ids at
// ids, on the device (C).  Returns a cudaError_t code, 0 on success.
extern "C" int tossctr_table_sweep(void* table, long long n, int W, float add, const void* ids,
                                   int n_ids, int device, void* stream) {
  if (n < 0 || W < 1 || n_ids < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t block = (size_t)kRows * W;
  const long long n_blocks = (long long)(((size_t)n + block - 1) / block);
  __nv_bfloat16* t = static_cast<__nv_bfloat16*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids == nullptr) {
    if (n_blocks == 0) return 0;
    if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dense_sweep_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(t, (size_t)n, block, add);
  } else {
    if (n_ids == 0) return 0;
    sparse_sweep_kernel<<<n_ids, kThreads, 0, s>>>(t, (size_t)n, block,
                                                   static_cast<const int*>(ids), n_blocks, add);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
