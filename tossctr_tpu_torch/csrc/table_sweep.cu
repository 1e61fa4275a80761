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
// here the work is cut into items of at most kChunk elements, 16 KB
// (dense: the whole table; sparse: each listed block, so an item never
// crosses a block, and an item of a skipped entry is empty), and a CUDA
// block of 256 threads takes one item: each thread issues its kDepth
// 16-byte loads (neighbouring threads on neighbouring addresses), then
// adds and stores them.  The ~156k blocks of a flagship sweep leave the
// block scheduler to keep the SMs full: 5 blocks an SM (44 registers a
// thread) keep 80 KB of reads in flight, where 3.35 TB/s at ~1 us needs
// ~25 KB.  An element tail that is not a multiple of 8 (the end of a
// table whose size is not) goes element by element.
//
// The designs timed against it (exp/sweep_design_probe.py, which builds
// them from exp/table_sweep_designs.cu; PERF.md): a bulk-copy ring
// through shared memory on a persistent grid and the same register walk
// on a persistent grid ran 2-5% slower on the H100; deeper loads or
// smaller blocks here timed within 0.2%.
#include "common.cuh"

namespace {

constexpr int kRows = 16;     // rows of W elements a block, the probe's BlockSpec (16, W)
constexpr int kThreads = 256;
constexpr int kDepth = 4;     // 16-byte loads in flight a thread
constexpr int kChunk = kThreads * kDepth * 8;  // elements an item

__device__ __forceinline__ uint32_t add2(uint32_t u, float c) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(__fadd_rn(f.x, c), __fadd_rn(f.y, c));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 add8(uint4 r, float c) {
  r.x = add2(r.x, c);
  r.y = add2(r.y, c);
  r.z = add2(r.z, c);
  r.w = add2(r.w, c);
  return r;
}

// The walk: item k -> the element range [s, e) it sweeps (empty for a
// skipped list entry).  B: the table in chunks.  C: list entry k /
// chunks, its block's chunk k % chunks.
struct Walk {
  size_t n;            // elements of the table
  size_t block;        // elements a (16, W) block
  long long n_blocks;  // blocks of the table, a partial last one included
  const int* ids;      // the block list (C), or nullptr (B)
  long long chunks;    // chunks a block (C)

  __device__ __forceinline__ void range(long long k, size_t& s, size_t& e) const {
    if (ids == nullptr) {
      s = (size_t)k * kChunk;
      e = s + kChunk < n ? s + kChunk : n;
      return;
    }
    const long long i = k / chunks;
    const long long b = ids[i];
    if ((i > 0 && ids[i - 1] == b) || b < 0 || b >= n_blocks) {
      s = e = 0;
      return;
    }
    const size_t b0 = (size_t)b * block;
    const size_t end = b0 + block < n ? b0 + block : n;  // a partial last block ends early
    s = b0 + (size_t)(k - i * chunks) * kChunk;
    if (s > end) s = end;
    e = s + kChunk < end ? s + kChunk : end;
  }
};

// CUDA block k sweeps item k
__global__ void __launch_bounds__(kThreads)
sweep_kernel(__nv_bfloat16* __restrict__ t, Walk w, float c) {
  size_t a, e;
  w.range(blockIdx.x, a, e);
  const size_t nv = (e - a) / 8;  // at most kThreads * kDepth
  uint4* v = reinterpret_cast<uint4*>(t + a);  // a is a multiple of 8
  uint4 r[kDepth];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const size_t i = threadIdx.x + (size_t)u * kThreads;
    if (i < nv) r[u] = v[i];
  }
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const size_t i = threadIdx.x + (size_t)u * kThreads;
    if (i < nv) v[i] = add8(r[u], c);
  }
  for (size_t i = a + nv * 8 + threadIdx.x; i < e; i += kThreads)
    t[i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(t[i]), c));
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
  Walk w{};
  w.n = (size_t)n;
  w.block = (size_t)kRows * W;
  w.n_blocks = (long long)((w.n + w.block - 1) / w.block);
  long long n_items;
  if (ids == nullptr) {
    n_items = (long long)((w.n + kChunk - 1) / kChunk);
  } else {
    w.ids = static_cast<const int*>(ids);
    w.chunks = (long long)((w.block + kChunk - 1) / kChunk);
    n_items = (long long)n_ids * w.chunks;
  }
  if (n_items == 0) return 0;
  if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sweep_kernel<<<(unsigned)n_items, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(table), w, add);
  return (int)cudaGetLastError();
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
