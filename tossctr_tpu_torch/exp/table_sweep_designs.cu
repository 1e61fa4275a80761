// The designs of the scatter probe's table sweep that were timed against
// csrc/table_sweep.cu and lost to it on the H100 (PERF.md), kept so that
// their times can be taken again: exp/sweep_design_probe.py builds this
// file in place of csrc/table_sweep.cu (the same C entry point, the same
// results bit for bit) with the constants below set per variant.
//
//   kBulk = true: a bulk-copy ring.  A persistent grid of kBlocksPerSM
//   blocks an SM, each running a ring of kStages shared-memory stages of
//   kChunk elements: one thread brings an item in with a 1-D bulk copy
//   (cp.async.bulk global to shared, completing on the stage's mbarrier;
//   16-byte-aligned sizes, no tensor map), the block adds the marker in
//   shared memory, the same thread writes the stage back with a bulk copy
//   shared to global and refills it with the item kStages further on
//   once that write has read it.
//
//   kBulk = false: the kept design's register walk (kDepth 16-byte loads
//   a thread, then the adds and stores) on a persistent grid of
//   kRegBlocksPerSM blocks an SM, each striding over the items.
//
// The walk (the items and their element ranges) is the kept kernel's.
#include "common.cuh"

namespace {

constexpr int kRows = 16;           // rows of W elements a block, the probe's BlockSpec (16, W)
constexpr int kThreads = 256;
constexpr bool kBulk = true;        // false: the persistent register walk
constexpr int kStages = 4;          // ring stages a block
constexpr int kChunk = 8192;        // elements a stage: 16 KB
constexpr int kBlocksPerSM = 3;     // 3 x 64 KB of stages an SM
// the register walk: kDepth 16-byte loads in flight a thread, a
// persistent grid of kRegBlocksPerSM blocks an SM
constexpr int kDepth = 8;
constexpr int kRegBlocksPerSM = 4;
constexpr int kRegChunk = kThreads * kDepth * 8;  // elements an item

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

__device__ __forceinline__ void add1(__nv_bfloat16* p, float c) {
  *p = __float2bfloat16_rn(__fadd_rn(__bfloat162float(*p), c));
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
  long long n_items;
  size_t chunk;        // elements an item at most

  __device__ __forceinline__ void range(long long k, size_t& s, size_t& e) const {
    if (ids == nullptr) {
      s = (size_t)k * chunk;
      e = s + chunk < n ? s + chunk : n;
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
    s = b0 + (size_t)(k - i * chunks) * chunk;
    if (s > end) s = end;
    e = s + chunk < end ? s + chunk : end;
  }
};

// ---- PTX of the bulk copies and their mbarriers (the ring) ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// `bytes` (a multiple of 16) from global src into shared dst; the
// stage's barrier completes when they have landed, or at once for none
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  if (bytes == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// ---- the bulk-copy ring ----
__global__ void __launch_bounds__(kThreads)
sweep_bulk_kernel(__nv_bfloat16* __restrict__ t, Walk w, float c) {
  extern __shared__ __align__(128) uint4 stage[];  // kStages x kChunk bf16
  __shared__ __align__(8) uint64_t full[kStages];
  const int tid = threadIdx.x;
  const long long first = blockIdx.x, step = gridDim.x;
  // item `item` into ring stage s (an item past the walk: nothing)
  auto fetch = [&](int s, long long item) {
    if (item >= w.n_items) return;
    size_t a, e;
    w.range(item, a, e);
    bulk_load(stage + (size_t)s * (kChunk / 8), t + a, (uint32_t)((e - a) / 8 * 16), &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages; ++s) fetch(s, first + s * step);
  bool prev_store = false, any_store = false;  // thread 0's: bulk writes issued
  for (long long k = 0; first + k * step < w.n_items; ++k) {
    const int s = (int)(k % kStages);
    while (!mbar_try_wait(&full[s], (uint32_t)((k / kStages) & 1))) {
    }
    size_t a, e;
    w.range(first + k * step, a, e);
    const size_t nv = (e - a) / 8;
    uint4* v = stage + (size_t)s * (kChunk / 8);
    for (size_t i = tid; i < nv; i += kThreads) v[i] = add8(v[i], c);
    for (size_t i = a + nv * 8 + tid; i < e; i += kThreads) add1(t + i, c);
    // the adds made in shared memory, visible to the copy engine's read
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      // a write only for an item with bytes (a skipped list entry has
      // none), each in a bulk group of its own
      if (nv) {
        bulk_store(t + a, v, (uint32_t)(nv * 16));
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        any_store = true;
      }
      if (k > 0) {
        // the write of item k - 1, if any, has read its stage: refill it
        if (prev_store && nv)
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        else if (prev_store)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        fetch((int)((k - 1) % kStages), first + (k - 1 + kStages) * step);
      }
      prev_store = nv != 0;
    }
  }
  if (tid == 0 && any_store) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- the persistent register walk ----
__global__ void __launch_bounds__(kThreads, kRegBlocksPerSM)
sweep_regs_kernel(__nv_bfloat16* __restrict__ t, Walk w, float c) {
  for (long long k = blockIdx.x; k < w.n_items; k += gridDim.x) {
    size_t a, e;
    w.range(k, a, e);
    const size_t nv = (e - a) / 8;
    uint4* v = reinterpret_cast<uint4*>(t + a);  // a is a multiple of 8
    for (size_t i0 = threadIdx.x; i0 < nv; i0 += (size_t)kThreads * kDepth) {
      uint4 r[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const size_t i = i0 + (size_t)u * kThreads;
        if (i < nv) r[u] = v[i];
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const size_t i = i0 + (size_t)u * kThreads;
        if (i < nv) v[i] = add8(r[u], c);
      }
    }
    for (size_t i = a + nv * 8 + threadIdx.x; i < e; i += kThreads) add1(t + i, c);
  }
}

}  // namespace

// csrc/table_sweep.cu's entry point and contract
extern "C" int tossctr_table_sweep(void* table, long long n, int W, float add, const void* ids,
                                   int n_ids, int device, void* stream) {
  if (n < 0 || W < 1 || n_ids < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Walk w{};
  w.n = (size_t)n;
  w.block = (size_t)kRows * W;
  w.n_blocks = (long long)((w.n + w.block - 1) / w.block);
  w.chunk = kBulk ? kChunk : kRegChunk;
  if (ids == nullptr) {
    w.n_items = (long long)((w.n + w.chunk - 1) / w.chunk);
  } else {
    w.ids = static_cast<const int*>(ids);
    w.chunks = (long long)((w.block + w.chunk - 1) / w.chunk);
    w.n_items = (long long)n_ids * w.chunks;
  }
  if (w.n_items == 0) return 0;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long most = (long long)sms * (kBulk ? kBlocksPerSM : kRegBlocksPerSM);
  const long long grid = w.n_items < most ? w.n_items : most;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  __nv_bfloat16* t = static_cast<__nv_bfloat16*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kBulk) {
    const int smem = kStages * kChunk * (int)sizeof(__nv_bfloat16);
    e = cudaFuncSetAttribute(sweep_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sweep_bulk_kernel<<<(unsigned)grid, kThreads, smem, s>>>(t, w, add);
  } else {
    sweep_regs_kernel<<<(unsigned)grid, kThreads, 0, s>>>(t, w, add);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
