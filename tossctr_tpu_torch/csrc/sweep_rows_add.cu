// sweep_rows_add: tables[t][ids] += deltas[t] for every table, in place,
// for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_scatter.py sweep_rows_add, the
// pallas_call over _sweep_kernel (a sweep of the whole table in (2048, D)
// superblocks, each merging its segment of the sorted update rows with a
// one-hot matmul).
//
// What it computes (the Pallas kernel's rules): ids sorted once (the
// wrapper, ops/sweep_scatter.py, as the JAX wrapper sorts outside its
// pallas_call); each delta cast to the table dtype; duplicate ids summed
// in fp32 in stable sorted order; each touched row rounded once, from
// fp32 (row + sum); ids out of range dropped (the wrapper maps them to
// the sentinel V, which sorts last).
//
// What bounds it on the card: the ids and deltas are read once and each
// touched row is read and written once.  At the flagship's update (N =
// 524,288 ids of a (10M, 128) bf16 table, fp32 deltas) that is ~280 MB
// plus 512 bytes a touched row: ~0.16 ms at 3.35 TB/s.  The sort's
// permutation adds 2 MB.  No arithmetic to speak of.
//
// Design: the TPU kernel sweeps the whole table because per-row DMA
// could not be expressed there; on the card a row is 256 bytes that a
// warp reads and writes in one coalesced access, so the kernel walks the
// sorted update rows instead and touches only the rows that change.  The
// sorted positions are cut into pieces of kPiece positions, one warp a
// piece (pass 1).  The deltas stay where the caller made them: the
// kernel reads the delta row of sorted position i at order[i] (the
// stable sort's permutation), 16 bytes a lane (a float4 of an fp32 row of
// 128), and rounds it to the table dtype itself, so no packed copy of the
// deltas is ever written.  A warp loads its piece's ids and order once,
// then walks the piece in batches of kBatch positions: it issues the
// batch's delta loads and the row loads of every segment that starts in
// the batch and ends in the piece (a segment of equal ids; the ids come
// to each lane by shuffles), then sums the segments in order in fp32 (4
// columns a lane, 128 columns a pass) and adds each finished one to its
// row (add, round, write).  So a warp has up to kBatch delta rows and
// kBatch table rows in flight at once, ~3 KB, and an SM's 32 warps ~96
// KB (an fp32 table's 16 warps as much, at twice the row), where 3.35
// TB/s at ~1 us needs ~25 KB an SM; small batches on many warps ran
// faster than large ones on few (exp/sweep_design_probe.py).
// A segment that crosses a piece boundary
// (a hot id: the pad id, whose masked zero deltas still come through, or
// a zipf head) leaves its per-piece fp32 partial in scratch, and pass 2
// adds the partials in piece order, in the warp of the piece where the
// segment starts, and writes the row.  So one hot row never holds up the
// grid, nothing is added with atomics, and the result repeats bit for
// bit.  The wrapper finds each piece's crossing segment's end with one
// torch.searchsorted over the pieces' last ids.
#include "common.cuh"

namespace {

using tossctr::load4;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// pass 1's blocks an SM: bf16 tables at most 64 registers a thread
// (ptxas: 64, 24 bytes of spill stores); fp32 tables, whose rows and
// rounded deltas take twice the registers, at most 128 (ptxas: 101, no
// spills; held to 64 they spill 1,388 bytes and ran 12-20% slower)
constexpr int kMinBlocks = 8;
constexpr int kMinBlocksF32 = 4;
constexpr int kPiece = 64;        // sorted positions a warp walks in pass 1
constexpr int kMergeBatch = 32;   // partials loaded ahead of their sums (pass 2)
constexpr int kMaxTables = 8;
constexpr int kBatch = 4;         // positions whose loads a warp issues together in pass 1
static_assert(kPiece == 64, "a lane holds two positions of its piece");

struct Tables {
  void* p[kMaxTables];
};

struct Deltas {
  const void* p[kMaxTables];
};

// four elements of T in registers, as they lie in memory
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  float4 v;
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void set(const float* f) { v = make_float4(f[0], f[1], f[2], f[3]); }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

template <>
struct Quad<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ void set(const float* f) {  // rounds to bf16
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    v.x = *reinterpret_cast<uint32_t*>(&a);
    v.y = *reinterpret_cast<uint32_t*>(&b);
  }
  __device__ __forceinline__ void get(float* f) const {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

// four elements at p (16-byte aligned for float, 8 for bf16) rounded to T
template <typename T, typename TD>
__device__ __forceinline__ void load_as(Quad<T>& q, const TD* p) {
  float f[4];
  load4(p, f);
  q.set(f);
}

// Pass 1: warp w of the grid walks the sorted positions [a, b) of piece w.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kMinBlocksF32 : kMinBlocks)
sweep_pieces_kernel(Tables tabs, Deltas dels, const int* __restrict__ ids,
                    const int* __restrict__ order, float* __restrict__ head,
                    float* __restrict__ tail, int N, int V, int D, int W, int n_pieces) {
  constexpr int B = kBatch;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_pieces) return;
  const int a = p * kPiece, b = min(N, a + kPiece);
  // the piece's ids and delta rows, lane l holding positions a + l and
  // a + 32 + l (id -1 past b)
  int pid[2], pord[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = a + h * 32 + lane;
    pid[h] = i < b ? ids[i] : -1;
    pord[h] = i < b ? order[i] : 0;
  }
  const int before = a > 0 ? ids[a - 1] : -1;  // the id at a - 1, if any
  const int after = b < N ? ids[b] : -1;       // the id at b, if any
  // the id of the piece's last segment where it runs on past b (pass 2
  // or a later piece writes its row), else -1
  const int open = ids[b - 1] == after ? after : -1;

  for (int cb = 0; cb < W; cb += 128) {
    const int c = cb + lane * 4;
    const bool active = c < W;
    const int t = active ? c / D : 0, col = c - t * D;
    // table t's pointers, picked without indexing the parameters at run time
    void* tp = tabs.p[0];
    const void* dp = dels.p[0];
#pragma unroll
    for (int j = 1; j < kMaxTables; ++j)
      if (j == t) tp = tabs.p[j], dp = dels.p[j];
    T* const rows = static_cast<T*>(tp) + col;
    const TD* const drows = static_cast<const TD*>(dp) + col;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    Quad<T> row;
    row.zero();
    int cur = -1, s0 = a, prev = before;
    // the segment [s0, e) of id `cur`, whose sum over this piece is acc
    auto flush = [&](int e) {
      if (cur < 0 || cur >= V || !active) return;  // dropped ids sort last
      const bool starts = s0 > a || cur != before;
      const bool ends = e < b || cur != after;
      if (starts && ends) {
        float r[4];
        row.get(r);
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = __fadd_rn(r[j], acc[j]);
        Quad<T> out;
        out.set(r);
        *reinterpret_cast<decltype(out.v)*>(rows + (size_t)cur * D) = out.v;
      } else {
        // continues into later pieces (pass 2 finishes it), or began in
        // an earlier one
        float* part = (starts ? tail : head) + (size_t)p * W + c;
        *reinterpret_cast<float4*>(part) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    };
#pragma unroll
    for (int k = 0; k < kPiece / B; ++k) {
      const int i0 = a + k * B;
      if (i0 >= b) break;
      int idb[B];
      Quad<T> dv[B], rv[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int pos = k * B + u;
        idb[u] = __shfl_sync(0xffffffffu, pid[pos / 32], pos % 32);
        const int o = __shfl_sync(0xffffffffu, pord[pos / 32], pos % 32);
        const int id_before = u == 0 ? prev : idb[u - 1];
        dv[u].zero();
        rv[u].zero();
        if (active && idb[u] >= 0 && idb[u] < V) {
          load_as(dv[u], drows + (size_t)o * D);
          // a segment that starts here and ends in this piece: its row
          if (idb[u] != id_before && idb[u] != open)
            rv[u].v = *reinterpret_cast<const decltype(rv[u].v)*>(rows + (size_t)idb[u] * D);
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (idb[u] < 0) break;  // past b
        if (idb[u] != cur) {
          flush(i0 + u);
          cur = idb[u];
          s0 = i0 + u;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = 0.f;
          row = rv[u];
        }
        float d[4];
        dv[u].get(d);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], d[j]);
      }
      prev = idb[B - 1];
    }
    flush(b);
  }
}

// row[id][col .. col+3] of table t = round_T(row + sum)
template <typename T>
__device__ __forceinline__ void add_to_row(const Tables& tabs, int D, int c, int id,
                                           const float* sum) {
  const int t = c / D, col = c - t * D;
  T* row = static_cast<T*>(tabs.p[t]) + (size_t)id * D + col;
  Quad<T> q;
  q.v = *reinterpret_cast<const decltype(q.v)*>(row);
  float r[4];
  q.get(r);
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = __fadd_rn(r[j], sum[j]);
  q.set(r);
  *reinterpret_cast<decltype(q.v)*>(row) = q.v;
}

// Pass 2: the warp of piece p finishes the segment that starts in p and
// runs past its end (seg_end[p]: the end of the segment holding p's last
// position), adding the pieces' partials in piece order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_merge_kernel(Tables tabs, const int* __restrict__ ids, const int* __restrict__ seg_end,
                   const float* __restrict__ head, const float* __restrict__ tail, int N, int V,
                   int D, int W, int n_pieces) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_pieces) return;
  const int a = p * kPiece, b = min(N, a + kPiece);
  const int cur = ids[b - 1];
  const int e = seg_end[p];
  if (e <= b || cur >= V) return;        // the last segment ends here (or is dropped)
  if (a > 0 && ids[a - 1] == cur) return;  // it began in an earlier piece
  const int q_last = (e - 1) / kPiece;   // the piece of the segment's last position
  for (int cb = 0; cb < W; cb += 128) {
    const int c = cb + lane * 4;
    if (c >= W) continue;
    float acc[4];
    load4(tail + (size_t)p * W + c, acc);
    for (int q0 = p + 1; q0 <= q_last; q0 += kMergeBatch) {
      float hv[kMergeBatch][4];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (q0 + u <= q_last) load4(head + (size_t)(q0 + u) * W + c, hv[u]);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (q0 + u <= q_last)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], hv[u][j]);
    }
    add_to_row<T>(tabs, D, c, cur, acc);
  }
}

template <typename T, typename TD>
int launch(const Tables& tabs, const Deltas& dels, const int* ids, const int* order,
           const int* seg_end, float* head, float* tail, int N, int V, int D, int n_tables,
           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int W = n_tables * D;
  const int n_pieces = (N + kPiece - 1) / kPiece;
  const int grid = (n_pieces + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sweep_pieces_kernel<T, TD><<<grid, kThreads, 0, s>>>(tabs, dels, ids, order, head, tail, N, V,
                                                       D, W, n_pieces);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_merge_kernel<T><<<grid, kThreads, 0, s>>>(tabs, ids, seg_end, head, tail, N, V, D, W,
                                                 n_pieces);
  return (int)cudaGetLastError();
}

}  // namespace

// tables, deltas: host arrays of n_tables device pointers: (V, D) tables
// of one dtype (0 = float32, 1 = bfloat16), updated in place, and their
// (N, D) contiguous deltas, row i the update of the caller's i-th id, all
// of one dtype (delta_dtype: 0 = float32, 1 = bfloat16; float32 or the
// tables' dtype), cast to the tables' dtype before the sums.  ids (N,)
// int32 sorted ascending, out-of-range ids replaced by V; order (N,)
// int32, the stable sort's permutation (sorted position i holds the
// caller's id order[i]); seg_end (n_pieces,) int32, n_pieces = ceil(N /
// kPiece), kPiece = 64: for piece p (positions p*64 .. p*64 + 63) the end
// of the segment of equal ids holding its last position; head, tail
// (n_pieces, n_tables * D) fp32 scratch.  D % 4 == 0, n_tables <= 8; the
// tables and deltas aligned to four elements.  Returns a cudaError_t code.
extern "C" int tossctr_sweep_piece() { return kPiece; }

extern "C" int tossctr_sweep_rows_add(const void* const* tables, const void* const* deltas,
                                      int n_tables, const void* ids, const void* order,
                                      const void* seg_end, void* head, void* tail, int N, int V,
                                      int D, int dtype, int delta_dtype, int device,
                                      void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || N < 0 || V < 1 || D < 4 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Tables tabs{};
  Deltas dels{};
  for (int t = 0; t < n_tables; ++t) {
    tabs.p[t] = const_cast<void*>(tables[t]);
    dels.p[t] = deltas[t];
  }
  const int* i = static_cast<const int*>(ids);
  const int* o = static_cast<const int*>(order);
  const int* se = static_cast<const int*>(seg_end);
  float* h = static_cast<float*>(head);
  float* tl = static_cast<float*>(tail);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && delta_dtype == 0)
    return launch<float, float>(tabs, dels, i, o, se, h, tl, N, V, D, n_tables, device, stream);
  if (dtype == 1 && delta_dtype == 0)
    return launch<bf16, float>(tabs, dels, i, o, se, h, tl, N, V, D, n_tables, device, stream);
  if (dtype == 1 && delta_dtype == 1)
    return launch<bf16, bf16>(tabs, dels, i, o, se, h, tl, N, V, D, n_tables, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
