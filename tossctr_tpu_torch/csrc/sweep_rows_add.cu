// sweep_rows_add: tables[t][ids] += deltas[t] for every table, in place,
// for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_scatter.py sweep_rows_add, the
// pallas_call over _sweep_kernel (a sweep of the whole table in (2048, D)
// superblocks, each merging its segment of the sorted update rows with a
// one-hot matmul).
//
// What it computes (the Pallas kernel's rules): ids sorted once (the
// wrapper, ops/sweep_scatter.py), the deltas cast to the table dtype and
// permuted into that order; duplicate ids summed in fp32 in sorted order;
// each touched row rounded once, from fp32 (row + sum); ids out of range
// dropped (the wrapper maps them to the sentinel V, which sorts last).
//
// What bounds it on the card: the ids and deltas are read once and each
// touched row is read and written once.  At the flagship's update (N =
// 524,288 ids of a (10M, 128) bf16 table, fp32 deltas) that is ~280 MB
// plus 512 bytes a touched row: ~0.1 ms at 3.35 TB/s.  No arithmetic to
// speak of.
//
// Design: the TPU kernel sweeps the whole table because per-row DMA
// could not be expressed there; on the card a row is 256 bytes that a
// warp reads and writes in one coalesced access, so the kernel walks the
// sorted update rows instead and touches only the rows that change.  The
// sorted positions are cut into pieces of kPiece positions, one warp a
// piece (pass 1).  A warp walks its piece in order, summing each segment
// of equal ids in fp32 (4 columns a lane, 128 columns a pass); a segment
// that starts and ends inside the piece is added to its row at once
// (read, add, round, write).  A segment that crosses a piece boundary (a
// hot id: the pad id, whose masked zero deltas still come through, or a
// zipf head) leaves its per-piece fp32 partial in scratch, and pass 2
// adds the partials in piece order, in the warp of the piece where the
// segment starts, and writes the row.  So one hot row never holds up the
// grid, nothing is added with atomics, and the result repeats bit for
// bit.  The wrapper finds each piece's crossing segment's end with one
// torch.searchsorted over the pieces' last ids.
#include "common.cuh"

namespace {

using tossctr::load4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 64;        // sorted positions a warp walks in pass 1
constexpr int kBatch = 8;         // positions loaded ahead of their sums (pass 1)
constexpr int kMergeBatch = 32;   // partials loaded ahead of their sums (pass 2)
constexpr int kMaxTables = 8;

struct Tables {
  void* p[kMaxTables];
};

// four fp32 values stored as four consecutive elements (16-byte aligned
// for float, 8 for bf16)
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// row[id][col .. col+3] of table t = round_T(row + sum)
template <typename T>
__device__ __forceinline__ void add_to_row(const Tables& tabs, int D, int c, int id,
                                           const float* sum) {
  const int t = c / D, col = c - t * D;
  T* row = static_cast<T*>(tabs.p[t]) + (size_t)id * D + col;
  float r[4];
  load4(row, r);
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = __fadd_rn(r[j], sum[j]);
  store4(row, r);
}

// Pass 1: warp w of the grid walks the sorted positions [a, b) of piece w.
// Two blocks an SM at least: the walk waits on loads, so warps in flight
// matter more than registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
sweep_pieces_kernel(Tables tabs, const int* __restrict__ ids, const T* __restrict__ deltas,
                    float* __restrict__ head, float* __restrict__ tail, int N, int V, int D,
                    int W, int n_pieces) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_pieces) return;
  const int a = p * kPiece, b = min(N, a + kPiece);
  const int before = a > 0 ? ids[a - 1] : -1;  // the id at a - 1, if any
  const int after = b < N ? ids[b] : -1;       // the id at b, if any

  for (int cb = 0; cb < W; cb += 128) {
    const int c = cb + lane * 4;
    const bool active = c < W;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int cur = ids[a], s0 = a;
    // a segment [s, e) of id `cur` whose sum over this piece is acc
    auto flush = [&](int s, int e) {
      if (cur >= V || !active) return;  // dropped ids sort last
      const bool starts = s > a || cur != before;
      const bool ends = e < b || cur != after;
      if (starts && ends)
        add_to_row<T>(tabs, D, c, cur, acc);
      else if (starts)  // continues into later pieces: pass 2 finishes it
        store4(tail + (size_t)p * W + c, acc);
      else  // began in an earlier piece
        store4(head + (size_t)p * W + c, acc);
    };
    for (int i0 = a; i0 < b; i0 += kBatch) {
      int idb[kBatch];
      float dv[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u;
        idb[u] = i < b ? ids[i] : -1;
        if (i < b && active) {
          load4(deltas + (size_t)i * W + c, dv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) dv[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u;
        if (i >= b) break;
        if (idb[u] != cur) {
          flush(s0, i);
          cur = idb[u];
          s0 = i;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], dv[u][j]);
      }
    }
    flush(s0, b);
  }
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

template <typename T>
int launch(const Tables& tabs, const int* ids, const void* deltas, const int* seg_end,
           float* head, float* tail, int N, int V, int D, int n_tables, int device,
           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int W = n_tables * D;
  const int n_pieces = (N + kPiece - 1) / kPiece;
  const int grid = (n_pieces + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sweep_pieces_kernel<T><<<grid, kThreads, 0, s>>>(tabs, ids, static_cast<const T*>(deltas),
                                                  head, tail, N, V, D, W, n_pieces);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_merge_kernel<T><<<grid, kThreads, 0, s>>>(tabs, ids, seg_end, head, tail, N, V, D, W,
                                                 n_pieces);
  return (int)cudaGetLastError();
}

}  // namespace

// tables: host array of n_tables device pointers to (V, D) tables of one
// dtype (0 = float32, 1 = bfloat16), updated in place.  ids (N,) int32
// sorted ascending, out-of-range ids replaced by V; deltas (N, n_tables *
// D) in the tables' dtype, row i the update of ids[i] (table t in columns
// t*D .. t*D + D - 1); seg_end (n_pieces,) int32, n_pieces = ceil(N /
// kPiece), kPiece = 64: for piece p (positions p*64 .. p*64 + 63) the end
// of the segment of equal ids holding its last position; head, tail (n_pieces,
// n_tables * D) fp32 scratch.  D % 4 == 0, n_tables <= 8.  Returns a
// cudaError_t code.
extern "C" int tossctr_sweep_piece() { return kPiece; }

extern "C" int tossctr_sweep_rows_add(const void* const* tables, int n_tables, const void* ids,
                                      const void* deltas, const void* seg_end, void* head,
                                      void* tail, int N, int V, int D, int dtype, int device,
                                      void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || N < 0 || V < 1 || D < 4 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Tables tabs{};
  for (int t = 0; t < n_tables; ++t) tabs.p[t] = const_cast<void*>(tables[t]);
  const int* i = static_cast<const int*>(ids);
  const int* se = static_cast<const int*>(seg_end);
  float* h = static_cast<float*>(head);
  float* tl = static_cast<float*>(tail);
  if (dtype == 0)
    return launch<float>(tabs, i, deltas, se, h, tl, N, V, D, n_tables, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(tabs, i, deltas, se, h, tl, N, V, D, n_tables, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
