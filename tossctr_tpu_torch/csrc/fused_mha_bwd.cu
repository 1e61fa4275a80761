// fused_mha backward: gradients of multi-head attention on
// already-projected q, k, v (the attention core of MultiHeadSelfAttention
// with fuse_qkv off), for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_attention.py fused_mha, backward
// pallas_call in _bwd_call (kernels _attn_bwd_kernel_packed, the default
// geometry, and _attn_bwd_kernel; core _packed_group_scores /
// _packed_attend_bwd).
//
// What it computes, per batch row b (q, k, v, do: (B, K, D); H heads of
// width dh = D / H), with the rounding points of the Pallas kernels:
//   p_h    = softmax(q_h k_h^T * scale + bias)            (fp32, not rounded)
//   dv_h   = round_T(round_T(p_h * keep_h)^T @ do_h)
//   dp_h   = (do_h @ v_h^T) * keep_h
//   ds_h   = p_h * (dp_h - rowsum(dp_h * p_h))            (fp32)
//   dbias += ds_h                                          (unscaled, fp32)
//   dk_h   = round_T(round_T(ds_h * scale)^T @ q_h)
//   dq_h   = round_T(round_T(ds_h * scale) @ k_h)
// keep_h is the forward's counter-hash mask, regenerated here.  dbias is
// a sum over the batch rows and heads in fp32.  Any K: the softmax runs
// over the K real key columns (mha_core.cuh), and rows >= K add nothing
// to dbias.
//
// What bounds it on the card: at the flagship shapes (B=8192, K=64, D=64,
// H=8, bf16) one call reads q, k, v and do (268 MB) and writes dq, dk and
// dv (201 MB), ~140 us at 3.35 TB/s, and does ~21.5 GFLOP (~22 us on the
// bf16 tensor cores): the floor is the memory traffic.
//
// Design: one head at a time (mha_core.cuh head_bwd_tiled): a persistent
// block walks batch rows, stages a head's q, k, v and do as (dh, K4) fp32
// tensors, walks its queries in tiles of QT rows (the largest of {K4, 64,
// 32, 16, 8} whose layout fits: the whole row up to K = 120, 64 rows at
// K = 152), so shared memory grows as QT x K, sums dv and dk over the
// tiles in query order, and writes the head's dq, dk, dv.  The block's
// dbias partial lives in device memory (one read-modify-write an entry a
// row and head, by one thread); a second kernel (common.cuh
// reduce_partials) adds the blocks' partials in block order, so the
// result repeats bit for bit (fp32 atomics would not).  At K = 64 this
// runs 27% faster than a row-resident form (a row's whole q, k, v, do, P
// and dS in 165 KB of shared memory, one block an SM): the smaller
// per-head footprint lets two blocks share an SM.
// Products run on the CUDA cores in fp32; the tensor cores are the next
// step for speed.
#include "mha_core.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::to_f;
using tossctr::mha::kThreads;

constexpr int kMaxDim = 64;  // D <= 64

// Shared memory of the key-tiled kernel, in floats: a query tile's bias
// rows, P and dS, and one head's seven (dh, K4) tensors.
struct TiledLayout {
  int K4, KS, QT;
  int bias, p, ds, heads, total;  // offsets in floats
  __host__ __device__ TiledLayout(int K, int dh, int QT_) {
    K4 = align4(K);
    KS = K + 1;
    QT = QT_;
    bias = 0;
    p = bias + align4(QT * K);
    ds = p + align4(QT * KS);
    heads = ds + align4(QT * KS);
    total = heads + tossctr::mha::kHeadTensors * dh * K4;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_bwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ bias, const T* __restrict__ dout,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ partials, int B, int K, int D, int H, int QT,
                     float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int dh = D / H;
  const TiledLayout L(K, dh, QT);
  const int K4 = L.K4;
  const bool resident = QT >= K;  // one tile: the bias is staged once
  float* bias_s = smem + L.bias;
  const tossctr::mha::HeadTiles a(smem + L.heads, dh, K4);
  float* dbias = partials + (size_t)blockIdx.x * K * K;  // this block's partial
  const int tid = threadIdx.x;

  for (int i = tid; i < K * K; i += kThreads) {
    dbias[i] = 0.f;
    if (resident) bias_s[i] = to_f<T>(bias[i]);
  }

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const size_t off = (size_t)row * K * D;
    for (int h = 0; h < H; ++h) {
      const int hd = h * dh;
      __syncthreads();  // the previous head is done with the head's tensors
      tossctr::mha::load_head(q + off, K, D, K4, hd, dh, a.qT);
      tossctr::mha::load_head(k + off, K, D, K4, hd, dh, a.kT);
      tossctr::mha::load_head(v + off, K, D, K4, hd, dh, a.vT);
      tossctr::mha::load_head(dout + off, K, D, K4, hd, dh, a.doT);
      tossctr::mha::head_bwd_tiled<T>(a, bias, bias_s, resident, smem + L.p, smem + L.ds, L.KS,
                                      QT, dbias, K, K4, dh, scale, row, h, drop);
      // ---- the head's dq, dk, dv = round_T(...) ----
      for (int i = tid; i < K * dh; i += kThreads) {
        const int r = i / dh, e = i - r * dh;
        const size_t o = off + (size_t)r * D + hd + e;
        dq[o] = from_f<T>(a.dqT[e * K4 + r]);
        dk[o] = from_f<T>(a.dkT[e * K4 + r]);
        dv[o] = from_f<T>(a.dvT[e * K4 + r]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* dout,
           void* dq, void* dk, void* dv, float* partials, float* dbias, int max_blocks, int B,
           int K, int D, int H, float scale, Dropout drop, int device, void* stream) {
  const int dh = D / H;
  const int QT = tossctr::mha::pick_query_tile(align4(K), tossctr::smem_optin(device),
                                               [&](int qt) { return TiledLayout(K, dh, qt); });
  if (QT == 0) return (int)cudaErrorInvalidValue;  // no tile fits: refused before launch
  const size_t smem = (size_t)TiledLayout(K, dh, QT).total * sizeof(float);
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(mha_bwd_tiled_kernel<T>, kThreads, smem, max_blocks,
                                          device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mha_bwd_tiled_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), partials, B, K, D, H, QT, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, grid, K * K, dbias, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, do, dq, dk and dv
// share it).  max_blocks: the most blocks the grid may have (persistent
// blocks, as many as fit on the SMs, each walking batch rows with a
// stride of the grid; a block with none writes zeros).  partials:
// (max_blocks, K*K) fp32 scratch; dbias: (K, K) fp32 out.  Dropout:
// keep_thresh (0 = off), keep_scale, seed, as the forward got them.
// D <= 64.  Returns a cudaError_t code; a shape whose layout does not fit
// a block's shared memory is refused before any launch.
extern "C" int tossctr_fused_mha_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* dout, void* dq, void* dk,
                                     void* dv, void* partials, void* dbias, int max_blocks,
                                     int B, int K, int D, int H, float scale,
                                     unsigned keep_thresh, float keep_scale, unsigned seed,
                                     int dtype, int device, void* stream) {
  if (B < 0 || K < 1 || D < 1 || D > kMaxDim || H < 1 || D % H != 0 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  float* p = static_cast<float*>(partials);
  float* g = static_cast<float*>(dbias);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, dout, dq, dk, dv, p, g, max_blocks, B, K, D, H, scale,
                         drop, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, p, g, max_blocks, B, K, D, H,
                                 scale, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
