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
// a sum over the batch rows and heads in fp32.  Any K <= 64: the softmax
// runs over the K real key columns (mha_core.cuh), and rows >= K add
// nothing to dbias.
//
// What bounds it on the card: at the flagship shapes (B=8192, K=64, D=64,
// H=8, bf16) one call reads q, k, v and do (268 MB) and writes dq, dk and
// dv (201 MB), ~140 us at 3.35 TB/s, and does ~21.5 GFLOP (~22 us on the
// bf16 tensor cores): the floor is the memory traffic.
//
// Design: fused_mha_qkv_bwd.cu without the projection; both run each
// head through mha_core.cuh head_bwd.  One persistent
// block an SM walks batch rows; a row's q, k, v, do, one head's (K, K) P
// and dS, and the row's dq, dk, dv never leave shared memory (dv takes
// v's place head by head, once the head's dP is done), and dq, dk, dv
// leave as coalesced rows at the end of the row.  dbias lives in shared
// memory with one owner thread per entry; at the end every block writes
// its fp32 partial sum to a scratch buffer and a second kernel
// (common.cuh reduce_partials) adds the partials in block order, so the
// result repeats bit for bit (fp32 atomics would not).  Products run on
// the CUDA cores in fp32; the tensor cores are the next step for speed.
#include "mha_core.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::to_f;
using tossctr::mha::kThreads;

constexpr int kMaxDim = 64;  // D <= 64 and K <= 64

struct Layout {
  int K4, KS, VS;
  int bias, dbias, qT, kT, v, dout, dq, dk, p, ds, total;  // offsets in floats
  __host__ __device__ Layout(int K, int D) {
    K4 = align4(K);
    KS = K + 1;  // P and dS row stride
    VS = D + 1;  // row stride of v, do, dq, dk, dv
    bias = 0;
    dbias = bias + align4(K * K);
    qT = dbias + align4(K * K);
    kT = qT + D * K4;
    v = kT + D * K4;  // v, each head's columns replaced by dv
    dout = v + align4(K4 * VS);
    dq = dout + align4(K4 * VS);
    dk = dq + align4(K4 * VS);
    p = dk + align4(K4 * VS);
    ds = p + align4(K4 * KS);
    total = ds + align4(K4 * KS);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ bias, const T* __restrict__ dout, T* __restrict__ dq,
               T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partials, int B,
               int K, int D, int H, float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(K, D);
  const int dh = D / H;
  const int K4 = L.K4, KS = L.KS, VS = L.VS;
  float* bias_s = smem + L.bias;
  float* dbias_s = smem + L.dbias;
  float* qT = smem + L.qT;    // (D, K4): q transposed
  float* kT = smem + L.kT;    // (D, K4): k transposed
  float* v_s = smem + L.v;    // (K4, VS): v, each head's columns replaced by dv
  float* do_s = smem + L.dout;
  float* dq_s = smem + L.dq;  // fp32, rounded where written out
  float* dk_s = smem + L.dk;
  float* p_s = smem + L.p;    // (K4, KS): P, then round_T(P * keep)
  float* ds_s = smem + L.ds;  // (K4, KS): dp * keep, then round_T(ds * scale)
  const int tid = threadIdx.x;

  for (int i = tid; i < K * K; i += kThreads) {
    bias_s[i] = to_f<T>(bias[i]);
    dbias_s[i] = 0.f;
  }

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const size_t off = (size_t)row * K * D;
    __syncthreads();  // the previous row is done with every buffer
    tossctr::mha::load_transposed(q + off, K, D, K4, qT);
    tossctr::mha::load_transposed(k + off, K, D, K4, kT);
    tossctr::mha::load_rows(v + off, K, D, K4, VS, v_s);
    tossctr::mha::load_rows(dout + off, K, D, K4, VS, do_s);
    __syncthreads();

    for (int h = 0; h < H; ++h)
      tossctr::mha::head_bwd<T>(qT, kT, bias_s, v_s, do_s, dq_s, dk_s, VS, p_s, ds_s, KS,
                                dbias_s, K, K4, h * dh, dh, scale, row, h, drop);

    // ---- dq, dk, dv = round_T(...), as coalesced rows ----
    for (int i = tid; i < K * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      dq[off + i] = from_f<T>(dq_s[r * VS + c]);
      dk[off + i] = from_f<T>(dk_s[r * VS + c]);
      dv[off + i] = from_f<T>(v_s[r * VS + c]);
    }
  }

  // ---- this block's partial dbias (K, K) ----
  __syncthreads();
  float* part = partials + (size_t)blockIdx.x * K * K;
  for (int i = tid; i < K * K; i += kThreads) part[i] = dbias_s[i];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* dout,
           void* dq, void* dk, void* dv, float* partials, float* dbias, int blocks, int B, int K,
           int D, int H, float scale, Dropout drop, int device, void* stream) {
  const Layout L(K, D);
  const size_t smem = (size_t)L.total * sizeof(float);
  int grid = 0;  // = blocks; sets the shared-memory cap and checks that a block fits
  cudaError_t e = tossctr::prepare_launch(mha_bwd_kernel<T>, kThreads, smem, blocks, device, 0,
                                          &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mha_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), partials, B, K, D, H, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, blocks, K * K, dbias, s);
}

bool shape_ok(int B, int K, int D, int H) {
  return B >= 0 && K >= 1 && K <= kMaxDim && D >= 1 && D <= kMaxDim && H >= 1 && D % H == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, do, dq, dk and dv
// share it).  blocks: the grid, one block an SM (each walks batch rows
// with a stride of the grid; a block with none writes zeros).  partials:
// (blocks, K*K) fp32 scratch; dbias: (K, K) fp32 out.  Dropout:
// keep_thresh (0 = off), keep_scale, seed, as the forward got them.
// K <= 64, D <= 64.  Returns a cudaError_t code.
extern "C" int tossctr_fused_mha_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* dout, void* dq, void* dk,
                                     void* dv, void* partials, void* dbias, int blocks, int B,
                                     int K, int D, int H, float scale, unsigned keep_thresh,
                                     float keep_scale, unsigned seed, int dtype, int device,
                                     void* stream) {
  if (!shape_ok(B, K, D, H) || blocks < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  float* p = static_cast<float*>(partials);
  float* g = static_cast<float*>(dbias);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, dout, dq, dk, dv, p, g, blocks, B, K, D, H, scale, drop,
                         device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, p, g, blocks, B, K, D, H,
                                 scale, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
