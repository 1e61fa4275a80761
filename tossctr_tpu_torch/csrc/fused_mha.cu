// fused_mha forward: multi-head attention over the K selected tokens on
// already-projected q, k, v (the attention core of
// MultiHeadSelfAttention with fuse_qkv off), for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_attention.py fused_mha, forward
// pallas_call in _fwd_call (kernels _attn_fwd_kernel_packed, the default
// geometry, and _attn_fwd_kernel; core _packed_group_scores /
// _packed_attend_fwd).
//
// What it computes, per batch row b (q, k, v: (B, K, D), H heads of width
// dh = D / H):
//   s_h    = (q_h k_h^T) * scale + bias            (fp32, bias (K, K))
//   p_h    = round_T(softmax(s_h) * keep_h)        (fp32 softmax and product)
//   out[b] = round_T(concat_h(p_h @ v_h))          (fp32 sums)
// which are the rounding points of the Pallas kernels.  keep_h is the
// counter-hash dropout mask of (b, query, key, h, seed) scaled by 1/(1-p)
// (common.cuh Dropout::attn), the mask the packed and loop kernels both
// draw; without dropout it is 1 and is not computed.  Any K: the softmax
// runs over the K real key columns (mha_core.cuh).  The queries run in
// tiles of QT rows, the largest of {K4, 64, 32, 16, 8} whose layout fits
// a block's shared memory (the whole row up to K = 120 in bf16 and fp32,
// 64 rows at K = 152), so shared memory grows as QT x K, not K x K.
//
// What bounds it on the card: at the flagship shapes (B=8192, K=64, D=64,
// H=8, bf16) one call reads q, k and v (201 MB) and writes the output
// (67 MB), ~80 us at 3.35 TB/s, and does 8.6 GFLOP (~9 us on the bf16
// tensor cores): the floor is the memory traffic.
//
// Design: fused_mha_qkv.cu without the projection; both run each head
// through mha_core.cuh head_fwd.  Persistent blocks
// (as many as fit on the SMs) walk batch rows; the bias stays in shared
// memory for all of a block's rows when one tile covers the row (else a
// tile's bias rows are staged per tile, from L2), and a row's q, k, v and
// one head's (QT, K) scores never leave shared memory, so device memory sees q, k, v
// once and the output once.  Products run on the CUDA cores in fp32 with
// 4x4 register tiles for the scores and 2x1 tiles for P.V; the tensor
// cores are the next step for speed.
#include "mha_core.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::to_f;
using tossctr::mha::kThreads;

// Shared memory of a block, in floats: the bias rows of one query tile
// and its scores (QT rows each), and the row's q, k (transposed) and v.
struct Layout {
  int K4, KS, QT;
  int bias, qT, kT, v, s, total;  // offsets in floats
  __host__ __device__ Layout(int K, int D, int QT_) {
    K4 = align4(K);
    KS = K + 1;  // score row stride: odd, for the P.V pass
    QT = QT_;
    bias = 0;
    qT = bias + align4(QT * K);
    kT = qT + D * K4;
    v = kT + D * K4;
    s = v + K4 * D;
    total = s + align4(QT * KS);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ bias, T* __restrict__ out, int B, int K, int D, int H,
               int QT, float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(K, D, QT);
  const int dh = D / H;
  const int K4 = L.K4, KS = L.KS;
  const bool resident = QT >= K;  // one tile: the bias is staged once
  float* bias_s = smem + L.bias;  // (QT, K): the bias rows of one query tile
  float* qT = smem + L.qT;  // (D, K4): q transposed
  float* kT = smem + L.kT;  // (D, K4): k transposed
  float* v_s = smem + L.v;  // (K4, D)
  float* s_s = smem + L.s;  // (QT, KS): one head's scores, then probabilities
  const int tid = threadIdx.x;

  if (resident)
    for (int i = tid; i < K * K; i += kThreads) bias_s[i] = to_f<T>(bias[i]);

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const size_t off = (size_t)row * K * D;
    T* outr = out + off;
    __syncthreads();  // the previous row's last head is done with v_s / s_s
    tossctr::mha::load_transposed(q + off, K, D, K4, qT);
    tossctr::mha::load_transposed(k + off, K, D, K4, kT);
    tossctr::mha::load_rows(v + off, K, D, K4, D, v_s);
    for (int q0 = 0; q0 < K; q0 += QT) {
      const int n = min(QT, K - q0);
      if (!resident) {
        __syncthreads();  // the previous tile's last head is done with bias_s
        for (int i = tid; i < n * K; i += kThreads) bias_s[i] = to_f<T>(bias[q0 * K + i]);
      }
      __syncthreads();
      for (int h = 0; h < H; ++h)
        tossctr::mha::head_fwd<T>(qT, kT, bias_s, v_s, D, s_s, KS, q0, n, K, K4, D, h * dh, dh,
                                  scale, row, h, drop, outr);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int K, int D, int H, float scale, Dropout drop, int device, void* stream) {
  const int QT = tossctr::mha::pick_query_tile(align4(K), tossctr::smem_optin(device),
                                               [&](int qt) { return Layout(K, D, qt); });
  if (QT == 0) return (int)cudaErrorInvalidValue;  // no tile fits: refused before launch
  const size_t smem = (size_t)Layout(K, D, QT).total * sizeof(float);
  auto kern = mha_fwd_kernel<T>;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, B, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<T*>(out), B, K, D, H, QT, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias and out share it).
// Dropout: keep_thresh (0 = off), keep_scale, seed (common.cuh Dropout).
// Returns a cudaError_t code, 0 on success.
extern "C" int tossctr_fused_mha_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int B, int K, int D, int H,
                                     float scale, unsigned keep_thresh, float keep_scale,
                                     unsigned seed, int dtype, int device, void* stream) {
  if (B < 0 || K < 1 || D < 1 || H < 1 || D % H != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, out, B, K, D, H, scale, drop, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, out, B, K, D, H, scale, drop, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
