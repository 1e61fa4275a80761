// fused_mha_qkv forward: qkv projection + multi-head self-attention over
// the K selected tokens of one DARE encoder layer, for sm_90a.
//
// Replaces: tossctr_tpu/ops/pallas_attention.py fused_mha_qkv, forward
// pallas_call in _fwd_call_qkv (kernel _attn_fwd_kernel_packed_qkv; core
// _qkv_project / _packed_group_scores / _packed_attend_fwd).
//
// What it computes, per batch row b (x: (B, K, D), H heads of width
// dh = D / H):
//   q, k, v = round_T(x[b] @ Wqkv + bqkv)             (fp32 sums)
//   s_h     = (q_h k_h^T) * scale + bias               (fp32, bias (K, K))
//   p_h     = round_T(softmax(s_h) * keep_h)           (fp32 softmax and product)
//   out[b]  = round_T(concat_h(p_h @ v_h))             (fp32 sums)
// which are the rounding points of the Pallas kernel.  keep_h is the
// counter-hash dropout mask of (b, query, key, h, seed) scaled by 1/(1-p)
// (common.cuh Dropout); without dropout it is 1 and is not computed.
//
// What bounds it on the card: at the flagship shapes (B=8192, K=64,
// D=64, H=8) one call reads 67 MB and writes 67 MB (~40 us at 3.35 TB/s)
// and does 21.5 GFLOP (~22 us on the bf16 tensor cores), so the floor is
// the memory traffic.
//
// Design: the TPU kernel packs heads into the matmul row dimension with
// head masks over the full D, a 128x128-MXU trick that costs 8x the
// FLOPs at dh=8; it is not copied.  Here one persistent block walks batch
// rows; Wqkv stays in shared memory for all its rows, and a row's x, q,
// k, v and one head's scores never leave shared memory, so device memory
// sees x once and the output once.  The queries run in tiles of QT rows,
// the largest of {K4, 64, 32, 16, 8} whose layout fits a block's shared
// memory: the whole row (and the whole bias, staged once a block) while
// it fits (K = 64 and 80 in both dtypes); tiles of 64 rows at K = 120 and
// 152 (32 at K = 152 in fp32), whose bias rows are staged per tile from
// L2, so shared memory grows as QT x K, not K x K.  All products
// run on the CUDA cores in fp32 with 4x4 register tiles (16 FMAs per
// five shared loads).  q and k are stored transposed (d-major) so the
// score tile reads them as float4 rows without bank conflicts; the score
// rows use an odd stride for the P.V pass.  The simple fp32-FMA design
// leaves the tensor cores idle: that is the next step for speed.
#include "mha_core.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::to_f;
using tossctr::mha::kThreads;

// Shared memory of a block, in floats: Wqkv and bqkv, the bias rows of
// one query tile, the row's q, k (transposed) and v, and a region that
// holds the row's x for the projection and then a query tile's scores.
struct Layout {
  int K4, XS, KS, QT;                          // padded rows, x stride, score stride, query tile
  int w, b, bias, qT, kT, v, xs, total;        // offsets in floats
  __host__ __device__ Layout(int K, int D, int elem_bytes, int QT_) {
    K4 = align4(K);
    XS = D + 1;
    KS = K + 1;
    QT = QT_;
    const int w_floats = align4((D * 3 * D * elem_bytes + 3) / 4);
    w = 0;
    b = w + w_floats;
    bias = b + align4(3 * D);
    qT = bias + align4(QT * K);
    kT = qT + D * K4;
    v = kT + D * K4;
    xs = v + K4 * D;
    const int union_floats = K4 * XS > QT * KS ? K4 * XS : QT * KS;
    total = xs + align4(union_floats);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_qkv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                   const float* __restrict__ bqkv, const T* __restrict__ bias,
                   T* __restrict__ out, int B, int K, int D, int H, int QT, float scale,
                   Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(K, D, (int)sizeof(T), QT);
  const int D3 = 3 * D;
  const int dh = D / H;
  const int K4 = L.K4, XS = L.XS, KS = L.KS;
  const bool resident = QT >= K;  // one tile: the bias is staged once
  T* w_s = reinterpret_cast<T*>(smem + L.w);
  float* b_s = smem + L.b;
  float* bias_s = smem + L.bias;  // (QT, K): the bias rows of one query tile
  float* qT = smem + L.qT;  // (D, K4): q transposed
  float* kT = smem + L.kT;  // (D, K4): k transposed
  float* v_s = smem + L.v;  // (K4, D)
  float* x_s = smem + L.xs; // (K4, XS): the row's input ...
  float* s_s = smem + L.xs; // (QT, KS): ... later one head's scores / probabilities
  const int tid = threadIdx.x;

  for (int i = tid; i < D * D3; i += kThreads) w_s[i] = wqkv[i];
  for (int i = tid; i < D3; i += kThreads) b_s[i] = bqkv[i];
  if (resident)
    for (int i = tid; i < K * K; i += kThreads) bias_s[i] = to_f<T>(bias[i]);

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const size_t off = (size_t)row * K * D;
    __syncthreads();  // previous row's last head is done with s_s / v_s
    tossctr::mha::load_rows(x + off, K, D, K4, XS, x_s);
    __syncthreads();
    tossctr::mha::project_qkv<T>(x_s, XS, w_s, b_s, K4, D, qT, kT, v_s, D);
    for (int q0 = 0; q0 < K; q0 += QT) {
      const int n = min(QT, K - q0);
      if (!resident) {
        __syncthreads();  // the previous tile's last head is done with bias_s
        for (int i = tid; i < n * K; i += kThreads) bias_s[i] = to_f<T>(bias[q0 * K + i]);
        __syncthreads();
      }
      for (int h = 0; h < H; ++h)
        tossctr::mha::head_fwd<T>(qT, kT, bias_s, v_s, D, s_s, KS, q0, n, K, K4, D, h * dh, dh,
                                  scale, row, h, drop, out + off);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* bias, void* out,
           int B, int K, int D, int H, float scale, Dropout drop, int max_blocks, int device,
           void* stream) {
  const int QT = tossctr::mha::pick_query_tile(
      align4(K), tossctr::smem_optin(device),
      [&](int qt) { return Layout(K, D, (int)sizeof(T), qt); });
  if (QT == 0) return (int)cudaErrorInvalidValue;  // no tile fits: refused before launch
  const size_t smem = (size_t)Layout(K, D, (int)sizeof(T), QT).total * sizeof(float);
  auto kern = mha_qkv_fwd_kernel<T>;
  int grid = 0;
  const int want = max_blocks > 0 && max_blocks < B ? max_blocks : B;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, want, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(bias), static_cast<T*>(out), B, K, D, H, QT, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, bias and out share it;
// bqkv is float32).  Dropout: keep_thresh (0 = off), keep_scale, seed
// (common.cuh Dropout).  max_blocks: the most blocks the persistent grid
// may have (0: as many as fit on the SMs; the output does not depend on
// it).  Returns a cudaError_t code, 0 on success.
extern "C" int tossctr_fused_mha_qkv_fwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* bias, void* out, int B, int K, int D,
                                         int H, float scale, unsigned keep_thresh,
                                         float keep_scale, unsigned seed, int max_blocks,
                                         int dtype, int device, void* stream) {
  if (B < 0 || K < 1 || D < 4 || H < 1 || D % H != 0 || D % 4 != 0 || max_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (dtype == 0)
    return launch<float>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, max_blocks,
                                 device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
