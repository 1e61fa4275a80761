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
// rows; Wqkv and the bias stay in shared memory for all its rows, and a
// row's x, q, k, v and one head's (K, K) scores never leave shared
// memory, so device memory sees x once and the output once.  All products
// run on the CUDA cores in fp32 with 4x4 register tiles (16 FMAs per
// five shared loads).  q and k are stored transposed (d-major) so the
// score tile reads them as float4 rows without bank conflicts; the score
// rows use an odd stride for the P.V pass.  The simple fp32-FMA design
// leaves the tensor cores idle: that is the next step for speed.
#include "common.cuh"

namespace {

using tossctr::align4;
using tossctr::Dropout;
using tossctr::from_f;
using tossctr::load4;
using tossctr::round_t;
using tossctr::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Layout {
  int K4, XS, KS;                               // padded rows, x stride, score stride
  int w, b, bias, qT, kT, v, xs, total;        // offsets in floats
  __host__ __device__ Layout(int K, int D, int elem_bytes) {
    K4 = align4(K);
    XS = D + 1;
    KS = K + 1;
    const int w_floats = align4((D * 3 * D * elem_bytes + 3) / 4);
    w = 0;
    b = w + w_floats;
    bias = b + align4(3 * D);
    qT = bias + align4(K * K);
    kT = qT + D * K4;
    v = kT + D * K4;
    xs = v + K4 * D;
    const int union_floats = K4 * XS > K4 * KS ? K4 * XS : K4 * KS;
    total = xs + align4(union_floats);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_qkv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                   const float* __restrict__ bqkv, const T* __restrict__ bias,
                   T* __restrict__ out, int B, int K, int D, int H, float scale,
                   Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(K, D, (int)sizeof(T));
  const int D3 = 3 * D;
  const int dh = D / H;
  const int K4 = L.K4, XS = L.XS, KS = L.KS;
  T* w_s = reinterpret_cast<T*>(smem + L.w);
  float* b_s = smem + L.b;
  float* bias_s = smem + L.bias;
  float* qT = smem + L.qT;  // (D, K4): q transposed
  float* kT = smem + L.kT;  // (D, K4): k transposed
  float* v_s = smem + L.v;  // (K4, D)
  float* x_s = smem + L.xs; // (K4, XS): the row's input ...
  float* s_s = smem + L.xs; // (K4, KS): ... later one head's scores / probabilities
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < D * D3; i += kThreads) w_s[i] = wqkv[i];
  for (int i = tid; i < D3; i += kThreads) b_s[i] = bqkv[i];
  for (int i = tid; i < K * K; i += kThreads) bias_s[i] = to_f<T>(bias[i]);

  const int CT = D3 / 4;             // projection column tiles
  const int proj_tiles = (K4 / 4) * CT;
  const int KT = K4 / 4;             // score tiles per side
  const int pv_tiles = (K4 / 2) * dh;

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const T* xr = x + (size_t)row * K * D;
    T* outr = out + (size_t)row * K * D;
    __syncthreads();  // previous row's last head is done with s_s / v_s
    for (int i = tid; i < K4 * D; i += kThreads) {
      const int k = i / D, d = i - k * D;
      x_s[k * XS + d] = k < K ? to_f<T>(xr[i]) : 0.f;
    }
    __syncthreads();

    // ---- q, k, v = round_T(x @ Wqkv + b): 4x4 register tiles ----
    for (int t = tid; t < proj_tiles; t += kThreads) {
      const int k0 = (t / CT) * 4, c0 = (t % CT) * 4;
      float acc[4][4] = {};
      for (int d = 0; d < D; ++d) {
        float w[4];
        load4(w_s + d * D3 + c0, w);
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = x_s[(k0 + i) * XS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], w[j], acc[i][j]);
      }
      const int which = c0 / D, col0 = c0 - which * D;  // D % 4 == 0: one stream per tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bj = b_s[c0 + j];
        const int col = col0 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float val = round_t<T>(__fadd_rn(acc[i][j], bj));
          const int k = k0 + i;
          if (which == 0)
            qT[col * K4 + k] = val;
          else if (which == 1)
            kT[col * K4 + k] = val;
          else
            v_s[k * D + col] = val;
        }
      }
    }
    __syncthreads();

    for (int h = 0; h < H; ++h) {
      const int hd = h * dh;
      // ---- scores: s = (q_h k_h^T) * scale + bias, fp32 ----
      for (int t = tid; t < KT * KT; t += kThreads) {
        const int i0 = (t / KT) * 4, j0 = (t % KT) * 4;
        float acc[4][4] = {};
        for (int e = 0; e < dh; ++e) {
          float qv[4], kv[4];
          load4(qT + (hd + e) * K4 + i0, qv);
          load4(kT + (hd + e) * K4 + j0, kv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = i0 + i;
          if (qi >= K) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = j0 + j;
            if (kj < K)
              s_s[qi * KS + kj] = __fadd_rn(__fmul_rn(acc[i][j], scale), bias_s[qi * K + kj]);
          }
        }
      }
      __syncthreads();

      // ---- fp32 softmax per query row (one warp a row), times the keep
      // mask in fp32, then rounded to T ----
      for (int qi = warp; qi < K; qi += kWarps) {
        float* sr = s_s + qi * KS;
        float m = __int_as_float(0xff800000);  // -inf
        for (int j = lane; j < K; j += 32) m = fmaxf(m, sr[j]);
        m = tossctr::warp_max(m);
        float sum = 0.f;
        for (int j = lane; j < K; j += 32) {
          const float e = expf(sr[j] - m);
          sr[j] = e;
          sum += e;
        }
        sum = tossctr::warp_sum(sum);
        if (drop.on()) {
          for (int j = lane; j < K; j += 32)
            sr[j] = round_t<T>(__fmul_rn(__fdiv_rn(sr[j], sum), drop.attn(row, qi, j, h)));
        } else {
          for (int j = lane; j < K; j += 32) sr[j] = round_t<T>(__fdiv_rn(sr[j], sum));
        }
      }
      __syncthreads();

      // ---- o_h = p_h @ v_h: 2-row x 1-column tiles ----
      for (int t = tid; t < pv_tiles; t += kThreads) {
        const int i0 = (t / dh) * 2, e = t % dh;
        const float* p0 = s_s + i0 * KS;
        const float* p1 = p0 + KS;
        const float* vc = v_s + hd + e;
        float a0 = 0.f, a1 = 0.f;
        for (int j = 0; j < K; ++j) {
          const float vv = vc[j * D];
          a0 = fmaf(p0[j], vv, a0);
          a1 = fmaf(p1[j], vv, a1);
        }
        if (i0 < K) outr[i0 * D + hd + e] = from_f<T>(a0);
        if (i0 + 1 < K) outr[(i0 + 1) * D + hd + e] = from_f<T>(a1);
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* bias, void* out,
           int B, int K, int D, int H, float scale, Dropout drop, int device, void* stream) {
  const Layout L(K, D, (int)sizeof(T));
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kern = mha_qkv_fwd_kernel<T>;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, B, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const T*>(bias), static_cast<T*>(out), B, K, D, H, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, bias and out share it;
// bqkv is float32).  Dropout: keep_thresh (0 = off), keep_scale, seed
// (common.cuh Dropout).  Returns a cudaError_t code, 0 on success.
extern "C" int tossctr_fused_mha_qkv_fwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* bias, void* out, int B, int K, int D,
                                         int H, float scale, unsigned keep_thresh,
                                         float keep_scale, unsigned seed, int dtype, int device,
                                         void* stream) {
  if (B < 0 || K < 1 || D < 4 || H < 1 || D % H != 0 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (dtype == 0)
    return launch<float>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, device,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tossctr_fused_mha_qkv_smem_bytes(int K, int D, int dtype) {
  const Layout L(K, D, dtype == 1 ? 2 : 4);
  return L.total * (int)sizeof(float);
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
