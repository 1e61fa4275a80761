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
// the memory traffic.  What sets the time of the warp-unit kernel is the
// instruction issue of its FFMA chains and of the elementwise work of the
// 268M score elements (scale and bias, max, expf, sum, the division, the
// keep hash), all on the CUDA cores.
//
// Why FFMA chains and not the tensor cores (fused_mha.cu's forward runs
// on them): this kernel runs in every encoder layer of the training step,
// whose bf16 step `chip_smoke.py` holds against the same step with the
// kernels' plain versions on the card (CHECK_BANDS vs_plain).  That step
// moves 0.4-4.5% in its gradients when any of this forward's fp32 sums
// changes by one rounding (exp/step_sensitivity_probe.py): each such
// change turns some ReLU inputs of the QNN head that lie within rounding
// of 0 to the other sign, and each sends its row's gradient down another
// path.  While the check counts those flips, the forward has to give the
// plain version's bits: each sum is an FFMA chain in the order of the
// CUDA-core kernel below and of cuBLAS's fp32 products, and the softmax's
// row sum runs in their order too (mha_mma.cuh row_sum).  mma.sync sums
// in another order and rounds otherwise.  The same kernel with
// project_qkv_mma and query_tile_fwd in place of the chains is the
// tensor-core form, built by that probe.
//
// Design, bf16 at K <= 160 with a head of 4, 8, 12 or 16 columns and H
// heads padded to at most 64 columns (mha_qkv_fwd_chain; mha_mma.cuh): the
// TPU kernel packs heads into the matmul row dimension with head masks
// over the full D, a 128x128-MXU trick that costs 8x the FLOPs at dh=8;
// it is not copied.  Persistent blocks walk batch rows with Wqkv (bf16,
// each head's columns padded to 8 or 16: padded_col), bqkv and the bias (a
// bf16 (KP, ldp(KP)) tile, K padded to KP = 64, 128 or 160, -inf past K)
// resident in shared memory; a row's x comes in by cp.async into one of
// two buffers, so the next row's x loads while the current row computes.
// Per row: q, k, v = round(x Wqkv + b) into bf16 slabs (project_qkv_chain:
// 4 x 8 register tiles), then a warp takes one (16-query tile, head) unit
// at a time, any of the row (query_tile_fwd_chain): the scores and the
// softmax in registers in the C layout of the tensor-core units (the
// softmax stage is theirs: softmax_frag), round(p * keep) packed, P.V
// with the quad's probabilities passed by shuffles, the output rounded
// once into the q slab and sent out in 16-byte stores.  Three barriers a
// row, none between heads; no score buffer in shared memory; device
// memory sees x once and the output once.  8 warps and two blocks an SM at
// KP = 64, 16 warps and one block above (exp/attn_fwd_probe.py).
//
// fp32, and bf16 at the other shapes (mha_qkv_fwd_kernel): the tiled
// CUDA-core kernel.  One persistent block walks batch rows; Wqkv stays in
// shared memory for all its rows, and a row's x, q, k, v and one head's
// scores never leave shared memory.  The queries run in tiles of QT rows,
// the largest of {K4, 64, 32, 16, 8} whose layout fits a block's shared
// memory: the whole row (and the whole bias, staged once a block) while
// it fits (K = 64 and 80 in both dtypes); tiles of 64 rows at K = 120 and
// 152 (32 at K = 152 in fp32), whose bias rows are staged per tile from
// L2, so shared memory grows as QT x K, not K x K.  All products run in
// fp32 with 4x4 register tiles (16 FMAs per five shared loads); q and k
// are stored transposed (d-major) so the score tile reads them as float4
// rows without bank conflicts; the score rows use an odd stride for the
// P.V pass.
#include "mha_core.cuh"
#include "mha_mma.cuh"

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


// ---- bf16 at K <= 160: the warp-unit kernel ----

namespace tc {

using tossctr::mha_mma::Geo;
using tossctr::mha_mma::ldp;
using tossctr::ptx::bf16;
using tossctr::ptx::round_up;
using tossctr::ptx::row_stride;

// warps a block, and the blocks an SM its registers are sized for
template <int KP>
struct Form {
  static constexpr int kWarps = KP == 64 ? 8 : 16;
  static constexpr int kBlocks = KP == 64 ? 2 : 1;
  static constexpr int kThreads = kWarps * 32;
};

struct Layout {  // offsets in bytes
  int DP, LX, LW;
  int w, b, bias, x, q, total;
  __host__ __device__ Layout(const Geo& g, int KP) {
    DP = round_up(g.D, 16);  // x's columns, Wqkv's rows, padded with zeros
    LX = row_stride(DP);
    LW = row_stride(3 * g.NQ);
    w = 0;                                    // Wqkv (DP, 3 NQ) bf16
    b = w + DP * LW * 2;                      // bqkv (3 NQ) fp32
    bias = b + round_up(3 * g.NQ * 4, 16);    // (KP, ldp(KP)) bf16
    x = bias + KP * ldp(KP) * 2;              // two (KP, LX) buffers of x
    q = x + 2 * KP * LX * 2;                  // the q, k, v slabs
    total = q + 3 * KP * g.RS * 2;
  }
};

template <int KP, int DHP>
__global__ void __launch_bounds__(Form<KP>::kThreads, Form<KP>::kBlocks)
mha_qkv_fwd_chain(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                bf16* __restrict__ out, int B, int K, int D, int H, float scale, Dropout drop) {
  using namespace tossctr::mha_mma;
  constexpr int kWarpsF = Form<KP>::kWarps, kThreadsF = Form<KP>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(K, D, H);
  const Layout L(geo, KP);
  const int LX = L.LX, D3 = 3 * D, slab = KP * geo.RS;
  bf16* w_s = reinterpret_cast<bf16*>(smem + L.w);
  float* b_s = reinterpret_cast<float*>(smem + L.b);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + L.bias);
  bf16* x_s = reinterpret_cast<bf16*>(smem + L.x);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  const int tid = threadIdx.x, warp = tid >> 5, units = geo.QT * H;

  // zeros everywhere: pad rows and columns are never written with anything else
  for (int i = tid; i < L.total / 16; i += kThreadsF)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int i = tid; i < D * D3; i += kThreadsF) {
    const int d = i / D3;
    w_s[d * L.LW + padded_col(geo, i - d * D3)] = wqkv[i];
  }
  for (int i = tid; i < D3; i += kThreadsF) b_s[padded_col(geo, i)] = bqkv[i];
  stage_bias_tile<KP>(bias_s, bias, K);
  if ((int)blockIdx.x < B) stage_x(x_s, LX, x + (size_t)blockIdx.x * K * D, K, D);
  cp_async_commit();

  int it = 0;
  for (int row = blockIdx.x; row < B; row += gridDim.x, ++it) {
    const bf16* xb = x_s + (it & 1) * KP * LX;
    const int next = row + gridDim.x;
    cp_async_wait<0>();
    __syncthreads();  // this row's x is in; the previous row's output is stored
    if (next < B) stage_x(x_s + ((it + 1) & 1) * KP * LX, LX, x + (size_t)next * K * D, K, D);
    cp_async_commit();
    project_qkv_chain(xb, LX, w_s, L.LW, b_s, qs, qs + slab, qs + 2 * slab, geo);
    __syncthreads();
    for (int u = warp; u < units; u += kWarpsF) {
      const int tile = u % geo.QT, h = u / geo.QT;
      query_tile_fwd_chain<KP, DHP>(qs, qs + slab, qs + 2 * slab, bias_s, qs, geo, 16 * tile, h,
                                    row, scale, drop);
    }
    __syncthreads();  // every unit's output is in the q slab
    store_heads(out + (size_t)row * K * D, qs, geo);
  }
}

template <int KP, int DHP>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* bias, void* out,
           int B, int K, int D, int H, float scale, Dropout drop, int max_blocks, int device,
           void* stream) {
  const size_t smem = (size_t)Layout(Geo(K, D, H), KP).total;
  auto kern = mha_qkv_fwd_chain<KP, DHP>;
  int grid = 0;
  const int want = max_blocks > 0 && max_blocks < B ? max_blocks : B;
  cudaError_t e = tossctr::prepare_launch(kern, Form<KP>::kThreads, smem, want, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, Form<KP>::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
      B, K, D, H, scale, drop);
  return (int)cudaGetLastError();
}

// K padded to KP = 64, 128 or 160, the head to 8 or 16 columns
template <int KP>
int launch_kp(const void* x, const void* wqkv, const void* bqkv, const void* bias, void* out,
              int B, int K, int D, int H, float scale, Dropout drop, int max_blocks, int device,
              void* stream) {
  return D / H <= 8 ? launch<KP, 8>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop,
                                    max_blocks, device, stream)
                    : launch<KP, 16>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop,
                                     max_blocks, device, stream);
}

int launch_bf16(const void* x, const void* wqkv, const void* bqkv, const void* bias, void* out,
                int B, int K, int D, int H, float scale, Dropout drop, int max_blocks,
                int device, void* stream) {
  if (K <= 64)
    return launch_kp<64>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                         stream);
  if (K <= 128)
    return launch_kp<128>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                          stream);
  return launch_kp<160>(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                        stream);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace tc
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, bias and out share it;
// bqkv is float32).  Dropout: keep_thresh (0 = off), keep_scale, seed
// (common.cuh Dropout).  max_blocks: the most blocks the persistent grid
// may have (0: as many as fit on the SMs; the output does not depend on
// it).  unit_kernel: 1 runs the bf16 warp-unit kernel (mha_qkv_fwd_chain),
// which takes K <= 160, a head width D / H of 4, 8, 12 or 16 with H heads
// padded to at most 64 columns (mha_mma.cuh head_ok, kMaxKPFwd,
// kMaxFwdNQ), x 16-byte aligned where D is a multiple of 8 (else 8) and
// out 16-byte aligned where D / H is (else 8); 0 runs the tiled CUDA-core
// kernel (any K whose query tile fits a block, both dtypes), to which the
// warp-unit kernel is bit-equal.  A shape the kernel asked for does not
// take is refused before any launch.  Returns a cudaError_t code, 0 on
// success.
extern "C" int tossctr_fused_mha_qkv_fwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* bias, void* out, int B, int K, int D,
                                         int H, float scale, unsigned keep_thresh,
                                         float keep_scale, unsigned seed, int max_blocks,
                                         int unit_kernel, int dtype, int device, void* stream) {
  if (B < 0 || K < 1 || D < 4 || H < 1 || D % H != 0 || D % 4 != 0 || max_blocks < 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (unit_kernel) {
    if (dtype != 1 || !tossctr::mha_mma::fwd_unit_shape(tossctr::mha_mma::Geo(K, D, H)) ||
        !tc::aligned(x, D % 8 == 0 ? 16 : 8) || !tc::aligned(out, (D / H) % 8 == 0 ? 16 : 8))
      return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    return tc::launch_bf16(x, wqkv, bqkv, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                           stream);
  }
  if (B == 0) return 0;
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
