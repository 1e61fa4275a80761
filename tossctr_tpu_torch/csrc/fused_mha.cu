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
// runs over the K real key columns.
//
// What bounds it on the card: at the flagship shapes (B=8192, K=64, D=64,
// H=8, bf16) one call reads q, k and v (201 MB) and writes the output
// (67 MB), ~80 us at 3.35 TB/s, and does 8.6 GFLOP (~9 us on the bf16
// tensor cores): the floor is the memory traffic.  What sets the time of
// the tensor-core kernel is the elementwise work of the 268M score
// elements on the CUDA cores (scale and bias, max, expf, sum, the
// division, the keep hash and the packing: ~15-25 lane instructions an
// element), not the products.
//
// Design, bf16 at K <= 160 with a head of 4, 8, 12 or 16 columns and H
// heads padded to at most 64 columns (mha_fwd_mma; mha_mma.cuh): every
// product on the tensor cores (mma.sync, bf16 operands, fp32 sums).
// Persistent blocks walk batch rows.  The bias stays resident in shared
// memory as a bf16 (KP, ldp(KP)) tile (K padded to KP = 64, 128 or 160);
// a row's q, k and v come in whole by 16-byte cp.async into bf16 slabs
// (each head padded to 8 or 16 columns), two buffers of them, so the next
// row's slabs load while the current row computes.  A warp takes one
// (16-query tile, head) unit at a time, any unit of the row
// (mha_mma.cuh query_tile_fwd): the scores and the softmax in registers
// (tile_softmax, the backward's stage), round(p * keep) packed straight
// into the A fragments of P.V, the output rounded once into the q slab at
// the head's columns; no score buffer in shared memory, no barrier
// between heads, two barriers a row.  The output leaves the slab in
// 16-byte stores.
//
// fp32, and bf16 at the other shapes (mha_fwd_kernel): the CUDA cores,
// fused_mha_qkv.cu's CUDA-core kernel without the projection; both run
// each head through mha_core.cuh head_fwd.  The queries run in tiles of
// QT rows, the largest of {K4, 64, 32, 16, 8} whose layout fits a block's
// shared memory (the whole row up to K = 120 in bf16 and fp32, 64 rows at
// K = 152), so shared memory grows as QT x K, not K x K.  Persistent
// blocks (as many as fit on the SMs) walk batch rows; the bias stays in
// shared memory for all of a block's rows when one tile covers the row
// (else a tile's bias rows are staged per tile, from L2), and a row's q,
// k, v and one head's (QT, K) scores never leave shared memory, so device
// memory sees q, k, v once and the output once.  Products run in fp32
// with 4x4 register tiles for the scores and 2x1 tiles for P.V.
#include "mha_core.cuh"
#include "mha_mma.cuh"

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
           int K, int D, int H, float scale, Dropout drop, int max_blocks, int device,
           void* stream) {
  const int QT = tossctr::mha::pick_query_tile(align4(K), tossctr::smem_optin(device),
                                               [&](int qt) { return Layout(K, D, qt); });
  if (QT == 0) return (int)cudaErrorInvalidValue;  // no tile fits: refused before launch
  const size_t smem = (size_t)Layout(K, D, QT).total * sizeof(float);
  auto kern = mha_fwd_kernel<T>;
  int grid = 0;
  const int want = max_blocks > 0 && max_blocks < B ? max_blocks : B;
  cudaError_t e = tossctr::prepare_launch(kern, kThreads, smem, want, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<T*>(out), B, K, D, H, QT, scale, drop);
  return (int)cudaGetLastError();
}


// ---- bf16 at K <= 160: the tensor-core kernel ----

namespace tc {

using tossctr::mha_mma::Geo;
using tossctr::mha_mma::ldp;
using tossctr::ptx::bf16;

// warps a block, and the blocks an SM its registers are sized for
template <int KP>
struct Form {
  static constexpr int kWarps = KP == 64 ? 8 : 16;
  static constexpr int kBlocks = KP == 64 ? 2 : 1;
  static constexpr int kThreads = kWarps * 32;
};

struct Layout {  // offsets in bytes
  int slab, bias, buf, total;
  __host__ __device__ Layout(const Geo& g, int KP) {
    slab = KP * g.RS * 2;
    bias = 0;                       // (KP, ldp(KP)) bf16
    buf = bias + KP * ldp(KP) * 2;  // two buffers of q, k and v slabs
    total = buf + 2 * 3 * slab;
  }
};

template <int KP, int DHP>
__global__ void __launch_bounds__(Form<KP>::kThreads, Form<KP>::kBlocks)
mha_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ bias, bf16* __restrict__ out, int B, int K, int D, int H,
            float scale, Dropout drop) {
  using namespace tossctr::mha_mma;
  constexpr int kWarpsF = Form<KP>::kWarps, kThreadsF = Form<KP>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(K, D, H);
  const Layout L(geo, KP);
  const int slab = L.slab / 2;  // elements
  bf16* bias_s = reinterpret_cast<bf16*>(smem + L.bias);
  bf16* bufs = reinterpret_cast<bf16*>(smem + L.buf);
  const int tid = threadIdx.x, warp = tid >> 5, units = geo.QT * H;
  auto stage = [&](int row, bf16* dst) {  // a row's q, k, v into one buffer
    const size_t off = (size_t)row * K * D;
    stage_heads(dst, q + off, geo);
    stage_heads(dst + slab, k + off, geo);
    stage_heads(dst + 2 * slab, v + off, geo);
  };

  // zeros everywhere: pad rows and columns are never written with anything else
  for (int i = tid; i < L.total / 16; i += kThreadsF)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  stage_bias_tile<KP>(bias_s, bias, K);
  if ((int)blockIdx.x < B) stage(blockIdx.x, bufs);
  cp_async_commit();

  int it = 0;
  for (int row = blockIdx.x; row < B; row += gridDim.x, ++it) {
    bf16* cur = bufs + (it & 1) * 3 * slab;
    const int next = row + gridDim.x;
    cp_async_wait<0>();
    __syncthreads();  // this row's slabs are in; the previous row's output is stored
    if (next < B) stage(next, bufs + ((it + 1) & 1) * 3 * slab);
    cp_async_commit();
    for (int u = warp; u < units; u += kWarpsF) {
      const int tile = u % geo.QT, h = u / geo.QT;
      query_tile_fwd<KP, DHP>(cur, cur + slab, cur + 2 * slab, bias_s, cur, geo, 16 * tile, h, row,
                              scale, drop);
    }
    __syncthreads();  // every unit's output is in the q slab
    store_heads(out + (size_t)row * K * D, cur, geo);
  }
}

template <int KP, int DHP>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int K, int D, int H, float scale, Dropout drop, int max_blocks, int device,
           void* stream) {
  const size_t smem = (size_t)Layout(Geo(K, D, H), KP).total;
  auto kern = mha_fwd_mma<KP, DHP>;
  int grid = 0;
  const int want = max_blocks > 0 && max_blocks < B ? max_blocks : B;
  cudaError_t e = tossctr::prepare_launch(kern, Form<KP>::kThreads, smem, want, device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, Form<KP>::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, K, D, H, scale, drop);
  return (int)cudaGetLastError();
}

// K padded to KP = 64, 128 or 160, the head to 8 or 16 columns
template <int KP>
int launch_kp(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
              int K, int D, int H, float scale, Dropout drop, int max_blocks, int device,
              void* stream) {
  return D / H <= 8 ? launch<KP, 8>(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks,
                                    device, stream)
                    : launch<KP, 16>(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks,
                                     device, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
                int K, int D, int H, float scale, Dropout drop, int max_blocks, int device,
                void* stream) {
  if (K <= 64)
    return launch_kp<64>(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks, device, stream);
  if (K <= 128)
    return launch_kp<128>(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                          stream);
  return launch_kp<160>(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks, device, stream);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace tc
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias and out share it).
// Dropout: keep_thresh (0 = off), keep_scale, seed (common.cuh Dropout).
// max_blocks: the most blocks the persistent grid may have (0: as many as
// fit on the SMs; the output does not depend on it).  unit_kernel: 1
// runs the bf16 warp-unit kernel (mha_fwd_mma, the tensor cores), which
// takes K <= 160, a head width D / H of 4, 8, 12 or 16 with H heads padded
// to at most 64 columns (mha_mma.cuh head_ok, kMaxKPFwd, kMaxFwdNQ), and q,
// k, v and out 16-byte aligned (8 where D / H is not a multiple of 8); 0
// runs the tiled CUDA-core kernel (any K whose query tile fits a block,
// both dtypes).  A shape the kernel asked for does not take is refused
// before any launch.  Returns a cudaError_t code, 0 on success.
extern "C" int tossctr_fused_mha_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int B, int K, int D, int H,
                                     float scale, unsigned keep_thresh, float keep_scale,
                                     unsigned seed, int max_blocks, int unit_kernel, int dtype,
                                     int device, void* stream) {
  if (B < 0 || K < 1 || D < 1 || H < 1 || D % H != 0 || max_blocks < 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop(keep_thresh, keep_scale, seed);
  if (unit_kernel) {
    const int bytes = (D / H) % 8 == 0 ? 16 : 8;
    if (dtype != 1 || !tossctr::mha_mma::fwd_unit_shape(tossctr::mha_mma::Geo(K, D, H)))
      return (int)cudaErrorInvalidValue;
    const void* ptrs[] = {q, k, v, out};
    for (const void* p : ptrs)
      if (!tc::aligned(p, bytes)) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    return tc::launch_bf16(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                           stream);
  }
  if (B == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks, device,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, out, B, K, D, H, scale, drop, max_blocks,
                                 device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
