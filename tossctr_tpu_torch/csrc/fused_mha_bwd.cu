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
// a sum over the batch rows and heads in fp32.  Rows >= K add nothing to
// dbias.
//
// What bounds it on the card: at the flagship shapes (B=8192, K=64, D=64,
// H=8, bf16) one call reads q, k, v and do (268 MB) and writes dq, dk and
// dv (201 MB), ~140 us at 3.35 TB/s, and does ~21.5 GFLOP (~22 us on the
// bf16 tensor cores): the floor is the memory traffic.  In practice the
// elementwise work of the 268M score elements on the CUDA cores (the
// softmax's expf and division, the keep hash, ds, dbias; ~30 lane
// instructions an element, ~0.3 ms) sets it.
//
// Design, bf16 at K <= 160 (mha_bwd_mma; mha_mma.cuh): every product on
// the tensor cores (mma.sync, bf16 operands, fp32 sums).  Persistent
// blocks of 8 warps walk batch rows; a row's q, k, v and do come in whole
// with 16-byte cp.async into bf16 slabs, each head padded to 8 or 16
// columns, with no per-head transposing load.  A warp takes one
// (16-query tile, head) unit at a time: its scores and softmax in
// registers, dp twice in 16-key panels, the keep hash once an element,
// ds in registers, dq = round(ds * scale) k_h straight from them, and
// round(ds * scale), round(p * keep) to two bf16 buffers; after a barrier
// a warp takes one (16-key tile, head) unit: dk and dv by ldmatrix.trans
// of those buffers.  K is padded to 64, 128 or 160.  At 64 (the flagship)
// four query tiles x two heads fill the 8 warps, a row takes 4 pairs of
// barriers, and two blocks share an SM (92 KB, 128 registers); at 128
// (K = 120) eight query tiles x one head, 8 pairs, one block an SM (197
// KB, up to 255 registers).  dbias has one owner lane an entry: a warp
// always takes the same query tile.  Up to 128 it keeps its tile's sums
// in registers across heads and rows, and the copies are added in warp
// order into the block's partial once, at the end.  At 160 (K = 152) the
// scores alone take 80 registers a lane and 10 query tiles do not divide
// over 8 warps, so a block has 10 warps (up to 200 registers), one a
// query tile, the bias is read from device memory (its tile would not fit
// beside the slabs and the 10 warps' P and dS buffers: 218 KB), and each
// ds goes into the block's partial in device memory by its owner lane's
// atomics, in program order (~92 KB a block: it stays in L2).  dq, dk and
// dv leave through the slabs (dk and dv over k_h and
// v_h, which no unit reads any more) in 16-byte stores.  A second kernel
// (common.cuh reduce_partials) adds the blocks' partials in block order,
// so the result repeats bit for bit (fp32 atomics would not), and a row's
// dq, dk, dv do not depend on the grid.
//
// fp32, and bf16 above K = 160 or at 128 < K <= 160 with a head width or
// heads the tensor-core kernel does not take (mha_bwd_tiled_kernel): the
// CUDA cores, one head
// at a time (mha_core.cuh head_bwd_tiled): a persistent block walks batch
// rows, stages a head's q, k, v and do as (dh, K4) fp32 tensors, walks its
// queries in tiles of QT rows (the largest of {K4, 64, 32, 16, 8} whose
// layout fits: the whole row up to K = 120, 64 rows at K = 152), so shared
// memory grows as QT x K, sums dv and dk over the tiles in query order,
// and writes the head's dq, dk, dv; the block's dbias partial lives in
// device memory (one read-modify-write an entry a row and head, by one
// thread), reduced in block order as above.  Products in fp32 4x4
// register tiles.
#include "mha_core.cuh"
#include "mha_mma.cuh"

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


// ---- bf16 at K <= 160: the tensor-core kernel ----

namespace tc {

using tossctr::mha_mma::Geo;
using tossctr::mha_mma::kMaxKPRegs;
using tossctr::mha_mma::ldp;
using tossctr::ptx::bf16;

// The kernel's form: 8 warps up to KP = 128, the bias a resident tile and
// dbias in registers; at KP = 160 kWarpsWide, one a query tile, the bias
// read from device memory and dbias added into the block's partial there
template <int KP>
struct Form {
  static constexpr bool kWide = KP > kMaxKPRegs;
  static constexpr int kWarps = kWide ? tossctr::mha_mma::kWarpsWide : tossctr::mha_mma::kWarps;
  static constexpr int kThreads = kWarps * 32;
};

template <int KP>
struct Layout {  // offsets in bytes
  int q, k, v, dout, dq, bias, p, ds, total;
  __host__ __device__ explicit Layout(const Geo& g) {
    using F = Form<KP>;
    const int slab = KP * g.RS * 2;
    q = 0;
    k = q + slab;
    v = k + slab;     // v, then dv head by head; k, then dk
    dout = v + slab;
    dq = dout + slab;
    bias = dq + slab;                                  // (KP, ldp(KP)) bf16, below KP = 160
    p = bias + (F::kWide ? 0 : KP * ldp(KP) * 2);      // round(p * keep) of a 16-row unit a warp
    ds = p + F::kWarps * 16 * ldp(KP) * 2;             // round(ds * scale), the same; with p,
    total = ds + F::kWarps * 16 * ldp(KP) * 2;         // the dbias flush's scratch at the end
  }
};

// two blocks an SM at KP = 64 (92 KB, 128 registers); one above (KP = 128:
// 197 KB, up to 255 registers; KP = 160: 218 KB, up to 200)
template <int KP, int DHP>
__global__ void __launch_bounds__(Form<KP>::kThreads, KP == 64 ? 2 : 1)
mha_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ bias, const bf16* __restrict__ dout, bf16* __restrict__ dq,
            bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ partials, int B,
            int K, int D, int H, float scale, Dropout drop) {
  using namespace tossctr::mha_mma;
  using F = Form<KP>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(K, D, H);
  const Layout<KP> L(geo);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* dos = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* dqs = reinterpret_cast<bf16*>(smem + L.dq);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + L.bias);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + L.p);
  bf16* dsbuf = reinterpret_cast<bf16*>(smem + L.ds);
  float* part = partials + (size_t)blockIdx.x * K * K;  // this block's dbias partial
  const int tid = threadIdx.x;

  // zeros everywhere: pad rows and columns are never written with anything else
  zero_bytes(smem, L.total);
  if constexpr (F::kWide)
    for (int i = tid; i < K * K; i += F::kThreads) part[i] = 0.f;
  __syncthreads();
  if constexpr (!F::kWide)
    for (int i = tid; i < K * K; i += F::kThreads) {
      const int r = i / K;
      bias_s[r * ldp(KP) + i - r * K] = bias[i];
    }

  DbFor<KP> db(part, K);
  const bf16* bias_src = F::kWide ? bias : bias_s;
  const int bias_ld = F::kWide ? K : ldp(KP);
  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const size_t off = (size_t)row * K * D;
    stage_heads(qs, q + off, geo);
    stage_heads(ks, k + off, geo);
    stage_heads(vs, v + off, geo);
    stage_heads(dos, dout + off, geo);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    row_grads<KP, DHP, F::kWarps>(qs, ks, vs, dos, bias_src, bias_ld, dqs, pbuf, dsbuf, db,
                                  nullptr, geo, row, scale, drop, 0, 1);
    store_heads(dq + off, dqs, geo);
    store_heads(dk + off, ks, geo);
    store_heads(dv + off, vs, geo);
    __syncthreads();  // the slabs are read out before the next row's come in
  }
  if constexpr (!F::kWide) flush_dbias<KP>(db, reinterpret_cast<float*>(smem + L.p), geo, part);
}

template <int KP, int DHP>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* dout,
           void* dq, void* dk, void* dv, float* partials, float* dbias, int max_blocks, int B,
           int K, int D, int H, float scale, Dropout drop, int device, void* stream) {
  constexpr int threads = Form<KP>::kThreads;
  const size_t smem = (size_t)Layout<KP>(Geo(K, D, H)).total;
  int grid = 0;
  cudaError_t e = tossctr::prepare_launch(mha_bwd_mma<KP, DHP>, threads, smem, max_blocks,
                                          device, 1, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mha_bwd_mma<KP, DHP><<<grid, threads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), partials, B, K, D, H, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)tossctr::launch_reduce(partials, grid, K * K, dbias, s);
}

// K padded to 64, 128 or 160, the head to 8 or 16 columns
int launch_bf16(const void* q, const void* k, const void* v, const void* bias,
                const void* dout, void* dq, void* dk, void* dv, float* partials, float* dbias,
                int max_blocks, int B, int K, int D, int H, float scale, Dropout drop,
                int device, void* stream) {
  const bool narrow = D / H <= 8;
#define TOSSCTR_LAUNCH(KP)                                                                       \
  return narrow ? launch<KP, 8>(q, k, v, bias, dout, dq, dk, dv, partials, dbias, max_blocks, B, \
                                K, D, H, scale, drop, device, stream)                            \
                : launch<KP, 16>(q, k, v, bias, dout, dq, dk, dv, partials, dbias, max_blocks,   \
                                 B, K, D, H, scale, drop, device, stream)
  if (K <= 64) TOSSCTR_LAUNCH(64);
  if (K <= 128) TOSSCTR_LAUNCH(128);
  TOSSCTR_LAUNCH(160);
#undef TOSSCTR_LAUNCH
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// the shapes the kernel takes (mha_mma.cuh bwd_unit_shape: K <= 160, 4 <=
// dh <= 16, dh % 4 == 0; above K = 128 the padded heads at most 64 columns
// wide), with base addresses aligned for its 16- (or 8-) byte copies
bool takes(int K, int D, int H, const void* const* ptrs, int n) {
  if (!tossctr::mha_mma::bwd_unit_shape(Geo(K, D, H))) return false;
  const int bytes = (D / H) % 8 == 0 ? 16 : 8;
  for (int i = 0; i < n; ++i)
    if (!aligned(ptrs[i], bytes)) return false;
  return true;
}

}  // namespace tc
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, do, dq, dk and dv
// share it).  max_blocks: the most blocks the grid may have (persistent
// blocks, as many as fit on the SMs, each walking batch rows with a
// stride of the grid; a block with none writes zeros).  partials:
// (max_blocks, K*K) fp32 scratch; dbias: (K, K) fp32 out.  Dropout:
// keep_thresh (0 = off), keep_scale, seed, as the forward got them.
// D <= 64.  bf16 runs the tensor-core kernel where tc::takes says so (K <=
// 160, the head width D / H a multiple of 4 from 4 to 16, above K = 128
// the heads padded to at most 64 columns, the tensors' base addresses
// 16-byte aligned, 8 where dh % 8 != 0), refuses every other shape at K <=
// 128 and runs the key-tiled kernel there above.  Returns a cudaError_t
// code; a shape the kernels do not take, or whose layout does not fit a
// block's shared memory, is refused before any launch.
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, dout, dq, dk, dv};
  if (tc::takes(K, D, H, ptrs, 7))
    return tc::launch_bf16(q, k, v, bias, dout, dq, dk, dv, p, g, max_blocks, B, K, D, H, scale,
                           drop, device, stream);
  if (K <= tc::kMaxKPRegs) return (int)cudaErrorInvalidValue;  // no other bf16 kernel there
  return launch<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, p, g, max_blocks, B, K, D, H,
                               scale, drop, device, stream);
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
