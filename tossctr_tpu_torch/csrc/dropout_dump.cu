// dropout_dump: the counter-hash keep masks of the eight dropping encoder
// kernels, written out, for sm_90a.
//
// Replaces: exp/hw_dropout_device_check.py, its two dump pallas_calls:
// dump_kernel (:61, the packed attention geometry, (B, H*Kp, Kp) over
// _head_group / _hw_block blocks) and ffn_dump (:133, the FFN hidden
// geometry, (N, F) at _ffn_hw_chunk rows).  On the TPU they draw the
// hardware PRNG at the coordinates the fused kernels draw it, so that a
// masked oracle can rebuild the kernels' outputs.  The card has no
// hardware mask: dropout_impl "hw" runs the counter hash
// (ops/dropout.py), and these kernels dump that hash.
//
// What it computes: attention (kind 0): out (B, H, K, K) fp32, out[b, h,
// q, k] = Dropout::attn(b, q, k, h), the keep scale 1/(1-p) where the
// element is kept, else 0.  FFN (kind 1): out (N, F) fp32, out[r, c] =
// Dropout::ffn(r, c), r the flattened row b*K + q of the hidden.
// The plain versions are ops/dropout.py attention_keep / ffn_keep, which
// the CPU tests hold bit for bit against the JAX package's numpy oracles.
//
// What bounds it on the card: the bytes written, 4 an element (1.07 GB at
// the flagship's attention geometry B = 8192, K = 64, H = 8: 0.32 ms at
// 3.35 TB/s).  The hash itself is a handful of 32-bit integer operations
// an element.
//
// Design: both masks are a stack of rows whose hash is linear in the
// coordinates, x = row_lin + col * col_mix (mod 2^32), then fmix32 and a
// compare (common.cuh Dropout::attn / ffn).  A block takes a tile of rows
// the grid indexes directly, so no 64-bit division is left: kind 0 one (b,
// h) slab of K query rows (row_lin = b*kMixR + q*kMixQ + h*kMixH + seed
// mix, col_mix = kMixK); kind 1 kFfnTile consecutive rows (row_lin =
// r*kMixR + seed mix, col_mix = kMixQ).  Its threads walk the tile's
// (row, group of 4 columns) items with a fixed stride, the row and column
// advanced by addition, forming row_lin once an item and adding col_mix
// from column to column, and store 16 bytes an item (st.global.cs: the
// mask is written once and read later by another kernel).  A tile whose
// width is not a multiple of 4 (its rows are then not 16-byte aligned)
// takes the tail path: one column an item, 4-byte stores.  The result is
// the same 32-bit arithmetic as Dropout::attn / ffn, so the bits are the
// plain version's.
#include "common.cuh"

namespace {

using tossctr::fmix32;
using tossctr::kMixH;
using tossctr::kMixK;
using tossctr::kMixQ;
using tossctr::kMixR;

constexpr int kThreads = 256;
constexpr int kFfnTileElems = 4096;  // an FFN block's tile: about this many elements

struct Keep {
  uint32_t thresh;
  float scale;
  __device__ __forceinline__ float operator()(uint32_t x) const {
    return fmix32(x) >= thresh ? scale : 0.f;
  }
};

// One tile: ``rows`` rows of ``cols`` fp32 at ``out``, element (i, j)
// keeping on row_lin0 + i * row_mix + j * col_mix.
__device__ __forceinline__ void dump_tile(float* __restrict__ out, uint32_t rows, uint32_t cols,
                                          uint32_t row_lin0, uint32_t row_mix, uint32_t col_mix,
                                          Keep keep) {
  const uint32_t groups = (cols % 4 == 0) ? cols / 4 : cols;  // items a row
  const uint32_t width = (cols % 4 == 0) ? 4u : 1u;           // columns an item
  // the walk's stride in (row, item) form, once a thread
  const uint32_t d_row = kThreads / groups, d_item = kThreads % groups;
  uint32_t i = threadIdx.x / groups, g = threadIdx.x % groups;
  if (width == 4) {
    float4* out4 = reinterpret_cast<float4*>(out);
    while (i < rows) {
      const uint32_t x = row_lin0 + i * row_mix + 4u * g * col_mix;
      const float4 v = make_float4(keep(x), keep(x + col_mix), keep(x + 2u * col_mix),
                                   keep(x + 3u * col_mix));
      __stcs(out4 + (size_t)i * groups + g, v);
      i += d_row;
      g += d_item;
      if (g >= groups) {
        g -= groups;
        ++i;
      }
    }
  } else {
    while (i < rows) {
      __stcs(out + (size_t)i * cols + g, keep(row_lin0 + i * row_mix + g * col_mix));
      i += d_row;
      g += d_item;
      if (g >= groups) {
        g -= groups;
        ++i;
      }
    }
  }
}

// kind 0: block s = b * H + h writes the (K, K) slab out[b, h].
__global__ void __launch_bounds__(kThreads)
attn_dump_kernel(float* __restrict__ out, uint32_t K, uint32_t H, uint32_t seed_mix, Keep keep) {
  const uint32_t s = blockIdx.x, b = s / H, h = s - b * H;
  dump_tile(out + (size_t)s * K * K, K, K, b * kMixR + h * kMixH + seed_mix, kMixQ, kMixK, keep);
}

// kind 1: block t writes rows [t * tile, min((t + 1) * tile, N)) of (N, F).
__global__ void __launch_bounds__(kThreads)
ffn_dump_kernel(float* __restrict__ out, uint32_t N, uint32_t F, uint32_t tile,
                uint32_t seed_mix, Keep keep) {
  const uint32_t r0 = blockIdx.x * tile;
  const uint32_t rows = min(tile, N - r0);
  dump_tile(out + (size_t)r0 * F, rows, F, r0 * kMixR + seed_mix, kMixR, kMixQ, keep);
}

}  // namespace

// out: fp32, 16-byte aligned.  kind 0: (rows, H, K, K) attention mask;
// kind 1: (rows, F) FFN mask with F passed as K (H unused).  Dropout:
// keep_thresh (> 0), keep_scale, seed (common.cuh Dropout).  Returns a
// cudaError_t code, 0 on success.
extern "C" int tossctr_dropout_dump(void* out, int kind, int rows, int K, int H,
                                    unsigned keep_thresh, float keep_scale, unsigned seed,
                                    int device, void* stream) {
  if ((kind != 0 && kind != 1) || rows < 0 || K < 1 || H < 1 || keep_thresh == 0u)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows == 0) return 0;
  const tossctr::Dropout drop(keep_thresh, keep_scale, seed);
  const Keep keep{drop.thresh, drop.scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (kind == 0) {
    const long long slabs = (long long)rows * H;
    if (slabs > 0x7fffffffLL || (long long)K * K > 0xffffffffLL)
      return (int)cudaErrorInvalidValue;
    attn_dump_kernel<<<(unsigned)slabs, kThreads, 0, st>>>(o, (uint32_t)K, (uint32_t)H,
                                                            drop.seed_mix, keep);
  } else {
    const uint32_t tile = K >= kFfnTileElems ? 1u : (uint32_t)(kFfnTileElems / K);
    const uint32_t blocks = (uint32_t)(((long long)rows + tile - 1) / tile);
    ffn_dump_kernel<<<blocks, kThreads, 0, st>>>(o, (uint32_t)rows, (uint32_t)K, tile,
                                                 drop.seed_mix, keep);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
