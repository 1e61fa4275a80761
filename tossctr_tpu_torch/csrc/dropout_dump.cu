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
// (ops/dropout.py), and these kernels dump that hash through the very
// functions the four forwards and four backwards call.
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
// 3.35 TB/s).  About 17 integer operations an element for the hash.
//
// Design: a grid-stride loop over the flat output, four consecutive
// elements a thread and one 16-byte store; the coordinates come from the
// flat index by division.  An output whose size is not a multiple of 4
// ends element by element.
#include "common.cuh"

namespace {

using tossctr::Dropout;

constexpr int kThreads = 256;

struct Geometry {
  int kind;  // 0: attention (rows, H, K, K); 1: FFN (rows, F)
  int K;     // K (attention) or F (FFN)
  int H;
  __device__ __forceinline__ float keep(const Dropout& drop, size_t e) const {
    if (kind == 1) return drop.ffn((uint32_t)(e / K), (uint32_t)(e % K));
    const uint32_t k = (uint32_t)(e % K);
    size_t t = e / K;
    const uint32_t q = (uint32_t)(t % K);
    t /= K;
    const uint32_t h = (uint32_t)(t % H);
    return drop.attn((uint32_t)(t / H), q, k, h);
  }
};

__global__ void __launch_bounds__(kThreads)
dump_kernel(float* __restrict__ out, size_t n, Geometry g, Dropout drop) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t n4 = n / 4;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const size_t e = 4 * i;
    reinterpret_cast<float4*>(out)[i] =
        make_float4(g.keep(drop, e), g.keep(drop, e + 1), g.keep(drop, e + 2),
                    g.keep(drop, e + 3));
  }
  for (size_t e = 4 * n4 + (size_t)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride)
    out[e] = g.keep(drop, e);
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
  const size_t n = kind == 0 ? (size_t)rows * H * K * K : (size_t)rows * K;
  if (n == 0) return 0;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const size_t want = (n / 4 + kThreads - 1) / kThreads;
  const size_t cap = (size_t)sms * 8;  // eight blocks an SM: 2048 threads, the SM's most
  const int grid = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  dump_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, Geometry{kind, K, H},
      Dropout(keep_thresh, keep_scale, seed));
  return (int)cudaGetLastError();
}

extern "C" const char* tossctr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
