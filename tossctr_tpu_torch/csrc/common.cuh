// Shared helpers for the hand-written Hopper kernels of tossctr_tpu_torch.
//
// Every kernel is templated on its storage type T (float or
// __nv_bfloat16).  Arithmetic runs in fp32; ``round_t<T>`` marks the
// points where the JAX reference rounds an intermediate to the storage
// type, so the bf16 kernels round exactly where the Pallas kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tossctr {

template <typename T>
__device__ __forceinline__ float to_f(T v);

template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);

template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// fp32 value rounded through the storage type
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

// four consecutive elements (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- counter-hash dropout (tossctr_tpu/ops/pallas_attention.py
// _dropout_keep, pallas_ffn.py _ffn_keep; ops/dropout.py) ----
// A keep mask is a pure function of absolute coordinates and the seed, so
// the forward and backward kernels regenerate it instead of storing it.
constexpr uint32_t kMixR = 0x9E3779B1u;
constexpr uint32_t kMixQ = 0x85EBCA77u;
constexpr uint32_t kMixK = 0xC2B2AE3Du;
constexpr uint32_t kMixH = 0x27D4EB2Fu;
constexpr uint32_t kMixS = 0x165667B1u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Dropout of one launch: elements whose hash is >= thresh are kept and
// scaled by ``scale`` (1/(1-p) in fp32); thresh == 0 means no dropout.
struct Dropout {
  uint32_t thresh;
  float scale;
  uint32_t seed_mix;  // seed * kMixS
  __host__ __device__ Dropout(uint32_t t, float s, uint32_t seed)
      : thresh(t), scale(s), seed_mix(seed * kMixS) {}
  __host__ __device__ bool on() const { return thresh != 0u; }
  // attention probabilities: (batch row, query, key, head)
  __device__ __forceinline__ float attn(uint32_t row, uint32_t q, uint32_t k, uint32_t h) const {
    const uint32_t x = row * kMixR + q * kMixQ + k * kMixK + h * kMixH + seed_mix;
    return fmix32(x) >= thresh ? scale : 0.f;
  }
  // FFN hidden units: (flattened row b*K+q, hidden column)
  __device__ __forceinline__ float ffn(uint32_t row, uint32_t col) const {
    return fmix32(row * kMixR + col * kMixQ + seed_mix) >= thresh ? scale : 0.f;
  }
};

// ---- tanh-approximate GELU and its derivative, in the reference's
// operation order (pallas_ffn.py _gelu_tanh / _gelu_tanh_grad) ----
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
constexpr float kGelu3C = 3.0f * 0.044715f;

__device__ __forceinline__ float gelu_tanh(float h) {
  // u = c0 * (h + c1*h*h*h); 0.5*h*(1 + tanh(u))
  const float h3 = __fmul_rn(__fmul_rn(__fmul_rn(kGeluC, h), h), h);
  const float u = __fmul_rn(kSqrt2OverPi, __fadd_rn(h, h3));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, tanhf(u)));
}

__device__ __forceinline__ float gelu_tanh_grad(float h) {
  // 0.5*(1 + t) + 0.5*h*(1 - t*t)*du, du = c0*(1 + 3*c1*h*h)
  const float h3 = __fmul_rn(__fmul_rn(__fmul_rn(kGeluC, h), h), h);
  const float t = tanhf(__fmul_rn(kSqrt2OverPi, __fadd_rn(h, h3)));
  const float du = __fmul_rn(kSqrt2OverPi, __fadd_rn(1.0f, __fmul_rn(__fmul_rn(kGelu3C, h), h)));
  const float a = __fmul_rn(0.5f, __fadd_rn(1.0f, t));
  const float b = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, h), __fsub_rn(1.0f, __fmul_rn(t, t))), du);
  return __fadd_rn(a, b);
}

// float offsets rounded up to 4 floats, so every region is 16-byte aligned
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

// The shared memory a block may opt in to on ``device`` (232,448 bytes on
// an H100); 0 if the query fails.
inline size_t smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return (size_t)v;
}

// Launch helper: raise the dynamic shared-memory cap, size a grid of at
// most ``want`` blocks, then launch.  Returns the first CUDA error.
template <typename Kern>
cudaError_t prepare_launch(Kern kern, int threads, size_t smem, int want, int device,
                           int persistent, int* grid) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long cap = persistent ? (long)sms * per_sm : (long)want;
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

// Second pass of a backward kernel's weight-gradient sums: out[i] = the sum
// over blocks b = 0, 1, ... of partials[b][i], always in that order, so the
// result repeats bit for bit from run to run (fp32 atomics would not).
__global__ void reduce_partials(const float* __restrict__ partials, int blocks, int n,
                                float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * n + i];
    out[i] = s;
  }
}

inline cudaError_t launch_reduce(const float* partials, int blocks, int n, float* out,
                                 cudaStream_t stream) {
  const int threads = 256;
  const int grid = (n + threads - 1) / threads;
  reduce_partials<<<grid, threads, 0, stream>>>(partials, blocks, n, out);
  return cudaGetLastError();
}

}  // namespace tossctr

extern "C" const char* tossctr_cuda_error_string(int code);
