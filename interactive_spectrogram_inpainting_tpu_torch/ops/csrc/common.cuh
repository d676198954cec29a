// Shared device helpers of the port's kernels: bf16/f32 element access,
// 16-byte vector loads, warp and block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// return the error of the launches enqueued so far from a host function
// that returns cudaError_t
#define ISI_CHECK()                            \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

namespace isi {

constexpr int kWarp = 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

// value after a round trip through T (the JAX code's ``.astype(dtype)``)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 16-byte vectors: 8 bf16 or 4 float
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

// the same 16-byte loads through the coherent path, for data that other
// blocks write while the kernel runs (no read-only cache)
__device__ __forceinline__ void load_vec_rw(const float* p, float* out) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_vec_rw(const __nv_bfloat16* p,
                                            float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

// two neighbouring elements as float32
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; ``red`` holds >= 33 floats of shared memory. All
// threads get the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

}  // namespace isi
