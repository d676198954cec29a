// Flash-decoding attention over a KV cache for the single-query attention
// kernel (decode_attention.cu): per-chunk partials, then their combine.
#pragma once

#include "common.cuh"

namespace isi {

constexpr int kAttnChunk = 128;   // keys per attention partial (one block)
constexpr int kAttnWarps = 4;
constexpr int kDhMax = 64;

// Flash-decoding partial: block (chunk, h, b) attends keys
// [chunk * kAttnChunk, min(n_keys, (chunk + 1) * kAttnChunk)) of head h of
// batch row b:  s_j = (q . K_j) * scale + bias[h * bias_hstride + j].
// part[((b * H + h) * n_chunks + chunk) * (dh + 2)] =
//   {max s, sum exp(s - max), sum exp(s - max) V_j}.
// One warp per key (each lane two neighbouring dims of the head, so a key
// row is one coalesced load), an online softmax per warp, the warps merged
// in shared memory. dh is even and at most kDhMax.
template <typename T>
__global__ void __launch_bounds__(kAttnWarps * kWarp)
    attend_partial_kernel(const T* q, size_t q_bstride, const T* K,
                          const T* V, size_t kv_bstride, int row_stride,
                          const float* bias, int bias_hstride, int n_keys,
                          int dh, float scale, float* part) {
  __shared__ float sm_m[kAttnWarps], sm_l[kAttnWarps];
  __shared__ float sm_acc[kAttnWarps][kDhMax];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, n_chunks = gridDim.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bool active = 2 * lane < dh;
  const int t0 = 2 * lane;
  q += b * q_bstride + (size_t)h * dh;
  K += b * kv_bstride + (size_t)h * dh;
  V += b * kv_bstride + (size_t)h * dh;
  if (bias != nullptr) bias += (size_t)h * bias_hstride;
  float q0 = 0.f, q1 = 0.f;
  if (active) {
    q0 = to_f(q[t0]);
    q1 = to_f(q[t0 + 1]);
  }
  const int j0 = chunk * kAttnChunk;
  const int j1 = min(j0 + kAttnChunk, n_keys);
  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int j = j0 + warp; j < j1; j += kAttnWarps) {
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    if (active) {
      load2(K + (size_t)j * row_stride + t0, k0, k1);
      load2(V + (size_t)j * row_stride + t0, v0, v1);
    }
    float s = fmaf(q0, k0, q1 * k1);
    s = warp_sum(s) * scale;
    if (bias != nullptr) s += bias[j];
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    a0 = a0 * corr + p * v0;
    a1 = a1 * corr + p * v1;
    m = m_new;
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (active) {
    sm_acc[warp][t0] = a0;
    sm_acc[warp][t0 + 1] = a1;
  }
  __syncthreads();
  float* out = part + (((size_t)b * H + h) * n_chunks + chunk) * (dh + 2);
  float mm = sm_m[0];
#pragma unroll
  for (int w = 1; w < kAttnWarps; ++w) mm = fmaxf(mm, sm_m[w]);
  for (int t = threadIdx.x; t < dh + 1; t += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) {
      // a warp that saw no key holds max -inf and zero sums
      const float wgt = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mm);
      acc += wgt * (t < dh ? sm_acc[w][t] : sm_l[w]);
    }
    if (t < dh) out[2 + t] = acc;
    else out[1] = acc;
  }
  if (threadIdx.x == 0) out[0] = mm;
}

// Combine the partials of head h of batch row b (block (h, b), kDhMax
// threads) into out[b * out_bstride + h * dh + t] = T(softmax . V).
template <typename T>
__global__ void __launch_bounds__(kDhMax)
    attend_combine_kernel(const float* part, int n_chunks, int dh, T* out,
                          size_t out_bstride) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int t = threadIdx.x;
  const float* ph = part + ((size_t)b * H + h) * n_chunks * (dh + 2);
  float m = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, ph[c * (dh + 2)]);
  float den = 0.f, acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float* pc = ph + c * (dh + 2);
    const float w = expf(pc[0] - m);
    den = fmaf(pc[1], w, den);
    if (t < dh) acc = fmaf(pc[2 + t], w, acc);
  }
  if (t < dh)
    out[b * out_bstride + (size_t)h * dh + t] =
        from_f<T>(acc / fmaxf(den, 1e-20f));
}

}  // namespace isi
