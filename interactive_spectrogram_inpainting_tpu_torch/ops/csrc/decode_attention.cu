// Single-query attention over the causal prefix of a KV cache.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/decode_attention.py
//           ::flash_decode_attention (Pallas kernel _decode_attn_kernel).
//
// out[b, h, :] = softmax_j(q[b, h] . K[b, j, h] / sqrt(Dh) + bias[h, j]) V
// over the keys j <= pos (the cache already holds row pos).
//
// Bound on the H100: bytes, the (pos + 1) K and V rows of every sequence
// read once. The TPU kernel streamed 128-key chunks through VMEM with a
// running softmax per batch tile; here the chunks run in parallel
// (flash-decoding, decode_common.cuh): one block per (128-key chunk, head,
// sequence) computes a partial softmax, one warp per key, and a second
// launch merges the partials of each (head, sequence). Only the
// ceil((pos + 1) / 128) chunks up to pos are read.
#include "decode_common.cuh"

using namespace isi;

struct DecodeAttnParams {
  const void* q;      // [B, H, Dh], T
  const void* k;      // [B, Lp, H, Dh], T
  const void* v;      // [B, Lp, H, Dh], T
  const float* bias;  // [H, Lp] or null
  void* out;          // [B, H, Dh], T
  float* part;        // [B, H, n_chunks, Dh + 2]
  int batch, n_heads, head_dim, length, pos;
  float scale;
};

template <typename T>
static cudaError_t attend(const DecodeAttnParams& P, cudaStream_t s) {
  const int H = P.n_heads, dh = P.head_dim, d = H * dh;
  if (dh > kDhMax || dh % 2 || P.pos < 0 || P.pos >= P.length)
    return cudaErrorInvalidValue;
  const int n_keys = P.pos + 1;
  const int n_chunks = (n_keys + kAttnChunk - 1) / kAttnChunk;
  const size_t cache_b = (size_t)P.length * d;
  attend_partial_kernel<T>
      <<<dim3(n_chunks, H, P.batch), kAttnWarps * kWarp, 0, s>>>(
          static_cast<const T*>(P.q), (size_t)d, static_cast<const T*>(P.k),
          static_cast<const T*>(P.v), cache_b, d, P.bias, P.length, n_keys,
          dh, P.scale, P.part);
  ISI_CHECK();
  attend_combine_kernel<T><<<dim3(H, P.batch), kDhMax, 0, s>>>(
      P.part, n_chunks, dh, static_cast<T*>(P.out), (size_t)d);
  ISI_CHECK();
  return cudaSuccess;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_decode_attention(const DecodeAttnParams* P, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? attend<__nv_bfloat16>(*P, s)
                                     : attend<float>(*P, s));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
