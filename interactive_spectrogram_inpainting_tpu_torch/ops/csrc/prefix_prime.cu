// Prefix priming: fill the decoder's self-attention KV cache for the known
// prefix [0, p0) of an inpaint with one forward over all p0 rows.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/prefix_prime_kernel.py
//           ::fused_prefix_prime (Pallas kernel _prefix_prime_kernel).
//
// Bound on the H100: at the full priors (d 512, d_ff 2048, p0 up to 640
// rows) each layer is a handful of [p0, 512] x [512, 1536 | 512 | 2048]
// products, ~2 GFLOP per prefix of 512 rows over 8 layers, against ~60 MB
// of weights and bias tables read once: the products bound it. The TPU
// kernel ran the whole forward in one call with every operand in VMEM;
// here each layer is a short fixed sequence of hand-written kernels on the
// current stream (no host synchronisation between them):
//
//   LayerNorm -> tiled GEMM (qkv) -> K/V store into the cache ->
//   causal attention with the relative-bias table -> GEMM + residual ->
//   cross attention (aligned gather of mem_v[i // c], or attention with
//   the cross-bias table and the e < E_src mask) -> GEMM + residual ->
//   LayerNorm -> GEMM + ReLU -> GEMM + residual.
//
// The GEMM (gemm.cuh) tiles 64 x 64 outputs (32 x 32 when the larger tiles
// would leave SMs idle) over 32-deep slices of K in shared memory,
// prefetching the next slice into registers, with float32 accumulation,
// and fuses bias, ReLU and the residual into its epilogue. The attention
// kernel is one block per (query tile of 32 rows, head) with an online
// float32 softmax over key tiles of 32. A batch of sequences is primed
// row by row: the same sequence of launches per batch row, on one stream.
// Only rows [0, p0) are computed: a causal prefix row never sees a later
// row, so the padded rows the TPU kernel carried are not needed; cache
// rows [p0, p_pad) are written as zeros, as the TPU kernel does.
#include "gemm.cuh"

using namespace isi;

struct PrimeParams {
  const void* wqkv;
  const void* bqkv;
  const void* wo;
  const void* bo;
  const void* wo_c;
  const void* bo_c;
  const void* wq_c;
  const void* bq_c;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  const float* ln;        // [n_layers, 6, d]
  const void* x_prefix;   // [batch, x_rows, d], T (rows [0, m) are read)
  const void* mem_k;      // [n_layers, batch, e_pad, d], T
  const void* mem_v;      // [n_layers, batch, e_pad, d], T
  const float* bias_hm;   // [n_layers, steps_pad, H, l_pad]
  const float* cross_hm;  // [n_layers, steps_pad, H, e_pad] or null
  void* kv;  // [n_layers, 2, batch, l_pad, d], T, updated in place
  // scratch (one batch row at a time)
  float* x;    // [m, d]
  void* h;     // [m, d], T
  float* qkv;  // [m, 3d]
  float* qc;   // [m, d]
  void* a;     // [m, d], T
  void* mid;   // [m, d_ff], T
  int n_layers, d, d_ff, n_heads, m, p_pad, l_pad, e_pad, steps_pad;
  int channels, e_src, aligned, batch, x_rows;
  float scale;
};

// ---------------------------------------------------------------------------
// cache rows [0, p_pad): the prefix K/V below m, zeros above
template <typename T>
__global__ void store_kv_kernel(const float* qkv, int m, int d, T* kc, T* vc) {
  const int r = blockIdx.x;
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    const size_t o = (size_t)r * d + t;
    kc[o] = from_f<T>(r < m ? qkv[(size_t)r * 3 * d + d + t] : 0.f);
    vc[o] = from_f<T>(r < m ? qkv[(size_t)r * 3 * d + 2 * d + t] : 0.f);
  }
}

// aligned cross attention: the softmax over the single allowed source key
// is 1, so row i takes mem_v[i // c] (zero past e_pad)
template <typename T>
__global__ void aligned_gather_kernel(const T* mem_v, int e_pad, int d, int c,
                                      T* out) {
  const int r = blockIdx.x;
  const int e = r / c;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    out[(size_t)r * d + t] = e < e_pad ? mem_v[(size_t)e * d + t]
                                       : from_f<T>(0.f);
}

// ---------------------------------------------------------------------------
constexpr int QT = 32, KT = 32, DH_MAX = 64, kAttnThreads = 256;

// One block per (query tile, head). Row i of the tile attends keys
// j < n_keys (and j <= i when causal) with logits
// (q_i . k_j) * scale + bias[i * bias_q_stride + h * bias_h_stride + j];
// out = T(softmax . V). Q is float32; K/V are TK.
template <typename T, typename TK>
__global__ void __launch_bounds__(kAttnThreads)
    prefix_attention_kernel(const float* Q, int q_stride, const TK* K,
                            const TK* V, int kv_stride, const float* bias,
                            int bias_q_stride, int bias_h_stride, int m,
                            int n_keys, int causal, int dh, float scale,
                            T* out, int out_stride) {
  __shared__ float Qs[QT][DH_MAX + 1];
  __shared__ float Ks[KT][DH_MAX + 1];
  __shared__ float Vs[KT][DH_MAX];
  __shared__ float S[QT][KT + 1];
  const int h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, r = tid / 8, g = tid % 8;
  const int i = q0 + r;
  Q += h * dh;
  K += h * dh;
  V += h * dh;
  bias += (size_t)h * bias_h_stride;

  for (int e = tid; e < QT * dh; e += kAttnThreads) {
    const int rr = e / dh, t = e % dh;
    Qs[rr][t] = q0 + rr < m ? Q[(size_t)(q0 + rr) * q_stride + t] : 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f, acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 0.f;
  const int k_end = causal ? min(q0 + QT, n_keys) : n_keys;

  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * dh; e += kAttnThreads) {
      const int j = e / dh, t = e % dh;
      const bool in = k0 + j < n_keys;
      Ks[j][t] = in ? to_f(K[(size_t)(k0 + j) * kv_stride + t]) : 0.f;
      Vs[j][t] = in ? to_f(V[(size_t)(k0 + j) * kv_stride + t]) : 0.f;
    }
    __syncthreads();
    float s[KT / 8];
    float tmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < KT / 8; ++u) {
      const int j = g + 8 * u, key = k0 + j;
      const bool valid = i < m && key < n_keys && (!causal || key <= i);
      float dot = 0.f;
      for (int t = 0; t < dh; ++t) dot = fmaf(Qs[r][t], Ks[j][t], dot);
      s[u] = valid ? dot * scale + bias[(size_t)i * bias_q_stride + key]
                   : -INFINITY;
      tmax = fmaxf(tmax, s[u]);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m_run, tmax);
    float corr = 1.f, psum = 0.f;
    if (m_new != -INFINITY) {
      corr = expf(m_run - m_new);
#pragma unroll
      for (int u = 0; u < KT / 8; ++u) {
        s[u] = s[u] == -INFINITY ? 0.f : expf(s[u] - m_new);
        psum += s[u];
      }
      m_run = m_new;
    } else {
#pragma unroll
      for (int u = 0; u < KT / 8; ++u) s[u] = 0.f;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l_run = l_run * corr + psum;
#pragma unroll
    for (int u = 0; u < KT / 8; ++u) S[r][g + 8 * u] = s[u];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] *= corr;
    for (int j = 0; j < KT; ++j) {
      const float pj = S[r][j];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = g + 8 * u;
        if (t < dh) acc[u] = fmaf(pj, Vs[j][t], acc[u]);
      }
    }
  }
  if (i < m) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = g + 8 * u;
      if (t < dh)
        out[(size_t)i * out_stride + h * dh + t] = from_f<T>(acc[u] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// the forward of batch row ``b``
template <typename T>
static cudaError_t prime_row(const PrimeParams& P, int b, int sms,
                             cudaStream_t s) {
  const int d = P.d, m = P.m, H = P.n_heads, dh = d / H, dff = P.d_ff;
  const T* wqkv = static_cast<const T*>(P.wqkv);
  const T* bqkv = static_cast<const T*>(P.bqkv);
  const T* wo = static_cast<const T*>(P.wo);
  const T* bo = static_cast<const T*>(P.bo);
  const T* wo_c = static_cast<const T*>(P.wo_c);
  const T* bo_c = static_cast<const T*>(P.bo_c);
  const T* wq_c = static_cast<const T*>(P.wq_c);
  const T* bq_c = static_cast<const T*>(P.bq_c);
  const T* w1 = static_cast<const T*>(P.w1);
  const T* b1 = static_cast<const T*>(P.b1);
  const T* w2 = static_cast<const T*>(P.w2);
  const T* b2 = static_cast<const T*>(P.b2);
  const T* mem_k = static_cast<const T*>(P.mem_k);
  const T* mem_v = static_cast<const T*>(P.mem_v);
  T* kv = static_cast<T*>(P.kv);
  T* h = static_cast<T*>(P.h);
  T* a = static_cast<T*>(P.a);
  T* mid = static_cast<T*>(P.mid);
  const size_t ln_smem = sizeof(float) * (d + 64);
  const dim3 attn_grid((m + QT - 1) / QT, H);

  to_f32_kernel<T><<<(m * d + 255) / 256, 256, 0, s>>>(
      static_cast<const T*>(P.x_prefix) + (size_t)b * P.x_rows * d, P.x,
      m * d);
  ISI_CHECK();
  for (int l = 0; l < P.n_layers; ++l) {
    const float* ln = P.ln + (size_t)l * 6 * d;
    T* kc = kv + ((size_t)(2 * l) * P.batch + b) * P.l_pad * d;
    T* vc = kc + (size_t)P.batch * P.l_pad * d;
    // self attention
    ln_rows_kernel<T><<<m, 128, ln_smem, s>>>(P.x, d, ln, ln + d, h);
    gemm<T, kOutF32>(h, wqkv + (size_t)l * 3 * d * d, bqkv + (size_t)l * 3 * d,
                     m, 3 * d, d, P.qkv, nullptr, sms, s);
    store_kv_kernel<T><<<P.p_pad, 128, 0, s>>>(P.qkv, m, d, kc, vc);
    prefix_attention_kernel<T, float><<<attn_grid, kAttnThreads, 0, s>>>(
        P.qkv, 3 * d, P.qkv + d, P.qkv + 2 * d, 3 * d,
        P.bias_hm + (size_t)l * P.steps_pad * H * P.l_pad, H * P.l_pad,
        P.l_pad, m, m, 1, dh, P.scale, a, d);
    gemm<T, kResidual>(a, wo + (size_t)l * d * d, bo + (size_t)l * d, m, d, d,
                       P.x, nullptr, sms, s);
    ISI_CHECK();
    // cross attention
    const T* mk = mem_k + ((size_t)l * P.batch + b) * P.e_pad * d;
    const T* mv = mem_v + ((size_t)l * P.batch + b) * P.e_pad * d;
    if (P.aligned) {
      aligned_gather_kernel<T><<<m, 128, 0, s>>>(mv, P.e_pad, d, P.channels,
                                                 a);
    } else {
      ln_rows_kernel<T><<<m, 128, ln_smem, s>>>(P.x, d, ln + 2 * d,
                                                ln + 3 * d, h);
      gemm<T, kOutF32>(h, wq_c + (size_t)l * d * d, bq_c + (size_t)l * d, m,
                       d, d, P.qc, nullptr, sms, s);
      prefix_attention_kernel<T, T><<<attn_grid, kAttnThreads, 0, s>>>(
          P.qc, d, mk, mv, d,
          P.cross_hm + (size_t)l * P.steps_pad * H * P.e_pad, H * P.e_pad,
          P.e_pad, m, P.e_src, 0, dh, P.scale, a, d);
    }
    gemm<T, kResidual>(a, wo_c + (size_t)l * d * d, bo_c + (size_t)l * d, m,
                       d, d, P.x, nullptr, sms, s);
    ISI_CHECK();
    // MLP
    ln_rows_kernel<T><<<m, 128, ln_smem, s>>>(P.x, d, ln + 4 * d, ln + 5 * d,
                                              h);
    gemm<T, kReluT>(h, w1 + (size_t)l * dff * d, b1 + (size_t)l * dff, m, dff,
                    d, nullptr, mid, sms, s);
    gemm<T, kResidual>(mid, w2 + (size_t)l * d * dff, b2 + (size_t)l * d, m,
                       d, dff, P.x, nullptr, sms, s);
    ISI_CHECK();
  }
  return cudaSuccess;
}

template <typename T>
static cudaError_t prime(const PrimeParams& P, cudaStream_t s) {
  if (P.d / P.n_heads > DH_MAX || P.d % P.n_heads)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  for (int b = 0; b < P.batch; ++b) {
    e = prime_row<T>(P, b, sms, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_prefix_prime(const PrimeParams* P, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? prime<__nv_bfloat16>(*P, s)
                                     : prime<float>(*P, s));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
