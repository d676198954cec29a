// Device code shared by the single-query decode kernels: flash-decoding
// attention over a KV cache (per-chunk partials, then a combine that can add
// the fresh key of the current position), the token embedding, the Gumbel
// argmax, the weight product of a few sequences at a time, and the launch
// sequence of one decode step, which decode_step.cu and
// decode_step_batched.cu instantiate for their batch sizes.
#pragma once

#include "common.cuh"

namespace isi {

constexpr int kAttnChunk = 128;   // keys per attention partial (one block)
constexpr int kAttnWarps = 4;
constexpr int kDhMax = 64;

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

// Flash-decoding partial: block (chunk, h, b) attends keys
// [chunk * kAttnChunk, min(n_keys, (chunk + 1) * kAttnChunk)) of head h of
// batch row b:  s_j = (q . K_j) * scale + bias[h * bias_hstride + j].
// part[((b * H + h) * n_chunks + chunk) * (dh + 2)] =
//   {max s, sum exp(s - max), sum exp(s - max) V_j}.
// One warp per key (each lane two neighbouring dims of the head, so a key
// row is one coalesced load), an online softmax per warp, the warps merged
// in shared memory. dh is even and at most kDhMax. With ROUND the query,
// the q.k products, the weights that multiply V and those products are
// rounded to T, as the JAX package's batched step does with its chunk
// intermediates (a no-op for float32).
template <typename TQ, typename T, bool ROUND = false>
__global__ void __launch_bounds__(kAttnWarps * kWarp)
    attend_partial_kernel(const TQ* q, size_t q_bstride, const T* K,
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
    if (ROUND) {
      q0 = round_to<T>(q0);
      q1 = round_to<T>(q1);
    }
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
    float s = ROUND ? round_to<T>(q0 * k0) + round_to<T>(q1 * k1)
                    : fmaf(q0, k0, q1 * k1);
    s = warp_sum(s) * scale;
    if (bias != nullptr) s += bias[j];
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    if (ROUND) {
      const float pr = round_to<T>(p);
      a0 = a0 * corr + round_to<T>(pr * v0);
      a1 = a1 * corr + round_to<T>(pr * v1);
    } else {
      a0 = a0 * corr + p * v0;
      a1 = a1 * corr + p * v1;
    }
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
// threads) into out[b * out_bstride + h * dh + t] = T(softmax . V). With
// ``qkv`` ([B, 3d] float32: the fresh q, k, v of the current position)
// the fresh key enters the softmax as its own term with the bias entry
// bias[h * bias_hstride + pos], and the fresh K/V rows are stored at row
// ``pos`` of the cache (rows < pos were read by the partials, so the store
// does not race with them).
template <typename T>
__global__ void __launch_bounds__(kDhMax)
    attend_combine_kernel(const float* part, int n_chunks, int dh, int d,
                          const float* qkv, const float* bias,
                          int bias_hstride, int pos, float scale, T* out,
                          size_t out_bstride, T* k_cache, T* v_cache,
                          size_t kv_bstride) {
  __shared__ float red[kDhMax / kWarp];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int t = threadIdx.x;
  const bool active = t < dh;
  const float* ph = part + ((size_t)b * H + h) * n_chunks * (dh + 2);
  const bool fresh = qkv != nullptr;
  float lp = -INFINITY, v_i = 0.f;
  if (fresh) {
    const float* row = qkv + (size_t)b * 3 * d + h * dh;
    float s = 0.f, k_i = 0.f;
    if (active) {
      k_i = row[d + t];
      v_i = row[2 * d + t];
      s = row[t] * k_i;
      const size_t o = b * kv_bstride + (size_t)pos * d + h * dh + t;
      k_cache[o] = from_f<T>(k_i);
      v_cache[o] = from_f<T>(v_i);
    }
    s = warp_sum(s);
    if (t % kWarp == 0) red[t / kWarp] = s;
    __syncthreads();
    s = 0.f;
#pragma unroll
    for (int w = 0; w < kDhMax / kWarp; ++w) s += red[w];
    lp = s * scale + (bias != nullptr ? bias[(size_t)h * bias_hstride + pos]
                                      : 0.f);
  }
  float m = lp;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, ph[c * (dh + 2)]);
  float den = fresh ? expf(lp - m) : 0.f;
  float acc = den * v_i;
  for (int c = 0; c < n_chunks; ++c) {
    const float* pc = ph + c * (dh + 2);
    const float w = expf(pc[0] - m);
    den = fmaf(pc[1], w, den);
    if (active) acc = fmaf(pc[2 + t], w, acc);
  }
  if (active)
    out[b * out_bstride + (size_t)h * dh + t] =
        from_f<T>(acc / fmaxf(den, 1e-20f));
}

// x[b, :] = emb[token[b], :] + posfull[b, pos, :]   (float32): each batch
// row reads its own start rows (class labels) from posfull [B, steps_pad, d]
template <typename T>
__global__ void embed_rows_kernel(const T* emb, const T* posfull,
                                  const int* token, int pos, int steps_pad,
                                  int d, float* x) {
  const int b = blockIdx.x;
  const size_t tok = token[b];
  const T* row = posfull + ((size_t)b * steps_pad + pos) * d;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    x[(size_t)b * d + t] = to_f(emb[tok * d + t]) + to_f(row[t]);
}

// out[b, :] = mem[b, row, :] (zeros when row lies past the memory's rows)
template <typename T>
__global__ void gather_rows_kernel(const T* mem, int rows, int row, int d,
                                   T* out) {
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    out[(size_t)b * d + t] =
        row < rows ? mem[((size_t)b * rows + row) * d + t] : from_f<T>(0.f);
}

// token_out[b] = take ? argmax_r(logits[b, r] + gumbel[b, r]) : cur[b];
// ties go to the lowest index. One block per batch row.
__global__ void gumbel_argmax_kernel(const float* logits, const float* gumbel,
                                     int n_class, const int* cur, int take,
                                     int* token_out) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int b = blockIdx.x;
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int r = threadIdx.x; r < n_class; r += blockDim.x) {
    const float v = logits[(size_t)b * n_class + r]
                    + gumbel[(size_t)b * n_class + r];
    if (v > best || (v == best && r < best_i)) {
      best = v;
      best_i = r;
    }
  }
  auto merge = [&](float ob, int oi) {
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  };
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    merge(ob, oi);
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x / kWarp); ++w) merge(sv[w], si[w]);
    if (best_i == 0x7fffffff) best_i = 0;
    token_out[b] = take ? best_i : cur[b];
  }
}

constexpr int kGemvThreads = 256;

// out[b, r] = epilogue(in[b, :] . W[r, :] + bias[r]): the weight product of
// a decode step. One warp owns output row r of a weight stored [out, in],
// reads it once as 16-byte vectors and multiplies it with the inputs of the
// up to NB sequences of its group (blockIdx.y), which the block holds in
// shared memory; so a weight row comes from device memory once per group.
// ``x`` (float32 [B, K]) is normalized first (LN, one warp per sequence,
// rounded to T) when ``ln_scale`` is given; else ``tin`` (T [B, K]) is the
// input. Dynamic shared memory: NB * K floats.
template <typename T, typename TB, int MODE, int NB>
__global__ void __launch_bounds__(kGemvThreads)
    gemv_batch_kernel(const float* x, const T* tin, const float* ln_scale,
                      const float* ln_bias, const T* __restrict__ W,
                      const TB* __restrict__ bias, int B, int N, int K,
                      float* out_f32, T* out_t, float out_scale) {
  extern __shared__ float4 smem4[];
  float* in = reinterpret_cast<float*>(smem4);  // [nb, K]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b0 = blockIdx.y * NB;
  const int nb = min(NB, B - b0);
  if (ln_scale != nullptr) {
    for (int b = warp; b < nb; b += kGemvThreads / kWarp)
      warp_layer_norm<T>(x + (size_t)(b0 + b) * K, ln_scale, ln_bias, K,
                         in + (size_t)b * K);
  } else {
    for (int e = threadIdx.x; e < nb * K; e += blockDim.x)
      in[e] = to_f(tin[(size_t)b0 * K + e]);
  }
  __syncthreads();
  constexpr int V = Vec<T>::N;
  const int r = blockIdx.x * (kGemvThreads / kWarp) + warp;
  if (r >= N) return;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  const T* row = W + (size_t)r * K;
#pragma unroll 2
  for (int c0 = lane * V; c0 < K; c0 += kWarp * V) {
    float w[V];
    load_vec(row + c0, w);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const float* xb = in + (size_t)b * K + c0;
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xb + j);
          acc[b] = fmaf(w[j], xv.x, acc[b]);
          acc[b] = fmaf(w[j + 1], xv.y, acc[b]);
          acc[b] = fmaf(w[j + 2], xv.z, acc[b]);
          acc[b] = fmaf(w[j + 3], xv.w, acc[b]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = warp_sum(acc[b]);
  if (lane == 0) {
    const float bv = to_f(bias[r]);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const float v = acc[b] + bv;
        const size_t o = (size_t)(b0 + b) * N + r;
        if (MODE == kOutF32) out_f32[o] = v;
        if (MODE == kResidual) out_f32[o] = out_f32[o] + v;
        if (MODE == kReluT) out_t[o] = from_f<T>(fmaxf(v, 0.f));
        if (MODE == kScaledF32) out_f32[o] = v * out_scale;
      }
    }
  }
}

// The weight products of a step through gemv_batch_kernel in groups of NB
// sequences; ROUND: see attend_partial_kernel.
template <int NB, bool ROUND>
struct GemvLinear {
  static constexpr bool kRoundAttention = ROUND;

  template <typename T, int MODE, typename TB>
  static void launch(int batch, cudaStream_t s, const float* x, const T* tin,
                     const float* ln_scale, const float* ln_bias, const T* W,
                     const TB* bias, int N, int K, float* out_f32, T* out_t,
                     float out_scale) {
    const int rows_per_block = kGemvThreads / kWarp;
    const int nb = batch < NB ? batch : NB;
    const int smem = (int)(sizeof(float) * (size_t)nb * K);
    // above the 48 KB a kernel gets without asking, raise its limit first
    // (a refusal shows as the launch's error)
    static int allowed = 48 * 1024;
    if (smem > allowed) {
      cudaFuncSetAttribute(gemv_batch_kernel<T, TB, MODE, NB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      allowed = smem;
    }
    const dim3 grid((N + rows_per_block - 1) / rows_per_block,
                    (batch + NB - 1) / NB);
    gemv_batch_kernel<T, TB, MODE, NB><<<grid, kGemvThreads, smem, s>>>(
        x, tin, ln_scale, ln_bias, W, bias, batch, N, K, out_f32, out_t,
        out_scale);
  }
  template <typename T, int MODE, typename TB>
  static void ln_linear(int batch, cudaStream_t s, const float* x,
                        const float* ln_scale, const float* ln_bias,
                        const T* W, const TB* bias, int N, int K,
                        float* out_f32, T* out_t, float out_scale) {
    launch<T, MODE, TB>(batch, s, x, nullptr, ln_scale, ln_bias, W, bias, N,
                        K, out_f32, out_t, out_scale);
  }
  template <typename T, int MODE, typename TB>
  static void linear(int batch, cudaStream_t s, const T* in, const T* W,
                     const TB* bias, int N, int K, float* out_f32, T* out_t) {
    launch<T, MODE, TB>(batch, s, nullptr, in, nullptr, nullptr, W, bias, N,
                        K, out_f32, out_t, 1.f);
  }
};

// One decode step of a batch (the arguments of both step kernels).
struct StepParams {
  // packed weights [n_layers, out, in] and biases [n_layers, out], dtype T
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
  const void* w_logits;   // [n_class, d], T
  const float* b_logits;  // [n_class]
  const float* ln;        // [n_layers, 6, d]
  const float* ln_final;  // [2, d]
  const void* emb;        // [emb_rows, d], T (row n_class is zeros)
  const void* posfull;    // [B, steps_pad, d], T: each row's start rows
  const void* mem_k;      // [n_layers, B, e_pad, d], T
  const void* mem_v;      // [n_layers, B, e_pad, d], T
  const float* bias_hm;   // [n_layers, steps_pad, H, l_pad]
  const float* cross_hm;  // [n_layers, steps_pad, H, e_pad] or null
  const float* gumbel;    // [B, n_class]
  const int* token_in;    // [B]
  const int* cur_token;   // [B]
  int* token_out;         // [B] (may alias cur_token)
  void* kv;               // [n_layers, 2, B, l_pad, d], T, updated in place
  // scratch
  float* x;       // [B, d]
  float* qkv;     // [B, 3d]
  float* qc;      // [B, d]
  void* a;        // [B, d], T
  void* mid;      // [B, d_ff], T
  float* logits;  // [B, n_class]
  float* part;    // [B, H, max_chunks, Dh + 2]
  int n_layers, d, d_ff, n_heads, n_class, batch, l_pad, e_pad, steps_pad;
  int channels, e_src, aligned, pos, take, max_chunks;
  float scale, inv_temperature;
};

// The launch sequence of one step on stream ``s``. ``Lin`` (a GemvLinear)
// supplies the weight products:
//   Lin::ln_linear<T, MODE>(B, s, x, ln_scale, ln_bias, W, bias, N, K,
//                           out_f32, out_t, out_scale)
//       out = epilogue(T(LayerNorm(x)) . W^T + bias)      x float32 [B, K]
//   Lin::linear<T, MODE>(B, s, in, W, bias, N, K, out_f32, out_t)
//       out = epilogue(in . W^T + bias)                   in T [B, K]
// and Lin::kRoundAttention says whether the self attention rounds its
// intermediates to T (see attend_partial_kernel).
template <typename T, typename Lin>
static cudaError_t decode_step_run(const StepParams& P, cudaStream_t s) {
  const int d = P.d, H = P.n_heads, dh = d / H, B = P.batch, dff = P.d_ff;
  const int pos = P.pos;
  if (dh > kDhMax || d % H || dh % 2 || d % 8 || dff % 8 || B < 1)
    return cudaErrorInvalidValue;
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
  T* a = static_cast<T*>(P.a);
  T* mid = static_cast<T*>(P.mid);
  const size_t cache_b = (size_t)P.l_pad * d;  // one batch row of one cache
  const size_t mem_b = (size_t)P.e_pad * d;
  const int n_self = (pos + kAttnChunk - 1) / kAttnChunk;  // rows < pos
  const int n_cross = (P.e_src + kAttnChunk - 1) / kAttnChunk;
  if (n_self > P.max_chunks || (!P.aligned && n_cross > P.max_chunks))
    return cudaErrorInvalidValue;
  const int e_q = pos / P.channels;

  embed_rows_kernel<T><<<B, 128, 0, s>>>(
      static_cast<const T*>(P.emb), static_cast<const T*>(P.posfull),
      P.token_in, pos, P.steps_pad, d, P.x);
  ISI_CHECK();
  for (int l = 0; l < P.n_layers; ++l) {
    const float* ln = P.ln + (size_t)l * 6 * d;
    T* kc = kv + (size_t)(2 * l) * B * cache_b;
    T* vc = kc + (size_t)B * cache_b;
    const float* bias_l =
        P.bias_hm + ((size_t)l * P.steps_pad + pos) * H * P.l_pad;
    // self attention over cache rows < pos plus the fresh position
    Lin::template ln_linear<T, kOutF32>(
        B, s, P.x, ln, ln + d, wqkv + (size_t)l * 3 * d * d,
        bqkv + (size_t)l * 3 * d, 3 * d, d, P.qkv, (T*)nullptr, 1.f);
    if (n_self > 0)
      attend_partial_kernel<float, T, Lin::kRoundAttention>
          <<<dim3(n_self, H, B), kAttnWarps * kWarp, 0, s>>>(
              P.qkv, (size_t)3 * d, kc, vc, cache_b, d, bias_l, P.l_pad, pos,
              dh, P.scale, P.part);
    attend_combine_kernel<T><<<dim3(H, B), kDhMax, 0, s>>>(
        P.part, n_self, dh, d, P.qkv, bias_l, P.l_pad, pos, P.scale, a,
        (size_t)d, kc, vc, cache_b);
    Lin::template linear<T, kResidual>(B, s, a, wo + (size_t)l * d * d,
                                       bo + (size_t)l * d, d, d, P.x,
                                       (T*)nullptr);
    ISI_CHECK();
    // cross attention
    const T* mk = mem_k + (size_t)l * B * mem_b;
    const T* mv = mem_v + (size_t)l * B * mem_b;
    if (P.aligned) {
      gather_rows_kernel<T><<<B, 128, 0, s>>>(mv, P.e_pad, e_q, d, a);
    } else {
      const float* cross_l =
          P.cross_hm + ((size_t)l * P.steps_pad + pos) * H * P.e_pad;
      Lin::template ln_linear<T, kOutF32>(
          B, s, P.x, ln + 2 * d, ln + 3 * d, wq_c + (size_t)l * d * d,
          bq_c + (size_t)l * d, d, d, P.qc, (T*)nullptr, 1.f);
      attend_partial_kernel<float, T>
          <<<dim3(n_cross, H, B), kAttnWarps * kWarp, 0, s>>>(
              P.qc, (size_t)d, mk, mv, mem_b, d, cross_l, P.e_pad, P.e_src,
              dh, P.scale, P.part);
      attend_combine_kernel<T><<<dim3(H, B), kDhMax, 0, s>>>(
          P.part, n_cross, dh, d, nullptr, nullptr, 0, 0, P.scale, a,
          (size_t)d, (T*)nullptr, (T*)nullptr, 0);
    }
    Lin::template linear<T, kResidual>(B, s, a, wo_c + (size_t)l * d * d,
                                       bo_c + (size_t)l * d, d, d, P.x,
                                       (T*)nullptr);
    ISI_CHECK();
    // MLP
    Lin::template ln_linear<T, kReluT>(
        B, s, P.x, ln + 4 * d, ln + 5 * d, w1 + (size_t)l * dff * d,
        b1 + (size_t)l * dff, dff, d, (float*)nullptr, mid, 1.f);
    Lin::template linear<T, kResidual>(B, s, mid,
                                       w2 + (size_t)l * d * dff,
                                       b2 + (size_t)l * d, d, dff, P.x,
                                       (T*)nullptr);
    ISI_CHECK();
  }
  // final LayerNorm, logits / temperature, Gumbel argmax
  Lin::template ln_linear<T, kScaledF32>(
      B, s, P.x, P.ln_final, P.ln_final + d,
      static_cast<const T*>(P.w_logits), P.b_logits, P.n_class, d, P.logits,
      (T*)nullptr, P.inv_temperature);
  gumbel_argmax_kernel<<<B, 256, 0, s>>>(P.logits, P.gumbel, P.n_class,
                                         P.cur_token, P.take, P.token_out);
  ISI_CHECK();
  return cudaSuccess;
}

}  // namespace isi
