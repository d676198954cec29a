// Whole-scan B=1 decode: the entire token loop over [p0, steps) in ONE
// persistent cooperative launch.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/decode_scan_kernel.py
//           ::fused_decode_scan (Pallas kernel _decode_scan_kernel).
//
// Bound on the H100: device-memory bandwidth. Each step streams every
// decoder weight once (bottom prior, bf16: 8 x (1536+512+512+2048+2048) x
// 512 x 2 B + logits ~ 55 MB; the top prior adds wq_c, ~59 MB), which does
// not fit the 50 MB L2, against a few MFLOP of arithmetic. The TPU kernel
// kept all weights and the ~59 MB KV cache resident in VMEM; no SM holds
// that, so here the weights stream from device memory every step and the
// cache lives in device memory.
//
// Design: one block of 512 threads per SM, alive for the whole scan; the
// phases of a step are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()), so no host round trip and no
// relaunch happens inside the loop. Within a GEMV phase every warp of the
// grid owns whole output rows of a weight stored [out, in] and reads them
// as 16-byte vectors (bf16 weights, float32 accumulation). Self attention
// runs as flash-decoding partials, one block per (head, 64-key chunk of
// the cache), combined with the fresh key by every block of the next
// phase; both stage their inputs in shared memory with cp.async so each
// costs one memory round trip. The aligned cross attention is a gather of
// mem_v[p // c] whose projection shares the self-attention output phase.
// The last phase takes the LayerNorm, the logits GEMV, /temperature plus
// the Gumbel noise and an argmax; every block computes the same winner,
// block 0 writes it where mask[i] && i >= 0, and the next step reads it
// from the block's own copy, so the token never leaves the device.
//
// Per-step barriers: 5 per layer (aligned), 8 per layer (cross), +1. A
// phase costs a few microseconds of latency (barrier, L2 reads of the
// residual, block reductions, one HBM round trip for the weight rows), so
// the scan is latency-bound, far from the bandwidth bound above.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace isi;

struct ScanParams {
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
  const void* posfull;    // [steps_pad, d], T
  const void* mem_k;      // [n_layers, e_pad, d], T
  const void* mem_v;      // [n_layers, e_pad, d], T
  const float* bias_hm;   // [n_layers, steps_pad, H, l_pad]
  const float* cross_hm;  // [n_layers, steps_pad, H, e_pad] or null
  const float* gumbel;    // [steps - p0, n_class]
  const unsigned char* mask;  // [length]
  int* tokens;            // [length], updated in place
  void* kv;               // [n_layers, 2, l_pad, d], T, updated in place
  // float32 scratch
  float* x;       // [d]
  float* qkv;     // [3d]
  float* qc;      // [d]
  float* mid;     // [d_ff]
  float* logits;  // [n_class]
  float* part;    // [H, max_chunks, Dh + 4]
  int n_layers, d, d_ff, n_heads, n_class, l_pad, e_pad, steps_pad, length;
  int channels, p0, steps, e_src, aligned, max_chunks;
  float scale, temperature;
};

constexpr int kThreads = 512;
constexpr int kChunk = 64;

// 16-byte asynchronous copy from global to shared memory (sm_80+); the
// .cg form reads through L2, so it sees what other blocks wrote
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float dot4(const float* w, const float* in,
                                      float acc) {
  const float4 a = *reinterpret_cast<const float4*>(in);
  acc = fmaf(w[0], a.x, acc);
  acc = fmaf(w[1], a.y, acc);
  acc = fmaf(w[2], a.z, acc);
  return fmaf(w[3], a.w, acc);
}

// out[r] = epi(r, W[r, :] . in) for the rows this warp owns
template <typename T, typename Epi>
__device__ __forceinline__ void gemv_rows(const T* __restrict__ W, int rows,
                                          int cols, const float* in,
                                          Epi epi) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x % kWarp;
  const int wpb = blockDim.x / kWarp;
  const int n_warps = gridDim.x * wpb;
  for (int r = blockIdx.x * wpb + threadIdx.x / kWarp; r < rows;
       r += n_warps) {
    float acc = 0.f;
    const T* row = W + (size_t)r * cols;
#pragma unroll 4
    for (int c0 = lane * V; c0 < cols; c0 += kWarp * V) {
      float w[V];
      load_vec(row + c0, w);
#pragma unroll
      for (int j = 0; j < V; j += 4) acc = dot4(w + j, in + c0 + j, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) epi(r, acc);
  }
}

// Two GEMVs over the same rows in one pass, their loads issued together:
// epi(r, W1[r, :] . in1, W2[r, :] . in2)
template <typename T, typename Epi>
__device__ __forceinline__ void gemv_rows2(const T* __restrict__ W1,
                                           const float* in1,
                                           const T* __restrict__ W2,
                                           const float* in2, int rows,
                                           int cols, Epi epi) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x % kWarp;
  const int wpb = blockDim.x / kWarp;
  const int n_warps = gridDim.x * wpb;
  for (int r = blockIdx.x * wpb + threadIdx.x / kWarp; r < rows;
       r += n_warps) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll 4
    for (int c0 = lane * V; c0 < cols; c0 += kWarp * V) {
      float w1[V], w2[V];
      load_vec(W1 + (size_t)r * cols + c0, w1);
      load_vec(W2 + (size_t)r * cols + c0, w2);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        a1 = dot4(w1 + j, in1 + c0 + j, a1);
        a2 = dot4(w2 + j, in2 + c0 + j, a2);
      }
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) epi(r, a1, a2);
  }
}

// Flash-decoding partial of one head over keys [j0, j1) (at most kChunk):
// s_j = (q . K_j) * scale + bias[j]; part = {max s, sum exp(s - max), -,
// -, sum exp(s - max) V_j} (rows of Dh + 4 floats, 16-byte aligned).
// ``sm`` holds Dh + kChunk + blockDim.x floats;
// ``stage`` holds 2 * kChunk * (Dh + V) elements. Every load (the chunk's
// key and value rows by cp.async, the bias, q) is issued up front, so the
// partial costs one memory round trip; then one thread per key takes its
// dot product from shared memory (rows padded by 16 bytes against bank
// conflicts) and the P.V sum is spread over every thread.
template <typename T>
__device__ void attend_chunk(const float* q, const T* K, const T* Vv,
                             int stride, int j0, int j1, const float* bias,
                             float scale, int dh, float* part, float* sm,
                             T* stage) {
  constexpr int V = Vec<T>::N;
  float* qs = sm;
  float* ps = sm + dh;
  float* pv = ps + kChunk;
  const int row = dh + V;
  T* ks = stage;
  T* vs = stage + kChunk * row;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = j1 - j0;
  const int pieces = dh / V;
  for (int e = threadIdx.x; e < n * pieces; e += blockDim.x) {
    const int j = e / pieces, o = (e % pieces) * V;
    cp_async16(ks + j * row + o, K + (size_t)(j0 + j) * stride + o);
    cp_async16(vs + j * row + o, Vv + (size_t)(j0 + j) * stride + o);
  }
  const float b = threadIdx.x < n ? bias[j0 + threadIdx.x] : 0.f;
  for (int t = threadIdx.x; t < dh; t += blockDim.x) qs[t] = q[t];
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < n) {
    const T* kr = ks + threadIdx.x * row;
    float s = 0.f;
    for (int t = 0; t < dh; t += V) {
      float kv[V];
      load_vec_rw(kr + t, kv);
#pragma unroll
      for (int k = 0; k < V; ++k) s = fmaf(qs[t + k], kv[k], s);
    }
    ps[threadIdx.x] = s * scale + b;
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    for (int t = lane; t < n; t += kWarp) m = fmaxf(m, ps[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += kWarp) {
      const float e = expf(ps[t] - m);
      ps[t] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part[0] = m;
      part[1] = l;
    }
  }
  __syncthreads();
  // thread (g, t) sums dim t over the keys j = g mod groups
  const int groups = blockDim.x / dh;
  if (threadIdx.x < groups * dh) {
    const int t = threadIdx.x % dh, g = threadIdx.x / dh;
    float a = 0.f;
    for (int j = g; j < n; j += groups)
      a = fmaf(ps[j], to_f(vs[j * row + t]), a);
    pv[threadIdx.x] = a;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < dh; t += blockDim.x) {
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += pv[g * dh + t];
    part[4 + t] = a;
  }
  __syncthreads();
}

// Every block: combine the chunk partials of all heads (plus, for self
// attention, the fresh q, k, v of this step: ``qkv`` non-null) into
// out[d], rounded to T. The block first copies every partial it needs
// (and qkv) into ``stage`` by cp.async, in one round trip; then one warp
// per head
// combines them, lane c holding chunk c's statistics (n_chunks <= 32,
// Dh <= 64: the wrapper checks both).
template <typename T>
__device__ void combine_heads(const ScanParams& P, int n_chunks,
                              const float* qkv, const float* bias_fresh,
                              float* out, float* stage) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int d = P.d, dh = d / P.n_heads, row = dh + 4;
  const int per_head = n_chunks * row;
  const bool fresh = qkv != nullptr;
  float* st_qkv = stage + P.n_heads * per_head;
  for (int e = threadIdx.x * 4; e < P.n_heads * per_head;
       e += blockDim.x * 4) {
    const int h = e / per_head;
    cp_async16(stage + e,
               P.part + (size_t)h * P.max_chunks * row + (e - h * per_head));
  }
  if (fresh) {
    for (int e = threadIdx.x * 4; e < 3 * d; e += blockDim.x * 4)
      cp_async16(st_qkv + e, qkv + e);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int h = warp; h < P.n_heads; h += n_warps) {
    const float* ph = stage + h * per_head;
    float lp = -INFINITY;
    if (fresh) {
      float s = 0.f;
      for (int t = lane; t < dh; t += kWarp)
        s = fmaf(st_qkv[h * dh + t], st_qkv[d + h * dh + t], s);
      lp = warp_sum(s) * P.scale + bias_fresh[h];
    }
    const bool mine = lane < n_chunks;
    const float mc = mine ? ph[lane * row] : -INFINITY;
    const float lc = mine ? ph[lane * row + 1] : 0.f;
    const float m = fmaxf(warp_max(mc), lp);
    const float wc = mine ? expf(mc - m) : 0.f;
    const float w_fresh = fresh ? expf(lp - m) : 0.f;
    const float den = fmaxf(warp_sum(lc * wc) + w_fresh, 1e-20f);
    const int t0 = lane, t1 = lane + kWarp;
    float a0 = 0.f, a1 = 0.f;
    if (fresh) {
      if (t0 < dh) a0 = w_fresh * st_qkv[2 * d + h * dh + t0];
      if (t1 < dh) a1 = w_fresh * st_qkv[2 * d + h * dh + t1];
    }
    for (int c = 0; c < n_chunks; ++c) {
      const float w = __shfl_sync(0xffffffffu, wc, c);
      const float* pc = ph + c * row + 4;
      if (t0 < dh) a0 = fmaf(pc[t0], w, a0);
      if (t1 < dh) a1 = fmaf(pc[t1], w, a1);
    }
    if (t0 < dh) out[h * dh + t0] = round_to<T>(a0 / den);
    if (t1 < dh) out[h * dh + t1] = round_to<T>(a1 / den);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    decode_scan_kernel(const ScanParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int d = P.d, H = P.n_heads, dh = d / H, c = P.channels;
  const int vmax = d > P.d_ff ? d : P.d_ff;
  float* vin = reinterpret_cast<float*>(smem4);  // GEMV input [vmax]
  float* xs = vin + vmax;                        // residual copy [d]
  float* red = xs + d;                           // reductions [64]
  float* att = red + 64;                         // [dh + kChunk + 512]
  float* stage = att + dh + kChunk + kThreads;   // stage_floats(P)
  __shared__ int s_tok;

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
  const T* w_logits = static_cast<const T*>(P.w_logits);
  const T* emb = static_cast<const T*>(P.emb);
  const T* posfull = static_cast<const T*>(P.posfull);
  const T* mem_k = static_cast<const T*>(P.mem_k);
  const T* mem_v = static_cast<const T*>(P.mem_v);
  T* kv = static_cast<T*>(P.kv);
  float* x = P.x;
  float* qkv = P.qkv;

  int last_tok = 0;  // token written at index i of the previous step
  for (int p = P.p0; p < P.steps; ++p) {
    const int i = p - (c - 1);
    int tok;
    if (p < c) {
      tok = P.n_class;  // start rows: the all-zeros embedding row
    } else if (p > P.p0) {
      tok = last_tok;  // index p - c was sampled by the previous step
    } else {
      tok = P.tokens[p - c];
    }

    for (int l = 0; l < P.n_layers; ++l) {
      const float* ln = P.ln + (size_t)l * 6 * d;
      const size_t row_l = ((size_t)l * P.steps_pad + p) * H;
      // ---- A: LN1 + qkv GEMV
      if (l == 0) {
        for (int t = threadIdx.x; t < d; t += blockDim.x) {
          xs[t] = to_f(emb[(size_t)tok * d + t])
                  + to_f(posfull[(size_t)p * d + t]);
          if (blockIdx.x == 0) x[t] = xs[t];
        }
      } else {
        for (int t = threadIdx.x; t < d; t += blockDim.x) xs[t] = x[t];
      }
      __syncthreads();
      block_layer_norm<T>(xs, ln, ln + d, d, vin, red);
      gemv_rows(wqkv + (size_t)l * 3 * d * d, 3 * d, d, vin,
                [&](int r, float acc) {
                  qkv[r] = acc + to_f(bqkv[(size_t)l * 3 * d + r]);
                });
      grid.sync();

      // ---- B: self-attention partials over cache rows [0, p); the fresh
      // K/V row p goes into the cache
      T* kc = kv + (size_t)(2 * l) * P.l_pad * d;
      T* vc = kc + (size_t)P.l_pad * d;
      const int n_self = (p + kChunk - 1) / kChunk;
      for (int item = blockIdx.x; item < H * n_self; item += gridDim.x) {
        const int h = item / n_self, ch = item % n_self;
        const int j0 = ch * kChunk;
        const int j1 = min(j0 + kChunk, p);
        attend_chunk(qkv + h * dh, kc + h * dh, vc + h * dh, d, j0, j1,
                     P.bias_hm + (row_l + h) * P.l_pad, P.scale, dh,
                     P.part + ((size_t)h * P.max_chunks + ch) * (dh + 4),
                     att, reinterpret_cast<T*>(stage));
      }
      if (blockIdx.x == gridDim.x - 1) {
        for (int t = threadIdx.x; t < d; t += blockDim.x) {
          kc[(size_t)p * d + t] = from_f<T>(qkv[d + t]);
          vc[(size_t)p * d + t] = from_f<T>(qkv[2 * d + t]);
        }
      }
      grid.sync();

      // ---- C: combine with the fresh key, O projection, residual. The
      // aligned cross attention (a gather of mem_v[p // c], independent of
      // x) adds its projection in the same phase: each warp owns the same
      // rows in both GEMVs, so x[r] still takes the two sums in order.
      const T* mk = mem_k + (size_t)l * P.e_pad * d;
      const T* mv = mem_v + (size_t)l * P.e_pad * d;
      if (threadIdx.x < H) red[threadIdx.x] =
          P.bias_hm[(row_l + threadIdx.x) * P.l_pad + p];
      if (P.aligned) {
        const int e_q = p / c;
        for (int t = threadIdx.x; t < d; t += blockDim.x)
          xs[t] = e_q < P.e_pad ? to_f(mv[(size_t)e_q * d + t]) : 0.f;
      }
      __syncthreads();
      combine_heads<T>(P, n_self, qkv, red, vin, stage);
      if (P.aligned) {
        gemv_rows2(wo + (size_t)l * d * d, vin, wo_c + (size_t)l * d * d, xs,
                   d, d, [&](int r, float a_self, float a_cross) {
                     x[r] = (x[r] + (a_self + to_f(bo[(size_t)l * d + r])))
                            + (a_cross + to_f(bo_c[(size_t)l * d + r]));
                   });
      } else {
        gemv_rows(wo + (size_t)l * d * d, d, d, vin, [&](int r, float acc) {
          x[r] = x[r] + (acc + to_f(bo[(size_t)l * d + r]));
        });
        grid.sync();
        // ---- D: cross attention over the E_src source keys
        for (int t = threadIdx.x; t < d; t += blockDim.x) xs[t] = x[t];
        __syncthreads();
        block_layer_norm<T>(xs, ln + 2 * d, ln + 3 * d, d, vin, red);
        gemv_rows(wq_c + (size_t)l * d * d, d, d, vin,
                  [&](int r, float acc) {
                    P.qc[r] = acc + to_f(bq_c[(size_t)l * d + r]);
                  });
        grid.sync();
        const int n_cross = (P.e_src + kChunk - 1) / kChunk;
        for (int item = blockIdx.x; item < H * n_cross; item += gridDim.x) {
          const int h = item / n_cross, ch = item % n_cross;
          const int j0 = ch * kChunk;
          const int j1 = min(j0 + kChunk, P.e_src);
          attend_chunk(P.qc + h * dh, mk + h * dh, mv + h * dh, d, j0, j1,
                       P.cross_hm + (row_l + h) * P.e_pad, P.scale, dh,
                       P.part + ((size_t)h * P.max_chunks + ch) * (dh + 4),
                       att, reinterpret_cast<T*>(stage));
        }
        grid.sync();
        combine_heads<T>(P, n_cross, nullptr, nullptr, vin, stage);
        gemv_rows(wo_c + (size_t)l * d * d, d, d, vin, [&](int r, float acc) {
          x[r] = x[r] + (acc + to_f(bo_c[(size_t)l * d + r]));
        });
      }
      grid.sync();

      // ---- E: LN3 + MLP in
      for (int t = threadIdx.x; t < d; t += blockDim.x) xs[t] = x[t];
      __syncthreads();
      block_layer_norm<T>(xs, ln + 4 * d, ln + 5 * d, d, vin, red);
      gemv_rows(w1 + (size_t)l * P.d_ff * d, P.d_ff, d, vin,
                [&](int r, float acc) {
                  P.mid[r] = round_to<T>(
                      fmaxf(acc + to_f(b1[(size_t)l * P.d_ff + r]), 0.f));
                });
      grid.sync();

      // ---- F: MLP out + residual
      for (int t = threadIdx.x; t < P.d_ff; t += blockDim.x)
        vin[t] = P.mid[t];
      __syncthreads();
      gemv_rows(w2 + (size_t)l * d * P.d_ff, d, P.d_ff, vin,
                [&](int r, float acc) {
                  x[r] = x[r] + (acc + to_f(b2[(size_t)l * d + r]));
                });
      grid.sync();
    }

    // ---- G: final LN + logits
    for (int t = threadIdx.x; t < d; t += blockDim.x) xs[t] = x[t];
    __syncthreads();
    block_layer_norm<T>(xs, P.ln_final, P.ln_final + d, d, vin, red);
    gemv_rows(w_logits, P.n_class, d, vin, [&](int r, float acc) {
      P.logits[r] = (acc + P.b_logits[r]) / P.temperature;
    });
    grid.sync();

    // ---- H: Gumbel argmax (every block, same answer); block 0 writes
    const float* g = P.gumbel + (size_t)(p - P.p0) * P.n_class;
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int r = threadIdx.x; r < P.n_class; r += blockDim.x) {
      const float v = P.logits[r] + g[r];
      if (v > best || (v == best && r < best_i)) {
        best = v;
        best_i = r;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    __syncthreads();
    if (lane == 0) {
      red[warp] = best;
      reinterpret_cast<int*>(red)[32 + warp] = best_i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float b = red[0];
      int bi = reinterpret_cast<int*>(red)[32];
      for (int w = 1; w < (int)(blockDim.x / kWarp); ++w) {
        const float ob = red[w];
        const int oi = reinterpret_cast<int*>(red)[32 + w];
        if (ob > b || (ob == b && oi < bi)) {
          b = ob;
          bi = oi;
        }
      }
      if (bi == 0x7fffffff) bi = 0;
      const int i_clip = i < 0 ? 0 : (i > P.length - 1 ? P.length - 1 : i);
      const bool take = i >= 0 && P.mask[i_clip];
      const int new_tok = take ? bi : P.tokens[i_clip];
      if (take && blockIdx.x == 0) P.tokens[i_clip] = bi;
      s_tok = new_tok;
    }
    __syncthreads();
    last_tok = s_tok;
  }
}

// floats of the staging region: the larger of an attention chunk's key and
// value rows and a combine's partials plus q, k, v
template <typename T>
static size_t stage_floats(const ScanParams& P) {
  const int dh = P.d / P.n_heads;
  const size_t chunk = (2 * (size_t)kChunk * (dh + Vec<T>::N) * sizeof(T)
                        + sizeof(float) - 1) / sizeof(float);
  const size_t comb = (size_t)P.n_heads * P.max_chunks * (dh + 4)
                      + 3 * (size_t)P.d;
  return chunk > comb ? chunk : comb;
}

template <typename T>
static size_t smem_bytes(const ScanParams& P) {
  const int vmax = P.d > P.d_ff ? P.d : P.d_ff;
  const int dh = P.d / P.n_heads;
  return sizeof(float) * ((size_t)(vmax + P.d + 64 + dh + kChunk + kThreads)
                          + stage_floats<T>(P));
}

template <typename T>
static cudaError_t grid_size(const ScanParams& P, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = 0, coop = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  e = cudaFuncSetAttribute(decode_scan_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes<T>(P)));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_scan_kernel<T>, kThreads, smem_bytes<T>(P));
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms;  // one resident block per SM
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch(const ScanParams& P, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t e = grid_size<T>(P, &blocks);
  if (e != cudaSuccess) return e;
  ScanParams arg = P;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decode_scan_kernel<T>), dim3(blocks),
      dim3(kThreads), args, smem_bytes<T>(P), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_decode_scan(const ScanParams* P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? launch<__nv_bfloat16>(*P, s)
                                     : launch<float>(*P, s));
}

extern "C" int isi_decode_scan_grid(const ScanParams* P, int dtype) {
  int blocks = 0;
  cudaError_t e = dtype == 1 ? grid_size<__nv_bfloat16>(*P, &blocks)
                             : grid_size<float>(*P, &blocks);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

extern "C" int isi_decode_scan_threads() { return kThreads; }

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
