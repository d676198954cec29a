// Prefix priming: fill the decoder's self-attention KV cache for the known
// prefix [0, p0) of an inpaint with one forward over all p0 rows.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/prefix_prime_kernel.py
//           ::fused_prefix_prime (Pallas kernel _prefix_prime_kernel).
//
// Bound on the H100: at the full priors (d 512, d_ff 2048, p0 up to 640
// rows) each layer is a handful of [p0, 512] x [512, 1536 | 512 | 2048]
// products, ~2 GFLOP per prefix of 512 rows over 8 layers, against ~60 MB
// of weights and bias tables read once: the products bound it, on the
// tensor cores. The TPU kernel ran the whole forward in one call with every
// operand in VMEM; here too the whole prefix is ONE persistent cooperative
// launch (a block per SM), its phases separated by grid barriers:
//
//   per layer   LN1 | P1 qkv (+ the K/V rows into the cache)
//               | P2 causal self attention with the relative-bias table
//               (key tiles | their combine)
//               | P3 wo (aligned: + the gathered memory rows times wo_c)
//               + residual
//               [cross: | LN2 | wq_c | attention over the source keys
//               with the cross-bias table (key tiles | combine) | wo_c +
//               residual]
//               | LN3 | P7 fc1 + ReLU | P8 fc2 + residual
//   last layer  LN1 | P1: its K/V rows are all the cache needs.
//
// Products: 64 x 64 output tiles dealt round robin over the blocks, 8 warps
// of 16 x 32 each, mma.sync (mma.cuh): bfloat16 as m16n8k16, float32 as
// split TF32; both operands staged by cp.async in slices 128 deep, three
// buffered (float32: 64 deep, two); a fresh accumulator per 32 columns,
// added in float32 (the tensor cores truncate what they add into).
// Epilogues fuse the bias, ReLU, the residual and the cache store. A
// product with few tiles (small M: wo, wq_c, wo_c, fc2) is split over K
// across the idle blocks and its splits added in order. A LayerNorm is a
// phase of its own (a warp a row, one round trip), writing the T rows the
// next product reads: taken inside each product tile instead, it ran once
// per column tile of its rows (24 times for qkv), each time one round trip
// per row.
//
// Attention: an item per (sequence, head, 64 query rows, 64-key tile), so
// that the last query tile's keys are spread over as many blocks as it has
// key tiles: S = Q K^T and P V on the tensor cores in split TF32 (the
// queries, keys and values are the float32 projections, as the plain
// version takes them), the bias and the causal mask added in float32; each
// item leaves its rows' partial (max, sum, P V), and after a grid barrier a
// warp a row combines the row's partials in key order.
//
// Widths: head_dim up to 128 (the attention tiles are instantiated for 64
// and 128 dims, the shared memory sized for the head_dim of the call) and
// d_model up to 2048 (a LayerNorm row above 1024, more than a warp holds in
// registers, is read three times from L2).
//
// A batch of sequences shares every product (M = batch x p0 rows). Only
// rows [0, p0) are computed: a causal prefix row never sees a later row, so
// the padded rows the TPU kernel carried are not needed; cache rows [p0,
// p_pad) are written as zeros, as the TPU kernel does.
#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace cg = cooperative_groups;
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
  // scratch, rows R = b * m + i
  float* x;    // [batch m, d], the residual
  void* h;     // [batch m, d], T: a LayerNorm's output
  float* qkv;  // [batch m, 3d]
  float* qc;   // [batch m, d]
  void* a;     // [batch m, d], T: attention outputs
  void* mid;   // [batch m, d_ff], T
  float* part;  // attention partials [items, 64, dh + 2]
  float* ws;    // split products' partials [2, splits, batch m, d]
  int n_layers, d, d_ff, n_heads, m, p_pad, l_pad, e_pad, steps_pad;
  int channels, e_src, aligned, batch, x_rows;
  float scale;
};

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / kWarp;
constexpr int kBM = 64, kBN = 64;  // output tile
constexpr int kSub = 32;           // columns a fresh accumulator takes
constexpr int kTile = 64;          // attention: query rows and keys a tile
constexpr int kDhMax = 128;
constexpr int kDMax = 2048;        // d_model

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// row strides in elements: rows 16 bytes apart from the next bank group
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}
// depth of a staged slice: 128 columns in bf16, 64 in float32 (fewer,
// deeper slices: each slice costs a wait and a block barrier)
template <typename T> __host__ __device__ constexpr int bk_max() {
  return sizeof(T) == 2 ? 128 : 64;
}
template <typename T> __host__ __device__ constexpr int slice_ld() {
  return bk_max<T>() + pad<T>();
}
// float32 rows of the attention tiles of head dims up to DH
template <int DH> __host__ __device__ constexpr int attn_ld() { return DH + 4; }
// the attention tiles' head-dim instantiation: 64 or 128
__host__ __device__ inline int attn_dh(int dh) { return dh <= 64 ? 64 : 128; }

// the depth of a product's slices: the deepest of bk_max, 64 and 32 that
// divides K
template <typename T> __host__ __device__ inline int slice_depth(int K) {
  return K % bk_max<T>() == 0 ? bk_max<T>() : K % 64 == 0 ? 64 : kSub;
}
// splits of a product's depth K when its tiles leave blocks idle: the most
// that divide K into whole slices with tiles x splits within the grid
template <typename T>
__host__ __device__ inline int split_k(int tiles, int K, int grid) {
  const int nk = K / slice_depth<T>(K);
  int best = 1;
  for (int s = 2; s <= nk; ++s)
    if (nk % s == 0 && tiles * s <= grid) best = s;
  return best;
}
template <typename T> __host__ __device__ inline size_t slice_elems() {
  return (size_t)kBM * slice_ld<T>();
}
// slices of an operand in flight: the copies of slice k + stages - 1 go
// while slice k is multiplied (one memory round trip hidden per slice)
template <typename T> __host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? 3 : 2;
}

// Bytes of dynamic shared memory: the larger of a product's operands (the
// slices of two A and two W operands) and the attention's Q, K, V tiles
// (float32), the bias tile, and the T rows of K and V they are widened
// from, for the head-dim instantiation of dh.
template <typename T> __host__ __device__ inline size_t smem_bytes(int dh) {
  const int DH = attn_dh(dh);
  const size_t ops = 4 * stages<T>() * slice_elems<T>() * sizeof(T);
  const size_t attn = (size_t)4 * kTile * (DH + 4) * sizeof(float)
                      + (size_t)2 * kTile * DH * sizeof(T);
  return ops > attn ? ops : attn;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// float32 B fragment [k][n] = s[n0 + n][k0 + k], split on the fly
__device__ __forceinline__ Mma<float>::B b_nk_f32(const float* s, int ld,
                                                  int n0, int k0) {
  const int i = (n0 + lane_g()) * ld + k0 + lane_t();
  Mma<float>::B b;
  Mma<float>::split(s[i], b.hi[0], b.lo[0]);
  Mma<float>::split(s[i + 4], b.hi[1], b.lo[1]);
  return b;
}
// float32 B fragment [k][n] = s[k0 + k'][n0 + n] in the contraction order
// that Mma<float>::c_to_a permutes (rows 2t and 2t + 1), split on the fly
__device__ __forceinline__ Mma<float>::B b_kn_f32(const float* s, int ld,
                                                  int k0, int n0) {
  const int i = (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  Mma<float>::B b;
  Mma<float>::split(s[i], b.hi[0], b.lo[0]);
  Mma<float>::split(s[i + ld], b.hi[1], b.lo[1]);
  return b;
}
template <typename T> struct Frag;
template <> struct Frag<float> {
  static __device__ __forceinline__ Mma<float>::B b(const float* s, int ld,
                                                   int n0, int k0) {
    return b_nk_f32(s, ld, n0, k0);
  }
};
template <> struct Frag<__nv_bfloat16> {
  static __device__ __forceinline__ Mma<__nv_bfloat16>::B b(
      const __nv_bfloat16* s, int ld, int n0, int k0) {
    return Mma<__nv_bfloat16>::load_b_nk(s, nullptr, ld, n0, k0);
  }
};

// rows [r0, r0 + 64) x columns [k0, k0 + kb) of a row-major operand into
// a slice (rows at row(r), null for a row past the operand: zeros)
template <typename T, typename Row>
__device__ __forceinline__ void stage_slice(T* dst, Row row, int k0, int kb) {
  constexpr int V = Vec<T>::N;
  const int per = kb / V;
  for (int e = threadIdx.x; e < kBM * per; e += kThreads) {
    const int r = e / per, c = (e % per) * V;
    T* to = dst + r * slice_ld<T>() + c;
    const T* from = row(r);
    if (from != nullptr) cp_async16(to, from + k0 + c);
    else *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
  }
}

// One 64 x 64 tile of sum over the NOP operand pairs of A_o W_o^T (K deep),
// handed to epi(row, col, v[NOP]) for rows < M, cols < N. W_o rows at
// wrow(o, n) (null past N), A_o rows at arow(o, r) (null past M).
template <typename T, int NOP, typename WRow, typename ARow, typename Epi>
__device__ void tile_product(T* sm, WRow wrow, ARow arow, int K, int r0,
                             int c0, int M, int N, Epi epi) {
  using MM = Mma<T>;
  constexpr int S = stages<T>();
  const int warp = threadIdx.x / kWarp, wm = warp % 4, wn = warp / 4;
  const size_t se = slice_elems<T>();
  // slices: W_o buffer b at sm + (S o + b) se; A_o at sm + (S (NOP + o) + b)
  // se
  auto w_buf = [&](int o, int b) { return sm + (S * o + b) * se; };
  auto a_buf = [&](int o, int b) { return sm + (S * (NOP + o) + b) * se; };
  const int kb = slice_depth<T>(K);
  auto stage = [&](int ks, int b) {
#pragma unroll
    for (int o = 0; o < NOP; ++o) {
      stage_slice(w_buf(o, b), [&](int r) { return wrow(o, c0 + r); },
                  ks * kb, kb);
      stage_slice(a_buf(o, b), [&](int r) { return arow(o, r0 + r); },
                  ks * kb, kb);
    }
    cp_async_commit();
  };
  float acc[NOP][4][4];
#pragma unroll
  for (int o = 0; o < NOP; ++o)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][j][e] = 0.f;
  const int nk = K / kb;
  // one commit group per slice (empty past the last), so that group ks is
  // complete once at most S - 2 newer ones are pending
  for (int ks = 0; ks < S - 1; ++ks) {
    if (ks < nk) stage(ks, ks);
    else cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    const int b = ks % S;
    cp_async_wait<S - 2>();
    __syncthreads();
    // slice ks - 1's buffer is free: refill it with slice ks + S - 1
    if (ks + S - 1 < nk) stage(ks + S - 1, (ks + S - 1) % S);
    else cp_async_commit();
#pragma unroll
    for (int o = 0; o < NOP; ++o) {
      const T* as = a_buf(o, b);
      const int lda = slice_ld<T>();
      const T* ws = w_buf(o, b);
      for (int kk = 0; kk < kb; kk += kSub) {
        float f[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < kSub; k0 += MM::KS) {
          const typename MM::A fa =
              MM::load_a(as + 16 * wm * lda, lda, kk + k0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            MM::run(f[j], fa, Frag<T>::b(ws, slice_ld<T>(),
                                         32 * wn + 8 * j, kk + k0));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[o][j][e] += f[j][e];
      }
    }
  }
  __syncthreads();  // the buffers are free for the next tile
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 16 * wm + g + 8 * (e >> 1);
      const int c = c0 + 32 * wn + 8 * j + 2 * t + (e & 1);
      if (r < M && c < N) {
        float v[NOP];
#pragma unroll
        for (int o = 0; o < NOP; ++o) v[o] = acc[o][j][e];
        epi(r, c, v);
      }
    }
}

// LayerNorm of one residual row xr [d] (other blocks wrote it: read
// through L2) into out (T), by one warp, the row's loads in flight at once
template <typename T>
__device__ __forceinline__ void ln_row(const float* xr, int d,
                                       const float* scale, const float* bias,
                                       T* out) {
  const int lane = threadIdx.x % kWarp;
  if (d > 32 * kWarp) {
    // wider than the registers hold: the row read three times
    float s = 0.f;
    for (int k = lane; k < d; k += kWarp) s += __ldcg(xr + k);
    const float mu = warp_sum(s) / d;
    float var = 0.f;
    for (int k = lane; k < d; k += kWarp) {
      const float dv = __ldcg(xr + k) - mu;
      var += dv * dv;
    }
    const float rs = rsqrtf(warp_sum(var) / d + 1e-6f);
    for (int k = lane; k < d; k += kWarp)
      out[k] = from_f<T>((__ldcg(xr + k) - mu) * rs * scale[k] + bias[k]);
    return;
  }
  float v[32];
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    const int k = lane + u * kWarp;
    v[u] = k < d ? __ldcg(xr + k) : 0.f;
    s += v[u];
  }
  const float mu = warp_sum(s) / d;
  float var = 0.f;
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    const int k = lane + u * kWarp;
    if (k < d) {
      const float dv = v[u] - mu;
      var += dv * dv;
    }
  }
  const float rs = rsqrtf(warp_sum(var) / d + 1e-6f);
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    const int k = lane + u * kWarp;
    if (k < d) out[k] = from_f<T>((v[u] - mu) * rs * scale[k] + bias[k]);
  }
}

// LayerNorm of every residual row into h [M][d] (T): a warp a row, over
// the grid
template <typename T>
__device__ void ln_rows(const float* x, int M, int d, const float* scale,
                        const float* bias, T* h) {
  const int n_warps = gridDim.x * kWarps;
  for (int r = (blockIdx.x * kThreads + threadIdx.x) / kWarp; r < M;
       r += n_warps)
    ln_row<T>(x + (size_t)r * d, d, scale, bias, h + (size_t)r * d);
}

// rows [r0, r0 + 64) of a [*, dh] operand (rows at row(r), r < n) into dst
// [64][ld] float32, zeros past n: float32 rows straight in by cp.async, T
// rows by cp.async into raw [64][dh] (widened by widen_tile once they
// landed)
template <typename TS, typename Row>
__device__ void load_attn_tile(float* dst, int ld, TS* raw, Row row, int r0,
                               int n, int dh) {
  constexpr int V = Vec<TS>::N;
  const int per = dh / V;
  for (int e = threadIdx.x; e < kTile * per; e += kThreads) {
    const int r = e / per, c = (e % per) * V;
    TS* to = sizeof(TS) == 4 ? reinterpret_cast<TS*>(dst + r * ld + c)
                             : raw + r * dh + c;
    if (r0 + r < n) cp_async16(to, row(r0 + r) + c);
    else *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
  }
}
template <typename TS>
__device__ void widen_tile(float* dst, int ld, const TS* raw, int dh) {
  if (sizeof(TS) == 2) {
    for (int e = threadIdx.x; e < kTile * dh; e += kThreads)
      dst[(e / dh) * ld + e % dh] = to_f(raw[e]);
  }
}

// One attention item: query rows [i0, i0 + 64) of one (sequence, head)
// against the key tile [j0, j0 + 64): row i takes keys j < n_keys (and
// j <= i when causal) with logits (q_i . k_j) * scale + bias[i * bias_q +
// j]. The tile's partial of each row, {max s, sum exp(s - max), sum
// exp(s - max) V}, goes to part [64][dh + 2] (rows past m not written).
// q rows at qrow(i) (float32), key and value rows at krow(j), vrow(j)
// (float32 or TK), bias rows at bias + i * bias_q. DH: the tiles' head
// dims (dh <= DH).
template <int DH, typename TK, typename QRow, typename KRow, typename VRow>
__device__ void attention_tile(float* sm, QRow qrow, KRow krow, VRow vrow,
                               const float* bias, size_t bias_q, int i0,
                               int j0, int m, int n_keys, bool causal, int dh,
                               float scale, float* part) {
  using MM = Mma<float>;
  constexpr int kAttnLd = attn_ld<DH>();
  float* Qs = sm;
  float* Ks = Qs + kTile * kAttnLd;
  float* Vs = Ks + kTile * kAttnLd;
  float* Bs = Vs + kTile * kAttnLd;  // the tile's bias [query][key]
  TK* raw_k = reinterpret_cast<TK*>(Bs + kTile * kAttnLd);
  TK* raw_v = raw_k + kTile * DH;
  const int warp = threadIdx.x / kWarp, g = lane_g(), t = lane_t();
  const int nd = dh / 8;  // n-blocks of the output
  load_attn_tile(Qs, kAttnLd, static_cast<float*>(nullptr), qrow, i0, m, dh);
  load_attn_tile(Ks, kAttnLd, raw_k, krow, j0, n_keys, dh);
  load_attn_tile(Vs, kAttnLd, raw_v, vrow, j0, n_keys, dh);
  // bias rows i of keys [j0, j0 + 64) (within the padded rows)
  load_attn_tile(Bs, kAttnLd, static_cast<float*>(nullptr),
                 [&](int i) { return bias + (size_t)i * bias_q + j0; }, i0, m,
                 kTile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (sizeof(TK) == 2) {
    widen_tile(Ks, kAttnLd, raw_k, dh);
    widen_tile(Vs, kAttnLd, raw_v, dh);
    __syncthreads();
  }
  // 4 warps, 16 query rows each (the other 4 idle here)
  if (warp < 4) {
    const int rw = 16 * warp;
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int k0 = 0; k0 < dh; k0 += MM::KS) {
      const MM::A fa = MM::load_a(Qs + rw * kAttnLd, kAttnLd, k0);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
        MM::run(s[j], fa, b_nk_f32(Ks, kAttnLd, 8 * j, k0));
    }
    // logits, the mask, the row maxima (rows g and g + 8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + rw + g + 8 * (e >> 1);
        const int key = j0 + 8 * j + 2 * t + (e & 1);
        const bool valid = i < m && key < n_keys && (!causal || key <= i);
        s[j][e] = valid ? s[j][e] * scale
                              + Bs[(i - i0) * kAttnLd + key - j0]
                        : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - mx[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const MM::A fa = MM::c_to_a(s, j);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        if (n < nd) MM::run(o[n], fa, b_kn_f32(Vs, kAttnLd, 8 * j, 8 * n));
    }
    const int row = dh + 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + g + 8 * h;
      if (t == 0 && i0 + r < m) {
        part[r * row] = mx[h];
        part[r * row + 1] = l[h];
      }
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + g + 8 * (e >> 1);
        if (n < nd && i0 + r < m)
          part[r * row + 2 + 8 * n + 2 * t + (e & 1)] = o[n][e];
      }
  }
  __syncthreads();
}

// The attention output of one row from its n key tiles' partials (rows
// ``stride`` floats apart, in key order): out[c] = T(sum_t o_t[c] w_t /
// sum_t l_t w_t), w_t = exp(m_t - max m); a warp a row, dims 2 lane,
// 2 lane + 1 (and 64 above those for head_dim > 64) a lane (tiles that saw
// no key hold max -inf and zero sums)
template <typename T>
__device__ __forceinline__ void combine_row(const float* part, size_t stride,
                                            int n, int dh, T* out) {
  const int lane = threadIdx.x % kWarp;
  float mm = -INFINITY;
  for (int k = 0; k < n; ++k) mm = fmaxf(mm, __ldcg(part + k * stride));
  float den = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const int c = 2 * lane, c1 = c + 64;
  for (int k = 0; k < n; ++k) {
    const float* p = part + k * stride;
    const float mk = __ldcg(p);
    const float w = mk == -INFINITY ? 0.f : expf(mk - mm);
    den = fmaf(__ldcg(p + 1), w, den);
    if (c < dh) {
      a0 = fmaf(__ldcg(p + 2 + c), w, a0);
      a1 = fmaf(__ldcg(p + 3 + c), w, a1);
    }
    if (c1 < dh) {
      a2 = fmaf(__ldcg(p + 2 + c1), w, a2);
      a3 = fmaf(__ldcg(p + 3 + c1), w, a3);
    }
  }
  if (c < dh) {
    out[c] = from_f<T>(a0 / den);
    out[c + 1] = from_f<T>(a1 / den);
  }
  if (c1 < dh) {
    out[c1] = from_f<T>(a2 / den);
    out[c1 + 1] = from_f<T>(a3 / den);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    prefix_prime_kernel(const PrimeParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  float* smf = reinterpret_cast<float*>(smem4);
  const int d = P.d, H = P.n_heads, dh = d / H, dff = P.d_ff, m = P.m;
  const int B = P.batch, M = B * m, G = gridDim.x;
  const size_t dd = (size_t)d * d;
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
  const T* xp = static_cast<const T*>(P.x_prefix);
  T* kv = static_cast<T*>(P.kv);
  T* a = static_cast<T*>(P.a);
  T* hn = static_cast<T*>(P.h);
  T* mid = static_cast<T*>(P.mid);
  // attention items: query tiles, key tiles at or below a query tile
  // (self), key tiles (cross); a partial row of dh + 2 floats
  const int nq = cdiv(m, kTile), tri = nq * (nq + 1) / 2;
  const int nkc = cdiv(P.e_src, kTile), prow = dh + 2;
  const int n_warps = G * kWarps;
  const int warp_g = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const size_t cache = (size_t)P.l_pad * d;  // one sequence of one cache

  // the products of a phase: tiles (row tile, column tile) round robin
  auto products = [&](int N, auto&& body) {
    const int nr = cdiv(M, kBM), nc = cdiv(N, kBN);
    for (int tile = blockIdx.x; tile < nr * nc; tile += G)
      body((tile / nc) * kBM, (tile % nc) * kBN);
  };
  // A product with d outputs a row (wo, wo_c, wq_c, fc2). When its tiles
  // leave blocks idle (few rows) it is split over K: each split's partial
  // into P.ws and, after a grid barrier, each output adds its splits in
  // order before epi(r, c, v[NOP]) (an element a thread).
  auto d_product = [&](auto nop, int K, auto&& wrow, auto&& arow,
                       auto&& epi) {
    constexpr int NOP = decltype(nop)::value;
    const int nc = cdiv(d, kBN), tiles = cdiv(M, kBM) * nc;
    const int S = split_k<T>(tiles, K, G);
    if (S == 1) {
      products(d, [&](int r0, int c0) {
        tile_product<T, NOP>(sm, wrow, arow, K, r0, c0, M, d, epi);
      });
      return;
    }
    const int ks = K / S;
    for (int it = blockIdx.x; it < tiles * S; it += G) {
      const int tile = it / S, s = it % S, k0 = s * ks;
      tile_product<T, NOP>(
          sm,
          [&](int o, int n) -> const T* {
            const T* w = wrow(o, n);
            return w != nullptr ? w + k0 : nullptr;
          },
          [&](int o, int r) -> const T* {
            const T* x = arow(o, r);
            return x != nullptr ? x + k0 : nullptr;
          },
          ks, (tile / nc) * kBM, (tile % nc) * kBN, M, d,
          [&](int r, int c, const float* v) {
            for (int o = 0; o < NOP; ++o)
              P.ws[(((size_t)o * S + s) * M + r) * d + c] = v[o];
          });
    }
    grid.sync();
    const size_t md = (size_t)M * d;
    for (size_t e = blockIdx.x * kThreads + threadIdx.x; e < md;
         e += (size_t)G * kThreads) {
      float v[NOP];
      for (int o = 0; o < NOP; ++o) {
        float acc = __ldcg(P.ws + o * S * md + e);
        for (int s = 1; s < S; ++s) acc += __ldcg(P.ws + (o * S + s) * md + e);
        v[o] = acc;
      }
      epi(static_cast<int>(e / d), static_cast<int>(e % d), v);
    }
  };
  // a LayerNorm'd product: LN(x) -> h | h times W [N, d]
  auto ln_product = [&](const float* scale, const float* bias, const T* W,
                        int N, auto&& epi) {
    ln_rows<T>(P.x, M, d, scale, bias, hn);
    grid.sync();
    products(N, [&](int r0, int c0) {
      tile_product<T, 1>(
          sm,
          [&](int, int n) -> const T* {
            return n < N ? W + (size_t)n * d : nullptr;
          },
          [&](int, int r) -> const T* {
            return r < M ? hn + (size_t)r * d : nullptr;
          },
          d, r0, c0, M, N, epi);
    });
  };

  // ---- set-up: x = x_prefix rows; cache rows [m, p_pad) = 0
  for (size_t e = blockIdx.x * kThreads + threadIdx.x; e < (size_t)M * d;
       e += (size_t)G * kThreads) {
    const size_t r = e / d;
    const int b = static_cast<int>(r / m), i = static_cast<int>(r % m);
    P.x[e] = to_f(xp[((size_t)b * P.x_rows + i) * d + e % d]);
  }
  const size_t tail = (size_t)(P.p_pad - m) * d;
  for (size_t e = blockIdx.x * kThreads + threadIdx.x;
       e < (size_t)P.n_layers * 2 * B * tail; e += (size_t)G * kThreads) {
    const size_t cb = e / tail;  // (layer, k|v, b)
    kv[cb * cache + (size_t)m * d + e % tail] = from_f<T>(0.f);
  }
  grid.sync();

  for (int l = 0; l < P.n_layers; ++l) {
    const float* ln = P.ln + (size_t)l * 6 * d;
    const bool last = l + 1 == P.n_layers;
    // ---- P1: LN1 + qkv; the K/V rows into the cache
    const T* bq = bqkv + (size_t)l * 3 * d;
    ln_product(ln, ln + d, wqkv + (size_t)l * 3 * dd, 3 * d,
               [&](int r, int c, const float* v) {
                 const float y = v[0] + to_f(bq[c]);
                 P.qkv[(size_t)r * 3 * d + c] = y;
                 if (c >= d) {
                   const int s = c / d - 1, b = r / m, i = r % m;
                   kv[((size_t)(2 * l + s) * B + b) * cache + (size_t)i * d
                      + c % d] = from_f<T>(y);
                 }
               });
    if (last) break;  // the rest of the last layer feeds no cache
    grid.sync();
    // ---- P2: causal self attention, an item per (sequence, head, query
    // tile, key tile at or below it), then a row's tiles combined
    const float* bias_l = P.bias_hm + (size_t)l * P.steps_pad * H * P.l_pad;
    for (int it = blockIdx.x; it < B * H * tri; it += G) {
      const int bh = it / tri, h = bh % H, b = bh / H;
      int qt = 0, tt = it % tri;
      while (tt > qt) tt -= ++qt;  // (qt, kt = tt): the tri-th item
      const float* base = P.qkv + (size_t)b * m * 3 * d + h * dh;
      const auto qrow = [&](int i) { return base + (size_t)i * 3 * d; };
      const auto krow = [&](int j) { return base + (size_t)j * 3 * d + d; };
      const auto vrow = [&](int j) {
        return base + (size_t)j * 3 * d + 2 * d;
      };
      float* pt = P.part + (size_t)it * kTile * prow;
      if (dh <= 64)
        attention_tile<64, float>(smf, qrow, krow, vrow,
                                  bias_l + (size_t)h * P.l_pad,
                                  (size_t)H * P.l_pad, qt * kTile,
                                  tt * kTile, m, m, true, dh, P.scale, pt);
      else
        attention_tile<128, float>(smf, qrow, krow, vrow,
                                   bias_l + (size_t)h * P.l_pad,
                                   (size_t)H * P.l_pad, qt * kTile,
                                   tt * kTile, m, m, true, dh, P.scale, pt);
    }
    grid.sync();
    for (int w = warp_g; w < B * m * H; w += n_warps) {
      const int h = w % H, r = w / H, i = r % m, qt = i / kTile;
      combine_row<T>(P.part + (((size_t)(r / m) * H + h) * tri
                                + qt * (qt + 1) / 2) * kTile * prow
                         + (size_t)(i % kTile) * prow,
                     (size_t)kTile * prow, qt + 1, dh,
                     a + (size_t)r * d + h * dh);
    }
    grid.sync();
    // ---- P3: wo (+ aligned: the memory row i // c times wo_c) + residual
    const T* bo_l = bo + (size_t)l * d;
    const T* bo_c_l = bo_c + (size_t)l * d;
    const T* wo_l = wo + (size_t)l * dd;
    const T* wo_c_l = wo_c + (size_t)l * dd;
    const T* mv_l = mem_v + (size_t)l * B * P.e_pad * d;
    auto a_rows = [&](int, int r) -> const T* {
      return r < M ? a + (size_t)r * d : nullptr;
    };
    if (P.aligned) {
      d_product(
          std::integral_constant<int, 2>{}, d,
          [&](int o, int n) -> const T* {
            return n < d ? (o ? wo_c_l : wo_l) + (size_t)n * d : nullptr;
          },
          [&](int o, int r) -> const T* {
            if (r >= M) return nullptr;
            if (o == 0) return a + (size_t)r * d;
            const int b = r / m, e = (r % m) / P.channels;
            return e < P.e_pad ? mv_l + ((size_t)b * P.e_pad + e) * d
                               : nullptr;
          },
          [&](int r, int c, const float* v) {
            float* xr = P.x + (size_t)r * d + c;
            *xr = (__ldcg(xr) + (v[0] + to_f(bo_l[c])))
                  + (v[1] + to_f(bo_c_l[c]));
          });
    } else {
      d_product(
          std::integral_constant<int, 1>{}, d,
          [&](int, int n) -> const T* {
            return n < d ? wo_l + (size_t)n * d : nullptr;
          },
          a_rows,
          [&](int r, int c, const float* v) {
            float* xr = P.x + (size_t)r * d + c;
            *xr = __ldcg(xr) + (v[0] + to_f(bo_l[c]));
          });
      grid.sync();
      // ---- LN2 + cross q
      const T* bqc = bq_c + (size_t)l * d;
      const T* wq_c_l = wq_c + (size_t)l * dd;
      ln_rows<T>(P.x, M, d, ln + 2 * d, ln + 3 * d, hn);
      grid.sync();
      d_product(
          std::integral_constant<int, 1>{}, d,
          [&](int, int n) -> const T* {
            return n < d ? wq_c_l + (size_t)n * d : nullptr;
          },
          [&](int, int r) -> const T* {
            return r < M ? hn + (size_t)r * d : nullptr;
          },
          [&](int r, int c, const float* v) {
            P.qc[(size_t)r * d + c] = v[0] + to_f(bqc[c]);
          });
      grid.sync();
      // ---- cross attention over the e_src source keys
      const float* cross_l =
          P.cross_hm + (size_t)l * P.steps_pad * H * P.e_pad;
      const T* mk_l = mem_k + (size_t)l * B * P.e_pad * d;
      // an item per (sequence, head, query tile, key tile), then a row's
      // tiles combined
      for (int it = blockIdx.x; it < B * H * nq * nkc; it += G) {
        const int kt = it % nkc, qt = (it / nkc) % nq, bh = it / (nkc * nq);
        const int h = bh % H, b = bh / H;
        const float* qb = P.qc + (size_t)b * m * d + h * dh;
        const T* kb = mk_l + (size_t)b * P.e_pad * d + h * dh;
        const T* vb = mv_l + (size_t)b * P.e_pad * d + h * dh;
        const auto qrow = [&](int i) { return qb + (size_t)i * d; };
        const auto krow = [&](int j) { return kb + (size_t)j * d; };
        const auto vrow = [&](int j) { return vb + (size_t)j * d; };
        float* pt = P.part + (size_t)it * kTile * prow;
        if (dh <= 64)
          attention_tile<64, T>(smf, qrow, krow, vrow,
                                cross_l + (size_t)h * P.e_pad,
                                (size_t)H * P.e_pad, qt * kTile, kt * kTile,
                                m, P.e_src, false, dh, P.scale, pt);
        else
          attention_tile<128, T>(smf, qrow, krow, vrow,
                                 cross_l + (size_t)h * P.e_pad,
                                 (size_t)H * P.e_pad, qt * kTile, kt * kTile,
                                 m, P.e_src, false, dh, P.scale, pt);
      }
      grid.sync();
      for (int w = warp_g; w < B * m * H; w += n_warps) {
        const int h = w % H, r = w / H, i = r % m;
        combine_row<T>(P.part + ((((size_t)(r / m) * H + h) * nq
                                  + i / kTile) * nkc) * kTile * prow
                           + (size_t)(i % kTile) * prow,
                       (size_t)kTile * prow, nkc, dh,
                       a + (size_t)r * d + h * dh);
      }
      grid.sync();
      // ---- cross O projection + residual
      d_product(
          std::integral_constant<int, 1>{}, d,
          [&](int, int n) -> const T* {
            return n < d ? wo_c_l + (size_t)n * d : nullptr;
          },
          a_rows,
          [&](int r, int c, const float* v) {
            float* xr = P.x + (size_t)r * d + c;
            *xr = __ldcg(xr) + (v[0] + to_f(bo_c_l[c]));
          });
    }
    grid.sync();
    // ---- P7: LN3 + fc1 + ReLU
    const T* b1_l = b1 + (size_t)l * dff;
    ln_product(ln + 4 * d, ln + 5 * d, w1 + (size_t)l * dff * d, dff,
               [&](int r, int c, const float* v) {
                 mid[(size_t)r * dff + c] =
                     from_f<T>(fmaxf(v[0] + to_f(b1_l[c]), 0.f));
               });
    grid.sync();
    // ---- P8: fc2 + residual
    const T* w2_l = w2 + (size_t)l * d * dff;
    const T* b2_l = b2 + (size_t)l * d;
    d_product(
        std::integral_constant<int, 1>{}, dff,
        [&](int, int n) -> const T* {
          return n < d ? w2_l + (size_t)n * dff : nullptr;
        },
        [&](int, int r) -> const T* {
          return r < M ? mid + (size_t)r * dff : nullptr;
        },
        [&](int r, int c, const float* v) {
          float* xr = P.x + (size_t)r * d + c;
          *xr = __ldcg(xr) + (v[0] + to_f(b2_l[c]));
        });
    grid.sync();
  }
}

// What the kernel does not take: a refusal is an error code, never another
// route.
cudaError_t shape_ok(const PrimeParams& P) {
  const int d = P.d, H = P.n_heads;
  if (H < 1 || d % H || d % kSub || P.d_ff % kSub || d > kDMax
      || P.m < 1 || P.batch < 1 || P.channels < 1 || P.n_layers < 1)
    return cudaErrorInvalidValue;
  const int dh = d / H;
  if (dh % 8 || dh > kDhMax || P.m > P.p_pad || P.p_pad > P.l_pad
      || (!P.aligned && P.e_src < 1))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t grid_size(const PrimeParams& P, int* blocks) {
  cudaError_t e = shape_ok(P);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = smem_bytes<T>(P.d / P.n_heads);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(prefix_prime_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prefix_prime_kernel<T>, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t prime(const PrimeParams& P, cudaStream_t s) {
  int blocks = 0;
  cudaError_t e = grid_size<T>(P, &blocks);
  if (e != cudaSuccess) return e;
  PrimeParams arg = P;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(prefix_prime_kernel<T>), dim3(blocks),
      dim3(kThreads), args, smem_bytes<T>(P.d / P.n_heads), s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// info[0..5] = grid blocks, threads a block, dynamic shared-memory bytes,
// registers a thread, local (spilled) bytes a thread, grid barriers
template <typename T>
cudaError_t info(const PrimeParams& P, int* out) {
  int blocks = 0;
  cudaError_t e = grid_size<T>(P, &blocks);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, prefix_prime_kernel<T>);
  if (e != cudaSuccess) return e;
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = static_cast<int>(smem_bytes<T>(P.d / P.n_heads));
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  // grid barriers: set-up and the last layer's LN1, then 8 a layer (13 with
  // cross attention), one more for each product split over K
  const int tiles = cdiv(P.batch * P.m, kBM) * cdiv(P.d, kBN);
  const int sd = split_k<T>(tiles, P.d, blocks) > 1;     // wo, wq_c, wo_c
  const int sf = split_k<T>(tiles, P.d_ff, blocks) > 1;  // fc2
  const int per_layer = P.aligned ? 8 + sd + sf : 13 + 3 * sd + sf;
  out[5] = 2 + per_layer * (P.n_layers - 1);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_prefix_prime(const PrimeParams* P, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? prime<__nv_bfloat16>(*P, s)
                                     : prime<float>(*P, s));
}

extern "C" int isi_prefix_prime_info(const PrimeParams* P, int dtype,
                                     int* out) {
  return static_cast<int>(dtype == 1 ? info<__nv_bfloat16>(*P, out)
                                     : info<float>(*P, out));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
