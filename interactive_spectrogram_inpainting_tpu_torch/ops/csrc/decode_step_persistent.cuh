// One decode step of a batch as ONE persistent cooperative launch: the
// device code of both step kernels (decode_step.cu: B 2-4 and the
// relative-bias top prior at any B; decode_step_batched.cu: B > 4 on aligned
// decoders), which differ only in whether the self attention rounds its
// intermediates (ROUND).
//
// One block of 512 threads per SM, alive for the whole step; its phases are
// separated by grid-wide barriers (cooperative_groups::this_grid().sync()):
//
//   per layer, aligned:  A LN1 + qkv | B self attention | C wo + wo_c
//                        | E LN3 + fc1 | F fc2                  (5 barriers)
//   per layer, cross:    A | B | C wo | D1 LN2 + wq_c | D2 cross attention
//                        | D3 wo_c | E | F                      (8 barriers)
//   then:                G final LN + logits | H Gumbel argmax  (1 barrier)
//
// A phase is latency: the barrier (~1.1 us on the H100), a round trip for
// its inputs, one for its weights. So before each barrier every block
// hints into its SM's L1 the weight tiles it will multiply in the next
// product phase.
//
// Weight products. The batch is walked in passes of up to four groups of
// kGroup = 16 sequences (bf16; float32 one group, fc2's wider inputs two).
// Every block stages the pass's inputs in shared memory (the LayerNorm in
// front of a product computed by each block on its own copy, one warp per
// sequence, the row held in registers), then takes tiles of 8 output rows
// of a weight stored [out, in]: tile t belongs to block t mod gridDim, and
// the block's warps split the tile's K dimension, each streaming its slice
// of the 8 rows as 16-byte vectors, group after group of the pass (the
// reloads hit L1); the slices are added in shared memory in a fixed order.
// bfloat16 multiplies on the tensor cores (mma.sync m16n8k16: a group is
// M, the 8 rows N, float32 accumulation, a fresh accumulator for every 32
// columns that is then added in float32, since the tensor cores truncate
// what they add into); float32, the parity dtype, on the CUDA cores (one
// FMA per weight and sequence).
//
// Attention: flash-decoding over chunks of key_chunk() keys. Each block
// takes whole (sequence, head) pairs, dealt round robin, in rounds of up
// to 16 pairs whose partials fit kMaxItems; a round's (pair, chunk) items
// are dealt over the block's warps (half of them above head_dim 64, whose
// key slots are twice as wide). A warp copies its chunk's key and
// value rows into its own shared-memory slot with cp.async (one memory
// round trip, no registers held), then takes one key a lane for q.k and
// two head dims a lane for p.V (four above head_dim 64: dims 2 lane and
// 64 + 2 lane), and leaves its partial (max, sum, p.V) in
// shared memory; with ROUND the query, the q.k products, the weights that
// multiply V and those products are rounded to T (as attend_partial_kernel
// does). After a __syncthreads one warp per pair combines the partials
// with the fresh key of this position, writes the attention output and
// stores the new K/V row at ``pos`` (rows < pos are the only ones read).
//
// Wide models: a LayerNorm row wider than 1024 is streamed three times
// from L2 instead of held in registers; a d_ff whose fc2 operand would not
// fit shared memory (8192) is multiplied in column tiles of d_ff
// (ff_tile()), the tiles' sums added in order in shared memory.
//
// Nothing returns to the host inside a step: the sampled token is written
// by the last phase where ``take`` is set.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace isi {

namespace cg = cooperative_groups;

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
  int n_layers, d, d_ff, n_heads, n_class, batch, l_pad, e_pad, steps_pad;
  int channels, e_src, aligned, pos, take, grid;
  float scale, inv_temperature;
};

constexpr int kStepThreads = 512;
constexpr int kStepWarps = kStepThreads / kWarp;
constexpr int kGroup = 16;      // sequences per weight-product group (M)
constexpr int kTileRows = 8;    // weight rows per tile (N)
constexpr int kStepDhMax = 128;  // head dim: two or four per lane
constexpr int kLnPerLane = 32;  // LN rows up to 32 * kWarp in registers
constexpr int kInFlight = 4;    // 16-byte weight loads a lane keeps in flight
constexpr int kMaxItems = 128;  // attention partials a block holds (dh 64)
// floats of the attention partials (kMaxItems rows of head_dim 64) and of
// a round's queries
constexpr int kPartFloats = kMaxItems * (64 + 2);
constexpr int kQsFloats = kStepWarps * 64;
// shared memory a block can have on the H100 (227 KB)
constexpr size_t kStepSmemBudget = 232448;

// keys of an attention chunk (one a lane): 32, or 16 in float32, whose
// staged rows are twice as wide
template <typename T> __host__ __device__ constexpr int key_chunk() {
  return sizeof(T) == 2 ? 32 : 16;
}
// W (wide): the kernel built for head_dim up to 128, d_model above 1024
// or fc2 in column tiles of d_ff (step_wide); else for the full test
// models' shapes, none of the wide code compiled in.
// a staged key or value row: 64 (W: 128) dims + 16 bytes, so that lane j's
// 16-byte reads of row j fall in other banks than its neighbours'
template <typename T, bool W> __host__ __device__ constexpr int key_row() {
  return (W ? 128 : 64) + 16 / static_cast<int>(sizeof(T));
}
// warps that take attention items: all of them, half when W
template <bool W> __host__ __device__ constexpr int attend_warps() {
  return W ? kStepWarps / 2 : kStepWarps;
}
// attention chunks of one pair that fit the partials
template <bool W> __host__ __device__ inline int max_items(int dh) {
  return W ? kPartFloats / (dh + 2) : kMaxItems;
}
// a row of the A operand in shared memory: bf16 rows padded so that the
// 16-byte reads of rows g and g + 1 fall in different banks
template <typename T> __host__ __device__ inline int a_stride(int k) {
  return sizeof(T) == 2 ? ((k + 63) / 64) * 64 + 32 : k;
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy from global to shared memory through L2 (so it
// sees what other blocks wrote), and the wait for a thread's copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Hint into this SM's L1 the tiles of 8 rows of W [N, K] that this block
// multiplies (tile t belongs to block t mod gridDim), one 128-byte line a
// thread per pass.
template <typename T>
__device__ __forceinline__ void prefetch_tiles(const T* W, int N, int K) {
  const int G = gridDim.x, n_tiles = (N + kTileRows - 1) / kTileRows;
  const int mine =
      n_tiles > (int)blockIdx.x ? (n_tiles - blockIdx.x + G - 1) / G : 0;
  const int lines = (kTileRows * K * (int)sizeof(T) + 127) / 128;  // a tile
  const size_t tile_bytes = (size_t)kTileRows * K * sizeof(T);
  const size_t w_bytes = (size_t)N * K * sizeof(T);
  for (int e = threadIdx.x; e < mine * lines; e += blockDim.x) {
    const size_t o = (blockIdx.x + (size_t)(e / lines) * G) * tile_bytes
                     + (size_t)(e % lines) * 128;
    if (o < w_bytes)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(
          reinterpret_cast<const char*>(W) + o));
  }
}

// The per-slice product of one warp: rows r0 .. r0 + 7 of W0 (and W1) times
// the group's inputs A0 (A1) [kGroup, stride] over the K chunks s, s + wpt,
// ...; the 16 x 8 sums go to red[op][m * 8 + n]. Lane (g, t) loads row
// r0 + g, columns chunk * 4V + t * V .. + V - 1.
template <typename T, int NOP>
struct SliceProduct;

template <int NOP>
struct SliceProduct<__nv_bfloat16, NOP> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void run(
      const T* const (&W)[NOP], const T* const (&A)[NOP], int stride, int N,
      int K, int ldw, int nb, int r0, int s, int wpt, float* red) {
    constexpr int V = 8, CW = 4 * V;
    const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
    const int r = r0 + g;
    const int n_chunks = K / CW;
    float c[NOP][4];
#pragma unroll
    for (int op = 0; op < NOP; ++op)
#pragma unroll
      for (int k = 0; k < 4; ++k) c[op][k] = 0.f;
    for (int ch = s; ch < n_chunks; ch += wpt * kInFlight) {
      uint4 w[NOP][kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int cc = ch + u * wpt;
#pragma unroll
        for (int op = 0; op < NOP; ++op)
          w[op][u] = (cc < n_chunks && r < N)
                         ? __ldg(reinterpret_cast<const uint4*>(
                               W[op] + (size_t)r * ldw + cc * CW + t * V))
                         : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int cc = ch + u * wpt;
        if (cc >= n_chunks) break;
#pragma unroll
        for (int op = 0; op < NOP; ++op) {
          const T* ar = A[op] + cc * CW + t * V;
          const uint4 lo = *reinterpret_cast<const uint4*>(ar + g * stride);
          const uint4 hi =
              *reinterpret_cast<const uint4*>(ar + (g + 8) * stride);
          // the lane's 8 columns are k-steps 2t, 2t+1 | 2t+8, 2t+9 of two
          // m16n8k16 products, in A and B alike
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16_16816(f, lo.x, hi.x, lo.y, hi.y, w[op][u].x, w[op][u].y);
          mma_bf16_16816(f, lo.z, hi.z, lo.w, hi.w, w[op][u].z, w[op][u].w);
#pragma unroll
          for (int k = 0; k < 4; ++k) c[op][k] += f[k];
        }
      }
    }
    // c0: (g, 2t), c1: (g, 2t + 1), c2: (g + 8, 2t), c3: (g + 8, 2t + 1)
#pragma unroll
    for (int op = 0; op < NOP; ++op) {
      float* o = red + op * 128;
      o[g * 8 + 2 * t] = c[op][0];
      o[g * 8 + 2 * t + 1] = c[op][1];
      o[(g + 8) * 8 + 2 * t] = c[op][2];
      o[(g + 8) * 8 + 2 * t + 1] = c[op][3];
    }
    (void)nb;
  }
};

template <int NOP>
struct SliceProduct<float, NOP> {
  using T = float;
  static __device__ __forceinline__ void run(
      const T* const (&W)[NOP], const T* const (&A)[NOP], int stride, int N,
      int K, int ldw, int nb, int r0, int s, int wpt, float* red) {
    constexpr int V = 4, CW = 4 * V;
    const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
    const int r = r0 + g;
    const int n_chunks = K / CW;
    float acc[NOP][kGroup];
#pragma unroll
    for (int op = 0; op < NOP; ++op)
#pragma unroll
      for (int m = 0; m < kGroup; ++m) acc[op][m] = 0.f;
    for (int ch = s; ch < n_chunks; ch += wpt * kInFlight) {
      float4 w[NOP][kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int cc = ch + u * wpt;
#pragma unroll
        for (int op = 0; op < NOP; ++op)
          w[op][u] = (cc < n_chunks && r < N)
                         ? __ldg(reinterpret_cast<const float4*>(
                               W[op] + (size_t)r * ldw + cc * CW + t * V))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int cc = ch + u * wpt;
        if (cc >= n_chunks) break;
#pragma unroll
        for (int op = 0; op < NOP; ++op) {
          const float* ar = A[op] + cc * CW + t * V;
          const float4 wv = w[op][u];
#pragma unroll
          for (int m = 0; m < kGroup; ++m) {
            if (m < nb) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(ar + m * stride);
              float a = acc[op][m];
              a = fmaf(wv.x, xv.x, a);
              a = fmaf(wv.y, xv.y, a);
              a = fmaf(wv.z, xv.z, a);
              acc[op][m] = fmaf(wv.w, xv.w, a);
            }
          }
        }
      }
    }
    // the row's four lanes hold four column sets: add them, then lane t
    // writes the sequences m = t (mod 4)
#pragma unroll
    for (int op = 0; op < NOP; ++op) {
      float* o = red + op * 128;
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        float v = acc[op][m];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((m & 3) == t) o[m * 8 + g] = v;
      }
    }
  }
};

// out[m, r] = epi(m, r, A0[m] . W0[r] [, A1[m] . W1[r]]) for every row r < N
// of the tiles this block owns and every sequence m < nb of the pass staged
// in A0 (A1) ([groups * kGroup, stride]), over K columns of W rows ldw
// apart (0: K). Called by the whole block; ends with __syncthreads.
template <typename T, int NOP, typename Epi>
__device__ void block_products(const T* const (&W)[NOP],
                               const T* const (&A)[NOP], int stride, int N,
                               int K, int nb, float* red, Epi epi,
                               int ldw = 0) {
  const int warp = threadIdx.x / kWarp;
  const int G = gridDim.x;
  const int ng = (nb + kGroup - 1) / kGroup;  // groups of the pass
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int mine =
      n_tiles > (int)blockIdx.x ? (n_tiles - blockIdx.x + G - 1) / G : 0;
  for (int i0 = 0; i0 < mine; i0 += kStepWarps) {
    const int nt = min(mine - i0, kStepWarps);  // tiles of this round
    const int wpt = kStepWarps / nt;            // warps per tile
    const int ti = warp / wpt, s = warp % wpt;
    if (ti < nt) {
      const int tile = blockIdx.x + (i0 + ti) * G;
      for (int g = 0; g < ng; ++g) {
        const T* Ag[NOP];
#pragma unroll
        for (int op = 0; op < NOP; ++op) Ag[op] = A[op] + g * kGroup * stride;
        SliceProduct<T, NOP>::run(W, Ag, stride, N, K, ldw ? ldw : K,
                                  min(kGroup, nb - g * kGroup),
                                  tile * kTileRows, s, wpt,
                                  red + (warp * ng + g) * NOP * 128);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nt * ng * 128; e += blockDim.x) {
      const int tj = e / (ng * 128), g = (e / 128) % ng, mn = e % 128;
      const int m = g * kGroup + mn / 8;
      const int r = (blockIdx.x + (i0 + tj) * G) * kTileRows + mn % 8;
      if (m >= nb || r >= N) continue;
      float v[NOP];
#pragma unroll
      for (int op = 0; op < NOP; ++op) {
        float a = 0.f;
        for (int q = 0; q < wpt; ++q)
          a += red[(((tj * wpt + q) * ng + g) * NOP + op) * 128 + mn];
        v[op] = a;
      }
      if constexpr (NOP == 1) epi(m, r, v[0], 0.f);
      else epi(m, r, v[0], v[1]);
    }
    __syncthreads();
  }
}

// The LayerNorm of one row by one warp, the row held in registers:
// out[i] = T((x[i] - mu) * rsqrt(var + 1e-6) * scale[i] + bias[i]), with
// x[i] = load(i) (flax LayerNorm; lane i mod 32 sums elements i).
template <typename T, bool W, typename Load>
__device__ __forceinline__ void warp_ln_row(Load load, const float* scale,
                                            const float* bias, int d, T* out) {
  const int lane = threadIdx.x % kWarp;
  if (W && d > kLnPerLane * kWarp) {
    // wider than the registers hold: the row's loads three times over
    float s = 0.f;
    for (int i = lane; i < d; i += kWarp) s += load(i);
    const float mu = warp_sum(s) / d;
    float var = 0.f;
    for (int i = lane; i < d; i += kWarp) {
      const float dv = load(i) - mu;
      var += dv * dv;
    }
    const float rs = rsqrtf(warp_sum(var) / d + 1e-6f);
    for (int i = lane; i < d; i += kWarp)
      out[i] = from_f<T>((load(i) - mu) * rs * scale[i] + bias[i]);
    return;
  }
  float v[kLnPerLane];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kLnPerLane; ++k) {
    const int i = lane + k * kWarp;
    v[k] = i < d ? load(i) : 0.f;
    s += v[k];
  }
  const float mu = warp_sum(s) / d;
  float var = 0.f;
#pragma unroll
  for (int k = 0; k < kLnPerLane; ++k) {
    const int i = lane + k * kWarp;
    if (i < d) {
      const float dv = v[k] - mu;
      var += dv * dv;
    }
  }
  const float rs = rsqrtf(warp_sum(var) / d + 1e-6f);
#pragma unroll
  for (int k = 0; k < kLnPerLane; ++k) {
    const int i = lane + k * kWarp;
    if (i < d) out[i] = from_f<T>((v[k] - mu) * rs * scale[i] + bias[i]);
  }
}

// copy rows b0 .. b0 + nb - 1 of src [*, K] (T, written earlier in this
// launch) into an A operand, 16-byte pieces by cp.async, every piece in
// flight at once; waits for this thread's copies
template <typename T>
__device__ void stage_rows(const T* src, size_t src_row, int b0, int nb,
                           int K, T* dst, int stride) {
  constexpr int V = Vec<T>::N;
  const int per_row = K / V;
  for (int e = threadIdx.x; e < nb * per_row; e += blockDim.x) {
    const int m = e / per_row, c = (e % per_row) * V;
    cp_async16(dst + m * stride + c, src + (b0 + m) * src_row + c);
  }
  cp_async_wait_all();
}

// The attention of one (query, key set) for every (sequence, head) pair:
// flash-decoding over n_keys keys in chunks of key_chunk<T>() keys. Block k
// takes the pairs k, k + gridDim, ... in rounds of up to kStepWarps pairs
// whose partials fit kMaxItems; a round's (pair, chunk) items are dealt over
// the block's warps, which leave their partials in ``parts``, and one warp
// a pair then combines them. ``q`` [B, q_row] float32 (written earlier in
// this launch); keys and values K/Vv [B, kv_rows, d] (T), bias row h at
// bias + h * bias_h. With ``fresh`` the combine adds the fresh key (q, k, v
// of qkv [B, 3d] at this position, its bias entry bias[h * bias_h + pos])
// and stores k, v at row ``pos`` of K/Vv. The output goes to out [B, d]
// (T). ``stage`` holds every warp's key and value slot, ``qs`` the round's
// queries (kQsFloats floats).
template <typename T, bool ROUND, bool W>
__device__ void attend(const StepParams& P, const float* q, int q_row,
                       const T* K, T* Vv, size_t kv_b, const float* bias,
                       int bias_h, int n_keys, bool fresh, T* out, T* stage,
                       float* parts, float* qs) {
  constexpr int KC = key_chunk<T>(), V = Vec<T>::N;
  const int d = P.d, H = P.n_heads, dh = d / H;
  constexpr int RS = key_row<T, W>(), AW = attend_warps<W>();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_items = n_keys > 0 ? (n_keys + KC - 1) / KC : 1;
  const int row = dh + 2;
  const int by_slots = W ? kPartFloats / (n_items * row)
                        : kMaxItems / n_items;
  int R = by_slots < kStepWarps ? by_slots : kStepWarps;  // >= 1
  if (W) R = R < kQsFloats / dh ? R : kQsFloats / dh;
  const int G = gridDim.x, pairs = P.batch * H;
  const int mine =
      pairs > (int)blockIdx.x ? (pairs - blockIdx.x + G - 1) / G : 0;
  // the lane's head dims: t0, t0 + 1 and (head_dim > 64) t1, t1 + 1
  const int t0 = 2 * lane, t1 = t0 + 64;
  const bool act = t0 < dh, act1 = W && t1 < dh;
  const int pieces = dh / V;  // 16-byte pieces of a key row
  T* ks = stage + warp * 2 * KC * RS;
  T* vs = ks + KC * RS;
  for (int r0 = 0; r0 < mine; r0 += R) {
    const int np = min(R, mine - r0);  // pairs of this round
    for (int e = threadIdx.x; e < np * dh; e += blockDim.x) {
      const int bh = blockIdx.x + (r0 + e / dh) * G;
      const float v = ldcg(q + (size_t)(bh / H) * q_row + (bh % H) * dh
                           + e % dh);
      qs[e] = ROUND ? round_to<T>(v) : v;
    }
    __syncthreads();
    for (int it = warp; warp < AW && it < np * n_items; it += AW) {
      const int c = it % n_items, pslot = it / n_items;
      const int bh = blockIdx.x + (r0 + pslot) * G;
      const int h = bh % H, b = bh / H;
      const T* Kb = K + b * kv_b + h * dh;
      const T* Vb = Vv + b * kv_b + h * dh;
      const float* qv = qs + pslot * dh;
      // the chunk's key and value rows into the warp's slot
      const int j0 = c * KC;
      const int n = min(KC, n_keys - j0);  // keys of this chunk
      for (int e = lane; e < n * pieces; e += kWarp) {
        const int jj = e / pieces, o = (e % pieces) * V;
        cp_async16(ks + jj * RS + o, Kb + (size_t)(j0 + jj) * d + o);
        cp_async16(vs + jj * RS + o, Vb + (size_t)(j0 + jj) * d + o);
      }
      const bool valid = lane < n;
      const float bj = valid ? bias[(size_t)h * bias_h + j0 + lane] : 0.f;
      cp_async_wait_all();
      __syncwarp();
      float sc = -INFINITY;
      if (valid) {
        float acc = 0.f;
        for (int t = 0; t < dh; t += V) {
          float kk[V];
          load_vec_rw(ks + lane * RS + t, kk);
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc = ROUND ? acc + round_to<T>(qv[t + k] * kk[k])
                        : fmaf(qv[t + k], kk[k], acc);
        }
        sc = acc * P.scale + bj;
      }
      const float m = warp_max(sc);
      float p = valid ? expf(sc - m) : 0.f;
      const float l = warp_sum(p);
      if (ROUND) p = round_to<T>(p);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < KC; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        if (jj < n && act) {
          float v0, v1;
          load2(vs + jj * RS + t0, v0, v1);
          if (ROUND) {
            a0 += round_to<T>(pj * v0);
            a1 += round_to<T>(pj * v1);
          } else {
            a0 = fmaf(pj, v0, a0);
            a1 = fmaf(pj, v1, a1);
          }
        }
        if (jj < n && act1) {
          float v0, v1;
          load2(vs + jj * RS + t1, v0, v1);
          if (ROUND) {
            a2 += round_to<T>(pj * v0);
            a3 += round_to<T>(pj * v1);
          } else {
            a2 = fmaf(pj, v0, a2);
            a3 = fmaf(pj, v1, a3);
          }
        }
      }
      float* o = parts + it * row;
      if (lane == 0) {
        o[0] = m;
        o[1] = l;
      }
      if (act) {
        o[2 + t0] = a0;
        o[3 + t0] = a1;
      }
      if (act1) {
        o[2 + t1] = a2;
        o[3 + t1] = a3;
      }
      __syncwarp();  // the slot is free for the warp's next item
    }
    __syncthreads();
    if (warp < np) {
      // combine pair r0 + warp from its partials; a chunk that saw no key
      // holds max -inf and zero sums
      const int bh = blockIdx.x + (r0 + warp) * G;
      const int h = bh % H, b = bh / H;
      const float* pc = parts + warp * n_items * row;
      float lp = -INFINITY, vf0 = 0.f, vf1 = 0.f, vf2 = 0.f, vf3 = 0.f;
      if (fresh) {
        const float* qkv = q + (size_t)b * q_row;  // q_row == 3d
        const size_t at = b * kv_b + (size_t)P.pos * d + h * dh;
        T* kw = const_cast<T*>(K) + at;
        float s = 0.f;
        if (act) {
          const float k0 = ldcg(qkv + d + h * dh + t0);
          const float k1 = ldcg(qkv + d + h * dh + t0 + 1);
          vf0 = ldcg(qkv + 2 * d + h * dh + t0);
          vf1 = ldcg(qkv + 2 * d + h * dh + t0 + 1);
          s = fmaf(ldcg(qkv + h * dh + t0 + 1), k1,
                   ldcg(qkv + h * dh + t0) * k0);
          kw[t0] = from_f<T>(k0);
          kw[t0 + 1] = from_f<T>(k1);
          Vv[at + t0] = from_f<T>(vf0);
          Vv[at + t0 + 1] = from_f<T>(vf1);
        }
        if (act1) {
          const float k2 = ldcg(qkv + d + h * dh + t1);
          const float k3 = ldcg(qkv + d + h * dh + t1 + 1);
          vf2 = ldcg(qkv + 2 * d + h * dh + t1);
          vf3 = ldcg(qkv + 2 * d + h * dh + t1 + 1);
          s += fmaf(ldcg(qkv + h * dh + t1 + 1), k3,
                    ldcg(qkv + h * dh + t1) * k2);
          kw[t1] = from_f<T>(k2);
          kw[t1 + 1] = from_f<T>(k3);
          Vv[at + t1] = from_f<T>(vf2);
          Vv[at + t1 + 1] = from_f<T>(vf3);
        }
        lp = warp_sum(s) * P.scale + bias[(size_t)h * bias_h + P.pos];
      }
      float mm = lp;
      for (int c = lane; c < n_items; c += kWarp) mm = fmaxf(mm, pc[c * row]);
      mm = warp_max(mm);
      const float wf = fresh ? expf(lp - mm) : 0.f;
      float den = 0.f, acc0 = wf * vf0, acc1 = wf * vf1;
      float acc2 = wf * vf2, acc3 = wf * vf3;
      for (int c = 0; c < n_items; ++c) {
        const float mc = pc[c * row];
        const float w = mc == -INFINITY ? 0.f : expf(mc - mm);
        den = fmaf(pc[c * row + 1], w, den);
        if (act) {
          acc0 = fmaf(pc[c * row + 2 + t0], w, acc0);
          acc1 = fmaf(pc[c * row + 3 + t0], w, acc1);
        }
        if (act1) {
          acc2 = fmaf(pc[c * row + 2 + t1], w, acc2);
          acc3 = fmaf(pc[c * row + 3 + t1], w, acc3);
        }
      }
      den += wf;
      const float inv = 1.f / fmaxf(den, 1e-20f);
      T* ob = out + (size_t)b * d + h * dh;
      if (act) {
        ob[t0] = from_f<T>(acc0 * inv);
        ob[t0 + 1] = from_f<T>(acc1 * inv);
      }
      if (act1) {
        ob[t1] = from_f<T>(acc2 * inv);
        ob[t1 + 1] = from_f<T>(acc3 * inv);
      }
    }
    __syncthreads();
  }
}

// groups a product pass takes at most: four on the tensor cores, one in
// float32 (its accumulators are a warp's registers)
template <typename T> __host__ __device__ constexpr int max_groups() {
  return sizeof(T) == 2 ? 4 : 1;
}
// groups of the batch that a pass can take
template <typename T>
__host__ __device__ inline int batch_groups(const StepParams& P) {
  const int g = (P.batch + kGroup - 1) / kGroup;
  return g < max_groups<T>() ? g : max_groups<T>();
}
// floats of a warp's split-K sums: groups x operands x 128
template <typename T> __host__ __device__ constexpr int sums_per_warp() {
  return (max_groups<T>() > 2 ? max_groups<T>() : 2) * 128;
}

// bytes after the operand region: the attention partials, every warp's
// split-K sums, the round's queries
template <typename T> __host__ __device__ constexpr size_t fixed_bytes() {
  return sizeof(float) * ((size_t)kPartFloats
                          + (size_t)kStepWarps * sums_per_warp<T>()
                          + kQsFloats);
}
// Bytes of the shared region that holds a pass's A operands (one group at
// K = kt, fc2's column tile, plus the aligned C phase's second operand, or
// ``groups`` groups of the batch at K = d) and, in the attention phases,
// the staged key and value rows.
template <typename T, bool W>
__host__ __device__ inline size_t operand_region(const StepParams& P, int kt,
                                                 int groups) {
  const int kmax = P.d > kt ? P.d : kt;
  size_t ops = (size_t)kGroup * (a_stride<T>(kmax) + a_stride<T>(P.d));
  const size_t wide = (size_t)groups * kGroup * a_stride<T>(P.d);
  ops = ops > wide ? ops : wide;
  const size_t keys = (size_t)attend_warps<W>() * 2 * key_chunk<T>()
                      * key_row<T, W>();
  return (ops > keys ? ops : keys) * sizeof(T);
}
// whether a shape needs the wide kernel: head_dim above 64, d_model above
// what a warp's registers hold of a LayerNorm row, or operands (at K =
// d_ff, every group of the batch at K = d) beyond the shared memory
template <typename T>
__host__ __device__ inline bool step_wide(const StepParams& P) {
  return P.d / P.n_heads > 64 || P.d > kLnPerLane * kWarp
         || operand_region<T, false>(P, P.d_ff, batch_groups<T>(P))
                    + fixed_bytes<T>()
                > kStepSmemBudget;
}
// fc2's column tile of d_ff: all of it, or (W) the largest half, quarter,
// ... whose operands fit the shared memory
template <typename T, bool W>
__host__ __device__ inline int ff_tile(const StepParams& P) {
  constexpr int CW = 4 * Vec<T>::N;
  int kt = P.d_ff;
  while (W && kt % (2 * CW) == 0
         && operand_region<T, W>(P, kt, 1) + fixed_bytes<T>()
                > kStepSmemBudget)
    kt /= 2;
  return kt;
}
template <typename T, bool W>
__host__ __device__ inline size_t operand_bytes(const StepParams& P) {
  const int kt = ff_tile<T, W>(P);
  int g = batch_groups<T>(P);  // (W) as many groups at K = d as fit
  while (W && g > 1
         && operand_region<T, W>(P, kt, g) + fixed_bytes<T>()
                > kStepSmemBudget)
    --g;
  return operand_region<T, W>(P, kt, g);
}

// sequences of one pass of a product of ``nop`` operands of width K: at
// most max_groups / nop groups (a warp's split-K sums), as many as the
// operand region holds
template <typename T, bool W>
__host__ __device__ inline int pass_rows(const StepParams& P, int K,
                                         int nop) {
  const size_t per = (size_t)nop * kGroup * a_stride<T>(K) * sizeof(T);
  int g = batch_groups<T>(P);
  const int by_sums = max_groups<T>() / nop;
  const int fit = static_cast<int>(operand_bytes<T, W>(P) / per);
  g = g < by_sums ? g : by_sums;
  g = g < fit ? g : fit;
  return (g > 1 ? g : 1) * kGroup;
}

// bytes of dynamic shared memory: the operand region, the attention
// partials, every warp's split-K sums and the round's queries
template <typename T, bool W>
__host__ __device__ inline size_t step_smem_bytes(const StepParams& P) {
  return operand_bytes<T, W>(P) + fixed_bytes<T>();
}

template <typename T, bool ROUND, bool W>
__global__ void __launch_bounds__(kStepThreads, 1)
    decode_step_kernel(const StepParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  const int d = P.d, H = P.n_heads, B = P.batch, dff = P.d_ff;
  const int pos = P.pos;
  T* aop = reinterpret_cast<T*>(smem4);
  const int kt = ff_tile<T, W>(P);  // fc2's column tile of d_ff
  const int rows_d = pass_rows<T, W>(P, d, 1);
  const int rows_ff = pass_rows<T, W>(P, kt, 1);
  const int rows_dual = pass_rows<T, W>(P, d, 2);
  T* aop2 = aop + (size_t)rows_dual * a_stride<T>(d);
  float* parts = reinterpret_cast<float*>(smem4) + operand_bytes<T, W>(P) / 4;
  float* red = parts + kPartFloats;
  float* qs = red + kStepWarps * sums_per_warp<T>();
  const int warp = threadIdx.x / kWarp;
  const int sd = a_stride<T>(d), sff = a_stride<T>(kt);

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
  const T* emb = static_cast<const T*>(P.emb);
  const T* posfull = static_cast<const T*>(P.posfull);
  const T* mem_k = static_cast<const T*>(P.mem_k);
  const T* mem_v = static_cast<const T*>(P.mem_v);
  T* kv = static_cast<T*>(P.kv);
  T* a = static_cast<T*>(P.a);
  T* mid = static_cast<T*>(P.mid);
  float* x = P.x;
  const size_t cache_b = (size_t)P.l_pad * d;  // one sequence of one cache
  const size_t mem_b = (size_t)P.e_pad * d;

  // stage LayerNorm(x) of sequences [b0, b0 + nb) into aop: one warp a row;
  // at layer 0 x = emb[token] + posfull[b, pos], and block b mod gridDim
  // writes row b of x
  auto stage_ln = [&](int b0, int nb, const float* scale, const float* bias,
                      bool embed) {
    for (int m = warp; m < nb; m += kStepWarps) {
      const int b = b0 + m;
      if (embed) {
        const T* er = emb + (size_t)P.token_in[b] * d;
        const T* pr = posfull + ((size_t)b * P.steps_pad + pos) * d;
        const bool owner = b % gridDim.x == blockIdx.x;
        warp_ln_row<T, W>(
            [&](int i) {
              const float v = to_f(er[i]) + to_f(pr[i]);
              if (owner) x[(size_t)b * d + i] = v;
              return v;
            },
            scale, bias, d, aop + m * sd);
      } else {
        const float* xr = x + (size_t)b * d;
        warp_ln_row<T, W>([&](int i) { return ldcg(xr + i); }, scale, bias, d,
                       aop + m * sd);
      }
    }
    __syncthreads();
  };

  const size_t dd = (size_t)d * d;
  const T* w_logits = static_cast<const T*>(P.w_logits);
  // the barrier between phases, after hinting into L1 this block's tiles
  // of the next product's weights w (and w2), [N, K]
  auto barrier = [&](const T* w, int N, int K, const T* w2 = nullptr) {
    if (w != nullptr) prefetch_tiles(w, N, K);
    if (w2 != nullptr) prefetch_tiles(w2, N, K);
    grid.sync();
  };

  for (int l = 0; l < P.n_layers; ++l) {
    const float* ln = P.ln + (size_t)l * 6 * d;
    T* kc = kv + (size_t)(2 * l) * B * cache_b;
    T* vc = kc + (size_t)B * cache_b;
    const float* bias_l =
        P.bias_hm + ((size_t)l * P.steps_pad + pos) * H * P.l_pad;
    const T* bo_l = bo + (size_t)l * d;
    const T* bo_c_l = bo_c + (size_t)l * d;
    // ---- A: LN1 + qkv
    for (int b0 = 0; b0 < B; b0 += rows_d) {
      const int nb = min(rows_d, B - b0);
      stage_ln(b0, nb, ln, ln + d, l == 0);
      const T* bq = bqkv + (size_t)l * 3 * d;
      block_products<T, 1>({wqkv + (size_t)l * 3 * d * d}, {aop}, sd, 3 * d,
                           d, nb, red, [&](int m, int r, float v, float) {
                             P.qkv[(size_t)(b0 + m) * 3 * d + r] =
                                 v + to_f(bq[r]);
                           });
    }
    barrier(wo + l * dd, d, d, P.aligned ? wo_c + l * dd : nullptr);
    // ---- B: self attention over cache rows < pos plus the fresh key
    attend<T, ROUND, W>(P, P.qkv, 3 * d, kc, vc, cache_b, bias_l, P.l_pad, pos,
                     true, a, aop, parts, qs);
    barrier(nullptr, 0, 0);
    if (P.aligned) {
      // ---- C: O projection and the aligned cross attention (the value
      // row pos // c of every sequence), added in that order
      const int e_q = pos / P.channels;
      const T* mv = mem_v + (size_t)l * B * mem_b;
      for (int b0 = 0; b0 < B; b0 += rows_dual) {
        const int nb = min(rows_dual, B - b0);
        stage_rows(a, (size_t)d, b0, nb, d, aop, sd);
        constexpr int V = Vec<T>::N;
        for (int e = threadIdx.x; e < nb * (d / V); e += blockDim.x) {
          const int m = e / (d / V), c = (e % (d / V)) * V;
          *reinterpret_cast<uint4*>(aop2 + m * sd + c) =
              e_q < P.e_pad
                  ? __ldg(reinterpret_cast<const uint4*>(
                        mv + (b0 + m) * mem_b + (size_t)e_q * d + c))
                  : make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
        block_products<T, 2>(
            {wo + (size_t)l * d * d, wo_c + (size_t)l * d * d}, {aop, aop2},
            sd, d, d, nb, red, [&](int m, int r, float vs, float vx) {
              float* xr = x + (size_t)(b0 + m) * d + r;
              *xr = (ldcg(xr) + (vs + to_f(bo_l[r])))
                    + (vx + to_f(bo_c_l[r]));
            });
      }
      barrier(w1 + (size_t)l * dff * d, dff, d);
    } else {
      // ---- C: O projection
      for (int b0 = 0; b0 < B; b0 += rows_d) {
        const int nb = min(rows_d, B - b0);
        stage_rows(a, (size_t)d, b0, nb, d, aop, sd);
        __syncthreads();
        block_products<T, 1>({wo + (size_t)l * d * d}, {aop}, sd, d, d, nb,
                             red, [&](int m, int r, float v, float) {
                               float* xr = x + (size_t)(b0 + m) * d + r;
                               *xr = ldcg(xr) + (v + to_f(bo_l[r]));
                             });
      }
      barrier(wq_c + l * dd, d, d);
      // ---- D1: LN2 + cross q
      const T* bq = bq_c + (size_t)l * d;
      for (int b0 = 0; b0 < B; b0 += rows_d) {
        const int nb = min(rows_d, B - b0);
        stage_ln(b0, nb, ln + 2 * d, ln + 3 * d, false);
        block_products<T, 1>({wq_c + (size_t)l * d * d}, {aop}, sd, d, d, nb,
                             red, [&](int m, int r, float v, float) {
                               P.qc[(size_t)(b0 + m) * d + r] =
                                   v + to_f(bq[r]);
                             });
      }
      barrier(wo_c + l * dd, d, d);
      // ---- D2: cross attention over the e_src source keys
      const float* cross_l =
          P.cross_hm + ((size_t)l * P.steps_pad + pos) * H * P.e_pad;
      attend<T, false, W>(P, P.qc, d, mem_k + (size_t)l * B * mem_b,
                       const_cast<T*>(mem_v) + (size_t)l * B * mem_b, mem_b,
                       cross_l, P.e_pad, P.e_src, false, a, aop, parts, qs);
      barrier(nullptr, 0, 0);
      // ---- D3: cross O projection
      for (int b0 = 0; b0 < B; b0 += rows_d) {
        const int nb = min(rows_d, B - b0);
        stage_rows(a, (size_t)d, b0, nb, d, aop, sd);
        __syncthreads();
        block_products<T, 1>({wo_c + (size_t)l * d * d}, {aop}, sd, d, d, nb,
                             red, [&](int m, int r, float v, float) {
                               float* xr = x + (size_t)(b0 + m) * d + r;
                               *xr = ldcg(xr) + (v + to_f(bo_c_l[r]));
                             });
      }
      barrier(w1 + (size_t)l * dff * d, dff, d);
    }
    // ---- E: LN3 + MLP in
    const T* b1_l = b1 + (size_t)l * dff;
    for (int b0 = 0; b0 < B; b0 += rows_d) {
      const int nb = min(rows_d, B - b0);
      stage_ln(b0, nb, ln + 4 * d, ln + 5 * d, false);
      block_products<T, 1>({w1 + (size_t)l * dff * d}, {aop}, sd, dff, d, nb,
                           red, [&](int m, int r, float v, float) {
                             mid[(size_t)(b0 + m) * dff + r] =
                                 from_f<T>(fmaxf(v + to_f(b1_l[r]), 0.f));
                           });
    }
    barrier(w2 + (size_t)l * d * dff, d, dff);
    // ---- F: MLP out + residual (W: over column tiles of d_ff, one
    // unless the operand would not fit; a tile's sums wait in ``parts``,
    // free outside the attention, a slot per (sequence, row of this block))
    const T* b2_l = b2 + (size_t)l * d;
    const int tile_rows = kTileRows * ((d / kTileRows + gridDim.x - 1)
                                       / gridDim.x);
    for (int b0 = 0; b0 < B; b0 += rows_ff) {
      const int nb = min(rows_ff, B - b0);
      if (!W) {
        stage_rows(mid, (size_t)dff, b0, nb, dff, aop, sff);
        __syncthreads();
        block_products<T, 1>({w2 + (size_t)l * d * dff}, {aop}, sff, d, dff,
                             nb, red, [&](int m, int r, float v, float) {
                               float* xr = x + (size_t)(b0 + m) * d + r;
                               *xr = ldcg(xr) + (v + to_f(b2_l[r]));
                             });
        continue;
      }
      for (int k0 = 0; k0 < dff; k0 += kt) {
        const bool first = k0 == 0, last = k0 + kt >= dff;
        stage_rows(mid + k0, (size_t)dff, b0, nb, kt, aop, sff);
        __syncthreads();
        block_products<T, 1>(
            {w2 + (size_t)l * d * dff + k0}, {aop}, sff, d, kt, nb, red,
            [&](int m, int r, float v, float) {
              float* xr = x + (size_t)(b0 + m) * d + r;
              if (first && last) {
                *xr = ldcg(xr) + (v + to_f(b2_l[r]));
                return;
              }
              // the row's slot: its tile's place among this block's tiles
              float* acc = parts + (size_t)m * tile_rows
                           + (r / kTileRows - (int)blockIdx.x) / gridDim.x
                                 * kTileRows
                           + r % kTileRows;
              const float t = first ? v : *acc + v;
              if (last) *xr = ldcg(xr) + (t + to_f(b2_l[r]));
              else *acc = t;
            },
            dff);
      }
    }
    if (l + 1 < P.n_layers)
      barrier(wqkv + (size_t)(l + 1) * 3 * dd, 3 * d, d);
    else
      barrier(w_logits, P.n_class, d);
  }

  // ---- G: final LayerNorm, logits / temperature
  for (int b0 = 0; b0 < B; b0 += rows_d) {
    const int nb = min(rows_d, B - b0);
    stage_ln(b0, nb, P.ln_final, P.ln_final + d, false);
    block_products<T, 1>(
        {w_logits}, {aop}, sd, P.n_class, d, nb, red,
        [&](int m, int r, float v, float) {
          P.logits[(size_t)(b0 + m) * P.n_class + r] =
              (v + P.b_logits[r]) * P.inv_temperature;
        });
  }
  grid.sync();

  // ---- H: + Gumbel noise, argmax (ties to the lowest index); block
  // b mod gridDim writes the token of sequence b
  const int lane = threadIdx.x % kWarp;
  int* red_i = reinterpret_cast<int*>(red + kStepWarps);
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    const float* lg = P.logits + (size_t)b * P.n_class;
    const float* gb = P.gumbel + (size_t)b * P.n_class;
    for (int r = threadIdx.x; r < P.n_class; r += blockDim.x) {
      const float v = ldcg(lg + r) + gb[r];
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
    if (lane == 0) {
      red[warp] = best;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kStepWarps; ++w) merge(red[w], red_i[w]);
      if (best_i == 0x7fffffff) best_i = 0;
      P.token_out[b] = P.take ? best_i : P.cur_token[b];
    }
    __syncthreads();
  }
}

// What the kernel does not take: a refusal is an error code, never another
// route.
template <typename T, bool W>
inline cudaError_t step_shape_ok(const StepParams& P, int grid) {
  const int d = P.d, H = P.n_heads;
  if (H < 1 || d % H || P.batch < 1 || P.n_layers < 1)
    return cudaErrorInvalidValue;
  const int dh = d / H;
  constexpr int CW = 4 * Vec<T>::N;  // K columns a product chunk takes
  if (dh > kStepDhMax || dh % 8 || d % CW || P.d_ff % CW || P.channels < 1)
    return cudaErrorInvalidValue;
  // an attention pair's chunks fit the partials
  constexpr int KC = key_chunk<T>();
  const int items = max_items<W>(dh);
  if (P.pos < 0 || P.pos >= P.l_pad || P.pos >= P.steps_pad
      || (P.l_pad + KC - 1) / KC > items
      || (!P.aligned && (P.e_src < 1 || (P.e_src + KC - 1) / KC > items)))
    return cudaErrorInvalidValue;
  // the operands fit the shared memory; with fc2 in column tiles, their
  // sums fit the partials (grid blocks)
  if (step_smem_bytes<T, W>(P) > kStepSmemBudget)
    return cudaErrorInvalidValue;
  const int kt = ff_tile<T, W>(P);
  if (kt < P.d_ff) {
    if (grid < 1) return cudaErrorInvalidConfiguration;
    const int tile_rows = kTileRows * ((d / kTileRows + grid - 1) / grid);
    if ((size_t)pass_rows<T, W>(P, kt, 1) * tile_rows > (size_t)kPartFloats)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// One block per SM, all co-resident (a cooperative launch); the kernel may
// take up to the SM's opt-in shared memory.
template <typename T, bool ROUND, bool W>
inline cudaError_t step_grid(const StepParams& P, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = step_shape_ok<T, W>(P, sms);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = step_smem_bytes<T, W>(P);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(decode_step_kernel<T, ROUND, W>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_step_kernel<T, ROUND, W>, kStepThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms;
  return cudaSuccess;
}

// info[0..6] = grid blocks, threads a block, dynamic shared-memory bytes,
// registers a thread, local (spilled) bytes a thread, grid barriers a step,
// 1 when the wide kernel runs
template <typename T, bool ROUND, bool W>
inline cudaError_t step_info(const StepParams& P, int* info) {
  int blocks = 0;
  cudaError_t e = step_grid<T, ROUND, W>(P, &blocks);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, decode_step_kernel<T, ROUND, W>);
  if (e != cudaSuccess) return e;
  info[0] = blocks;
  info[1] = kStepThreads;
  info[2] = static_cast<int>(step_smem_bytes<T, W>(P));
  info[3] = attr.numRegs;
  info[4] = static_cast<int>(attr.localSizeBytes);
  info[5] = (P.aligned ? 5 : 8) * P.n_layers + 1;
  info[6] = W;
  return cudaSuccess;
}

// One step: a single cooperative launch of P.grid blocks (the grid that
// step_info returned for this shape).
template <typename T, bool ROUND, bool W>
inline cudaError_t step_launch(const StepParams& P, cudaStream_t s) {
  if (P.grid < 1) return cudaErrorInvalidConfiguration;
  cudaError_t e = step_shape_ok<T, W>(P, P.grid);
  if (e != cudaSuccess) return e;
  StepParams arg = P;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decode_step_kernel<T, ROUND, W>), dim3(P.grid),
      dim3(kStepThreads), args, step_smem_bytes<T, W>(P), s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool ROUND>
inline cudaError_t step_launch(const StepParams& P, cudaStream_t s) {
  return step_wide<T>(P) ? step_launch<T, ROUND, true>(P, s)
                         : step_launch<T, ROUND, false>(P, s);
}

template <typename T, bool ROUND>
inline cudaError_t step_info(const StepParams& P, int* info) {
  return step_wide<T>(P) ? step_info<T, ROUND, true>(P, info)
                         : step_info<T, ROUND, false>(P, info);
}

// the C entry points of one step library (ROUND: see attend)
template <bool ROUND>
inline int step_entry(const StepParams* P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1
                              ? step_launch<__nv_bfloat16, ROUND>(*P, s)
                              : step_launch<float, ROUND>(*P, s));
}

template <bool ROUND>
inline int step_info_entry(const StepParams* P, int dtype, int* info) {
  return static_cast<int>(dtype == 1
                              ? step_info<__nv_bfloat16, ROUND>(*P, info)
                              : step_info<float, ROUND>(*P, info));
}

}  // namespace isi
