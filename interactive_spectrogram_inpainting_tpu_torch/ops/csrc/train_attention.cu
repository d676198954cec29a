// Training attention of the priors and its gradient, on the tensor cores.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/train_attention.py
//           ::fused_train_attention (Pallas kernels _fwd_kernel /
//           _fwd_kernel_packed and _bwd_kernel / _bwd_kernel_packed).
//
// For q [B, Lq, H, Dh], k, v [B, Lk, H, Dh] (float32 or bfloat16) and the
// batch-shared additive term ab [H, Lq, Lk] (float32: relative bias plus
// masks, which are finite, -1e9):
//
//   forward   P  = softmax(q k^T * scale + ab)            (float32)
//             o  = T(P) v                                  (T = the dtype)
//   backward  dP = dO v^T,  dS = P * (dP - delta),  delta = rowsum(dO * o)
//             (bfloat16: o of the unrounded P, kept in float32)
//             dq = (T(dS) k) * scale,  dk = (T(dS)^T q) * scale,
//             dv = T(P)^T dO,          dab = sum over b of dS (float32)
//
// rounded where the Pallas kernels round (T(x) is a round trip through the
// input dtype, a no-op for float32); every product accumulates in float32.
//
// Bound on the H100: operations (4 B H Lq Lk Dh flops forward, 10 backward;
// the bytes of q, k, v, ab and the outputs are tens of times fewer). The
// products run on the tensor cores with mma.sync: bfloat16 as m16n8k16
// (989 TFLOP/s peak), float32 as split TF32, m16n8k8 three times per
// product (hi*lo + lo*hi + hi*hi, where hi = tf32(x) and lo = tf32(x - hi):
// about 21 bits of each operand, so float32's tolerances hold; one TF32
// pass keeps about three digits).
//
// The TPU kernels held a whole (head, batch) attention in VMEM, padded Dh
// and L to 128 lanes and packed head pairs. Here a block of 4 warps owns a
// 64 x 64 tile per step (16 rows per warp); Dh is padded in shared memory to
// the next multiple of 16 with zeros (64 or 128 columns allocated), and the
// [B, L, H, Dh] projections are read in place with cp.async. In bfloat16
// the next tile loads while the current one is multiplied (two stages). In
// float32 the second stage's buffers hold the lo parts instead: the tiles
// that serve as B (K and V, or Q and dO in the dk/dv kernel) are split into
// hi and lo once per block, where every warp splitting every fragment again
// cost more than the double buffering saved (chip_smoke.py on an H100, B 32,
// 516 x 516: the float32 pair 2.33 ms against 3.16).
//
// Dead tiles are skipped, exactly. ``live`` [H, ceil(Lq/64), ceil(Lk/64)]
// marks the tiles holding an ab entry above -1e8; a tile whose entries are
// all masked contributes exp(-1e9 - m) = 0 to every row that has a key,
// and its dab is 0 (written as such). A query tile holding a row without
// any live key is live throughout, so that row keeps the dense answer. The
// causal 516 x 516 self-attention runs 45 of its 81 tiles, the aligned
// 516 x 129 cross-attention 9 of 27, the anti-causal 129 x 129 encoder 6
// of 9.
//
//   attn_live    block per (64 query rows, h): the map, from one pass over
//                ab, before the forward (the backward reuses it).
//   attn_fwd     block per (64 query rows, h, b): online softmax over the
//                live key tiles in registers, o / l written in T, the row
//                max and 1 / row sum kept for the backward (stats).
//   attn_bwd_dq  block per (64 query rows, h, group of batch rows) walking
//                its b in order: delta from dO and o, then per live key
//                tile S, P, dP, dS in registers, dq += T(dS) k, and dS added
//                into the dab rows the block alone owns in device memory
//                (its group's partial sum; zeros on dead tiles). With more
//                than one group, attn_dab_sum adds the partial sums in group
//                order. No float atomics: the same bits on every run.
//   attn_bwd_dkv block per (64 keys, h, b) walking the live query tiles:
//                S^T, P^T, dP^T, dS^T from the stats, dv += T(P)^T dO,
//                dk += T(dS)^T q in registers.
// P is recomputed in both backward kernels and never stored: writing dS
// once (float32, for dab) and reading it back would move about 2 x 270 MB
// at B 32, 516 x 516 (0.16 ms at 3.35 TB/s), more than the bound of the two
// products it saves (0.03 ms of TF32 operations on the live tiles).
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

using namespace isi;

struct TrainAttnParams {
  const void* q;     // [B, Lq, H, Dh]
  const void* k;     // [B, Lk, H, Dh]
  const void* v;     // [B, Lk, H, Dh]
  const float* ab;   // [H, Lq, Lk]
  const void* dout;  // [B, Lq, H, Dh] (backward)
  void* out;         // [B, Lq, H, Dh] (written forward, read backward)
  float* out_f;      // [B, Lq, H, Dh] float32 o of unrounded P (bfloat16)
  void* dq;          // [B, Lq, H, Dh]
  void* dk;          // [B, Lk, H, Dh]
  void* dv;          // [B, Lk, H, Dh]
  float* dab;        // [H, Lq, Lk]
  float* dab_parts;  // [groups, H, Lq, Lk] scratch, null for one group
  float* stats;      // [3, B, H, Lq]: row max, 1 / row sum, delta
  unsigned char* live;  // [H, ceil(Lq / 64), ceil(Lk / 64)] (attn_live)
  int batch, lq, lk, heads, dh, groups;
  int vec;           // 1: every row starts 16-byte aligned (cp.async)
  float scale;
};

namespace {

constexpr int kThreads = 128;  // 4 warps, 16 rows (or keys) each
constexpr int kTile = 64;      // rows and keys of a tile and of ``live``
constexpr int kStep = 32;      // queries per step of attn_bwd_dkv

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared-memory row stride in elements: rows 16 bytes apart from the next
// bank group, so that the fragment loads below hit 32 distinct banks
template <typename T, int D> __host__ __device__ constexpr int row_ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int D> size_t tile_bytes() {
  return sizeof(T) * static_cast<size_t>(kTile) * row_ld<T, D>();
}

// -- cp.async -----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r][c] = src[r * stride + c] for r < n_valid, c < dh; zero for
// dh <= c < dp and for rows past n_valid (64 rows). With ``vec`` the rows
// go by cp.async in 16-byte pieces (dh is then a whole number of pieces),
// else element by element.
template <typename T, int D>
__device__ void load_tile(T* dst, const T* src, int n_valid, size_t stride,
                          int dh, int dp, bool vec) {
  constexpr int LD = row_ld<T, D>(), VE = 16 / sizeof(T);
  if (vec) {
    const int pieces = dp / VE;
    for (int e = threadIdx.x; e < kTile * pieces; e += kThreads) {
      const int r = e / pieces, c = (e % pieces) * VE;
      const bool ok = r < n_valid && c < dh;
      cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * dp; e += kThreads) {
      const int r = e / dp, c = e % dp;
      dst[r * LD + c] = r < n_valid && c < dh ? src[r * stride + c]
                                              : from_f<T>(0.f);
    }
  }
}

// acc[j] += A (16 rows of ``a`` from row 0) x B over the dp columns of the
// contraction, B's columns n-block j taken from rows 8 j of ``b`` ([n][k])
template <typename T, int D, int NB>
__device__ __forceinline__ void product_nk(const T* a, const T* b,
                                           const T* b_lo, int dp,
                                           float (&acc)[NB][4]) {
  using M = Mma<T>;
  constexpr int LD = row_ld<T, D>();
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += M::KS) {
    if (k0 < dp) {
      const typename M::A fa = M::load_a(a, LD, k0);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        M::run(acc[j], fa, M::load_b_nk(b, b_lo, LD, 8 * j, k0));
    }
  }
}

// acc[n] += T(c) x B for the accumulators c of NC columns (the rows of B,
// [k][n] in ``b``) and B's dp columns
template <typename T, int D, int NC>
__device__ __forceinline__ void product_ck(const float (&c)[NC / 8][4],
                                           const T* b, const T* b_lo, int dp,
                                           float (&acc)[D / 8][4]) {
  using M = Mma<T>;
  constexpr int LD = row_ld<T, D>();
#pragma unroll
  for (int j = 0; j < NC / M::KS; ++j) {
    const typename M::A fa = M::c_to_a(c, j);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (8 * n < dp)
        M::run(acc[n], fa, M::load_b_kn(b, b_lo, LD, j * M::KS, 8 * n));
  }
}

// float32 tiles that serve as B: each element split once per block into its
// tf32 hi part (in place) and lo part (into ``lo``), so that the four warps
// do not split them again for every fragment. bfloat16: nothing to do.
template <typename T, int D>
__device__ void split_tile(T* tile, T* lo, int dp) {
  if constexpr (sizeof(T) == 4) {
    constexpr int LD = row_ld<T, D>();
    const int quads = dp / 4;
    for (int e = threadIdx.x; e < kTile * quads; e += kThreads) {
      const int i = (e / quads) * LD + (e % quads) * 4;
      float4 x = *reinterpret_cast<float4*>(tile + i), h, l;
      uint32_t a, b;
      Mma<float>::split(x.x, a, b); h.x = __uint_as_float(a); l.x = __uint_as_float(b);
      Mma<float>::split(x.y, a, b); h.y = __uint_as_float(a); l.y = __uint_as_float(b);
      Mma<float>::split(x.z, a, b); h.z = __uint_as_float(a); l.z = __uint_as_float(b);
      Mma<float>::split(x.w, a, b); h.w = __uint_as_float(a); l.w = __uint_as_float(b);
      *reinterpret_cast<float4*>(tile + i) = h;
      *reinterpret_cast<float4*>(lo + i) = l;
    }
  }
}

// acc = acc * alpha[row] + part, in float32. Every product accumulates one
// tile's terms into a fresh accumulator: the tensor cores add into their
// accumulator with truncation, so a long chain of k-steps into one
// accumulator drifts; the tiles' sums are added here with rounding.
template <int D>
__device__ __forceinline__ void add_scaled(float (&acc)[D / 8][4],
                                           const float (&alpha)[2],
                                           const float (&part)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], part[n][e]);
}

// the indices i < n with row[i * stride] != 0, in order, into list (the
// flags read by all threads at once); returns their number (every thread)
__device__ int live_list(const unsigned char* row, int n, int stride,
                         int* list) {
  __shared__ int count;
  for (int i = threadIdx.x; i < n; i += kThreads)
    list[i] = row[static_cast<size_t>(i) * stride];
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int i = 0; i < n; ++i)
      if (list[i]) list[c++] = i;
    count = c;
  }
  __syncthreads();
  return count;
}


// out[row r][col] = T(acc * mul) for the lane's accumulator elements,
// rows row0 + {g, g + 8} below n_rows, columns below dh
template <typename T, int D>
__device__ void store_acc(const float (&acc)[D / 8][4], const float (&mul)[2],
                          T* out, int row0, int n_rows, size_t stride,
                          int dh) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
      if (r < n_rows && c < dh)
        out[r * stride + c] = from_f<T>(acc[n][e] * mul[e >> 1]);
    }
}

// live[h][qt][kt] = 1 where the 64 x 64 tile of ab holds an entry above
// -1e8, and on every tile of a query tile that holds a row without one.
// Block per (query tile, h), a warp per row (coalesced), one pass over ab.
constexpr float kDead = -1e8f;

__global__ void __launch_bounds__(256) attn_live(TrainAttnParams P) {
  extern __shared__ int tile_live[];  // [nkt]
  const int qt = blockIdx.x, h = blockIdx.y, lq = P.lq, lk = P.lk;
  const int nqt = cdiv(lq, kTile), nkt = cdiv(lk, kTile);
  const int r0 = qt * kTile, nr = min(kTile, lq - r0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int kt = threadIdx.x; kt < nkt; kt += blockDim.x) tile_live[kt] = 0;
  __syncthreads();
  const float* ab = P.ab + (static_cast<size_t>(h) * lq + r0) * lk;
  bool dead_row = false;
  for (int r = warp; r < nr; r += blockDim.x / kWarp) {
    bool has = false;
    for (int c = lane; c < lk; c += kWarp)
      if (ab[static_cast<size_t>(r) * lk + c] > kDead) {
        has = true;
        tile_live[c / kTile] = 1;
      }
    dead_row |= !__any_sync(0xffffffffu, has);
  }
  const int whole = __syncthreads_or(dead_row);
  unsigned char* out = P.live + (static_cast<size_t>(h) * nqt + qt) * nkt;
  for (int kt = threadIdx.x; kt < nkt; kt += blockDim.x)
    out[kt] = whole || tile_live[kt] ? 1 : 0;
}

template <typename T, int D> size_t fwd_smem(int nkt) {
  return 5 * tile_bytes<T, D>() + sizeof(int) * nkt;
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kThreads) attn_fwd(TrainAttnParams P) {
  constexpr int LD = row_ld<T, D>(), NB = kTile / 8;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);     // [kTile][LD]
  T* ks = qs + kTile * LD;                 // [2][kTile][LD]
  T* vs = ks + 2 * kTile * LD;             // [2][kTile][LD]
  int* list = reinterpret_cast<int*>(vs + 2 * kTile * LD);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lq = P.lq, lk = P.lk, dh = P.dh;
  const int dp = FULL ? D : cdiv(dh, 16) * 16;
  const int nqt = cdiv(lq, kTile), nkt = cdiv(lk, kTile), r0 = qt * kTile;
  const size_t rs = static_cast<size_t>(P.heads) * dh;
  const size_t head = static_cast<size_t>(h) * dh;
  const T* q = static_cast<const T*>(P.q) + (static_cast<size_t>(b) * lq + r0) * rs + head;
  const T* k = static_cast<const T*>(P.k) + static_cast<size_t>(b) * lk * rs + head;
  const T* v = static_cast<const T*>(P.v) + static_cast<size_t>(b) * lk * rs + head;
  const int warp = threadIdx.x / kWarp, g = lane_g(), t = lane_t();
  const int n_live =
      live_list(P.live + (static_cast<size_t>(h) * nqt + qt) * nkt, nkt, 1, list);
  const bool vec = P.vec != 0;
  load_tile<T, D>(qs, q, lq - r0, rs, dh, dp, vec);
  if (n_live > 0) {
    const int c0 = list[0] * kTile;
    load_tile<T, D>(ks, k + c0 * rs, lk - c0, rs, dh, dp, vec);
    load_tile<T, D>(vs, v + c0 * rs, lk - c0, rs, dh, dp, vec);
  }
  cp_async_commit();
  int rows[2];
  const float* ab_rows[2];
  for (int r = 0; r < 2; ++r) {
    rows[r] = r0 + 16 * warp + g + 8 * r;
    ab_rows[r] = P.ab + (static_cast<size_t>(h) * lq + min(rows[r], lq - 1)) * lk;
  }
  float o[D / 8][4] = {}, o_rest[sizeof(T) == 2 ? D / 8 : 1][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n_live; ++i) {
    // bfloat16: two stages, the next tile loading during this one; float32:
    // one stage, its second buffer holding the lo parts
    const int st = kSplit ? 0 : i & 1, c0 = list[i] * kTile;
    if (!kSplit && i + 1 < n_live) {
      const int c1 = list[i + 1] * kTile;
      load_tile<T, D>(ks + (st ^ 1) * kTile * LD, k + c1 * rs, lk - c1, rs,
                      dh, dp, vec);
      load_tile<T, D>(vs + (st ^ 1) * kTile * LD, v + c1 * rs, lk - c1, rs,
                      dh, dp, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* kst = ks + st * kTile * LD;
    T* vst = vs + st * kTile * LD;
    T* klo = ks + kTile * LD;
    T* vlo = vs + kTile * LD;
    if constexpr (kSplit) {
      split_tile<T, D>(kst, klo, dp);
      split_tile<T, D>(vst, vlo, dp);
      __syncthreads();
    }
    // logits x = s * scale + ab (-inf past the keys, 0 on padding rows),
    // the online softmax, P v
    float abv[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + 2 * t + (e & 1);
        abv[j][e] = col < lk ? __ldg(ab_rows[e >> 1] + col) : 0.f;
      }
    float s[NB][4] = {};
    product_nk<T, D, NB>(qs + 16 * warp * LD, kst, klo, dp, s);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
        const float x = col >= lk ? -INFINITY
                        : rows[r] >= lq ? 0.f
                                        : fmaf(s[j][e], P.scale, abv[j][e]);
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    float pv[D / 8][4] = {};
    product_ck<T, D, kTile>(s, vst, vlo, dp, pv);
    add_scaled<D>(o, alpha, pv);
    if constexpr (sizeof(T) == 2) {
      // the part of P that T(P) dropped: o_f = (T(P) + rest) v / l, so
      // that the backward's delta = rowsum(dO * o_f) is rowsum(P * dP)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] -= round_to<T>(s[j][e]);
      float rest[D / 8][4] = {};
      product_ck<T, D, kTile>(s, vst, vlo, dp, rest);
      add_scaled<D>(o_rest, alpha, rest);
    }
    __syncthreads();  // the stage is free for the next load
    if (kSplit && i + 1 < n_live) {
      const int c1 = list[i + 1] * kTile;
      load_tile<T, D>(ks, k + c1 * rs, lk - c1, rs, dh, dp, vec);
      load_tile<T, D>(vs, v + c1 * rs, lk - c1, rs, dh, dp, vec);
      cp_async_commit();
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
  const size_t ooff = (static_cast<size_t>(b) * lq + r0) * rs + head;
  store_acc<T, D>(o, inv, static_cast<T*>(P.out) + ooff, 16 * warp, lq - r0,
                  rs, dh);
  if constexpr (sizeof(T) == 2) {
    const float one[2] = {1.f, 1.f};
    add_scaled<D>(o_rest, one, o);
    store_acc<float, D>(o_rest, inv, P.out_f + ooff, 16 * warp, lq - r0, rs,
                        dh);
  }
  if (t == 0) {
    const size_t plane = static_cast<size_t>(P.batch) * P.heads * lq;
    float* st = P.stats + (static_cast<size_t>(b) * P.heads + h) * lq;
    for (int r = 0; r < 2; ++r)
      if (rows[r] < lq) {
        st[rows[r]] = m[r];
        st[plane + rows[r]] = inv[r];
      }
  }
}

template <typename T, int D> size_t dq_smem(int nkt) {
  return 6 * tile_bytes<T, D>() + sizeof(int) * nkt;
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(TrainAttnParams P) {
  constexpr int LD = row_ld<T, D>(), NB = kTile / 8;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);     // [kTile][LD]
  T* dos = qs + kTile * LD;                // [kTile][LD]
  T* ks = dos + kTile * LD;                // [2][kTile][LD]
  T* vs = ks + 2 * kTile * LD;             // [2][kTile][LD]
  int* list = reinterpret_cast<int*>(vs + 2 * kTile * LD);
  const int qt = blockIdx.x, h = blockIdx.y;
  const int lq = P.lq, lk = P.lk, dh = P.dh, nh = P.heads;
  const int dp = FULL ? D : cdiv(dh, 16) * 16;
  const int nqt = cdiv(lq, kTile), nkt = cdiv(lk, kTile), r0 = qt * kTile;
  const size_t rs = static_cast<size_t>(nh) * dh;
  const size_t head = static_cast<size_t>(h) * dh;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane_g(), t = lane_t();
  const bool vec = P.vec != 0;
  // this block's batch rows [b0, b1) and the dab rows it owns
  const int per = cdiv(P.batch, P.groups);
  const int b0 = blockIdx.z * per, b1 = min(P.batch, b0 + per);
  const size_t plane = static_cast<size_t>(nh) * lq * lk;
  float* dab = (P.groups == 1 ? P.dab : P.dab_parts + blockIdx.z * plane)
               + static_cast<size_t>(h) * lq * lk;
  const unsigned char* live = P.live + (static_cast<size_t>(h) * nqt + qt) * nkt;
  const int n_live = live_list(live, nkt, 1, list);
  // dead tiles: dS is exactly 0 there
  for (int kt = 0; kt < nkt; ++kt) {
    if (live[kt]) continue;
    const int c0 = kt * kTile, nc = min(kTile, lk - c0);
    for (int e = threadIdx.x; e < kTile * nc; e += kThreads) {
      const int r = r0 + e / nc, c = c0 + e % nc;
      if (r < lq) dab[static_cast<size_t>(r) * lk + c] = 0.f;
    }
  }
  int rows[2];
  const float* ab_rows[2];
  float* dab_rows[2];
  for (int r = 0; r < 2; ++r) {
    rows[r] = r0 + 16 * warp + g + 8 * r;
    const size_t off = static_cast<size_t>(min(rows[r], lq - 1)) * lk;
    ab_rows[r] = P.ab + static_cast<size_t>(h) * lq * lk + off;
    dab_rows[r] = dab + off;
  }
  const size_t splane = static_cast<size_t>(P.batch) * nh * lq;

  for (int b = b0; b < b1; ++b) {
    const size_t qoff = (static_cast<size_t>(b) * lq + r0) * rs + head;
    const T* k = static_cast<const T*>(P.k) + static_cast<size_t>(b) * lk * rs + head;
    const T* v = static_cast<const T*>(P.v) + static_cast<size_t>(b) * lk * rs + head;
    __syncthreads();  // the previous row's tiles are consumed
    load_tile<T, D>(qs, static_cast<const T*>(P.q) + qoff, lq - r0, rs, dh,
                    dp, vec);
    load_tile<T, D>(dos, static_cast<const T*>(P.dout) + qoff, lq - r0, rs,
                    dh, dp, vec);
    if (n_live > 0) {
      const int c0 = list[0] * kTile;
      load_tile<T, D>(ks, k + c0 * rs, lk - c0, rs, dh, dp, vec);
      load_tile<T, D>(vs, v + c0 * rs, lk - c0, rs, dh, dp, vec);
    }
    cp_async_commit();
    // delta = rowsum(dO * o): two lanes per row of the warp's 16
    float* stb = P.stats + (static_cast<size_t>(b) * nh + h) * lq;
    float delta_row = 0.f;
    {
      const int rr = r0 + 16 * warp + (lane >> 1);
      if (rr < lq) {
        const size_t off = (static_cast<size_t>(b) * lq + rr) * rs + head;
        const T* dorow = static_cast<const T*>(P.dout) + off;
        if (sizeof(T) == 2) {
          const float* orow = P.out_f + off;
          for (int d = lane & 1; d < dh; d += 2)
            delta_row = fmaf(to_f(dorow[d]), orow[d], delta_row);
        } else {
          const T* orow = static_cast<const T*>(P.out) + off;
          for (int d = lane & 1; d < dh; d += 2)
            delta_row = fmaf(to_f(dorow[d]), to_f(orow[d]), delta_row);
        }
      }
      delta_row += __shfl_xor_sync(0xffffffffu, delta_row, 1);
      if (rr < lq && (lane & 1) == 0) stb[2 * splane + rr] = delta_row;
    }
    float mrow[2], inv[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] = __shfl_sync(0xffffffffu, delta_row, 2 * (g + 8 * r));
      const bool ok = rows[r] < lq;
      mrow[r] = ok ? stb[rows[r]] : 0.f;
      inv[r] = ok ? stb[splane + rows[r]] : 0.f;
    }
    float dq[D / 8][4] = {};
    const float one[2] = {1.f, 1.f};
    for (int i = 0; i < n_live; ++i) {
      const int st = kSplit ? 0 : i & 1, c0 = list[i] * kTile;
      if (!kSplit && i + 1 < n_live) {
        const int c1 = list[i + 1] * kTile;
        load_tile<T, D>(ks + (st ^ 1) * kTile * LD, k + c1 * rs, lk - c1, rs,
                        dh, dp, vec);
        load_tile<T, D>(vs + (st ^ 1) * kTile * LD, v + c1 * rs, lk - c1, rs,
                        dh, dp, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      T* kst = ks + st * kTile * LD;
      T* vst = vs + st * kTile * LD;
      T* klo = ks + kTile * LD;
      T* vlo = vs + kTile * LD;
      if constexpr (kSplit) {
        split_tile<T, D>(kst, klo, dp);
        split_tile<T, D>(vst, vlo, dp);
        __syncthreads();
      }
      // P (in s), then the old dab cells and dP, then dS (in s) and dab,
      // each of ab and dab loaded ahead of a product that hides it; dq's
      // terms go to a fresh accumulator
      float part[D / 8][4] = {};
      float s[NB][4] = {};
      {
        float abv[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            abv[j][e] = col < lk ? __ldg(ab_rows[e >> 1] + col) : 0.f;
          }
        product_nk<T, D, NB>(qs + 16 * warp * LD, kst, klo, dp, s);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
            s[j][e] = col < lk && rows[r] < lq
                ? expf(fmaf(s[j][e], P.scale, abv[j][e]) - mrow[r]) * inv[r]
                : 0.f;
          }
      }
      float old[NB][4] = {};
      if (b != b0) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            if (col < lk) old[j][e] = dab_rows[e >> 1][col];
          }
      }
      float dpv[NB][4] = {};
      product_nk<T, D, NB>(dos + 16 * warp * LD, vst, vlo, dp, dpv);
      // dS into s; dab rows (b0 writes, later rows add)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
          const float ds = s[j][e] * (dpv[j][e] - delta[r]);
          if (col < lk && rows[r] < lq) dab_rows[r][col] = old[j][e] + ds;
          s[j][e] = ds;
        }
      product_ck<T, D, kTile>(s, kst, klo, dp, part);
      add_scaled<D>(dq, one, part);
      __syncthreads();
      if (kSplit && i + 1 < n_live) {
        const int c1 = list[i + 1] * kTile;
        load_tile<T, D>(ks, k + c1 * rs, lk - c1, rs, dh, dp, vec);
        load_tile<T, D>(vs, v + c1 * rs, lk - c1, rs, dh, dp, vec);
        cp_async_commit();
      }
    }
    const float mul[2] = {P.scale, P.scale};
    store_acc<T, D>(dq, mul, static_cast<T*>(P.dq) + qoff, 16 * warp,
                    lq - r0, rs, dh);
  }
}

// dab = the groups' partial sums added in group order
__global__ void __launch_bounds__(256) attn_dab_sum(TrainAttnParams P) {
  const size_t n = static_cast<size_t>(P.heads) * P.lq * P.lk;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = P.dab_parts[i];
    for (int g = 1; g < P.groups; ++g) s += P.dab_parts[g * n + i];
    P.dab[i] = s;
  }
}

template <typename T, int D> size_t dkv_smem(int nqt) {
  return 6 * tile_bytes<T, D>() + sizeof(int) * nqt;
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv(TrainAttnParams P) {
  constexpr int LD = row_ld<T, D>(), NB = kStep / 8;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);     // [kTile][LD]
  T* vs = ks + kTile * LD;                 // [kTile][LD]
  T* qs = vs + kTile * LD;                 // [2][kTile][LD]
  T* dos = qs + 2 * kTile * LD;            // [2][kTile][LD]
  int* list = reinterpret_cast<int*>(dos + 2 * kTile * LD);
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lq = P.lq, lk = P.lk, dh = P.dh, nh = P.heads;
  const int dp = FULL ? D : cdiv(dh, 16) * 16;
  const int nqt = cdiv(lq, kTile), nkt = cdiv(lk, kTile), c0 = kt * kTile;
  const size_t rs = static_cast<size_t>(nh) * dh;
  const size_t head = static_cast<size_t>(h) * dh;
  const int warp = threadIdx.x / kWarp, g = lane_g(), t = lane_t();
  const bool vec = P.vec != 0;
  const int n_live = live_list(
      P.live + static_cast<size_t>(h) * nqt * nkt + kt, nqt, nkt, list);
  const size_t koff = (static_cast<size_t>(b) * lk + c0) * rs + head;
  const T* q = static_cast<const T*>(P.q) + static_cast<size_t>(b) * lq * rs + head;
  const T* dout = static_cast<const T*>(P.dout) + static_cast<size_t>(b) * lq * rs + head;
  load_tile<T, D>(ks, static_cast<const T*>(P.k) + koff, lk - c0, rs, dh, dp,
                  vec);
  load_tile<T, D>(vs, static_cast<const T*>(P.v) + koff, lk - c0, rs, dh, dp,
                  vec);
  if (n_live > 0) {
    const int r0 = list[0] * kTile;
    load_tile<T, D>(qs, q + r0 * rs, lq - r0, rs, dh, dp, vec);
    load_tile<T, D>(dos, dout + r0 * rs, lq - r0, rs, dh, dp, vec);
  }
  cp_async_commit();
  int keys[2];
  for (int r = 0; r < 2; ++r) keys[r] = c0 + 16 * warp + g + 8 * r;
  const float* ab = P.ab + static_cast<size_t>(h) * lq * lk;
  const size_t splane = static_cast<size_t>(P.batch) * nh * lq;
  const float* stb = P.stats + (static_cast<size_t>(b) * nh + h) * lq;
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int i = 0; i < n_live; ++i) {
    const int st = kSplit ? 0 : i & 1, r0 = list[i] * kTile;
    if (!kSplit && i + 1 < n_live) {
      const int r1 = list[i + 1] * kTile;
      load_tile<T, D>(qs + (st ^ 1) * kTile * LD, q + r1 * rs, lq - r1, rs,
                      dh, dp, vec);
      load_tile<T, D>(dos + (st ^ 1) * kTile * LD, dout + r1 * rs, lq - r1,
                      rs, dh, dp, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* qst = qs + st * kTile * LD;
    T* dost = dos + st * kTile * LD;
    T* qlo = qs + kTile * LD;
    T* dolo = dos + kTile * LD;
    if constexpr (kSplit) {
      split_tile<T, D>(qst, qlo, dp);
      split_tile<T, D>(dost, dolo, dp);
      __syncthreads();
    }
#pragma unroll
    for (int q0 = 0; q0 < kTile; q0 += kStep) {
      // per query column: ab, the row max, 1 / row sum, delta
      float abv[NB][4], sm[NB][2], si[NB][2], sd[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qr = r0 + q0 + 8 * j + 2 * t + e;
          const bool ok = qr < lq;
          sm[j][e] = ok ? stb[qr] : 0.f;
          si[j][e] = ok ? stb[splane + qr] : 0.f;
          sd[j][e] = ok ? stb[2 * splane + qr] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            abv[j][2 * r + e] = ok && keys[r] < lk
                ? __ldg(ab + static_cast<size_t>(qr) * lk + keys[r]) : 0.f;
        }
      float s[NB][4] = {}, dpv[NB][4] = {};
      product_nk<T, D, NB>(ks + 16 * warp * LD, qst + q0 * LD,
                           qlo + q0 * LD, dp, s);
      product_nk<T, D, NB>(vs + 16 * warp * LD, dost + q0 * LD,
                           dolo + q0 * LD, dp, dpv);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, qc = e & 1;
          const int qr = r0 + q0 + 8 * j + 2 * t + qc;
          float p = 0.f, ds = 0.f;
          if (qr < lq && keys[r] < lk) {
            p = expf(fmaf(s[j][e], P.scale, abv[j][e]) - sm[j][qc]) * si[j][qc];
            ds = p * (dpv[j][e] - sd[j][qc]);
          }
          s[j][e] = p;
          dpv[j][e] = ds;
        }
      const float one[2] = {1.f, 1.f};
      {
        float part[D / 8][4] = {};
        product_ck<T, D, kStep>(s, dost + q0 * LD, dolo + q0 * LD, dp, part);
        add_scaled<D>(dv, one, part);
      }
      {
        float part[D / 8][4] = {};
        product_ck<T, D, kStep>(dpv, qst + q0 * LD, qlo + q0 * LD, dp, part);
        add_scaled<D>(dk, one, part);
      }
    }
    __syncthreads();
    if (kSplit && i + 1 < n_live) {
      const int r1 = list[i + 1] * kTile;
      load_tile<T, D>(qs, q + r1 * rs, lq - r1, rs, dh, dp, vec);
      load_tile<T, D>(dos, dout + r1 * rs, lq - r1, rs, dh, dp, vec);
      cp_async_commit();
    }
  }
  const float mul_k[2] = {P.scale, P.scale}, one[2] = {1.f, 1.f};
  store_acc<T, D>(dk, mul_k, static_cast<T*>(P.dk) + koff, 16 * warp, lk - c0,
                  rs, dh);
  store_acc<T, D>(dv, one, static_cast<T*>(P.dv) + koff, 16 * warp, lk - c0,
                  rs, dh);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool FULL>
cudaError_t forward(const TrainAttnParams& P, cudaStream_t s) {
  const int nqt = cdiv(P.lq, kTile), nkt = cdiv(P.lk, kTile);
  const size_t bytes = fwd_smem<T, D>(nkt);
  cudaError_t e = allow_smem(attn_fwd<T, D, FULL>, bytes);
  if (e != cudaSuccess) return e;
  attn_live<<<dim3(nqt, P.heads), 256, sizeof(int) * nkt, s>>>(P);
  ISI_CHECK();
  attn_fwd<T, D, FULL><<<dim3(nqt, P.heads, P.batch), kThreads, bytes, s>>>(P);
  return cudaGetLastError();
}

template <typename T, int D, bool FULL>
cudaError_t backward(const TrainAttnParams& P, cudaStream_t s) {
  const int nqt = cdiv(P.lq, kTile), nkt = cdiv(P.lk, kTile);
  const size_t dq_bytes = dq_smem<T, D>(nkt), dkv_bytes = dkv_smem<T, D>(nqt);
  cudaError_t e = allow_smem(attn_bwd_dq<T, D, FULL>, dq_bytes);
  if (e != cudaSuccess) return e;
  e = allow_smem(attn_bwd_dkv<T, D, FULL>, dkv_bytes);
  if (e != cudaSuccess) return e;
  if (P.groups < 1 || P.groups > P.batch
      || (P.groups > 1 && P.dab_parts == nullptr))
    return cudaErrorInvalidValue;
  attn_bwd_dq<T, D, FULL><<<dim3(nqt, P.heads, P.groups), kThreads, dq_bytes, s>>>(P);
  ISI_CHECK();
  if (P.groups > 1) {
    const size_t n = static_cast<size_t>(P.heads) * P.lq * P.lk;
    const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
    attn_dab_sum<<<blocks, 256, 0, s>>>(P);
    ISI_CHECK();
  }
  attn_bwd_dkv<T, D, FULL><<<dim3(nkt, P.heads, P.batch), kThreads, dkv_bytes, s>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const TrainAttnParams& P, bool fwd, cudaStream_t s) {
  if (P.dh < 1 || P.lq < 1 || P.lk < 1) return cudaErrorInvalidValue;
  // the priors' heads of 64 fill the tiles: their products run without
  // the guards of the padded columns
  if (P.dh > 48 && P.dh <= 64)
    return fwd ? forward<T, 64, true>(P, s) : backward<T, 64, true>(P, s);
  if (P.dh <= 64)
    return fwd ? forward<T, 64, false>(P, s) : backward<T, 64, false>(P, s);
  if (P.dh <= 128)
    return fwd ? forward<T, 128, false>(P, s) : backward<T, 128, false>(P, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int isi_train_attention_forward(const TrainAttnParams* P,
                                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? dispatch<__nv_bfloat16>(*P, true, s)
                                     : dispatch<float>(*P, true, s));
}

extern "C" int isi_train_attention_backward(const TrainAttnParams* P,
                                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? dispatch<__nv_bfloat16>(*P, false, s)
                                     : dispatch<float>(*P, false, s));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
