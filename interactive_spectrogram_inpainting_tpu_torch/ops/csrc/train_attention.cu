// Training attention of the priors and its gradient.
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
//   backward  dP = dO v^T,  dS = P * (dP - rowsum(P * dP))
//             dq = (T(dS) k) * scale,  dk = (T(dS)^T q) * scale,
//             dv = T(P)^T dO,          dab = sum over b of dS (float32)
//
// rounded where the Pallas kernels round (T(x) is a round trip through the
// input dtype); every product accumulates in float32, one fmaf per term,
// never in TF32.
//
// Bound on the H100: operations. Every product runs in float32 FMA on the
// CUDA cores (4 B Lq Lk Dh H flops forward, 2.5 times that backward); the
// bytes of q, k, v, ab and the outputs are tens of times fewer.
//
// The TPU kernels held a whole (head, batch) attention in VMEM, padded Dh
// and L to 128 lanes and packed head pairs; the grid walked b innermost so
// that the dab block stayed resident. Here the port's [B, L, H, Dh]
// projections are read in place and padded in shared memory only:
//   attn_fwd     one block per (32 query rows, h, b). The score rows of the
//                block sit whole in shared memory ([Lk][33], key-major), the
//                keys pass through in tiles of 64; softmax by rows, P
//                rounded to T, then P V with V in tiles of 64.
//   attn_bwd_dq  one block per (16 query rows, h, group of batch rows)
//                walking its b in order: it recomputes the score rows, dP,
//                delta and dS, adds dS into the dab rows it alone owns in
//                device memory (its group's partial sum; coalesced, L2-
//                resident), and writes dq and the row statistics (max, sum,
//                delta) for the second kernel. The groups (chosen by the
//                caller from the shapes: ~528 blocks) keep the grid full at
//                short sequences; with more than one, attn_dab_sum adds the
//                partial sums in group order. No float atomics: the same
//                bits on every run.
//   attn_bwd_dkv one block per (64 keys, h, b) (32 keys at Dh > 64) walking
//                the query rows in tiles of 32: it recomputes P and dS from
//                the statistics (the same fmaf chains, so the same bits) and
//                accumulates dk and dv in registers.
// P is recomputed twice and never stored. Tensor cores are for a later
// version.
#include <algorithm>

#include "common.cuh"

using namespace isi;

struct TrainAttnParams {
  const void* q;     // [B, Lq, H, Dh]
  const void* k;     // [B, Lk, H, Dh]
  const void* v;     // [B, Lk, H, Dh]
  const float* ab;   // [H, Lq, Lk]
  const void* dout;  // [B, Lq, H, Dh] (backward)
  void* out;         // [B, Lq, H, Dh] (forward)
  void* dq;          // [B, Lq, H, Dh]
  void* dk;          // [B, Lk, H, Dh]
  void* dv;          // [B, Lk, H, Dh]
  float* dab;        // [H, Lq, Lk]
  float* dab_parts;  // [groups, H, Lq, Lk] scratch, null for one group
  float* stats;      // [3, B, H, Lq] scratch: row max, row sum, delta
  int batch, lq, lk, heads, dh, groups;
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kKeyTile = 64;   // keys per shared-memory tile (attn_fwd, dq)
constexpr int kFwdRows = 32;   // query rows per attn_fwd block
constexpr int kDqRows = 16;    // query rows per attn_bwd_dq block
constexpr int kDkvRows = 32;   // query rows per step of attn_bwd_dkv

template <int D> __host__ __device__ constexpr int dkv_keys() {
  return D == 64 ? 64 : 32;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// rows of D floats in shared memory are D + 4 apart: 16-byte aligned, and
// eight rows read at one column fall into eight different bank groups
template <int D> __host__ __device__ constexpr int row_ld() { return D + 4; }

// dst[r][d] = float(src[r * stride + d]) for r < n_rows, d < D; zero past
// n_valid rows or past dh (the kernels then add zeros, exactly)
template <typename T, int D>
__device__ void load_rows(const T* src, int n_valid, size_t stride, int dh,
                          int n_rows, float* dst) {
  for (int e = threadIdx.x; e < n_rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < n_valid && d < dh) x = to_f(src[r * stride + d]);
    dst[r * row_ld<D>() + d] = x;
  }
}

// acc[i][j] = sum_d A[ty + TY i][d] * B[tx + TX j][d], d = 0 .. D-1 in
// ascending order, one fmaf per term. A and B are row-major with rows
// row_ld<D>() apart. Every recomputation of a score goes through here, so
// the same inputs give the same bits in all three kernels.
template <int D, int TM, int TN, int TX, int TY>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         float (&acc)[TM][TN]) {
  constexpr int LD = row_ld<D>();
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + TY * i) * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + TX * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][e] += sum_{c < n} At[c * lda + ty + TY i] * B[c][4 tx + e], c in
// ascending order: a product whose left operand is stored contraction-major
// (score columns, P, dS) and whose right operand is row-major (V, K, dO, Q).
// TX = D / 4 threads cover one output row.
template <int D, int TM>
__device__ __forceinline__ void axpy_rows(const float* At, int lda,
                                          const float* B, int n,
                                          float (&acc)[TM][4]) {
  constexpr int TX = D / 4, TY = kThreads / TX, LD = row_ld<D>();
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(B + c * LD + 4 * tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a = At[c * lda + ty + TY * i];
      acc[i][0] = fmaf(a, b.x, acc[i][0]);
      acc[i][1] = fmaf(a, b.y, acc[i][1]);
      acc[i][2] = fmaf(a, b.z, acc[i][2]);
      acc[i][3] = fmaf(a, b.w, acc[i][3]);
    }
  }
}

// out[ty + TY i][4 tx + e] = T(acc[i][e] * mul) for rows < n_valid and
// columns < dh, rows ``stride`` elements apart
template <typename T, int D, int TM>
__device__ void store_rows(const float (&acc)[TM][4], float mul, T* out,
                           int n_valid, size_t stride, int dh) {
  constexpr int TX = D / 4, TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + TY * i;
    if (r >= n_valid) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * tx + e;
      if (d < dh) out[r * stride + d] = from_f<T>(acc[i][e] * mul);
    }
  }
}

// Scores of ``rows`` query rows (in qs) against keys [c0, c0 + kKeyTile)
// (in ts) into st[c][r] (key-major, row stride ldst), scaled, plus ab;
// zero outside the valid rows and keys.
template <int D, int ROWS>
__device__ void score_tile(const float* qs, const float* ts, float* st,
                           int ldst, int c0, int n_rows, int lk,
                           const float* ab_rows, float scale) {
  constexpr int TX = 16, TY = 16, TM = ROWS / TY, TN = kKeyTile / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[TM][TN];
  dot_rows<D, TM, TN, TX, TY>(qs, ts, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = ty + TY * i, c = c0 + tx + TX * j;
      float s = 0.f;
      if (r < n_rows && c < lk)
        s = ab_rows == nullptr ? acc[i][j]
                               : fmaf(acc[i][j], scale,
                                      ab_rows[static_cast<size_t>(r) * lk + c]);
      st[c * ldst + r] = s;
    }
}

// max and sum of exp over the keys of each row of st[c][r] (ROWS rows,
// key-major): thread (r, part) takes keys part, part + NP, ...; the parts
// combine in ascending order. Every thread of row r gets (m, l).
template <int ROWS>
__device__ void row_softmax_stats(const float* st, int ldst, int lk,
                                  float* red, float* m_out, float* l_out) {
  constexpr int NP = kThreads / ROWS;
  const int r = threadIdx.x % ROWS, part = threadIdx.x / ROWS;
  float m = -INFINITY;
  for (int c = part; c < lk; c += NP) m = fmaxf(m, st[c * ldst + r]);
  red[part * ROWS + r] = m;
  __syncthreads();
  m = red[r];
  for (int p = 1; p < NP; ++p) m = fmaxf(m, red[p * ROWS + r]);
  __syncthreads();
  float l = 0.f;
  for (int c = part; c < lk; c += NP) l += expf(st[c * ldst + r] - m);
  red[part * ROWS + r] = l;
  __syncthreads();
  l = 0.f;
  for (int p = 0; p < NP; ++p) l += red[p * ROWS + r];
  __syncthreads();
  *m_out = m;
  *l_out = l;
}

template <int D> size_t fwd_smem(int lkp) {
  return sizeof(float) * (static_cast<size_t>(kFwdRows + kKeyTile) * row_ld<D>()
                          + static_cast<size_t>(lkp) * (kFwdRows + 1)
                          + kThreads);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd(TrainAttnParams P,
                                                     int lkp) {
  extern __shared__ float4 smem4[];
  constexpr int BQ = kFwdRows, LD = row_ld<D>(), LDS = BQ + 1;
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* ts = qs + BQ * LD;                      // [kKeyTile][LD]: K, then V
  float* st = ts + kKeyTile * LD;                // [lkp][LDS]: scores, then P
  float* red = st + lkp * LDS;                   // [kThreads]
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * BQ;
  const int lq = P.lq, lk = P.lk, dh = P.dh;
  const size_t rs = static_cast<size_t>(P.heads) * dh;
  const size_t head = static_cast<size_t>(h) * dh;
  const int nq = min(BQ, lq - r0);
  const T* q = static_cast<const T*>(P.q) + (static_cast<size_t>(b) * lq + r0) * rs + head;
  const T* k = static_cast<const T*>(P.k) + static_cast<size_t>(b) * lk * rs + head;
  const T* v = static_cast<const T*>(P.v) + static_cast<size_t>(b) * lk * rs + head;
  const float* ab = P.ab + (static_cast<size_t>(h) * lq + r0) * lk;

  load_rows<T, D>(q, nq, rs, dh, BQ, qs);
  for (int c0 = 0; c0 < lkp; c0 += kKeyTile) {
    __syncthreads();
    load_rows<T, D>(k + c0 * rs, lk - c0, rs, dh, kKeyTile, ts);
    __syncthreads();
    score_tile<D, BQ>(qs, ts, st, LDS, c0, nq, lk, ab, P.scale);
  }
  __syncthreads();
  float m, l;
  row_softmax_stats<BQ>(st, LDS, lk, red, &m, &l);
  {
    constexpr int NP = kThreads / BQ;
    const int r = threadIdx.x % BQ, part = threadIdx.x / BQ;
    for (int c = part; c < lkp; c += NP)
      st[c * LDS + r] =
          c < lk ? round_to<T>(expf(st[c * LDS + r] - m) / l) : 0.f;
  }
  constexpr int TM = BQ * D / (4 * kThreads);
  float o[TM][4] = {};
  for (int c0 = 0; c0 < lkp; c0 += kKeyTile) {
    __syncthreads();
    load_rows<T, D>(v + c0 * rs, lk - c0, rs, dh, kKeyTile, ts);
    __syncthreads();
    axpy_rows<D, TM>(st + c0 * LDS, LDS, ts, kKeyTile, o);
  }
  T* out = static_cast<T*>(P.out) + (static_cast<size_t>(b) * lq + r0) * rs + head;
  store_rows<T, D, TM>(o, 1.f, out, nq, rs, dh);
}

template <int D> size_t dq_smem(int lkp) {
  return sizeof(float) * (static_cast<size_t>(2 * kDqRows + kKeyTile) * row_ld<D>()
                          + 2 * static_cast<size_t>(lkp) * (kDqRows + 1)
                          + kThreads + 3 * kDqRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(TrainAttnParams P,
                                                        int lkp) {
  extern __shared__ float4 smem4[];
  constexpr int BQ = kDqRows, LD = row_ld<D>(), LDS = BQ + 1;
  constexpr int NP = kThreads / BQ;
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* dos = qs + BQ * LD;                     // [BQ][LD]
  float* ts = dos + BQ * LD;                     // [kKeyTile][LD]: K or V
  float* st = ts + kKeyTile * LD;                // [lkp][LDS]: scores, P
  float* dpt = st + lkp * LDS;                   // [lkp][LDS]: dP, T(dS)
  float* red = dpt + lkp * LDS;                  // [kThreads]
  float* deltas = red + kThreads;                // [BQ]
  const int h = blockIdx.y, r0 = blockIdx.x * BQ;
  const int lq = P.lq, lk = P.lk, dh = P.dh, nh = P.heads;
  const size_t rs = static_cast<size_t>(nh) * dh;
  const size_t head = static_cast<size_t>(h) * dh;
  const int nq = min(BQ, lq - r0);
  const float* ab = P.ab + (static_cast<size_t>(h) * lq + r0) * lk;
  const int r = threadIdx.x % BQ, part = threadIdx.x / BQ;
  constexpr int TM = BQ * D / (4 * kThreads);
  // this block's batch rows [b0, b1) and the dab rows it owns
  const int per = (P.batch + P.groups - 1) / P.groups;
  const int b0 = blockIdx.z * per, b1 = min(P.batch, b0 + per);
  const size_t plane = static_cast<size_t>(nh) * lq * lk;
  float* dab = (P.groups == 1 ? P.dab : P.dab_parts + blockIdx.z * plane)
               + (static_cast<size_t>(h) * lq + r0) * lk;

  for (int b = b0; b < b1; ++b) {
    const size_t qoff = (static_cast<size_t>(b) * lq + r0) * rs + head;
    const size_t koff = static_cast<size_t>(b) * lk * rs + head;
    const T* k = static_cast<const T*>(P.k) + koff;
    const T* v = static_cast<const T*>(P.v) + koff;
    __syncthreads();
    load_rows<T, D>(static_cast<const T*>(P.q) + qoff, nq, rs, dh, BQ, qs);
    load_rows<T, D>(static_cast<const T*>(P.dout) + qoff, nq, rs, dh, BQ, dos);
    for (int c0 = 0; c0 < lkp; c0 += kKeyTile) {
      __syncthreads();
      load_rows<T, D>(k + c0 * rs, lk - c0, rs, dh, kKeyTile, ts);
      __syncthreads();
      score_tile<D, BQ>(qs, ts, st, LDS, c0, nq, lk, ab, P.scale);
    }
    for (int c0 = 0; c0 < lkp; c0 += kKeyTile) {
      __syncthreads();
      load_rows<T, D>(v + c0 * rs, lk - c0, rs, dh, kKeyTile, ts);
      __syncthreads();
      score_tile<D, BQ>(dos, ts, dpt, LDS, c0, nq, lk, nullptr, 0.f);
    }
    __syncthreads();
    float m, l;
    row_softmax_stats<BQ>(st, LDS, lk, red, &m, &l);
    float delta = 0.f;
    for (int c = part; c < lk; c += NP) {
      const float p = expf(st[c * LDS + r] - m) / l;
      st[c * LDS + r] = p;
      delta += p * dpt[c * LDS + r];
    }
    red[part * BQ + r] = delta;
    __syncthreads();
    delta = 0.f;
    for (int p = 0; p < NP; ++p) delta += red[p * BQ + r];
    if (part == 0) {
      deltas[r] = delta;
      if (r < nq) {
        const size_t rows = static_cast<size_t>(P.batch) * nh * lq;
        const size_t i = (static_cast<size_t>(b) * nh + h) * lq + r0 + r;
        P.stats[i] = m;
        P.stats[rows + i] = l;
        P.stats[2 * rows + i] = delta;
      }
    }
    __syncthreads();
    // dS row by row, the threads along the keys: the dab update is one
    // coalesced read-modify-write of rows no other block touches
    for (int rr = 0; rr < BQ; ++rr)
      for (int c = threadIdx.x; c < lkp; c += kThreads) {
        float ds = 0.f;
        if (c < lk) {
          ds = st[c * LDS + rr] * (dpt[c * LDS + rr] - deltas[rr]);
          if (rr < nq) {
            float* cell = dab + static_cast<size_t>(rr) * lk + c;
            *cell = b == b0 ? ds : *cell + ds;
          }
        }
        dpt[c * LDS + rr] = round_to<T>(ds);
      }
    float acc[TM][4] = {};
    for (int c0 = 0; c0 < lkp; c0 += kKeyTile) {
      __syncthreads();
      load_rows<T, D>(k + c0 * rs, lk - c0, rs, dh, kKeyTile, ts);
      __syncthreads();
      axpy_rows<D, TM>(dpt + c0 * LDS, LDS, ts, kKeyTile, acc);
    }
    store_rows<T, D, TM>(acc, P.scale, static_cast<T*>(P.dq) + qoff, nq, rs,
                         dh);
  }
}

// dab = the groups' partial sums added in group order
__global__ void __launch_bounds__(kThreads) attn_dab_sum(TrainAttnParams P) {
  const size_t n = static_cast<size_t>(P.heads) * P.lq * P.lk;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = P.dab_parts[i];
    for (int g = 1; g < P.groups; ++g) s += P.dab_parts[g * n + i];
    P.dab[i] = s;
  }
}

template <int D> size_t dkv_smem() {
  constexpr int BK = dkv_keys<D>();
  return sizeof(float) * (static_cast<size_t>(2 * BK + 2 * kDkvRows) * row_ld<D>()
                          + 2 * static_cast<size_t>(kDkvRows) * (BK + 1)
                          + 3 * kDkvRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv(TrainAttnParams P) {
  extern __shared__ float4 smem4[];
  constexpr int BK = dkv_keys<D>(), BQ = kDkvRows, LD = row_ld<D>();
  constexpr int LDP = BK + 1;
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* vs = ks + BK * LD;                      // [BK][LD]
  float* qs = vs + BK * LD;                      // [BQ][LD]
  float* dos = qs + BQ * LD;                     // [BQ][LD]
  float* ps = dos + BQ * LD;                     // [BQ][LDP]: T(P)
  float* dss = ps + BQ * LDP;                    // [BQ][LDP]: T(dS)
  float* rst = dss + BQ * LDP;                   // [3][BQ]: max, sum, delta
  const int b = blockIdx.z, h = blockIdx.y, c0 = blockIdx.x * BK;
  const int lq = P.lq, lk = P.lk, dh = P.dh, nh = P.heads;
  const size_t rs = static_cast<size_t>(nh) * dh;
  const size_t head = static_cast<size_t>(h) * dh;
  const int nk = min(BK, lk - c0);
  const size_t koff = (static_cast<size_t>(b) * lk + c0) * rs + head;
  load_rows<T, D>(static_cast<const T*>(P.k) + koff, nk, rs, dh, BK, ks);
  load_rows<T, D>(static_cast<const T*>(P.v) + koff, nk, rs, dh, BK, vs);
  constexpr int TX = 16, TY = 16, TM = BQ / TY, TN = BK / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  constexpr int KTM = BK * D / (4 * kThreads);
  float dk[KTM][4] = {}, dv[KTM][4] = {};
  const size_t plane = static_cast<size_t>(P.batch) * nh * lq;
  const float* stats = P.stats + (static_cast<size_t>(b) * nh + h) * lq;

  for (int r0 = 0; r0 < lq; r0 += BQ) {
    const int nq = min(BQ, lq - r0);
    const size_t qoff = (static_cast<size_t>(b) * lq + r0) * rs + head;
    __syncthreads();
    load_rows<T, D>(static_cast<const T*>(P.q) + qoff, nq, rs, dh, BQ, qs);
    load_rows<T, D>(static_cast<const T*>(P.dout) + qoff, nq, rs, dh, BQ, dos);
    for (int e = threadIdx.x; e < 3 * BQ; e += kThreads) {
      const int s = e / BQ, rr = e % BQ;
      rst[e] = rr < nq ? stats[s * plane + r0 + rr] : 0.f;
    }
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
    dot_rows<D, TM, TN, TX, TY>(qs, ks, s);
    dot_rows<D, TM, TN, TX, TY>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int rr = ty + TY * i, c = tx + TX * j;
        float p = 0.f, ds = 0.f;
        if (rr < nq && c < nk) {
          const float x = fmaf(
              s[i][j], P.scale,
              P.ab[(static_cast<size_t>(h) * lq + r0 + rr) * lk + c0 + c]);
          p = expf(x - rst[rr]) / rst[BQ + rr];
          ds = p * (dp[i][j] - rst[2 * BQ + rr]);
        }
        ps[rr * LDP + c] = round_to<T>(p);
        dss[rr * LDP + c] = round_to<T>(ds);
      }
    __syncthreads();
    axpy_rows<D, KTM>(ps, LDP, dos, BQ, dv);
    axpy_rows<D, KTM>(dss, LDP, qs, BQ, dk);
  }
  store_rows<T, D, KTM>(dk, P.scale, static_cast<T*>(P.dk) + koff, nk, rs, dh);
  store_rows<T, D, KTM>(dv, 1.f, static_cast<T*>(P.dv) + koff, nk, rs, dh);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t forward(const TrainAttnParams& P, cudaStream_t s) {
  const int lkp = round_up(P.lk, kKeyTile);
  const size_t bytes = fwd_smem<D>(lkp);
  cudaError_t e = allow_smem(attn_fwd<T, D>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.lq + kFwdRows - 1) / kFwdRows, P.heads, P.batch);
  attn_fwd<T, D><<<grid, kThreads, bytes, s>>>(P, lkp);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t backward(const TrainAttnParams& P, cudaStream_t s) {
  const int lkp = round_up(P.lk, kKeyTile);
  const size_t dq_bytes = dq_smem<D>(lkp), dkv_bytes = dkv_smem<D>();
  cudaError_t e = allow_smem(attn_bwd_dq<T, D>, dq_bytes);
  if (e != cudaSuccess) return e;
  e = allow_smem(attn_bwd_dkv<T, D>, dkv_bytes);
  if (e != cudaSuccess) return e;
  if (P.groups < 1 || P.groups > P.batch
      || (P.groups > 1 && P.dab_parts == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid_dq((P.lq + kDqRows - 1) / kDqRows, P.heads, P.groups);
  attn_bwd_dq<T, D><<<grid_dq, kThreads, dq_bytes, s>>>(P, lkp);
  ISI_CHECK();
  if (P.groups > 1) {
    const size_t n = static_cast<size_t>(P.heads) * P.lq * P.lk;
    const int blocks = static_cast<int>(
        std::min<size_t>((n + kThreads - 1) / kThreads, 4096));
    attn_dab_sum<<<blocks, kThreads, 0, s>>>(P);
    ISI_CHECK();
  }
  constexpr int BK = dkv_keys<D>();
  const dim3 grid_dkv((P.lk + BK - 1) / BK, P.heads, P.batch);
  attn_bwd_dkv<T, D><<<grid_dkv, kThreads, dkv_bytes, s>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const TrainAttnParams& P, bool fwd, cudaStream_t s) {
  if (P.dh <= 64) return fwd ? forward<T, 64>(P, s) : backward<T, 64>(P, s);
  if (P.dh <= 128) return fwd ? forward<T, 128>(P, s) : backward<T, 128>(P, s);
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
