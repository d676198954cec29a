// Whole-scan B=1 decode: the entire token loop over [p0, steps) in ONE
// persistent cooperative launch.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/decode_scan_kernel.py
//           ::fused_decode_scan (Pallas kernel _decode_scan_kernel).
//
// Bound on the H100: each step streams every decoder weight once (bottom
// prior, bf16: 8 x (1536+512+512+2048+2048) x 512 x 2 B + logits ~ 55 MB;
// the top prior adds wq_c, ~59 MB): 16-18 us at 3.35 TB/s, against a few
// MFLOP of arithmetic. The TPU kernel kept every weight and the KV cache in
// VMEM; no SM holds that, so the weights stream from device memory (and
// L2) every step. What paces a step is latency: each phase waits for a
// grid barrier (~1.1 us on the H100), then for its inputs, then for its
// weights. So the design cuts phases and, inside a phase, round trips.
//
// Layout: kBlocks = 120 blocks of 512 threads, one per SM, in kClusters =
// 15 thread-block clusters of kCluster = 8 (the most clusters of 8 that
// co-reside on the H100 at one block per SM), all alive for the whole
// scan: a cooperative launch with a cluster dimension. Up to 15 heads,
// cluster c takes head c. Above 15 heads, cluster c takes the G = ceil(H /
// 15) adjacent heads c G, ..., c G + G - 1 side by side (the grouped
// kernel, decode_scan_kernel<T, false, true>): the block computes its G dh
// / 8 of their q, k, v rows in one product, attends its eighth of the keys
// of every head of the group, and stages all G heads' slices before the
// grid barrier, so a phase keeps one gather and one combine a cluster
// whatever G is. It runs where the group is at most kDhMax wide and every
// region of it fits shared memory (side_by_side()); the reference's 16
// heads of 32 take 8 clusters of 2 heads. Else the general kernel runs
// the heads c, c + 15, ... of cluster c one after the other inside the
// phase. Either way the grid barriers a step stay as many as with one head
// a cluster. Per layer and step:
//
//   ATT   (head clusters) rebuild the residual x from the last phase's
//         partials (each block its own copy), LN1, the head's q, k, v rows
//         split over the cluster (dh / 8 of each a block), the fresh K/V
//         row into the cache | cluster barrier, q, k, v gathered through
//         distributed shared memory | attention partials over the block's
//         eighth of the cached keys | cluster barrier | every block combines
//         the 8 partials with the fresh key, then multiplies the head's
//         output by its d / 8 rows of the head's columns of wo (aligned: and
//         of wo_c times the gathered memory row): a [d] partial per head.
//   CROSS (cross layers, head clusters) the same for LN2, wq_c and the
//         attention over the source keys, ending in wo_c's partial.
//   MLP   (all blocks) rebuild x, LN3, the block's d_ff slice of fc1
//         (+ ReLU, rounded to T), that slice's fc2 partial [d] | cluster
//         barrier | the cluster's partials added in rank order: a [d]
//         partial per cluster.
//   then  LOGITS (all blocks) rebuild x, final LN, the block's logit rows;
//         the next step's ATT takes the Gumbel argmax (every head block the
//         same answer, block 0 writes it where mask[i] && i >= 0).
//
// Grid barriers a step: 2 per aligned layer, 3 per cross layer, plus 1.
// No float atomics: every partial is added in a fixed order (heads, then
// clusters, each in index order, then the bias), so runs repeat bit for
// bit; decode_scan_plain adds its partials in the same order.
//
// Weights and cached keys do not depend on the step's values, so before
// each grid barrier every block issues cp.async copies of what it will
// multiply or read in the next phase (its weight slices; its keys and
// values) into shared memory: the copies fly during the barrier and the
// residual rebuild. Each phase has its region: R1 for ATT, R2 for MLP and
// LOGITS, R3 for CROSS (fc2's column slice is staged in bf16 only; float32,
// the parity dtype, reads it from device memory, for want of shared
// memory). A wide model whose regions do not all fit the 227 KB a block
// can have (d_model 1024 with head_dim 128, the float32 parity dtype at
// head_dim 128) reads regions straight from device memory, in this order
// until the rest fits: R2, R3, R1's weights, R1's keys (geometry()). The
// products are the same either way, in the same order: only where an
// operand is read from changes. In the general kernel the second and later
// heads of a cluster stage their slices after the first head's products,
// without overlap; the grouped kernel stages every region, all its heads'
// slices at once. Each head's products are the same in all three kernels,
// added in the same order.
//
// Measured on the H100 (PERF.md, Findings): a step takes about as long as
// the 41-phase design it replaces. Each segment between two barriers still
// costs several microseconds for little work: the phase's weight copies (a
// head block copies ~56 KB in ATT), an L2 round trip for the partial sums,
// block and lane reductions.
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
  float* xbuf;        // [2, d]: the residual, published by block 0
  float* part_att;    // [H, d]: per-head partials of ATT
  float* part_cross;  // [H, d]: per-head partials of CROSS
  float* part_mlp;    // [kClusters, d]: per-cluster partials of MLP
  float* logits;      // [n_class]
  int n_layers, d, d_ff, n_heads, n_class, l_pad, e_pad, steps_pad, length;
  int channels, p0, steps, e_src, aligned;
  float scale, temperature;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kCluster = 8;    // blocks of a cluster: one head's group
constexpr int kClusters = 15;  // clusters of 8 co-resident on the H100
constexpr int kBlocks = kCluster * kClusters;
constexpr int kUnit = 8;       // d_ff rows of fc1 (columns of fc2) a unit
constexpr int kMaxParts = 16;  // partials a rebuild loads at once
constexpr int kDhMax = 128;    // head dim: 3 dh values gathered a thread
// shared memory a block can have on the H100 (227 KB): the regions that
// would exceed it are read from device memory
constexpr size_t kSmemBudget = 232448;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// the next n floats of the scratch, 16-byte aligned
__host__ __device__ inline int take_floats(int& o, int n) {
  const int at = o;
  o += (n + 3) / 4 * 4;
  return at;
}

// The shapes of a block's slices and the byte offsets of its shared
// memory: float32 scratch first, then the two staging regions.
struct Geometry {
  int dh, dq, rows_o, kmax, emax, umax, lmax, w2_ld;
  // the regions staged in shared memory (else read from device memory)
  bool stage_w1, stage_k1, stage_r2, stage_r3;
  // float offsets
  int xs, vin, lnw, rowb, exch, qf, kf, vf, keyb, sc, pv, part, av, mvs, mid,
      fc2p, red;
  // byte offsets and sizes of the regions
  size_t r1, r1_bytes, r2, r2_bytes, r3, r3_bytes, total;
};

// heads a cluster takes side by side in the grouped kernel
__host__ __device__ inline int group_heads(const ScanParams& P) {
  return cdiv(P.n_heads, kClusters);
}

// kGeneral false: every region staged (the caller knows it fits); kGrouped:
// room for group_heads() heads side by side (scores and partials a head
// apart), every region staged
template <typename T, bool kGeneral = true, bool kGrouped = false>
__host__ __device__ inline Geometry geometry(const ScanParams& P) {
  Geometry g;
  const int d = P.d;
  g.dh = d / P.n_heads;
  g.dq = g.dh / kCluster;
  const int heads = kGrouped ? group_heads(P) : 1;
  const int gh = heads * g.dh, gq = heads * g.dq;  // the group's widths
  g.rows_o = d / kCluster;
  g.kmax = cdiv(P.l_pad, kCluster);
  g.emax = P.aligned ? 0 : cdiv(P.e_src, kCluster);
  g.umax = cdiv(P.d_ff / kUnit, kBlocks);
  g.lmax = cdiv(P.n_class, kBlocks);
  // a staged fc2 row of umax units, an odd number of 16-byte pieces apart
  // (thread r reads row r: no bank conflicts)
  g.w2_ld = g.umax * kUnit + ((g.umax % 2) ? 0 : kUnit);
  const int rows_b = 3 * gq > g.umax * kUnit ? 3 * gq : g.umax * kUnit;
  int o = 0;
  const int keys = g.kmax > g.emax ? g.kmax : g.emax;
  g.xs = take_floats(o, d);
  g.vin = take_floats(o, d);
  g.lnw = take_floats(o, 2 * d);
  g.rowb = take_floats(o, rows_b > g.lmax ? rows_b : g.lmax);
  g.exch = take_floats(o, 3 * gq);
  g.qf = take_floats(o, gh);
  g.kf = take_floats(o, gh);
  g.vf = take_floats(o, gh);
  g.keyb = take_floats(o, heads * keys);
  g.sc = take_floats(o, heads * keys);
  g.pv = take_floats(o, heads * kThreads);
  g.part = take_floats(o, heads * (2 + g.dh));
  g.av = take_floats(o, gh);
  g.mvs = take_floats(o, gh);
  g.mid = take_floats(o, g.umax * kUnit);
  g.fc2p = take_floats(o, d);
  g.red = take_floats(o, 64);
  const size_t es = sizeof(T);
  const size_t w1 = es * ((size_t)3 * gq * d + 2 * (size_t)g.rows_o * gh);
  const size_t k1 = es * 2 * (size_t)g.kmax * gh;
  const size_t r3 = P.aligned ? 0
                              : es * ((size_t)gq * d + (size_t)g.rows_o * gh
                                      + 2 * (size_t)g.emax * gh);
  size_t mlp = es * (size_t)g.umax * kUnit * d;
  if (sizeof(T) == 2) mlp += es * (size_t)d * g.w2_ld;
  const size_t logit = es * (size_t)g.lmax * d;
  const size_t r2 = logit > mlp ? logit : mlp;
  g.r1 = (size_t)o * 4;
  // level 0 stages every region; each level reads one more from device
  // memory: R2, R3, R1's weights, R1's keys
  for (int level = 0; level < (kGeneral ? 5 : 1); ++level) {
    g.stage_r2 = level < 1;
    g.stage_r3 = level < 2;
    g.stage_w1 = level < 3;
    g.stage_k1 = level < 4;
    g.r1_bytes = (g.stage_w1 ? w1 : 0) + (g.stage_k1 ? k1 : 0);
    g.r2_bytes = g.stage_r2 ? r2 : 0;
    g.r3_bytes = g.stage_r3 ? r3 : 0;
    g.r2 = g.r1 + (g.r1_bytes + 15) / 16 * 16;
    g.r3 = g.r2 + (g.r2_bytes + 15) / 16 * 16;
    g.total = g.r3 + g.r3_bytes;
    if (g.total <= kSmemBudget) break;
  }
  return g;
}

// 16-byte asynchronous copy from global to shared memory through L2 (so it
// sees what other blocks wrote earlier), and the wait for this thread's
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[r * dld + c] = src[r * sld + c] for r < n, c < k (k a whole number
// of 16-byte pieces), by cp.async
template <typename T>
__device__ void stage(T* dst, int dld, const T* src, size_t sld, int n,
                      int k) {
  constexpr int V = Vec<T>::N;
  const int per = k / V;
  for (int e = threadIdx.x; e < n * per; e += kThreads) {
    const int r = e / per, c = (e % per) * V;
    cp_async16(dst + (size_t)r * dld + c, src + (size_t)r * sld + c);
  }
}

__device__ __forceinline__ float dot_vec(const float* w, const float* in,
                                         int n, float acc) {
  for (int j = 0; j < n; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(in + j);
    acc = fmaf(w[j], a.x, acc);
    acc = fmaf(w[j + 1], a.y, acc);
    acc = fmaf(w[j + 2], a.z, acc);
    acc = fmaf(w[j + 3], a.w, acc);
  }
  return acc;
}

// epi(r, row(r)[:K] . in) for r < rows, LPR lanes a row; the rows in
// shared or device memory, ``in`` float32 in shared memory
template <int LPR, typename T, typename Row, typename Epi>
__device__ __forceinline__ void gemv_rows(Row row_at, int rows, int K,
                                          const float* in, Epi epi) {
  constexpr int V = Vec<T>::N, RPW = kWarp / LPR;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int sub = lane % LPR;
  for (int r0 = warp * RPW; r0 < rows; r0 += kWarps * RPW) {
    const int r = r0 + lane / LPR;
    float acc = 0.f;
    if (r < rows) {
      const T* row = row_at(r);
      for (int c = sub * V; c < K; c += LPR * V) {
        float w[V];
        load_vec_rw(row + c, w);
        acc = dot_vec(w, in + c, V, acc);
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (sub == 0 && r < rows) epi(r, acc);
  }
}
// the same for W rows ldw elements apart
template <int LPR, typename T, typename Epi>
__device__ __forceinline__ void gemv(const T* W, int ldw, int rows, int K,
                                     const float* in, Epi epi) {
  gemv_rows<LPR, T>([=](int r) { return W + (size_t)r * ldw; }, rows, K, in,
                    epi);
}

// loads of cached keys and values: from shared memory (G false) or from
// device memory through L2 (G true: other blocks write the cache while the
// kernel runs)
template <bool G>
__device__ __forceinline__ void load_key(const float* p, float* out) {
  if (G) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    load_vec_rw(p, out);
  }
}
template <bool G>
__device__ __forceinline__ void load_key(const __nv_bfloat16* p,
                                         float* out) {
  if (G) {
    uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  } else {
    load_vec_rw(p, out);
  }
}
template <bool G>
__device__ __forceinline__ float load_elem(const float* p) {
  return G ? __ldcg(p) : *p;
}
template <bool G>
__device__ __forceinline__ float load_elem(const __nv_bfloat16* p) {
  return G ? __bfloat162float(__ushort_as_bfloat16(
                 __ldcg(reinterpret_cast<const unsigned short*>(p))))
           : to_f(*p);
}

// the sum of v over the block, every thread the same (the warps' sums
// added in warp order); ``red`` holds kWarps floats
__device__ __forceinline__ float block_total(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// LayerNorm of xs [d] into vin, rounded to T (flax LayerNorm). Thread i
// reads the elements i, i + 512, ... that the rebuild wrote.
template <typename T>
__device__ void layer_norm(const float* xs, const float* scale,
                           const float* bias, int d, float* vin, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) s += xs[i];
  const float mu = block_total(s, red) / d;
  float v = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float dv = xs[i] - mu;
    v += dv * dv;
  }
  const float rs = rsqrtf(block_total(v, red + kWarps) / d + 1e-6f);
  for (int i = threadIdx.x; i < d; i += kThreads)
    vin[i] = round_to<T>((xs[i] - mu) * rs * scale[i] + bias[i]);
  __syncthreads();
}

// The attention partial of this block's n keys (ks, vs [n] rows kld
// apart: staged in shared memory, or with G the cache in device memory):
// s_j = (q . K_j) * scale + kb[j]; part = {max s, sum exp(s - max),
// sum exp(s - max) V_j}. Four threads a key for q . K; thread (g, t) sums
// dim t over the keys j = g mod (512 / dh).
template <bool G, typename T>
__device__ void attend_own(const T* ks, const T* vs, int kld, int n,
                           const float* q, const float* kb, int dh,
                           float scale, float* sc, float* pv, float* part) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x;
  const int pieces = dh / V;
  for (int j0 = 0; j0 < n; j0 += kThreads / 4) {
    const int j = j0 + tid / 4, s = tid % 4;
    float a = 0.f;
    if (j < n) {
      for (int pc = s; pc < pieces; pc += 4) {
        float kk[V];
        load_key<G>(ks + (size_t)j * kld + pc * V, kk);
        a = dot_vec(kk, q + pc * V, V, a);
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if (j < n && s == 0) sc[j] = a * scale + kb[j];
  }
  __syncthreads();
  if (tid < kWarp) {
    float m = -INFINITY;
    for (int t = tid; t < n; t += kWarp) m = fmaxf(m, sc[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = tid; t < n; t += kWarp) {
      const float e = expf(sc[t] - m);
      sc[t] = e;
      l += e;
    }
    l = warp_sum(l);
    if (tid == 0) {
      part[0] = m;
      part[1] = l;
    }
  }
  __syncthreads();
  const int groups = kThreads / dh;
  if (tid < groups * dh) {
    const int t = tid % dh, g = tid / dh;
    float a = 0.f;
    for (int j = g; j < n; j += groups)
      a = fmaf(sc[j], load_elem<G>(vs + (size_t)j * kld + t), a);
    pv[tid] = a;
  }
  __syncthreads();
  for (int t = tid; t < dh; t += kThreads) {
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += pv[g * dh + t];
    part[2 + t] = a;
  }
}

// Every block of a head's cluster: the head's output from the cluster's 8
// partials (read through distributed shared memory) and, with ``fresh``,
// the fresh key (logit lp, value vf): av[t] = T(softmax . V)
template <typename T>
__device__ void combine(cg::cluster_group& cluster, float* part, int dh,
                        bool fresh, float lp, const float* vf, float* av) {
  const int t = threadIdx.x;
  if (t < dh) {
    float m[kCluster], l[kCluster], a[kCluster];
#pragma unroll
    for (int i = 0; i < kCluster; ++i) {
      const float* pp = cluster.map_shared_rank(part, i);
      m[i] = pp[0];
      l[i] = pp[1];
      a[i] = pp[2 + t];
    }
    float mm = fresh ? lp : -INFINITY;
#pragma unroll
    for (int i = 0; i < kCluster; ++i) mm = fmaxf(mm, m[i]);
    const float wf = fresh ? expf(lp - mm) : 0.f;
    float den = 0.f, acc = fresh ? wf * vf[t] : 0.f;
#pragma unroll
    for (int i = 0; i < kCluster; ++i) {
      // a block that saw no key holds max -inf and zero sums
      const float w = m[i] == -INFINITY ? 0.f : expf(m[i] - mm);
      den = fmaf(l[i], w, den);
      acc = fmaf(a[i], w, acc);
    }
    av[t] = round_to<T>(acc / fmaxf(den + wf, 1e-20f));
  }
  __syncthreads();
}

// attend_own for ``heads`` heads side by side (staged keys and values):
// head i's dims at column i dh of the rows (kld apart) and of q, its key
// biases and scores at kb and sc + i kst, its partial at part + i (2 + dh),
// pv [heads][kThreads]. Each head's sums are attend_own's, in its order.
template <typename T>
__device__ void attend_heads(const T* ks, const T* vs, int kld, int n,
                             int heads, const float* q, const float* kb,
                             int kst, int dh, float scale, float* sc,
                             float* pv, float* part) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int pieces = dh / V, items = heads * n;
  for (int e0 = 0; e0 < items; e0 += kThreads / 4) {
    const int e = e0 + tid / 4, s = tid % 4;
    const int i = e / n, j = e - i * n;
    float a = 0.f;
    if (e < items) {
      for (int pc = s; pc < pieces; pc += 4) {
        float kk[V];
        load_vec_rw(ks + (size_t)j * kld + i * dh + pc * V, kk);
        a = dot_vec(kk, q + i * dh + pc * V, V, a);
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if (e < items && s == 0) sc[i * kst + j] = a * scale + kb[i * kst + j];
  }
  __syncthreads();
  if (warp < heads) {  // warp i: head i's softmax
    float* si = sc + warp * kst;
    float m = -INFINITY;
    for (int t = lane; t < n; t += kWarp) m = fmaxf(m, si[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += kWarp) {
      const float e = expf(si[t] - m);
      si[t] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part[warp * (2 + dh)] = m;
      part[warp * (2 + dh) + 1] = l;
    }
  }
  __syncthreads();
  const int groups = kThreads / dh, per = groups * dh;
  for (int e = tid; e < heads * per; e += kThreads) {
    const int i = e / per, t = e % per % dh, g = e % per / dh;
    const float* si = sc + i * kst;
    float a = 0.f;
    for (int j = g; j < n; j += groups)
      a = fmaf(si[j], to_f(vs[(size_t)j * kld + i * dh + t]), a);
    pv[e] = a;
  }
  __syncthreads();
  for (int e = tid; e < heads * dh; e += kThreads) {
    const int i = e / dh, t = e % dh;
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += pv[i * per + g * dh + t];
    part[i * (2 + dh) + 2 + t] = a;
  }
}

// combine for ``heads`` heads side by side: thread t takes dim t % dh of
// head t / dh (its partials at part + i (2 + dh), its fresh logit lps[i])
template <typename T>
__device__ void combine_heads(cg::cluster_group& cluster, float* part,
                              int dh, int heads, bool fresh, const float* lps,
                              const float* vf, float* av) {
  const int t = threadIdx.x;
  if (t < heads * dh) {
    const int i = t / dh, ti = t % dh;
    float* pi = part + i * (2 + dh);
    float m[kCluster], l[kCluster], a[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float* pp = cluster.map_shared_rank(pi, r);
      m[r] = pp[0];
      l[r] = pp[1];
      a[r] = pp[2 + ti];
    }
    const float lp = fresh ? lps[i] : 0.f;
    float mm = fresh ? lp : -INFINITY;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) mm = fmaxf(mm, m[r]);
    const float wf = fresh ? expf(lp - mm) : 0.f;
    float den = 0.f, acc = fresh ? wf * vf[t] : 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float w = m[r] == -INFINITY ? 0.f : expf(m[r] - mm);
      den = fmaf(l[r], w, den);
      acc = fmaf(a[r], w, acc);
    }
    av[t] = round_to<T>(acc / fmaxf(den + wf, 1e-20f));
  }
  __syncthreads();
}

// keys [j0, j0 + n) of this block's eighth of n_keys
__device__ __forceinline__ void key_range(int n_keys, int rank, int& j0,
                                          int& n) {
  const int per = cdiv(n_keys, kCluster);
  j0 = min(rank * per, n_keys);
  n = min(per, n_keys - j0);
}

// kGeneral: one head a cluster and every region staged (false: the full
// test models' shapes, the code the general path adds compiled out), or
// any head count and regions read from device memory where they do not fit.
// kGrouped (with kGeneral false): the heads of a group side by side in each
// cluster, every region staged; the code it adds is compiled out of the
// other two.
template <typename T, bool kGeneral, bool kGrouped = false>
__global__ void __launch_bounds__(kThreads, 1)
    decode_scan_kernel(const ScanParams P) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const Geometry g = geometry<T, kGeneral, kGrouped>(P);
  const bool stage_w1 = !kGeneral || g.stage_w1;
  const bool stage_k1 = !kGeneral || g.stage_k1;
  const bool stage_r2 = !kGeneral || g.stage_r2;
  const bool stage_r3 = !kGeneral || g.stage_r3;
  float* fs = reinterpret_cast<float*>(smem4);
  float* xs = fs + g.xs;
  float* vin = fs + g.vin;
  float* lnw = fs + g.lnw;
  float* rowb = fs + g.rowb;
  float* exch = fs + g.exch;
  float* qf = fs + g.qf;
  float* kf = fs + g.kf;
  float* vf = fs + g.vf;
  float* keyb = fs + g.keyb;
  float* sc = fs + g.sc;
  float* pv = fs + g.pv;
  float* part = fs + g.part;
  float* av = fs + g.av;
  float* mvs = fs + g.mvs;
  float* mid = fs + g.mid;
  float* fc2p = fs + g.fc2p;
  float* red = fs + g.red;
  char* bytes = reinterpret_cast<char*>(smem4);
  T* r1 = reinterpret_cast<T*>(bytes + g.r1);
  T* r2 = reinterpret_cast<T*>(bytes + g.r2);
  T* r3 = reinterpret_cast<T*>(bytes + g.r3);

  const int d = P.d, H = P.n_heads, dh = g.dh, dq = g.dq, c = P.channels;
  const int rows_o = g.rows_o, tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / kCluster;
  // the cluster's first head (general: then cid + kClusters, ...) and, in
  // kGrouped, its hg heads side by side: hw dims, gq of them this block's
  const int heads = kGrouped ? group_heads(P) : 1;
  const int head0 = cid * heads;
  const int hg = kGrouped ? max(0, min(heads, H - head0)) : 1;
  const int hw = hg * dh, gq = hg * dq;
  // kGrouped: a head's key scores lie kst apart; the fresh keys' logits in
  // red's free upper half (block_total and argmax take its first 2 kWarps)
  const int kst = max(g.kmax, g.emax);
  float* lpf = red + 2 * kWarps;
  const int U = P.d_ff / kUnit;
  const int f0 = blockIdx.x * U / kBlocks * kUnit;
  const int nf = (blockIdx.x + 1) * U / kBlocks * kUnit - f0;
  const int lr0 = blockIdx.x * P.n_class / kBlocks;
  const int nl = (blockIdx.x + 1) * P.n_class / kBlocks - lr0;
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
  const T* w_logits = static_cast<const T*>(P.w_logits);
  const T* emb = static_cast<const T*>(P.emb);
  const T* posfull = static_cast<const T*>(P.posfull);
  const T* mem_k = static_cast<const T*>(P.mem_k);
  const T* mem_v = static_cast<const T*>(P.mem_v);
  T* kv = static_cast<T*>(P.kv);

  // R1 (ATT): wqkv rows [3 gq][d], wo and wo_c slices [rows_o][hw], the
  // block's cached keys and values [kmax][hw]
  T* wqkv_s = r1;
  T* wo_s = wqkv_s + (size_t)3 * gq * d;
  T* woc_s = wo_s + (size_t)rows_o * hw;
  T* ks = stage_w1 ? woc_s + (size_t)rows_o * hw : r1;
  T* vs = ks + (size_t)g.kmax * hw;
  // R3 (CROSS): wq_c rows [gq][d], wo_c slice, source keys and values
  T* wqc_s = r3;
  T* woc2_s = wqc_s + (size_t)gq * d;
  T* mk_s = woc2_s + (size_t)rows_o * hw;
  T* mv_s = mk_s + (size_t)g.emax * hw;
  // R2 (MLP): fc1 rows [nf][d], fc2 columns [d][w2_ld] (bf16); (LOGITS)
  // logit rows [nl][d]
  T* w1_s = r2;
  T* w2_s = w1_s + (size_t)g.umax * kUnit * d;
  T* wl_s = r2;
  const bool w2_staged = sizeof(T) == 2 && stage_r2;

  // where a head's slices lie in device memory
  auto wqkv_row = [&](int l, int head, int r) {  // r < 3 dq: q, k, v rows
    return wqkv + (size_t)l * 3 * dd
           + ((size_t)(r / dq) * d + head * dh + rank * dq + r % dq) * d;
  };
  auto o_slice = [&](const T* w, int l, int head) {  // [rows_o][hw], ld d
    return w + (size_t)l * dd + (size_t)rank * rows_o * d + head * dh;
  };
  // the slices of head ``head`` (kGrouped: of the hg heads from it)
  auto prefetch_att = [&](int l, int p, int head) {
    if (head >= H) return;
    if (stage_w1) {
      const T* wl = wqkv + (size_t)l * 3 * dd;
      for (int s = 0; s < 3; ++s)
        stage(wqkv_s + (size_t)s * gq * d, d,
              wl + ((size_t)s * d + head * dh + rank * gq) * d, d, gq, d);
      stage(wo_s, hw, o_slice(wo, l, head), d, rows_o, hw);
      if (P.aligned) stage(woc_s, hw, o_slice(wo_c, l, head), d, rows_o, hw);
    }
    if (stage_k1) {
      int j0, n;
      key_range(p, rank, j0, n);
      const T* kc = kv + (size_t)(2 * l) * P.l_pad * d + head * dh;
      stage(ks, hw, kc + (size_t)j0 * d, d, n, hw);
      stage(vs, hw, kc + (size_t)(P.l_pad + j0) * d, d, n, hw);
    }
  };
  auto prefetch_cross = [&](int l, int head) {
    if (head >= H || !stage_r3) return;
    stage(wqc_s, d, wq_c + (size_t)l * dd + (size_t)(head * dh + rank * gq) * d,
          d, gq, d);
    stage(woc2_s, hw, o_slice(wo_c, l, head), d, rows_o, hw);
    int e0, n;
    key_range(P.e_src, rank, e0, n);
    const size_t at = ((size_t)l * P.e_pad + e0) * d + head * dh;
    stage(mk_s, hw, mem_k + at, d, n, hw);
    stage(mv_s, hw, mem_v + at, d, n, hw);
  };
  auto prefetch_mlp = [&](int l) {
    if (!stage_r2) return;
    stage(w1_s, d, w1 + ((size_t)l * P.d_ff + f0) * d, d, nf, d);
    if (w2_staged)
      stage(w2_s, g.w2_ld, w2 + (size_t)l * d * P.d_ff + f0, P.d_ff, d, nf);
  };
  auto prefetch_logits = [&]() {
    if (stage_r2) stage(wl_s, d, w_logits + (size_t)lr0 * d, d, nl, d);
  };

  // xs = xbuf[ph - 1] + (sum over k of parts[k] + (bias_a + bias_b)), in
  // that order; block 0 publishes it as xbuf[ph]; the LayerNorm's scale
  // and bias into lnw. Every load of the first kMaxParts partials is issued
  // before its first use: one round trip (more partials, more heads, come
  // in further batches, added in order).
  auto rebuild = [&](int ph, const float* parts, int n_parts, const T* ba,
                     const T* bb, const float* ln_s, const float* ln_b) {
    const float* xp = P.xbuf + (size_t)((ph + 1) & 1) * d;
    float* xc = P.xbuf + (size_t)(ph & 1) * d;
    for (int r = tid; r < d; r += kThreads) {
      float v[kMaxParts];
#pragma unroll
      for (int k = 0; k < kMaxParts; ++k)
        v[k] = k < n_parts ? __ldcg(parts + (size_t)k * d + r) : 0.f;
      const float x0 = __ldcg(xp + r);
      float b = to_f(ba[r]);
      if (bb != nullptr) b += to_f(bb[r]);
      lnw[r] = ln_s[r];
      lnw[d + r] = ln_b[r];
      float s = v[0];
#pragma unroll
      for (int k = 1; k < kMaxParts; ++k)
        if (k < n_parts) s += v[k];
      for (int k0 = kMaxParts; (kGeneral || kGrouped) && k0 < n_parts;
           k0 += kMaxParts) {
#pragma unroll
        for (int k = 0; k < kMaxParts; ++k)
          v[k] = k0 + k < n_parts ? __ldcg(parts + (size_t)(k0 + k) * d + r)
                                  : 0.f;
#pragma unroll
        for (int k = 0; k < kMaxParts; ++k)
          if (k0 + k < n_parts) s += v[k];
      }
      const float x = x0 + (s + b);
      xs[r] = x;
      if (blockIdx.x == 0) xc[r] = x;
    }
  };

  // the head's (self or cross) attention once every block's q dims are in
  // its exch (behind a cluster barrier): gather q (and the fresh k, v)
  // through the cluster, attend this block's keys (staged, or with
  // ``direct`` rows kld apart in device memory), combine the cluster's
  // partials into av
  auto attention = [&](const T* k_s, const T* v_s, int kld, bool direct,
                       int n, bool fresh, float bias_fresh) {
    const int parts_n = fresh ? 3 : 1;
    if (tid < parts_n * dh) {
      const int which = tid / dh, t = tid % dh;
      const float* peer = cluster.map_shared_rank(exch, t / dq);
      const float v = peer[which * dq + t % dq];
      (which == 0 ? qf : which == 1 ? kf : vf)[t] = v;
    }
    __syncthreads();
    float lp = 0.f;
    if (fresh) {
      float s = 0.f;
      for (int t = tid % kWarp; t < dh; t += kWarp) s = fmaf(qf[t], kf[t], s);
      lp = warp_sum(s) * P.scale + bias_fresh;
    }
    if (direct)
      attend_own<true, T>(k_s, v_s, kld, n, qf, keyb, dh, P.scale, sc, pv,
                          part);
    else
      attend_own<false, T>(k_s, v_s, kld, n, qf, keyb, dh, P.scale, sc, pv,
                           part);
    cluster.sync();
    combine<T>(cluster, part, dh, fresh, lp, vf, av);
  };
  // the same for the cluster's hg heads side by side (kGrouped), keys
  // staged [n][hw]; with ``fresh`` head i's fresh-key bias at brow[i bld]
  auto attention_heads = [&](const T* k_s, const T* v_s, int n, bool fresh,
                             const float* brow, int bld) {
    const int parts_n = fresh ? 3 : 1;
    if (tid < parts_n * hw) {
      const int which = tid / hw, t = tid % hw;
      const float* peer = cluster.map_shared_rank(exch, t / gq);
      const float v = peer[which * gq + t % gq];
      (which == 0 ? qf : which == 1 ? kf : vf)[t] = v;
    }
    __syncthreads();
    const int warp = tid / kWarp;
    if (fresh && warp < hg) {  // warp i: head i's fresh logit
      float s = 0.f;
      for (int t = tid % kWarp; t < dh; t += kWarp)
        s = fmaf(qf[warp * dh + t], kf[warp * dh + t], s);
      s = warp_sum(s) * P.scale + brow[(size_t)warp * bld];
      if (tid % kWarp == 0) lpf[warp] = s;
    }
    attend_heads<T>(k_s, v_s, hw, n, hg, qf, keyb, kst, dh, P.scale, sc,
                    pv, part);
    cluster.sync();
    combine_heads<T>(cluster, part, dh, hg, fresh, lpf, vf, av);
  };

  // Gumbel argmax of the logits of step p (every thread gets it); ties go
  // to the lowest index
  auto argmax = [&](int p) -> int {
    const float* gb = P.gumbel + (size_t)(p - P.p0) * P.n_class;
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    auto merge = [&](float ob, int oi) {
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    };
    for (int r = tid; r < P.n_class; r += kThreads)
      merge(__ldcg(P.logits + r) + gb[r], r);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      merge(ob, oi);
    }
    int* red_i = reinterpret_cast<int*>(red + kWarps);
    const int warp = tid / kWarp;
    if (tid % kWarp == 0) {
      red[warp] = best;
      red_i[warp] = best_i;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) merge(red[w], red_i[w]);
    __syncthreads();
    return best_i == 0x7fffffff ? 0 : best_i;
  };
  // the token of index i = p - (c - 1) after step p: the winner where
  // mask[i] (block 0 writes it), else the token as it was
  auto take = [&](int p) -> int {
    const int i = p - (c - 1);
    const int win = argmax(p);
    if (i < 0) return 0;
    if (!P.mask[i]) return P.tokens[i];
    if (blockIdx.x == 0 && tid == 0) P.tokens[i] = win;
    return win;
  };

  int ph = 0;  // phases so far: the residual's double buffer
  prefetch_att(0, P.p0, head0);
  for (int p = P.p0; p < P.steps; ++p) {
    for (int l = 0; l < P.n_layers; ++l) {
      const float* ln = P.ln + (size_t)l * 6 * d;
      const size_t bias_row = ((size_t)l * P.steps_pad + p) * H;
      // ---- ATT
      if (head0 < H) {
        if (l == 0) {
          int tok;
          if (p < c) tok = P.n_class;  // start rows: the all-zeros row
          else if (p > P.p0) tok = take(p - 1);
          else tok = P.tokens[p - c];
          float* xc = P.xbuf + (size_t)(ph & 1) * d;
          for (int r = tid; r < d; r += kThreads) {
            const float x = to_f(emb[(size_t)tok * d + r])
                            + to_f(posfull[(size_t)p * d + r]);
            xs[r] = x;
            if (blockIdx.x == 0) xc[r] = x;
            lnw[r] = ln[r];
            lnw[d + r] = ln[d + r];
          }
        } else {
          rebuild(ph, P.part_mlp, kClusters, b2 + (size_t)(l - 1) * d,
                  nullptr, ln, ln + d);
        }
        int j0, n;
        key_range(p, rank, j0, n);
        // one head of the cluster (kGrouped: its hg heads); ``first``: its
        // slices were staged before the grid barrier and the LayerNorm is
        // still to take
        auto att_head = [&](int head, bool first) {
          if (!first) {
            __syncthreads();  // the last head's slices are consumed
            prefetch_att(l, p, head);
          }
          const float* brow = P.bias_hm + (bias_row + head) * P.l_pad;
          if constexpr (kGrouped) {
            for (int e = tid; e < hg * n; e += kThreads) {
              const int i = e / n, j = e - i * n;
              keyb[i * kst + j] = brow[(size_t)i * P.l_pad + j0 + j];
            }
          } else {
            for (int j = tid; j < n; j += kThreads) keyb[j] = brow[j0 + j];
          }
          const float bias_fresh = brow[p];
          if (tid < 3 * gq) {
            const int s = tid / gq;
            rowb[tid] = to_f(bqkv[(size_t)l * 3 * d + s * d + head * dh
                                  + rank * gq + tid % gq]);
          }
          if (P.aligned && tid < hw) {
            const int e_q = p / c;
            mvs[tid] = e_q < P.e_pad
                           ? to_f(mem_v[((size_t)l * P.e_pad + e_q) * d
                                        + head * dh + tid])
                           : 0.f;
          }
          cp_async_wait_all();
          __syncthreads();
          if (first) layer_norm<T>(xs, lnw, lnw + d, d, vin, red);
          const auto to_exch = [&](int r, float acc) {
            exch[r] = acc + rowb[r];
          };
          if (stage_w1)
            gemv<kWarp>(wqkv_s, d, 3 * gq, d, vin, to_exch);
          else
            gemv_rows<kWarp, T>([&](int r) { return wqkv_row(l, head, r); },
                                3 * dq, d, vin, to_exch);
          __syncthreads();
          // this block's dims of the fresh K/V row p (read from the next
          // step on)
          if (tid >= gq && tid < 3 * gq) {
            const int s = tid / gq - 1;
            kv[((size_t)(2 * l + s) * P.l_pad + p) * d + head * dh
               + rank * gq + tid % gq] = from_f<T>(exch[tid]);
          }
          cluster.sync();
          if constexpr (kGrouped) {
            attention_heads(ks, vs, n, true, brow + p, P.l_pad);
            // head i's partial from its columns of the staged slices; the
            // same lane owns row r in wo's and wo_c's product
            for (int i = 0; i < hg; ++i) {
              float* out = P.part_att + (size_t)(head + i) * d + rank * rows_o;
              gemv<8>(wo_s + i * dh, hw, rows_o, dh, av + i * dh,
                      [&](int r, float acc) {
                        if (P.aligned) fc2p[r] = acc;
                        else out[r] = acc;
                      });
              if (P.aligned)
                gemv<8>(woc_s + i * dh, hw, rows_o, dh, mvs + i * dh,
                        [&](int r, float acc) { out[r] = fc2p[r] + acc; });
            }
            return;
          }
          const T* kc = kv + (size_t)(2 * l) * P.l_pad * d + head * dh;
          if (stage_k1)
            attention(ks, vs, dh, false, n, true, bias_fresh);
          else
            attention(kc + (size_t)j0 * d, kc + (size_t)(P.l_pad + j0) * d,
                      d, true, n, true, bias_fresh);
          float* out = P.part_att + (size_t)head * d + rank * rows_o;
          // aligned: wo's sum waits in fc2p (free until MLP) for wo_c's;
          // the same lane owns row r in both products
          const T* wo_w = stage_w1 ? wo_s : o_slice(wo, l, head);
          const T* woc_w = stage_w1 ? woc_s : o_slice(wo_c, l, head);
          const int ld_o = stage_w1 ? dh : d;
          gemv<8>(wo_w, ld_o, rows_o, dh, av, [&](int r, float acc) {
            if (P.aligned) fc2p[r] = acc;
            else out[r] = acc;
          });
          if (P.aligned) {
            gemv<8>(woc_w, ld_o, rows_o, dh, mvs,
                    [&](int r, float acc) { out[r] = fc2p[r] + acc; });
          }
        };
        // one body either way (the general kernel's loop takes a runtime
        // ``first``: inlined twice, it spilled more and ran slower)
        if (kGeneral)
          for (int head = cid; head < H; head += kClusters)
            att_head(head, head == cid);
        else
          att_head(head0, true);
      }
      if (P.aligned || head0 >= H) prefetch_mlp(l);
      else prefetch_cross(l, head0);
      grid.sync();
      ++ph;

      if (!P.aligned) {
        // ---- CROSS
        if (head0 < H) {
          rebuild(ph, P.part_att, H, bo + (size_t)l * d, nullptr, ln + 2 * d,
                  ln + 3 * d);
          int e0, n;
          key_range(P.e_src, rank, e0, n);
          auto cross_head = [&](int head, bool first) {
            if (!first) {
              __syncthreads();  // the last head's slices are consumed
              prefetch_cross(l, head);
            }
            const float* crow = P.cross_hm + (bias_row + head) * P.e_pad;
            if constexpr (kGrouped) {
              for (int e = tid; e < hg * n; e += kThreads) {
                const int i = e / n, j = e - i * n;
                keyb[i * kst + j] = crow[(size_t)i * P.e_pad + e0 + j];
              }
            } else {
              for (int j = tid; j < n; j += kThreads) keyb[j] = crow[e0 + j];
            }
            if (tid < gq)
              rowb[tid] =
                  to_f(bq_c[(size_t)l * d + head * dh + rank * gq + tid]);
            cp_async_wait_all();
            __syncthreads();
            if (first) layer_norm<T>(xs, lnw, lnw + d, d, vin, red);
            gemv<kWarp>(stage_r3 ? wqc_s
                                 : wq_c + (size_t)l * dd
                                       + (size_t)(head * dh + rank * dq) * d,
                        d, gq, d, vin,
                        [&](int r, float acc) { exch[r] = acc + rowb[r]; });
            cluster.sync();
            if constexpr (kGrouped) {
              attention_heads(mk_s, mv_s, n, false, nullptr, 0);
              for (int i = 0; i < hg; ++i) {
                float* out =
                    P.part_cross + (size_t)(head + i) * d + rank * rows_o;
                gemv<8>(woc2_s + i * dh, hw, rows_o, dh, av + i * dh,
                        [&](int r, float acc) { out[r] = acc; });
              }
              return;
            }
            const size_t at = ((size_t)l * P.e_pad + e0) * d + head * dh;
            if (stage_r3)
              attention(mk_s, mv_s, dh, false, n, false, 0.f);
            else
              attention(mem_k + at, mem_v + at, d, true, n, false, 0.f);
            float* out = P.part_cross + (size_t)head * d + rank * rows_o;
            gemv<8>(stage_r3 ? woc2_s : o_slice(wo_c, l, head),
                    stage_r3 ? dh : d, rows_o, dh, av,
                    [&](int r, float acc) { out[r] = acc; });
          };
          if (kGeneral)
            for (int head = cid; head < H; head += kClusters)
              cross_head(head, head == cid);
          else
            cross_head(head0, true);
          prefetch_mlp(l);
        }
        grid.sync();
        ++ph;
      }

      // ---- MLP
      if (P.aligned)
        rebuild(ph, P.part_att, H, bo + (size_t)l * d, bo_c + (size_t)l * d,
                ln + 4 * d, ln + 5 * d);
      else
        rebuild(ph, P.part_cross, H, bo_c + (size_t)l * d, nullptr,
                ln + 4 * d, ln + 5 * d);
      if (tid < nf) rowb[tid] = to_f(b1[(size_t)l * P.d_ff + f0 + tid]);
      cp_async_wait_all();
      __syncthreads();
      layer_norm<T>(xs, lnw, lnw + d, d, vin, red);
      gemv<kWarp>(stage_r2 ? w1_s : w1 + ((size_t)l * P.d_ff + f0) * d, d,
                  nf, d, vin, [&](int r, float acc) {
                    mid[r] = round_to<T>(fmaxf(acc + rowb[r], 0.f));
                  });
      __syncthreads();
      {
        constexpr int V = Vec<T>::N;
        const T* w2p = w2_staged ? w2_s : w2 + (size_t)l * d * P.d_ff + f0;
        const int ld2 = w2_staged ? g.w2_ld : P.d_ff;
        for (int r = tid; r < d; r += kThreads) {
          float acc = 0.f;
          for (int u = 0; u < nf; u += V) {
            float w[V];
            load_vec_rw(w2p + (size_t)r * ld2 + u, w);
            acc = dot_vec(w, mid + u, V, acc);
          }
          fc2p[r] = acc;
        }
      }
      cluster.sync();
      for (int r = tid; r < rows_o; r += kThreads) {
        const int row = rank * rows_o + r;
        float s = cluster.map_shared_rank(fc2p, 0)[row];
#pragma unroll
        for (int i = 1; i < kCluster; ++i)
          s += cluster.map_shared_rank(fc2p, i)[row];
        P.part_mlp[(size_t)cid * d + row] = s;
      }
      if (l + 1 < P.n_layers) prefetch_att(l + 1, p, head0);
      else prefetch_logits();
      grid.sync();
      ++ph;
    }

    // ---- LOGITS
    rebuild(ph, P.part_mlp, kClusters, b2 + (size_t)(P.n_layers - 1) * d,
            nullptr, P.ln_final, P.ln_final + d);
    if (tid < nl) rowb[tid] = P.b_logits[lr0 + tid];
    cp_async_wait_all();
    __syncthreads();
    layer_norm<T>(xs, lnw, lnw + d, d, vin, red);
    gemv<kWarp>(stage_r2 ? wl_s : w_logits + (size_t)lr0 * d, d, nl, d, vin,
                [&](int r, float acc) {
                  P.logits[lr0 + r] = (acc + rowb[r]) / P.temperature;
                });
    if (p + 1 < P.steps) prefetch_att(0, p + 1, head0);
    grid.sync();
    ++ph;
  }
  if (blockIdx.x == 0) take(P.steps - 1);
}

// What the kernel does not take: a refusal is an error code, never another
// route.
template <typename T>
cudaError_t shape_ok(const ScanParams& P) {
  const int d = P.d, H = P.n_heads;
  if (H < 1 || d % H || P.n_layers < 1 || P.channels < 1)
    return cudaErrorInvalidValue;
  const int dh = d / H;
  if (dh % kCluster || dh > kDhMax || d % kCluster || d % 8 || P.d_ff % kUnit
      || P.n_class < 1)
    return cudaErrorInvalidValue;
  if (P.p0 < 0 || P.steps > P.l_pad || P.steps > P.steps_pad
      || (!P.aligned && P.e_src < 1))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// heads a cluster takes side by side: G = ceil(H / kClusters) above
// kClusters heads, where the group is at most kDhMax wide and every region
// of the grouped layout fits shared memory; else 1
template <typename T>
int side_by_side(const ScanParams& P) {
  const int H = P.n_heads, G = group_heads(P);
  if (H <= kClusters || G * (P.d / H) > kDhMax) return 1;
  return geometry<T, false, true>(P).total <= kSmemBudget ? G : 1;
}

// the kernel of a shape: the grouped one where heads go side by side, the
// general one for more heads than clusters otherwise or a region that does
// not fit
template <typename T>
void (*kernel_for(const ScanParams& P))(const ScanParams) {
  if (side_by_side<T>(P) > 1) return decode_scan_kernel<T, false, true>;
  return P.n_heads > kClusters || !geometry<T>(P).stage_r2
             ? decode_scan_kernel<T, true>
             : decode_scan_kernel<T, false>;
}

// the shared-memory plan of that kernel
template <typename T>
Geometry launch_geometry(const ScanParams& P) {
  return side_by_side<T>(P) > 1 ? geometry<T, false, true>(P)
                                : geometry<T>(P);
}

template <typename T>
cudaError_t configure(const ScanParams& P, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attrs, int* clusters) {
  cudaError_t e = shape_ok<T>(P);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = launch_geometry<T>(P).total;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel_for<T>(P),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kBlocks);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg->attrs = attrs;
  cfg->numAttrs = 1;  // the occupancy query takes the cluster shape alone
  e = cudaOccupancyMaxActiveClusters(clusters, kernel_for<T>(P), cfg);
  if (e != cudaSuccess) return e;
  if (*clusters < kClusters) return cudaErrorCooperativeLaunchTooLarge;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const ScanParams& P, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  int clusters = 0;
  cudaError_t e = configure<T>(P, &cfg, attrs, &clusters);
  if (e != cudaSuccess) return e;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, kernel_for<T>(P), P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// info[0..11] = grid blocks, cluster size, threads a block, dynamic
// shared-memory bytes, registers a thread, local (spilled) bytes a thread,
// grid barriers a step, clusters of 8 that can co-reside, heads a cluster
// at most, the regions staged in shared memory (bits: 1 R1's weights, 2
// R1's keys, 4 R2, 8 R3), 1 when the general kernel runs, the heads a
// cluster takes side by side
template <typename T>
cudaError_t info(const ScanParams& P, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  int clusters = 0;
  cudaError_t e = configure<T>(P, &cfg, attrs, &clusters);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel_for<T>(P));
  if (e != cudaSuccess) return e;
  out[0] = kBlocks;
  out[1] = kCluster;
  out[2] = kThreads;
  out[3] = static_cast<int>(cfg.dynamicSmemBytes);
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  out[6] = (P.aligned ? 2 : 3) * P.n_layers + 1;
  out[7] = clusters;
  out[8] = cdiv(P.n_heads, kClusters);
  const Geometry g = launch_geometry<T>(P);
  out[9] = g.stage_w1 | g.stage_k1 << 1 | g.stage_r2 << 2
           | (!P.aligned && g.stage_r3) << 3;
  out[10] = kernel_for<T>(P) == decode_scan_kernel<T, true>;
  out[11] = side_by_side<T>(P);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_decode_scan(const ScanParams* P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? launch<__nv_bfloat16>(*P, s)
                                     : launch<float>(*P, s));
}

extern "C" int isi_decode_scan_info(const ScanParams* P, int dtype,
                                    int* out) {
  return static_cast<int>(dtype == 1 ? info<__nv_bfloat16>(*P, out)
                                     : info<float>(*P, out));
}

// the heads a cluster of the launch takes side by side (1 for a shape the
// kernel refuses)
extern "C" int isi_decode_scan_heads(const ScanParams* P, int dtype) {
  if (dtype == 1)
    return shape_ok<__nv_bfloat16>(*P) == cudaSuccess
               ? side_by_side<__nv_bfloat16>(*P) : 1;
  return shape_ok<float>(*P) == cudaSuccess ? side_by_side<float>(*P) : 1;
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
