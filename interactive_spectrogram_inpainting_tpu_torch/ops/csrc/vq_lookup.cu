// Nearest-codebook lookup of the VQ bottleneck with its EMA statistics.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/vq_lookup.py
//           ::fused_vq_lookup (Pallas kernel _vq_kernel).
//
//   ids[n]        = argmin_k (|e_k|^2 - 2 x_n . e_k)     (lowest k on a tie)
//   quantize[n]   = e[:, ids[n]]                          (a copy of the code)
//   counts[k]     = #{n : ids[n] = k}
//   embed_sum[:,k] = sum_{n : ids[n] = k} x_n             (ascending n)
//
// Bound on the H100: operations. The one product the function needs, 2 N
// dim K flops, runs on the tensor cores as split TF32 (three m16n8k8
// passes, lo*hi + hi*lo + hi*hi, as mma.cuh's Mma<float>): about 21 bits
// of each operand, so float32's near ties stay where they are (one TF32 or
// bf16 pass would move them). Two launches a call:
//
//   assign (normal launch) one block of 8 warps per tile of 16 * RW rows
//          (RW = 8 when N fills the card, fewer below so that small N still
//          spreads over the SMs; the 8 / RW warps of a row tile split the
//          codes). A warp's 16 rows are split into hi / lo once, as A
//          fragments in registers (dim <= 64; wider rows, up to 1024, 64
//          dims at a time, vq_assign_wide_kernel). The codebook passes
//          through shared memory in its own [dim, K] layout, a chunk of
//          codes at a time by cp.async (the next chunk lands while this one
//          is multiplied); one pass over a chunk forms |e_k|^2 (four
//          interleaved partial sums, added in a fixed order: the same
//          arithmetic for every code) and the (hi, lo) pairs of each
//          element, read by 64-bit loads. Each k-step of 8 dimensions runs
//          its three passes into a fresh accumulator (the tensor cores
//          truncate into theirs) that is added in float32. A lane keeps its
//          rows' best (score, code) over ascending codes; quads and warps
//          merge (score, code) pairs, so the lowest code wins a tie. Writes
//          ids.
//   stats  (cooperative launch, grid barriers between phases) a stable
//          counting sort of the rows by code, then fixed-order sums:
//            P0  the codebook transposed into scratch (a code one row);
//            P1  each block counts one tile of 1024 positions by digit: each
//                warp 128 of them (a group of lanes with one digit found by
//                one ballot a bit, warp-private counters in shared memory,
//                integers only), the warps' counts added;
//            P2  per digit, the tiles' exclusive prefix (a warp scan) and
//                the total;
//            P3  every block scans the totals; each block ranks its tile
//                again and scatters the row indices to base[digit] +
//                prefix[tile][digit] + the earlier warps' count + the rank;
//                then quantize, each row its code's transposed row. K <=
//                2048 sorts in one pass with the code as the digit; larger
//                K by 11-bit digits, least significant first (each pass
//                stable);
//            P4  each warp sums one piece of 64 sorted positions run by run
//                (a run: one code's rows inside the piece, ascending rows),
//                the rows brought into shared memory by cp.async; a run that
//                starts a code goes to first[k], one that continues a code
//                from the piece before to head[piece];
//            P5  embed_sum[:, k] = first[k] + head[...] in piece order,
//                counts[k] = the code's run length.
//          No float atomics: the same bits on every run, and no warp sums
//          more than 64 rows however skewed the codes are (an untrained
//          encoder sends every row to one code). Work O(N dim + K dim).
//          Loops that one warp runs alone stay rolled and bring their
//          operands in batches: such a warp pays an instruction fetch for
//          unrolled straight-line code and a memory round trip for each
//          dependent load.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace cg = cooperative_groups;
using namespace isi;

struct VqLookupParams {
  const float* flat;   // [N, dim]
  const float* embed;  // [dim, K]
  int* ids;            // [N]
  float* quantize;     // [N, dim]
  float* counts;       // [K]
  float* embed_sum;    // [dim, K]
  int* work;           // scratch of isi_vq_workspace_ints(N, dim, K) ints
  int n, dim, n_embed;
};

namespace {

constexpr int kThreads = 256;  // both kernels
constexpr int kWarps = kThreads / kWarp;
constexpr int kGroup = 32;     // codes a warp multiplies per A fragment
constexpr int kMaxDim = 1024;
constexpr int kMidDim = 256;   // widest rows of the middle stats kernel
constexpr int kTile = 1024;    // sort positions one block ranks (P1, P3)
constexpr int kPiece = 64;     // sorted positions one warp sums (P4)
constexpr int kDigitBits = 11;
constexpr int kScratch = 2 * kTile;  // words of a warp's scratch (P4)
constexpr int kSub = kTile / kWarps;  // positions of a tile a warp ranks
// loads a thread keeps in flight where a loop stores what it loads (the
// compiler cannot move a load above a store that may alias it)
constexpr int kFlight = 16;
constexpr int kMaxBins = 1 << kDigitBits;
constexpr size_t kAssignSmemCap = 216 * 1024;

__host__ __device__ inline int cdiv(long a, long b) {
  return static_cast<int>((a + b - 1) / b);
}

// -- assign ------------------------------------------------------------------

constexpr int kRegSteps = 8;  // k-steps whose A fragments stay in registers

struct AssignGeom {
  int rw;      // row warps (16 rows each); kWarps / rw warps split the codes
  int chunk;   // codes staged per pass, a multiple of kGroup
  int dp;      // dim rounded up to the k-step (8)
  bool wide;   // dp > 8 kRegSteps: vq_assign_wide_kernel
  int grid;
  size_t smem;
};

AssignGeom assign_geom(int n, int dim, int sms) {
  AssignGeom g;
  g.dp = (dim + 7) / 8 * 8;
  g.wide = g.dp > 8 * kRegSteps;
  g.rw = kWarps;
  while (g.rw > 1 && cdiv(n, 16 * g.rw) < sms) g.rw /= 2;
  if (g.wide) {
    // one group of codes a warp: the chunk is kGroup x the code warps
    g.chunk = kGroup * (kWarps / g.rw);
    g.grid = cdiv(n, 16 * g.rw);
    g.smem = (size_t)8 * kRegSteps * (g.chunk + 8) * 4
             + (size_t)8 * kRegSteps * (g.chunk + 4) * 8
             + sizeof(float) * 5 * g.chunk
             + sizeof(float) * kWarps * 16 + sizeof(int) * kWarps * 16;
    return g;
  }
  g.chunk = 128 > kGroup * (kWarps / g.rw) ? 128 : kGroup * (kWarps / g.rw);
  // the staged chunk and its (hi, lo) pairs
  const auto stage = [&](int c) {
    return (size_t)g.dp * (c + 8) * 4 + (size_t)g.dp * (c + 4) * 8;
  };
  while (g.chunk > kGroup && stage(g.chunk) > kAssignSmemCap)
    g.chunk /= 2;
  g.grid = cdiv(n, 16 * g.rw);
  g.smem = stage(g.chunk) + sizeof(float) * g.chunk
           + sizeof(float) * kWarps * 16 + sizeof(int) * kWarps * 16;
  return g;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst[d * ld + c] = embed[d * K + c0 + c] for d < dp, c < chunk, zero
// outside [0, dim) x [0, K): 16-byte pieces when K % 4 == 0 (every piece
// then lies wholly inside or outside the codebook), else 4-byte ones
__device__ void stage_chunk(float* dst, const float* embed, int dim, int dp,
                            int K, int c0, int chunk, int ld) {
  if (K % 4 == 0) {
    const int per = chunk / 4;
    for (int i = threadIdx.x; i < dp * per; i += kThreads) {
      const int d = i / per, c = (i % per) * 4;
      const bool in = d < dim && c0 + c < K;
      const float* src = in ? embed + (size_t)d * K + c0 + c : embed;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + d * ld + c)),
                   "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < dp * chunk; i += kThreads) {
      const int d = i / chunk, c = i % chunk;
      const bool in = d < dim && c0 + c < K;
      const float* src = in ? embed + (size_t)d * K + c0 + c : embed;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(dst + d * ld + c)),
                   "l"(src), "r"(in ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// d = a b + 0: the first pass into a fresh accumulator, no zeroing moves
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ bool better(float s, int k, float b, int bk) {
  return s < b || (s == b && k < bk);
}

// dim <= 64, the models' width: the warp's 16 rows as A fragments in
// registers for every k-step
__global__ void __launch_bounds__(kThreads)
    vq_assign_kernel(VqLookupParams P, int rw, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int dim = P.dim, K = P.n_embed, n = P.n;
  const int dp = (dim + 7) / 8 * 8, ld = chunk + 8;
  const int ld2 = chunk + 4;  // (hi, lo) pairs a row: 64-bit loads and
                              // stores without bank conflicts
  const int cw = kWarps / rw, rows = 16 * rw;
  float* raw = smem;                                         // [dp][ld]
  float2* bhl = reinterpret_cast<float2*>(raw + dp * ld);     // [dp][ld2]
  float* sq = reinterpret_cast<float*>(bhl + dp * ld2);       // [chunk]
  float* red_s = sq + chunk;                      // [cw][rows]
  int* red_k = reinterpret_cast<int*>(red_s + kWarps * 16);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * rows;
  const int rwi = warp % rw, cwi = warp / rw;
  const int n_chunks = cdiv(K, chunk);
  const int ksteps = dp / 8;

  stage_chunk(raw, P.embed, dim, dp, K, 0, chunk, ld);
  Mma<float>::A areg[kRegSteps];
  {
    const int r_lo = row0 + 16 * rwi + g, r_hi = r_lo + 8;
    const auto x = [&](int r, int d) {
      return r < n && d < dim ? __ldg(P.flat + (size_t)r * dim + d) : 0.f;
    };
#pragma unroll
    for (int ks = 0; ks < kRegSteps; ++ks) {
      const int d = 8 * ks + t;
      areg[ks] = Mma<float>::make_a(x(r_lo, d), x(r_hi, d), x(r_lo, d + 4),
                                    x(r_hi, d + 4));
    }
  }

  float best[2] = {INFINITY, INFINITY};
  int best_k[2] = {0, 0};
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * chunk;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk ci landed; the last chunk's products are done
    // |e_c|^2: lane q of a quad sums dims q, q + 4, ... in order, then
    // (s0 + s1) + (s2 + s3): the same for every code whatever the chunk.
    // The same pass splits each element into its TF32 hi and lo parts, once
    // per block.
    for (int task = tid; task < 4 * chunk; task += kThreads) {
      const int c = task >> 2, q = task & 3;
      float s = 0.f;
      for (int d = q; d < dp; d += 4) {
        const float v = raw[d * ld + c];
        s = fmaf(v, v, s);
        uint32_t hi, lo;
        Mma<float>::split(v, hi, lo);
        bhl[d * ld2 + c] =
            make_float2(__uint_as_float(hi), __uint_as_float(lo));
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) sq[c] = s;
    }
    __syncthreads();
    // the next chunk lands while this one is multiplied
    if (ci + 1 < n_chunks)
      stage_chunk(raw, P.embed, dim, dp, K, c0 + chunk, chunk, ld);
    for (int gi = cwi; gi < chunk / kGroup; gi += cw) {
      const int cb = gi * kGroup;
      if (c0 + cb >= K) break;
      float acc[kGroup / 8][4];
#pragma unroll
      for (int nt = 0; nt < kGroup / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      // one k-step: three passes a code tile into a fresh accumulator
      // (the tensor cores truncate into theirs), added in float32
      const auto kstep = [&](const Mma<float>::A& a, int k0) {
#pragma unroll
        for (int nt = 0; nt < kGroup / 8; ++nt) {
          const int ib = (k0 + t) * ld2 + cb + nt * 8 + g;
          const float2 e0 = bhl[ib], e1 = bhl[ib + 4 * ld2];
          const uint32_t b_hi[2] = {__float_as_uint(e0.x),
                                    __float_as_uint(e1.x)};
          const uint32_t b_lo[2] = {__float_as_uint(e0.y),
                                    __float_as_uint(e1.y)};
          float c[4];
          mma_tf32_zero(c, a.lo, b_hi);  // lo*hi + hi*lo + hi*hi, as
          mma_tf32(c, a.hi, b_lo);       // Mma<float>::run
          mma_tf32(c, a.hi, b_hi);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] += c[i];
        }
      };
#pragma unroll
      for (int ks = 0; ks < kRegSteps; ++ks)
        if (ks < ksteps) kstep(areg[ks], 8 * ks);
      // lane (g, t) holds rows g, g + 8 and codes 2t, 2t + 1 of each
      // 8-code tile: ascending within the lane, so the first best stays
#pragma unroll
      for (int nt = 0; nt < kGroup / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cc = cb + nt * 8 + 2 * t + j;
          if (c0 + cc < K) {
            const float e2 = sq[cc];
            const float s0 = e2 - 2.0f * acc[nt][j];
            const float s1 = e2 - 2.0f * acc[nt][2 + j];
            if (s0 < best[0]) {
              best[0] = s0;
              best_k[0] = c0 + cc;
            }
            if (s1 < best[1]) {
              best[1] = s1;
              best_k[1] = c0 + cc;
            }
          }
        }
    }
  }

  // the quad's four lanes, then the warps of the row tile, as pairs
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int k = __shfl_xor_sync(0xffffffffu, best_k[i], o);
      if (better(s, k, best[i], best_k[i])) {
        best[i] = s;
        best_k[i] = k;
      }
    }
  if (t == 0) {
    red_s[cwi * rows + 16 * rwi + g] = best[0];
    red_k[cwi * rows + 16 * rwi + g] = best_k[0];
    red_s[cwi * rows + 16 * rwi + g + 8] = best[1];
    red_k[cwi * rows + 16 * rwi + g + 8] = best_k[1];
  }
  __syncthreads();
  if (tid < rows && row0 + tid < n) {
    float b = red_s[tid];
    int bk = red_k[tid];
    for (int w = 1; w < cw; ++w) {
      const float s = red_s[w * rows + tid];
      const int k = red_k[w * rows + tid];
      if (better(s, k, b, bk)) {
        b = s;
        bk = k;
      }
    }
    P.ids[row0 + tid] = bk;
  }
}

// Rows wider than 64 (up to kMaxDim): the same scores, the dimensions
// taken kWideDims at a time. Each warp of a row tile owns one group of
// kGroup codes of a chunk (chunk = kGroup x the warps that split the
// codes), so its accumulators stay in registers across the dimension
// chunks; a dimension chunk stages its rows of the codebook chunk by
// cp.async, splits them into (hi, lo) pairs, continues each code's four
// |e|^2 partial sums (kept in shared memory), and runs its k-steps with the
// warp's 16 rows as A fragments in registers. The k-steps and the |e|^2
// sums run in the order of the single-tile kernel: the same bits.
constexpr int kWideDims = 8 * kRegSteps;

__global__ void __launch_bounds__(kThreads)
    vq_assign_wide_kernel(VqLookupParams P, int rw, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int dim = P.dim, K = P.n_embed, n = P.n;
  const int dp = (dim + 7) / 8 * 8, ld = chunk + 8, ld2 = chunk + 4;
  const int cw = kWarps / rw, rows = 16 * rw;
  float* raw = smem;                                             // [64][ld]
  float2* bhl = reinterpret_cast<float2*>(raw + kWideDims * ld);  // [64][ld2]
  float* sq4 = reinterpret_cast<float*>(bhl + kWideDims * ld2);  // [4 chunk]
  float* sq = sq4 + 4 * chunk;                                   // [chunk]
  float* red_s = sq + chunk;                                     // [cw][rows]
  int* red_k = reinterpret_cast<int*>(red_s + kWarps * 16);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * rows;
  const int rwi = warp % rw, cwi = warp / rw;
  const int cb = cwi * kGroup;  // the warp's codes in a chunk
  const int r_lo = row0 + 16 * rwi + g, r_hi = r_lo + 8;
  const auto x = [&](int r, int d) {
    return r < n && d < dim ? __ldg(P.flat + (size_t)r * dim + d) : 0.f;
  };

  float best[2] = {INFINITY, INFINITY};
  int best_k[2] = {0, 0};
  for (int c0 = 0; c0 < K; c0 += chunk) {
    float acc[kGroup / 8][4];
#pragma unroll
    for (int nt = 0; nt < kGroup / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    for (int d0 = 0; d0 < dp; d0 += kWideDims) {
      const int dc = min(kWideDims, dp - d0);
      __syncthreads();  // the last chunk's pairs are consumed
      stage_chunk(raw, P.embed + (size_t)d0 * K, dim - d0, dc, K, c0, chunk,
                  ld);
      Mma<float>::A areg[kRegSteps];
#pragma unroll
      for (int ks = 0; ks < kRegSteps; ++ks) {
        const int d = d0 + 8 * ks + t;
        areg[ks] = Mma<float>::make_a(x(r_lo, d), x(r_hi, d), x(r_lo, d + 4),
                                      x(r_hi, d + 4));
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      // each code's four interleaved |e|^2 sums go on over these dims
      // (lane q of a quad: dims q, q + 4, ...); the (hi, lo) pairs
      for (int task = tid; task < 4 * chunk; task += kThreads) {
        const int c = task >> 2, q = task & 3;
        float s = d0 == 0 ? 0.f : sq4[task];
        for (int d = q; d < dc; d += 4) {
          const float v = raw[d * ld + c];
          s = fmaf(v, v, s);
          uint32_t hi, lo;
          Mma<float>::split(v, hi, lo);
          bhl[d * ld2 + c] =
              make_float2(__uint_as_float(hi), __uint_as_float(lo));
        }
        sq4[task] = s;
      }
      __syncthreads();
      if (c0 + cb < K) {
#pragma unroll
        for (int ks = 0; ks < kRegSteps; ++ks) {
          if (8 * ks >= dc) break;
#pragma unroll
          for (int nt = 0; nt < kGroup / 8; ++nt) {
            const int ib = (8 * ks + t) * ld2 + cb + nt * 8 + g;
            const float2 e0 = bhl[ib], e1 = bhl[ib + 4 * ld2];
            const uint32_t b_hi[2] = {__float_as_uint(e0.x),
                                      __float_as_uint(e1.x)};
            const uint32_t b_lo[2] = {__float_as_uint(e0.y),
                                      __float_as_uint(e1.y)};
            float c[4];
            mma_tf32_zero(c, areg[ks].lo, b_hi);  // lo*hi + hi*lo + hi*hi
            mma_tf32(c, areg[ks].hi, b_lo);
            mma_tf32(c, areg[ks].hi, b_hi);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[nt][i] += c[i];
          }
        }
      }
    }
    // |e_c|^2 = (s0 + s1) + (s2 + s3), as the single-tile kernel adds them
    for (int c = tid; c < chunk; c += kThreads)
      sq[c] = (sq4[4 * c] + sq4[4 * c + 1]) + (sq4[4 * c + 2] + sq4[4 * c + 3]);
    __syncthreads();
    if (c0 + cb < K) {
#pragma unroll
      for (int nt = 0; nt < kGroup / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cc = cb + nt * 8 + 2 * t + j;
          if (c0 + cc < K) {
            const float e2 = sq[cc];
            const float s0 = e2 - 2.0f * acc[nt][j];
            const float s1 = e2 - 2.0f * acc[nt][2 + j];
            if (s0 < best[0]) {
              best[0] = s0;
              best_k[0] = c0 + cc;
            }
            if (s1 < best[1]) {
              best[1] = s1;
              best_k[1] = c0 + cc;
            }
          }
        }
    }
  }

  // the quad's four lanes, then the warps of the row tile, as pairs
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int k = __shfl_xor_sync(0xffffffffu, best_k[i], o);
      if (better(s, k, best[i], best_k[i])) {
        best[i] = s;
        best_k[i] = k;
      }
    }
  if (t == 0) {
    red_s[cwi * rows + 16 * rwi + g] = best[0];
    red_k[cwi * rows + 16 * rwi + g] = best_k[0];
    red_s[cwi * rows + 16 * rwi + g + 8] = best[1];
    red_k[cwi * rows + 16 * rwi + g + 8] = best_k[1];
  }
  __syncthreads();
  if (tid < rows && row0 + tid < n) {
    float b = red_s[tid];
    int bk = red_k[tid];
    for (int w = 1; w < cw; ++w) {
      const float s = red_s[w * rows + tid];
      const int k = red_k[w * rows + tid];
      if (better(s, k, b, bk)) {
        b = s;
        bk = k;
      }
    }
    P.ids[row0 + tid] = bk;
  }
}

// -- stats -------------------------------------------------------------------

// where the warps' scratch starts in the stats kernel's shared memory (in
// ints, after scan, the warps' counters and tmp; 16-byte aligned)
__host__ __device__ inline int scratch_at(int bins) {
  return ((kWarps + 1) * bins + kWarp + 3) / 4 * 4;
}

struct StatsGeom {
  int passes, bins, bits, tiles, pieces, grid;
  size_t smem;
  // offsets into the int workspace
  long hist, total, perm_a, key_a, perm_b, key_b, start, end, first, head,
      et, ints;
  int kj;  // dims a lane sums in P4 (the kernel's template argument)
};

StatsGeom stats_geom(int n, int dim, int K) {
  StatsGeom g;
  int bits = 0;
  while ((1L << bits) < K) ++bits;
  g.passes = K <= kMaxBins ? 1 : cdiv(bits, kDigitBits);
  g.bins = K <= kMaxBins ? K : kMaxBins;
  g.bits = g.passes == 1 ? bits : kDigitBits;  // bits of a digit
  g.tiles = cdiv(n, kTile);
  g.pieces = cdiv(n, kPiece);
  g.smem = sizeof(int) * (scratch_at(g.bins) + (size_t)kWarps * kScratch);
  static_assert(kWarps * kScratch >= 3 * kTile, "a tile's keys, rows, ranks");
  long o = 0;
  const auto take = [&](long count) {  // 16-byte aligned
    const long at = o;
    o += (count + 3) / 4 * 4;
    return at;
  };
  g.hist = take((long)g.tiles * g.bins);
  g.total = take(g.bins);
  g.perm_a = take(n);
  g.key_a = take(n);
  g.perm_b = take(g.passes > 1 ? n : 0);
  g.key_b = take(g.passes > 1 ? n : 0);
  g.start = take(K);
  g.end = take(K);
  g.first = take((long)K * dim);
  g.head = take((long)g.pieces * dim);
  g.et = take((long)K * dim);
  g.ints = o;
  g.kj = dim <= 2 * kWarp ? 2 : dim <= kMidDim ? kMidDim / kWarp
                                                 : kMaxDim / kWarp;
  g.grid = 0;
  return g;
}

// exclusive scan of total[0, bins) into scan[] (shared), by the block
__device__ void block_exclusive_scan(const int* total, int* scan, int bins,
                                     int* tmp) {
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int per = (bins + kThreads - 1) / kThreads;
  const int b0 = min(bins, tid * per), b1 = min(bins, b0 + per);
  int s = 0;
  for (int v = b0; v < b1; ++v) s += total[v];
  int incl = s;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == kWarp - 1) tmp[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += tmp[w];
  int run = before + incl - s;
  for (int v = b0; v < b1; ++v) {
    scan[v] = run;
    run += total[v];
  }
  __syncthreads();
}

// the lanes whose digit (>= 0) equals this lane's: one ballot a bit
__device__ __forceinline__ unsigned same_digit(int digit, int bits) {
  unsigned peers = __ballot_sync(0xffffffffu, digit >= 0);
  for (int b = 0; b < bits; ++b) {
    const bool on = (digit >> b) & 1;
    const unsigned x = __ballot_sync(0xffffffffu, on);
    peers &= on ? x : ~x;
  }
  return peers;
}

// KJ: dims a lane sums in P4 (dim <= 32 KJ). kWarps * kScratch words of
// shared memory hold the block's tile (keys, rows, ranks) in P1 / P3 and
// each warp's batch of sorted rows in P4, so the loops over them are short
// and stay rolled: a phase that few warps run pays no instruction fetch
// for unrolled straight-line code and no memory round trip a step.
template <int KJ>
__global__ void __launch_bounds__(kThreads)
    vq_stats_kernel(VqLookupParams P, StatsGeom G) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) int ssm[];
  const int n = P.n, dim = P.dim, K = P.n_embed, bins = G.bins;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  int* scan = ssm;                            // [bins]
  int* cnt = ssm + bins + warp * bins;        // this warp's [bins]
  int* tmp = ssm + (kWarps + 1) * bins;       // [32]
  int* tile_buf = ssm + scratch_at(bins);  // the block's tile: keys, rows,
                                           // ranks (P1, P3)
  int* wbuf = tile_buf + warp * kScratch;  // this warp's rows (P4)
  // warps number across the blocks first: a phase with fewer work items
  // than warps (tiles, pieces, digits) spreads them over the SMs
  const int gw = warp * gridDim.x + blockIdx.x, n_gw = gridDim.x * kWarps;
  const int gt = blockIdx.x * kThreads + tid, n_gt = gridDim.x * kThreads;
  const unsigned below = (1u << lane) - 1u;
  int* W = P.work;
  int* hist = W + G.hist;
  int* total = W + G.total;
  int* start = W + G.start;
  int* end = W + G.end;
  float* first = reinterpret_cast<float*>(W + G.first);
  float* head = reinterpret_cast<float*>(W + G.head);
  float* et = reinterpret_cast<float*>(W + G.et);

  // P0: every code empty until P4 says otherwise; the codebook transposed
  // (a code one contiguous row, for quantize)
  for (int k = gt; k < K; k += n_gt) start[k] = end[k] = 0;
  for (long i0 = gt; i0 < (long)K * dim; i0 += (long)kFlight * n_gt) {
    float x[kFlight];  // the loads in flight together, then the stores
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      const long i = i0 + (long)u * n_gt;
      x[u] = i < (long)K * dim ? __ldg(P.embed + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      const long i = i0 + (long)u * n_gt;
      if (i < (long)K * dim) et[(i % K) * dim + i / K] = x[u];
    }
  }

  const int* src_perm = nullptr;  // pass 0 reads the rows in their order
  const int* src_key = P.ids;
  // the tile's keys (and rows) into the block's scratch, -1 past the end
  const auto load_tile = [&](int b0, int e, bool rows) {
    for (int i0 = tid; i0 < kTile; i0 += kFlight * kThreads) {
      int key[kFlight], row[kFlight];
#pragma unroll
      for (int u = 0; u < kFlight; ++u) {
        const int i = b0 + i0 + u * kThreads;
        key[u] = i0 + u * kThreads < kTile && i < e ? __ldcg(src_key + i)
                                                    : -1;
        row[u] = rows && src_perm != nullptr && i < e ? __ldcg(src_perm + i)
                                                      : i;
      }
#pragma unroll
      for (int u = 0; u < kFlight; ++u)
        if (i0 + u * kThreads < kTile) {
          tile_buf[i0 + u * kThreads] = key[u];
          if (rows) tile_buf[kTile + i0 + u * kThreads] = row[u];
        }
    }
    __syncthreads();
  };
  // each warp ranks its kSub positions of the tile in order: rank[i] =
  // the earlier positions of the warp with the same digit; cnt = the
  // warp's count of each digit
  const auto rank_sub = [&](int shift, int mask, int valid, int* rank) {
    for (int v = lane; v < bins; v += kWarp) cnt[v] = 0;
    __syncwarp();
#pragma unroll 1
    for (int o = warp * kSub; o < min(valid, (warp + 1) * kSub); o += kWarp) {
      const int key = tile_buf[o + lane];
      const int digit = key >= 0 ? (key >> shift) & mask : -1;
      const unsigned peers = same_digit(digit, G.bits);
      if (digit >= 0 && rank != nullptr)
        rank[o + lane] = cnt[digit] + __popc(peers & below);
      __syncwarp();
      if (digit >= 0 && lane == __ffs(peers) - 1)
        cnt[digit] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
  };
  for (int pass = 0; pass < G.passes; ++pass) {
    const int shift = kDigitBits * pass;
    const int mask = G.passes == 1 ? 0x7fffffff : kMaxBins - 1;
    int* dst_perm = W + ((pass & 1) ? G.perm_b : G.perm_a);
    int* dst_key = W + ((pass & 1) ? G.key_b : G.key_a);
    // P1: each tile's count of every digit (a block a tile, the warps'
    // counts added in order)
    for (int tl = blockIdx.x; tl < G.tiles; tl += gridDim.x) {
      const int b0 = tl * kTile, e = min(n, b0 + kTile);
      load_tile(b0, e, false);
      rank_sub(shift, mask, e - b0, nullptr);
      for (int v = tid; v < bins; v += kThreads) {
        int c = 0;
        for (int w = 0; w < kWarps; ++w) c += ssm[bins + w * bins + v];
        hist[(size_t)tl * bins + v] = c;
      }
      __syncthreads();
    }
    grid.sync();
    // P2: one warp per digit: the tiles' exclusive prefix (in place) by
    // warp scans, and the total
    for (int v = gw; v < bins; v += n_gw) {
      int carry = 0;
      for (int t0 = 0; t0 < G.tiles; t0 += kWarp) {
        const int tl = t0 + lane;
        const int c = tl < G.tiles ? __ldcg(hist + (size_t)tl * bins + v) : 0;
        int incl = c;
#pragma unroll
        for (int o = 1; o < kWarp; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += u;
        }
        if (tl < G.tiles) hist[(size_t)tl * bins + v] = carry + incl - c;
        carry += __shfl_sync(0xffffffffu, incl, kWarp - 1);
      }
      if (lane == 0) total[v] = carry;
    }
    grid.sync();
    // P3: stable scatter to base[digit] + prefix[tile][digit] + the earlier
    // warps' count + the rank in the warp: the ranks first (shared memory
    // only), then the stores. In the first pass the threads then write
    // quantize, each row its code's row of the transposed codebook.
    block_exclusive_scan(total, scan, bins, tmp);
    for (int tl = blockIdx.x; tl < G.tiles; tl += gridDim.x) {
      const int b0 = tl * kTile, e = min(n, b0 + kTile);
      int* rank = tile_buf + 2 * kTile;
      load_tile(b0, e, true);
      rank_sub(shift, mask, e - b0, rank);
      for (int v = tid; v < bins; v += kThreads) {  // the warps' offsets
        int run = scan[v] + __ldcg(hist + (size_t)tl * bins + v);
        for (int w = 0; w < kWarps; ++w) {
          const int c = ssm[bins + w * bins + v];
          ssm[bins + w * bins + v] = run;
          run += c;
        }
      }
      __syncthreads();
      for (int i = tid; i < e - b0; i += kThreads) {
        const int key = tile_buf[i];
        const int at =
            ssm[bins + (i / kSub) * bins + ((key >> shift) & mask)] + rank[i];
        dst_perm[at] = tile_buf[kTile + i];
        dst_key[at] = key;
      }
      __syncthreads();
    }
    if (pass == 0) {
      const bool vec4 = dim % 4 == 0
                        && reinterpret_cast<size_t>(P.quantize) % 16 == 0;
      const int w = vec4 ? 4 : 1;  // floats a copy
      const long count = (long)n * dim / w;
      for (long i0 = gt; i0 < count; i0 += (long)kFlight * n_gt) {
        float4 x[kFlight];
#pragma unroll
        for (int u = 0; u < kFlight; ++u) {
          const long i = i0 + (long)u * n_gt;
          if (i < count) {
            const long f = i * w;
            const float* src =
                et + (size_t)__ldg(P.ids + f / dim) * dim + f % dim;
            if (vec4)
              x[u] = __ldcg(reinterpret_cast<const float4*>(src));
            else
              x[u].x = __ldcg(src);
          }
        }
#pragma unroll
        for (int u = 0; u < kFlight; ++u) {
          const long i = i0 + (long)u * n_gt;
          if (i < count) {
            if (vec4)
              reinterpret_cast<float4*>(P.quantize)[i] = x[u];
            else
              P.quantize[i] = x[u].x;
          }
        }
      }
    }
    grid.sync();
    src_perm = dst_perm;
    src_key = dst_key;
  }

  // P4: runs of one code inside each piece of kPiece sorted positions; a
  // batch of rows at a time lands in the warp's scratch by cp.async
  float* rbuf = reinterpret_cast<float*>(wbuf);
  const int batch = min(kWarp, kScratch / dim);  // rows a batch
  const bool vec =
      dim % 4 == 0 && reinterpret_cast<size_t>(P.flat) % 16 == 0;
  const int per = vec ? dim / 4 : dim;            // pieces a row
  for (int pc = gw; pc < G.pieces; pc += n_gw) {
    const int p0 = pc * kPiece, p1 = min(n, p0 + kPiece);
    float acc[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[j] = 0.f;
    int code = __ldcg(src_key + p0);
    bool cont = p0 > 0 && __ldcg(src_key + p0 - 1) == code;
    int from = p0;
    for (int sub = p0; sub < p1; sub += batch) {
      const int m = min(batch, p1 - sub);
      const int my_key = lane < m ? __ldcg(src_key + sub + lane) : 0;
      const int my_row = lane < m ? __ldcg(src_perm + sub + lane) : 0;
      for (int b = 0; b < m * per; b += kWarp) {
        const int e = b + lane;
        const int u = min(e / per, m - 1), c = e % per;
        const int row = __shfl_sync(0xffffffffu, my_row, u);
        if (e < m * per) {
          if (vec)
            asm volatile(
                "cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                    smem_addr(rbuf + u * dim + 4 * c)),
                "l"(P.flat + (size_t)row * dim + 4 * c)
                : "memory");
          else
            asm volatile(
                "cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                    smem_addr(rbuf + u * dim + c)),
                "l"(P.flat + (size_t)row * dim + c)
                : "memory");
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
#pragma unroll 1
      for (int u = 0; u < m; ++u) {
        const int k = __shfl_sync(0xffffffffu, my_key, u);
        if (k != code) {  // warp-uniform: one code per position
          float* dst =
              cont ? head + (size_t)pc * dim : first + (size_t)code * dim;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int d = lane + kWarp * j;
            if (d < dim) dst[d] = acc[j];
            acc[j] = 0.f;
          }
          if (lane == 0) {
            if (!cont) start[code] = from;
            end[code] = sub + u;
          }
          code = k;
          cont = false;
          from = sub + u;
        }
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int d = lane + kWarp * j;
          if (d < dim) acc[j] += rbuf[u * dim + d];
        }
      }
      __syncwarp();  // the batch is consumed
    }
    float* dst = cont ? head + (size_t)pc * dim : first + (size_t)code * dim;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int d = lane + kWarp * j;
      if (d < dim) dst[d] = acc[j];
    }
    if (lane == 0) {
      if (!cont) start[code] = from;
      if (p1 == n || __ldcg(src_key + p1) != code) end[code] = p1;
    }
  }
  grid.sync();

  // P5: each code's pieces in order
  for (long i = gt; i < (long)K * dim; i += n_gt) {
    const int k = static_cast<int>(i % K), d = static_cast<int>(i / K);
    const int s = __ldcg(start + k), e = __ldcg(end + k);
    float sum = 0.f;
    if (e > s) {
      sum = __ldcg(first + (size_t)k * dim + d);
      int pc = s / kPiece + 1;
      const int last = (e - 1) / kPiece;
      for (; pc + 3 <= last; pc += 4) {  // four loads in flight
        float h[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          h[u] = __ldcg(head + (size_t)(pc + u) * dim + d);
#pragma unroll
        for (int u = 0; u < 4; ++u) sum += h[u];
      }
      for (; pc <= last; ++pc) sum += __ldcg(head + (size_t)pc * dim + d);
    }
    P.embed_sum[(size_t)d * K + k] = sum;
    if (d == 0) P.counts[k] = static_cast<float>(e - s);
  }
}

const void* assign_kernel(const AssignGeom& A) {
  return A.wide ? reinterpret_cast<const void*>(vq_assign_wide_kernel)
                : reinterpret_cast<const void*>(vq_assign_kernel);
}
const void* stats_kernel(const StatsGeom& S) {
  if (S.kj == 2) return reinterpret_cast<const void*>(vq_stats_kernel<2>);
  return S.kj == kMidDim / kWarp
             ? reinterpret_cast<const void*>(vq_stats_kernel<kMidDim / kWarp>)
             : reinterpret_cast<const void*>(vq_stats_kernel<kMaxDim / kWarp>);
}

struct Device {
  int sms = 0, optin = 0, ready = 0;
  size_t stats_smem = 0;
  int stats_kj = 0, stats_per_sm = 0;
};
Device g_devices[64];

cudaError_t device_info(Device** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Device& D = g_devices[dev];
  if (!D.ready) {
    int coop = 0;
    cudaDeviceGetAttribute(&D.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&D.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return cudaErrorNotSupported;
    for (const void* f :
         {reinterpret_cast<const void*>(vq_assign_kernel),
          reinterpret_cast<const void*>(vq_assign_wide_kernel),
          reinterpret_cast<const void*>(vq_stats_kernel<2>),
          reinterpret_cast<const void*>(vq_stats_kernel<kMidDim / kWarp>),
          reinterpret_cast<const void*>(vq_stats_kernel<kMaxDim / kWarp>)}) {
      e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               D.optin);
      if (e != cudaSuccess) return e;
    }
    D.ready = 1;
  }
  *out = &D;
  return cudaSuccess;
}

// the plan of one call: both kernels' shapes, the stats grid within what
// can co-reside
cudaError_t plan(const VqLookupParams& P, AssignGeom* A, StatsGeom* S) {
  const int n = P.n, dim = P.dim, K = P.n_embed;
  if (n <= 0 || dim <= 0 || dim > kMaxDim || K <= 0)
    return cudaErrorInvalidValue;
  Device* D = nullptr;
  cudaError_t e = device_info(&D);
  if (e != cudaSuccess) return e;
  *A = assign_geom(n, dim, D->sms);
  *S = stats_geom(n, dim, K);
  if (A->smem > (size_t)D->optin || S->smem > (size_t)D->optin)
    return cudaErrorInvalidValue;
  if (S->smem != D->stats_smem || S->kj != D->stats_kj) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &D->stats_per_sm, stats_kernel(*S), kThreads, S->smem);
    if (e != cudaSuccess) return e;
    D->stats_smem = S->smem;
    D->stats_kj = S->kj;
  }
  const int resident = D->stats_per_sm * D->sms;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  int want = cdiv(S->pieces, kWarps);
  want = max(want, S->tiles);
  want = max(want, cdiv((long)K * dim, 4L * kThreads));
  S->grid = max(1, min(want, resident));
  return cudaSuccess;
}

}  // namespace

extern "C" long long isi_vq_workspace_ints(int n, int dim, int n_embed) {
  if (n <= 0 || dim <= 0 || n_embed <= 0) return 0;
  return stats_geom(n, dim, n_embed).ints;
}

extern "C" int isi_vq_lookup(const VqLookupParams* P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AssignGeom A;
  StatsGeom S;
  cudaError_t e = plan(*P, &A, &S);
  if (e != cudaSuccess) return static_cast<int>(e);
  VqLookupParams params = *P;
  void* assign_args[] = {&params, &A.rw, &A.chunk};
  e = cudaLaunchKernel(assign_kernel(A), dim3(A.grid), dim3(kThreads),
                       assign_args, A.smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* stats_args[] = {&params, &S};
  e = cudaLaunchCooperativeKernel(stats_kernel(S), dim3(S.grid),
                                  dim3(kThreads), stats_args, S.smem, s);
  return static_cast<int>(e);
}

// info[0..11] = assign grid, rows a block, codes staged a pass, assign
// dynamic shared-memory bytes, assign registers; stats grid, stats dynamic
// shared-memory bytes, stats registers, stats blocks that can co-reside,
// sort passes, grid barriers, threads a block (both)
extern "C" int isi_vq_lookup_info(const VqLookupParams* P, int* out) {
  AssignGeom A;
  StatsGeom S;
  cudaError_t e = plan(*P, &A, &S);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa, fs;
  e = cudaFuncGetAttributes(&fa, assign_kernel(A));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncGetAttributes(&fs, stats_kernel(S));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  cudaGetDevice(&dev);
  out[0] = A.grid;
  out[1] = 16 * A.rw;
  out[2] = A.chunk;
  out[3] = static_cast<int>(A.smem);
  out[4] = fa.numRegs;
  out[5] = S.grid;
  out[6] = static_cast<int>(S.smem);
  out[7] = fs.numRegs;
  out[8] = g_devices[dev].stats_per_sm * g_devices[dev].sms;
  out[9] = S.passes;
  out[10] = 3 * S.passes + 1;
  out[11] = kThreads;
  return cudaSuccess;
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
