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
// Bound on the H100: operations. The one product the function needs,
// 2 N dim K flops, runs in float32 FMA on the CUDA cores (the TPU kernel
// asks for Precision.HIGHEST; a TF32 or bf16 product would move near
// ties), far above the bytes of x, ids and quantize at every N.
//
// The TPU kernel walked N in tiles of 512 on one core, padded dim to 128
// lanes, multiplied by a one-hot matrix to gather and to reduce, and
// carried counts and sums from one grid step to the next. Here:
//   prep   one thread per code: |e_k|^2 summed over dim in ascending order,
//          and a transposed copy e_t[K, dim] so that a code is one
//          contiguous row for the gather;
//   assign one block per 32 rows. The rows sit in shared memory; the
//          codebook passes through shared memory in chunks of 128 codes in
//          its own [dim, K] layout. A warp's 32 lanes are the 32 rows and
//          each of the 8 warps owns 16 codes of a chunk, so an inner step
//          is one row element, two broadcast float4 loads of 8 codes and 8
//          FMAs. Each thread keeps its best (score, code) over ascending
//          codes; the warps' bests are merged as (score, code) pairs, so
//          the lowest code wins a tie. The block then copies the winning
//          rows of e_t to quantize;
//   stats  one block per (code, segment of 2048 rows) scans the segment's
//          ids in ascending order, 256 at a time, compacts the matching rows
//          with warp ballots and adds them, each of 256 / dim thread groups
//          taking every (256 / dim)-th match; the groups' sums are added in
//          a fixed order. With more than one segment the blocks write
//          partial sums and a fourth launch adds them in ascending segment
//          order. No float atomics: the same bits on every run, and no
//          block sums more than 2048 rows however skewed the codes are (an
//          untrained encoder sends every row to one code).
#include "common.cuh"

using namespace isi;

struct VqLookupParams {
  const float* flat;   // [N, dim]
  const float* embed;  // [dim, K]
  float* embed_t;      // [K, dim] scratch
  float* embed_sq;     // [K] scratch
  int* ids;            // [N]
  float* quantize;     // [N, dim]
  float* counts;       // [K]
  float* embed_sum;    // [dim, K]
  float* part_sum;     // [segments, dim, K] scratch, null for one segment
  int* part_count;     // [segments, K] scratch, null for one segment
  int n, dim, n_embed;
};

namespace {

constexpr int kTileRows = 32;     // rows per assign block = lanes of a warp
constexpr int kAssignWarps = 8;
constexpr int kChunkCodes = 128;  // codes staged per pass
constexpr int kCodesPerWarp = kChunkCodes / kAssignWarps;  // 16
constexpr int kStatsThreads = 256;
constexpr int kSegmentRows = 2048;  // rows one stats block scans
constexpr int kMaxDim = 256;

__global__ void vq_prep_kernel(const float* __restrict__ embed, int dim,
                               int K, float* __restrict__ embed_t,
                               float* __restrict__ embed_sq) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float sq = 0.f;
  for (int d = 0; d < dim; ++d) {
    const float v = embed[(size_t)d * K + k];
    embed_t[(size_t)k * dim + d] = v;
    sq = fmaf(v, v, sq);
  }
  embed_sq[k] = sq;
}

__global__ void __launch_bounds__(kAssignWarps* kWarp)
    vq_assign_kernel(const float* __restrict__ flat,
                     const float* __restrict__ embed,
                     const float* __restrict__ embed_t,
                     const float* __restrict__ embed_sq, int n, int dim,
                     int K, int* __restrict__ ids,
                     float* __restrict__ quantize) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                                  // [dim][kChunkCodes]
  float* xs = es + (size_t)dim * kChunkCodes;        // [32][dim + 1]
  float* red_s = xs + kTileRows * (dim + 1);         // [8][32]
  int* red_i = reinterpret_cast<int*>(red_s + kAssignWarps * kTileRows);
  int* win = red_i + kAssignWarps * kTileRows;       // [32]

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, n - row0);
  const int xstride = dim + 1;

  for (int i = tid; i < kTileRows * dim; i += blockDim.x) {
    const int r = i / dim, d = i % dim;
    xs[r * xstride + d] =
        r < rows ? flat[(size_t)(row0 + r) * dim + d] : 0.f;
  }

  float best = INFINITY;
  int best_k = 0;
  const float* xrow = xs + lane * xstride;
  for (int c0 = 0; c0 < K; c0 += kChunkCodes) {
    __syncthreads();  // the previous chunk is consumed, xs is written
    if (K % 4 == 0) {  // 16-byte loads: rows of embed stay 16-byte aligned
      for (int i = tid * 4; i < dim * kChunkCodes; i += blockDim.x * 4) {
        const int d = i / kChunkCodes, c = c0 + i % kChunkCodes;
        *reinterpret_cast<float4*>(es + i) =
            c < K ? __ldg(reinterpret_cast<const float4*>(
                        embed + (size_t)d * K + c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < dim * kChunkCodes; i += blockDim.x) {
        const int d = i / kChunkCodes, c = c0 + i % kChunkCodes;
        es[i] = c < K ? embed[(size_t)d * K + c] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kCodesPerWarp / 8; ++g) {
      const int cw = warp * kCodesPerWarp + g * 8;  // offset in the chunk
      if (c0 + cw >= K) break;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      const float* ep = es + cw;
#pragma unroll 4
      for (int d = 0; d < dim; ++d) {
        const float xv = xrow[d];
        const float4 e0 =
            *reinterpret_cast<const float4*>(ep + (size_t)d * kChunkCodes);
        const float4 e1 = *reinterpret_cast<const float4*>(
            ep + (size_t)d * kChunkCodes + 4);
        acc[0] = fmaf(xv, e0.x, acc[0]);
        acc[1] = fmaf(xv, e0.y, acc[1]);
        acc[2] = fmaf(xv, e0.z, acc[2]);
        acc[3] = fmaf(xv, e0.w, acc[3]);
        acc[4] = fmaf(xv, e1.x, acc[4]);
        acc[5] = fmaf(xv, e1.y, acc[5]);
        acc[6] = fmaf(xv, e1.z, acc[6]);
        acc[7] = fmaf(xv, e1.w, acc[7]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + cw + j;
        if (c < K) {
          const float s = embed_sq[c] - 2.0f * acc[j];
          if (s < best) {  // codes ascend within a thread: first one wins
            best = s;
            best_k = c;
          }
        }
      }
    }
  }

  red_s[warp * kTileRows + lane] = best;
  red_i[warp * kTileRows + lane] = best_k;
  __syncthreads();
  if (warp == 0) {
    float b = red_s[lane];
    int bk = red_i[lane];
    for (int w = 1; w < kAssignWarps; ++w) {
      const float s = red_s[w * kTileRows + lane];
      const int sk = red_i[w * kTileRows + lane];
      if (s < b || (s == b && sk < bk)) {
        b = s;
        bk = sk;
      }
    }
    win[lane] = bk;
    if (lane < rows) ids[row0 + lane] = bk;
  }
  __syncthreads();
  for (int i = tid; i < rows * dim; i += blockDim.x) {
    const int r = i / dim, d = i % dim;
    quantize[(size_t)(row0 + r) * dim + d] =
        embed_t[(size_t)win[r] * dim + d];
  }
}

__global__ void __launch_bounds__(kStatsThreads)
    vq_stats_kernel(const int* __restrict__ ids,
                    const float* __restrict__ flat, int n, int dim, int K,
                    float* __restrict__ sums, int* __restrict__ part_count,
                    float* __restrict__ counts) {
  // blockIdx.x: code, blockIdx.y: segment. sums is embed_sum itself with
  // one segment (counts written as floats), else the partial buffer
  // [segments, dim, K] (counts as ints into part_count).
  __shared__ int rows[kStatsThreads];
  __shared__ int warp_count[kStatsThreads / kWarp];
  __shared__ float group_sum[kStatsThreads];
  const int k = blockIdx.x, seg = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int groups = dim <= kStatsThreads / 2 ? kStatsThreads / dim : 1;
  const int group = tid / dim, d = tid % dim;
  const int begin = seg * kSegmentRows;
  const int end = min(n, begin + kSegmentRows);
  float acc = 0.f;
  int count = 0;
  for (int base = begin; base < end; base += kStatsThreads) {
    const int row = base + tid;
    const bool hit = row < end && ids[row] == k;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kStatsThreads / kWarp; ++w) {
      const int c = warp_count[w];
      if (w < warp) before += c;
      total += c;
    }
    if (hit) rows[before + __popc(ballot & ((1u << lane) - 1u))] = row;
    __syncthreads();
    if (group < groups) {
      // a pass's rows are summed first and added as one term: a busy
      // code's running sum rounds once per pass, not once per row
      float part = 0.f;
#pragma unroll 4
      for (int i = group; i < total; i += groups)
        part += flat[(size_t)rows[i] * dim + d];
      acc += part;
    }
    count += total;
    // the next pass's first barrier orders these reads before its writes
  }
  group_sum[tid] = acc;
  __syncthreads();
  if (tid < dim) {
    float total = group_sum[tid];
    for (int g = 1; g < groups; ++g) total += group_sum[g * dim + tid];
    sums[((size_t)seg * dim + tid) * K + k] = total;
  }
  if (tid == 0) {
    if (part_count != nullptr)
      part_count[(size_t)seg * K + k] = count;
    else
      counts[k] = (float)count;
  }
}

// embed_sum and counts from the segments' partials, in ascending segment
// order: one thread per (dim row or the count row, code).
__global__ void vq_stats_combine_kernel(const float* __restrict__ part_sum,
                                        const int* __restrict__ part_count,
                                        int segments, int dim, int K,
                                        float* __restrict__ counts,
                                        float* __restrict__ embed_sum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (dim + 1) * K) return;
  if (i < dim * K) {
    float total = 0.f;
    for (int s = 0; s < segments; ++s)
      total += part_sum[(size_t)s * dim * K + i];
    embed_sum[i] = total;
  } else {
    int total = 0;
    for (int s = 0; s < segments; ++s)
      total += part_count[(size_t)s * K + (i - dim * K)];
    counts[i - dim * K] = (float)total;
  }
}

}  // namespace

extern "C" int isi_vq_lookup(const VqLookupParams* P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = P->n, dim = P->dim, K = P->n_embed;
  if (n <= 0 || dim <= 0 || dim > kMaxDim || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run = [&]() -> cudaError_t {
    vq_prep_kernel<<<(K + 127) / 128, 128, 0, s>>>(P->embed, dim, K,
                                                  P->embed_t, P->embed_sq);
    ISI_CHECK();
    const size_t smem =
        sizeof(float) * ((size_t)dim * kChunkCodes + kTileRows * (dim + 1) +
                         kAssignWarps * kTileRows) +
        sizeof(int) * (kAssignWarps * kTileRows + kTileRows);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          vq_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
    }
    vq_assign_kernel<<<(n + kTileRows - 1) / kTileRows,
                       kAssignWarps * kWarp, smem, s>>>(
        P->flat, P->embed, P->embed_t, P->embed_sq, n, dim, K, P->ids,
        P->quantize);
    ISI_CHECK();
    const int segments = (n + kSegmentRows - 1) / kSegmentRows;
    if (segments > 1 && (P->part_sum == nullptr || P->part_count == nullptr))
      return cudaErrorInvalidValue;
    vq_stats_kernel<<<dim3(K, segments), kStatsThreads, 0, s>>>(
        P->ids, P->flat, n, dim, K,
        segments > 1 ? P->part_sum : P->embed_sum,
        segments > 1 ? P->part_count : nullptr, P->counts);
    ISI_CHECK();
    if (segments > 1) {
      vq_stats_combine_kernel<<<((dim + 1) * K + 255) / 256, 256, 0, s>>>(
          P->part_sum, P->part_count, segments, dim, K, P->counts,
          P->embed_sum);
      ISI_CHECK();
    }
    return cudaSuccess;
  };
  return static_cast<int>(run());
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
