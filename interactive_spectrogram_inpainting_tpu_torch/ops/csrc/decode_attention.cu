// Single-query attention over the causal prefix of a KV cache.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/decode_attention.py
//           ::flash_decode_attention (Pallas kernel _decode_attn_kernel).
//
// out[b, h, :] = softmax_j(q[b, h] . K[b, j, h] / sqrt(Dh) + bias[h, j]) V
// over the keys j <= pos (the cache already holds row pos).
//
// Bound on the H100: bytes, the (pos + 1) K and V rows of every sequence
// read once. At the dense sampler's shapes (B 2, 8 heads, Dh 64, <= 640
// keys) that is well under a microsecond, so what paces a call is latency:
// launches, round trips to memory, dependent chains. The TPU kernel
// streamed 128-key chunks through VMEM with a running softmax per batch
// tile. Here one launch runs a thread-block cluster of kSplit blocks per
// (head, sequence); block r of the cluster takes the r-th contiguous
// kSplit-th of the pos + 1 keys:
//   stage   its K and V rows (up to kStageKeys a pass) into shared memory
//           by cp.async, all in flight at once;
//   scores  one thread per key, q . k over Dh in order (16-byte shared
//           loads, rows 16 bytes apart beyond their length: no bank
//           conflicts), times 1 / sqrt(Dh), plus the bias;
//   softmax the block's max and exp sum by warp shuffles and the warps in
//           order (a running max and sum across passes);
//   P V     threads over (key group, Dh): each group sums its keys (every
//           kGroups-th) in order, the groups are added in order;
//   combine each block stores its partial (max, sum, acc) into block 0's
//           shared memory (distributed shared memory; a cluster barrier
//           arrived at before the staging and waited on after it makes
//           sure block 0 is running), one cluster barrier, and block 0
//           merges the kSplit partials in rank order and writes the output
//           in the cache's dtype.
// Float32 arithmetic, no float atomics, no partials in device memory: the
// same bits on every call. Head dims up to 128: the staging buffers hold
// kStageKeys rows of a float32 head_dim 64; a wider row stages fewer keys a
// pass (41 at float32 head_dim 128), the same arithmetic in more passes.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace isi;

namespace {

constexpr int kSplit = 8;        // blocks of a cluster: one (head, sequence)
constexpr int kThreads = 128;
constexpr int kStageKeys = 80;   // keys staged a pass (640 / kSplit)
constexpr int kDhMax = 128;
// bytes of each staging buffer: kStageKeys rows of a float32 head_dim 64
constexpr int kStageBytes = kStageKeys * (64 * 4 + 16);

struct FlashParams {
  const void* q;      // [B, H, Dh], T
  const void* k;      // [B, Lp, H, Dh], T
  const void* v;      // [B, Lp, H, Dh], T
  const void* bias;   // [H, Lp] float32 or bfloat16, or null
  void* out;          // [B, H, Dh], T
  int n_heads, head_dim, length, pos, bias_bf16;
  float scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// q . row over dh elements of a staged row: 16-byte loads when dh is a
// multiple of 8, else pairs
__device__ __forceinline__ float dot_row(const float* q, const float* row,
                                         int dh) {
  float s = 0.f;
  if (dh % 8 == 0) {
    for (int d = 0; d < dh; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + d);
      s = fmaf(q[d], x.x, s);
      s = fmaf(q[d + 1], x.y, s);
      s = fmaf(q[d + 2], x.z, s);
      s = fmaf(q[d + 3], x.w, s);
    }
  } else {
    for (int d = 0; d < dh; ++d) s = fmaf(q[d], row[d], s);
  }
  return s;
}
__device__ __forceinline__ float dot_row(const float* q,
                                         const __nv_bfloat16* row, int dh) {
  float s = 0.f;
  if (dh % 8 == 0) {
    for (int d = 0; d < dh; d += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + d);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        s = fmaf(q[d + 2 * i], f.x, s);
        s = fmaf(q[d + 2 * i + 1], f.y, s);
      }
    }
  } else {
    for (int d = 0; d < dh; ++d) s = fmaf(q[d], to_f(row[d]), s);
  }
  return s;
}

// the block's max (op 0) or sum (op 1) of one value a thread, the warps
// added in order; every thread gets it
template <int Op>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  x = Op == 0 ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / kWarp; ++w)
    r = Op == 0 ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is free again
  return r;
}

template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
    flash_decode_kernel(FlashParams P) {
  __shared__ __align__(16) unsigned char ks_raw[kStageBytes];
  __shared__ __align__(16) unsigned char vs_raw[kStageBytes];
  __shared__ float q_s[kDhMax];
  __shared__ float p_s[kStageKeys];
  __shared__ float grp[kThreads];
  __shared__ float red[kThreads / kWarp];
  __shared__ float parts[kSplit][2 + kDhMax];  // block 0's: every partial
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = P.n_heads, dh = P.head_dim, tid = threadIdx.x;
  const int n_keys = P.pos + 1;
  const int j0 = static_cast<int>((long)r * n_keys / kSplit);
  const int j1 = static_cast<int>((long)(r + 1) * n_keys / kSplit);
  const size_t row_stride = (size_t)H * dh;  // elements between keys
  const T* K = static_cast<const T*>(P.k) + (size_t)b * P.length * row_stride
               + (size_t)h * dh;
  const T* V = static_cast<const T*>(P.v) + (size_t)b * P.length * row_stride
               + (size_t)h * dh;
  const int row_bytes = dh * static_cast<int>(sizeof(T));
  const int rs = (row_bytes + 15) / 16 * 16 + 16;  // staged row stride
  const int stage_keys = min(kStageKeys, kStageBytes / rs);  // keys a pass
  // 16-byte pieces when every row starts 16-byte aligned, else 4-byte ones
  const bool vec = row_bytes % 16 == 0
                   && (reinterpret_cast<size_t>(K) % 16) == 0
                   && (reinterpret_cast<size_t>(V) % 16) == 0;
  const int piece = vec ? 16 : 4;
  const int per_row = row_bytes / piece;

  if (tid < dh)
    q_s[tid] =
        to_f(static_cast<const T*>(P.q)[((size_t)b * H + h) * dh + tid]);
  const int groups = kThreads / dh;  // P V key groups
  const int grp_id = tid / dh, dcol = tid % dh;
  float m_run = -INFINITY, l_run = 0.f, acc = 0.f;
  for (int js = j0; js < j1; js += stage_keys) {
    const int nk = min(stage_keys, j1 - js);
    for (int i = tid; i < 2 * nk * per_row; i += kThreads) {
      const int which = i / (nk * per_row), e = i % (nk * per_row);
      const int jj = e / per_row, o = (e % per_row) * piece;
      const T* src = (which ? V : K) + (size_t)(js + jj) * row_stride;
      unsigned char* dst = (which ? vs_raw : ks_raw) + jj * rs + o;
      const char* s = reinterpret_cast<const char*>(src) + o;
      if (vec)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(s)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(s)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (js == j0) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the rows and q are in shared memory
    float s = -INFINITY;
    if (tid < nk) {
      const T* row = reinterpret_cast<const T*>(ks_raw + tid * rs);
      s = dot_row(q_s, row, dh) * P.scale;
      if (P.bias != nullptr) {
        const size_t i = (size_t)h * P.length + js + tid;
        s += P.bias_bf16
                 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(P.bias)[i])
                 : static_cast<const float*>(P.bias)[i];
      }
    }
    const float m_new = fmaxf(m_run, block_reduce<0>(s, red));
    const float corr = expf(m_run - m_new);  // 0 on the first pass
    const float p = tid < nk ? expf(s - m_new) : 0.f;
    if (tid < nk) p_s[tid] = p;
    l_run = l_run * corr + block_reduce<1>(p, red);  // p_s is visible too
    float a = 0.f;
    if (grp_id < groups)
      for (int i = grp_id; i < nk; i += groups)
        a = fmaf(p_s[i],
                 to_f(reinterpret_cast<const T*>(vs_raw + i * rs)[dcol]), a);
    grp[tid] = a;
    __syncthreads();
    if (tid < dh) {
      float sum = grp[tid];
      for (int g = 1; g < groups; ++g) sum += grp[g * dh + tid];
      acc = acc * corr + sum;
    }
    m_run = m_new;
    __syncthreads();  // the staged rows and p_s are free
  }
  // a block without keys arrives here first, and leaves max -inf and zero
  // sums
  if (j0 == j1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* mine = cluster.map_shared_rank(&parts[0][0], 0) + r * (2 + kDhMax);
  if (tid == 0) {
    mine[0] = m_run;
    mine[1] = l_run;
  }
  if (tid < dh) mine[2 + tid] = acc;
  cluster.sync();  // every partial is in block 0's shared memory
  if (r == 0 && tid < dh) {
    float mm = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSplit; ++i) mm = fmaxf(mm, parts[i][0]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int i = 0; i < kSplit; ++i) {
      const float w = parts[i][0] == -INFINITY ? 0.f : expf(parts[i][0] - mm);
      den = fmaf(parts[i][1], w, den);
      num = fmaf(parts[i][2 + tid], w, num);
    }
    static_cast<T*>(P.out)[((size_t)b * H + h) * dh + tid] =
        from_f<T>(num / fmaxf(den, 1e-20f));
  }
}

bool shape_ok(const FlashParams& P, int batch) {
  return P.head_dim > 0 && P.head_dim <= kDhMax && P.head_dim % 2 == 0
         && P.pos >= 0 && P.pos < P.length && batch > 0 && P.n_heads > 0;
}

template <typename T>
cudaError_t launch(const FlashParams& P, int batch, cudaStream_t stream) {
  if (!shape_ok(P, batch)) return cudaErrorInvalidValue;
  flash_decode_kernel<T><<<dim3(kSplit, P.n_heads, batch), kThreads, 0,
                           stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t info(const FlashParams& P, int batch, int* out) {
  if (!shape_ok(P, batch)) return cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, flash_decode_kernel<T>);
  if (e != cudaSuccess) return e;
  out[0] = kSplit * P.n_heads * batch;
  out[1] = kSplit;
  out[2] = kThreads;
  out[3] = static_cast<int>(fa.sharedSizeBytes);
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  return cudaSuccess;
}

FlashParams params(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int n_heads, int head_dim,
                   int length, int pos, int bias_bf16, float scale) {
  return FlashParams{q, k, v,   bias,     out,      n_heads,
                     head_dim, length, pos, bias_bf16, scale};
}

}  // namespace

// dtype (of q, the caches and out) and bias_dtype: 0 = float32, 1 =
// bfloat16. Returns a cudaError_t code. Plain arguments (no struct to fill
// on the host).
extern "C" int isi_decode_attention(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int batch, int n_heads,
                                    int head_dim, int length, int pos,
                                    float scale, int dtype, int bias_dtype,
                                    void* stream) {
  const FlashParams P = params(q, k, v, bias, out, n_heads, head_dim, length,
                               pos, bias_dtype == 1, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1 ? launch<__nv_bfloat16>(P, batch, s)
                                     : launch<float>(P, batch, s));
}

// info[0..5] = grid blocks, cluster size, threads a block, static shared
// bytes, registers a thread, local (spilled) bytes a thread
extern "C" int isi_decode_attention_info(int batch, int n_heads,
                                         int head_dim, int length, int pos,
                                         int dtype, int* out) {
  const FlashParams P = params(nullptr, nullptr, nullptr, nullptr, nullptr,
                               n_heads, head_dim, length, pos, 0, 1.f);
  return static_cast<int>(dtype == 1 ? info<__nv_bfloat16>(P, batch, out)
                                     : info<float>(P, batch, out));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
