// Row-block building blocks of the prefix forward, which runs a decoder
// layer over a block of rows: float32 conversion, a LayerNorm per row, and
// a tiled CUDA-core GEMM with fused bias / ReLU / residual epilogues.
#pragma once

#include "common.cuh"

namespace isi {

template <typename T>
__global__ void to_f32_kernel(const T* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = to_f(in[i]);
}

// one block per row: out = round_to<T>(LayerNorm(x))
template <typename T>
__global__ void ln_rows_kernel(const float* x, int d, const float* scale,
                               const float* bias, T* out) {
  extern __shared__ float sm[];
  float* buf = sm;
  float* red = sm + d;
  const size_t row = blockIdx.x;
  block_layer_norm<T>(x + row * d, scale, bias, d, buf, red);
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    out[row * d + t] = from_f<T>(buf[t]);
}

constexpr int BK = 32, kGemmThreads = 256;

// C[M, N] = A[M, K] . W[N, K]^T + bias[N], float32 accumulation, one
// TILE x TILE output tile per block (TILE / 16 squared outputs a thread).
// The next K-slice is loaded into registers while the current one is
// multiplied out of shared memory. MODE is an epilogue of common.cuh.
template <typename T, int MODE, int TILE>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_nt_kernel(const T* __restrict__ A, const T* __restrict__ W,
                   const T* __restrict__ bias, int M, int N, int K,
                   float* out_f32, T* out_t) {
  constexpr int TM = TILE / 16;
  constexpr int LOADS = TILE * BK / kGemmThreads;
  __shared__ float As[BK][TILE + 4];
  __shared__ float Ws[BK][TILE + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  float ra[LOADS], rw[LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = tid + u * kGemmThreads;
      const int r = e / BK, gk = k0 + e % BK;
      ra[u] = (row0 + r < M && gk < K)
                  ? to_f(A[(size_t)(row0 + r) * K + gk]) : 0.f;
      rw[u] = (col0 + r < N && gk < K)
                  ? to_f(W[(size_t)(col0 + r) * K + gk]) : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = tid + u * kGemmThreads;
      As[e % BK][e / BK] = ra[u];
      Ws[e % BK][e / BK] = rw[u];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], wv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      const float v = acc[i][j] + to_f(bias[c]);
      const size_t o = (size_t)r * N + c;
      if (MODE == kOutF32) out_f32[o] = v;
      if (MODE == kResidual) out_f32[o] = out_f32[o] + v;
      if (MODE == kReluT) out_t[o] = from_f<T>(fmaxf(v, 0.f));
    }
  }
}

// 64 x 64 tiles when they fill the card, else 32 x 32 (four times as many
// blocks for the short row blocks)
template <typename T, int MODE>
static void gemm(const T* A, const T* W, const T* bias, int M, int N, int K,
                 float* out_f32, T* out_t, int sms, cudaStream_t s) {
  if (((M + 63) / 64) * ((N + 63) / 64) >= sms) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_nt_kernel<T, MODE, 64><<<grid, kGemmThreads, 0, s>>>(
        A, W, bias, M, N, K, out_f32, out_t);
  } else {
    dim3 grid((N + 31) / 32, (M + 31) / 32);
    gemm_nt_kernel<T, MODE, 32><<<grid, kGemmThreads, 0, s>>>(
        A, W, bias, M, N, K, out_f32, out_t);
  }
}

}  // namespace isi
