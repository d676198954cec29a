// One scale of the multiscale STFT loss and its gradient.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/spectral_loss_kernel.py
//           ::fused_scale_loss (Pallas kernels _fwd_kernel, _bwd_kernel).
//
// For pred and target audio x [B, L], a window-folded rDFT basis
// wb [win, 2F] (cos | sin, the Hann window folded into its rows) and
// frames = 1 + (L - n_fft) / hop, start = (n_fft - win) / 2:
//
//   ri[b, f, k]  = sum_{n < win} x[b, start + f hop + n] wb[n, k]   (re | im)
//   mag          = sqrt(re^2 + im^2 + 1e-12)
//   loss         = sum lin_w d(mag_p, mag_t) + log_w d(log(mag_p + eps),
//                                                  log(mag_t + eps))
//   U[b, f, :]   = dL/dmag_p (re_p, im_p) / mag_p        (bf16)
//
// with d the L1 or the squared distance and lin_w, log_w the per-element
// weights. Backward (win = m hop, chunk j of hop samples at start + j hop):
//
//   d_pred[b, start + j hop + h] = g sum_{c < m} sum_k U[b, j - c, k]
//                                                     wb[c hop + h, k]
//
// Bound on the H100: operations. The forward is 8 B frames win F flops for
// the two products (pred and target against one basis), the backward half
// of that; the audio, the basis and U are small beside them (U, the one
// large intermediate, is 69 MB at B = 64 for the largest Jukebox scale).
// Both run in float32 FMA on the CUDA cores.
//
// The TPU kernel padded hop and F to 128 lanes, split the basis into
// bf16 hi/lo halves for a 3-pass product, and needed hop >= 48 to keep the
// padding small; none of that carries over. Here:
//   fwd     one block per (64 frequencies, 64 frames, batch row), 256
//           threads, each holding 4 frames x 4 frequencies x (re, im) of
//           pred and of target. The frames are read straight from the
//           audio (they overlap; nothing is framed in device memory), 32
//           samples at a time into shared memory beside the 32 basis rows
//           they meet. The epilogue computes magnitudes, the distances and
//           U (only when a gradient is wanted) and writes one partial sum
//           per block;
//   reduce  one block adds each batch row's partials in tile order
//           (per-row losses, for exact-count evaluation), then the rows:
//           no float atomics, the same bits on every call;
//   bwd     one block per (64 samples of a chunk, 64 chunks, batch row):
//           for each c < m, 32 columns of U and of the basis at a time
//           through shared memory; every output sample is written once
//           (an overlap-add without atomics).
// precision "default" rounds the audio (here) and the basis (by the
// caller) to bf16 before the float32 FMA: the 1-pass product.
#include "common.cuh"

using namespace isi;

struct SpectralParams {
  const float* pred;           // [B, L]
  const float* target;         // [B, L]
  const float* basis;          // [win, 2F]
  const float* grad;           // [1] cotangent of the loss (backward)
  const __nv_bfloat16* u_in;   // [B, frames, 2F] (backward)
  __nv_bfloat16* u;            // [B, frames, 2F] or null (forward)
  float* partial;              // [B, tiles] (forward)
  float* rows;                 // [B] (forward)
  float* total;                // [1] (forward)
  float* d_pred;               // [B, L], zero outside the chunks (backward)
  int batch, length, hop, win, frames, n_freq, start;
  int mse, round_bf16;
  float lin_w, log_w, log_eps;
};

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 64;   // frames of a forward block
constexpr int kFreqs = 64;    // frequencies of a forward block
constexpr int kSamples = 32;  // window samples staged per pass
constexpr int kChunks = 64;   // chunks j of a backward block
constexpr int kOffsets = 64;  // offsets h < hop of a backward block
constexpr int kCols = 32;     // columns of U staged per pass

__device__ __forceinline__ float sign_of(float v) {
  return static_cast<float>((v > 0.f) - (v < 0.f));
}

__global__ void __launch_bounds__(kThreads)
    spectral_fwd_kernel(SpectralParams P) {
  __shared__ float xs_p[kFrames][kSamples + 1];
  __shared__ float xs_t[kFrames][kSamples + 1];
  __shared__ __align__(16) float bc[kSamples][kFreqs];
  __shared__ __align__(16) float bs[kSamples][kFreqs];
  __shared__ float red[33];

  const int b = blockIdx.z;
  const int f0 = blockIdx.y * kFrames, k0 = blockIdx.x * kFreqs;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int two_f = 2 * P.n_freq;
  const float* xp = P.pred + (size_t)b * P.length + P.start;
  const float* xt = P.target + (size_t)b * P.length + P.start;

  // acc[q][r][0..3] = re_p, im_p, re_t, im_t of frame ty*4+q, freq tx*4+r
  float acc[4][4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][r][e] = 0.f;

  for (int n0 = 0; n0 < P.win; n0 += kSamples) {
    for (int i = tid; i < kFrames * kSamples; i += kThreads) {
      const int j = i % kSamples, f = i / kSamples;
      const int n = n0 + j, fr = f0 + f;
      float vp = 0.f, vt = 0.f;
      if (n < P.win && fr < P.frames) {
        const size_t off = (size_t)fr * P.hop + n;
        vp = xp[off];
        vt = xt[off];
        if (P.round_bf16) {
          vp = round_to<__nv_bfloat16>(vp);
          vt = round_to<__nv_bfloat16>(vt);
        }
      }
      xs_p[f][j] = vp;
      xs_t[f][j] = vt;
    }
    for (int i = tid; i < kSamples * kFreqs; i += kThreads) {
      const int kk = i % kFreqs, j = i / kFreqs;
      const int n = n0 + j, k = k0 + kk;
      float c = 0.f, s = 0.f;
      if (n < P.win && k < P.n_freq) {
        const float* row = P.basis + (size_t)n * two_f;
        c = row[k];
        s = row[P.n_freq + k];
      }
      bc[j][kk] = c;
      bs[j][kk] = s;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kSamples; ++j) {
      const float4 c4 = *reinterpret_cast<const float4*>(&bc[j][tx * 4]);
      const float4 s4 = *reinterpret_cast<const float4*>(&bs[j][tx * 4]);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float p = xs_p[ty * 4 + q][j];
        const float t = xs_t[ty * 4 + q][j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[q][r][0] = fmaf(p, cv[r], acc[q][r][0]);
          acc[q][r][1] = fmaf(p, sv[r], acc[q][r][1]);
          acc[q][r][2] = fmaf(t, cv[r], acc[q][r][2]);
          acc[q][r][3] = fmaf(t, sv[r], acc[q][r][3]);
        }
      }
    }
    __syncthreads();
  }

  float sum = 0.f;
  __nv_bfloat16* u_row =
      P.u == nullptr ? nullptr : P.u + (size_t)b * P.frames * two_f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int fr = f0 + ty * 4 + q;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + tx * 4 + r;
      if (fr >= P.frames || k >= P.n_freq) continue;
      const float re_p = acc[q][r][0], im_p = acc[q][r][1];
      const float re_t = acc[q][r][2], im_t = acc[q][r][3];
      const float mag_p = sqrtf(re_p * re_p + im_p * im_p + 1e-12f);
      const float mag_t = sqrtf(re_t * re_t + im_t * im_t + 1e-12f);
      float dmag = 0.f;
      if (P.lin_w != 0.f) {
        const float d = mag_p - mag_t;
        if (P.mse) {
          sum += P.lin_w * (d * d);
          dmag += (2.f * P.lin_w) * d;
        } else {
          sum += P.lin_w * fabsf(d);
          dmag += P.lin_w * sign_of(d);
        }
      }
      if (P.log_w != 0.f) {
        const float lp = mag_p + P.log_eps;
        const float d = logf(lp) - logf(mag_t + P.log_eps);
        if (P.mse) {
          sum += P.log_w * (d * d);
          dmag += (2.f * P.log_w) * d / lp;
        } else {
          sum += P.log_w * fabsf(d);
          dmag += P.log_w * sign_of(d) / lp;
        }
      }
      if (u_row != nullptr) {
        const float scale = dmag / mag_p;
        __nv_bfloat16* u = u_row + (size_t)fr * two_f;
        u[k] = __float2bfloat16(scale * re_p);
        u[P.n_freq + k] = __float2bfloat16(scale * im_p);
      }
    }
  }
  sum = block_sum(sum, red);
  if (tid == 0) {
    const int tiles = gridDim.x * gridDim.y;
    P.partial[(size_t)b * tiles + blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
}

// rows[b] = the row's partials in tile order; total = the rows in order
__global__ void spectral_reduce_kernel(const float* __restrict__ partial,
                                       int batch, int tiles,
                                       float* __restrict__ rows,
                                       float* __restrict__ total) {
  __shared__ float red[33];
  float mine = 0.f;
  for (int b = threadIdx.x; b < batch; b += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += partial[(size_t)b * tiles + t];
    rows[b] = s;
    mine += s;
  }
  mine = block_sum(mine, red);
  if (threadIdx.x == 0) *total = mine;
}

__global__ void __launch_bounds__(kThreads)
    spectral_bwd_kernel(SpectralParams P) {
  // padded rows: the transposed stores of a pass conflict 4-way, not 32
  __shared__ __align__(16) float us[kCols][kChunks + 4];
  __shared__ __align__(16) float ws[kCols][kOffsets + 4];

  const int b = blockIdx.z;
  const int j0 = blockIdx.y * kChunks, h0 = blockIdx.x * kOffsets;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int two_f = 2 * P.n_freq;
  const int m = P.win / P.hop;
  const int chunks = P.frames + m - 1;
  const __nv_bfloat16* U = P.u_in + (size_t)b * P.frames * two_f;

  // acc[q][r]: chunk j0 + ty*4 + q, offset h0 + tx*4 + r
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;

  for (int c = 0; c < m; ++c) {
    for (int k0 = 0; k0 < two_f; k0 += kCols) {
      for (int i = tid; i < kCols * kChunks; i += kThreads) {
        const int kk = i % kCols, jj = i / kCols;
        const int row = j0 + jj - c, k = k0 + kk;
        float v = 0.f;
        if (row >= 0 && row < P.frames && k < two_f)
          v = __bfloat162float(U[(size_t)row * two_f + k]);
        us[kk][jj] = v;
      }
      for (int i = tid; i < kCols * kOffsets; i += kThreads) {
        const int kk = i % kCols, hh = i / kCols;
        const int h = h0 + hh, k = k0 + kk;
        float v = 0.f;
        if (h < P.hop && k < two_f)
          v = P.basis[(size_t)(c * P.hop + h) * two_f + k];
        ws[kk][hh] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kCols; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&us[kk][ty * 4]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[q][r] = fmaf(av[q], wv[r], acc[q][r]);
      }
      __syncthreads();
    }
  }

  const float g = *P.grad;
  float* out = P.d_pred + (size_t)b * P.length + P.start;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + ty * 4 + q;
    if (j >= chunks) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = h0 + tx * 4 + r;
      if (h < P.hop) out[(size_t)j * P.hop + h] = g * acc[q][r];
    }
  }
}

bool valid(const SpectralParams* P) {
  return P->batch > 0 && P->batch <= 65535 && P->frames > 0 &&
         P->hop > 0 && P->win > 0 && P->n_freq > 0 && P->start >= 0 &&
         P->start + (P->frames - 1) * P->hop + P->win <= P->length;
}

}  // namespace

extern "C" int isi_spectral_loss_forward(const SpectralParams* P,
                                         void* stream) {
  if (!valid(P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((P->n_freq + kFreqs - 1) / kFreqs,
                  (P->frames + kFrames - 1) / kFrames, P->batch);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  spectral_fwd_kernel<<<grid, kThreads, 0, s>>>(*P);
  ISI_CHECK();
  spectral_reduce_kernel<<<1, 1024, 0, s>>>(P->partial, P->batch,
                                            grid.x * grid.y, P->rows,
                                            P->total);
  ISI_CHECK();
  return 0;
}

extern "C" int isi_spectral_loss_backward(const SpectralParams* P,
                                          void* stream) {
  if (!valid(P) || P->win % P->hop != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = P->frames + P->win / P->hop - 1;
  const dim3 grid((P->hop + kOffsets - 1) / kOffsets,
                  (chunks + kChunks - 1) / kChunks, P->batch);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  spectral_bwd_kernel<<<grid, kThreads, 0, s>>>(*P);
  ISI_CHECK();
  return 0;
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
