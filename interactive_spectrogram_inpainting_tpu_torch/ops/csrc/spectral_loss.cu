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
// Two routes, chosen by the wrapper from the shape and the precision alone
// (spectral_loss_kernel.py::fft_route):
//
// FFT route: precision "high", n_fft a power of two from 64 to 4096. Bound
// on the H100: an FFT's 5 N log2 N flops a complex frame are ~0.1 ms of
// the CUDA cores' peak for the three Jukebox scales at B = 64, about what
// U (229 MB) takes at 3.35 TB/s; what limits a transform in shared memory
// is that memory's traffic (16 bytes a value a pass). So:
//   fwd     one block per (group of frames, batch row), 16 complex values a
//           thread, 2048 (4096 at n_fft 4096) values a block: 2048 / n_fft
//           frames side by side. A frame's win samples are read straight
//           from the audio (the frames overlap; nothing is framed in device
//           memory), times the window, zero-padded at the end to n_fft, as
//           one complex signal z = pred + i target. Radix-8 Stockham passes
//           (a radix-2 or -4 first where log2 n_fft is not a multiple of 3)
//           run in registers; each pass reads and writes shared memory
//           once, padded one word in 32 against bank conflicts; twiddles
//           are a float32 table of the float64 exp(-2 pi i t / N). Then
//           P[k] = (Z[k] + conj Z[N-k]) / 2, T[k] = (Z[k] - conj Z[N-k]) / 2i
//           and re = Re, im = -Im (the basis's +sin), and the DFT route's
//           epilogue: magnitudes, distances, U, one partial sum a block;
//   bwd     the transposed STFT of a frame is w[n] (N/2) irfft(X)[n],
//           X[k] = U_re[k] - i U_im[k] with X[0], X[N/2] doubled: two
//           frames share one complex inverse transform (both outputs are
//           real), whose w-weighted first win values go to a float32
//           [B, frames, win] intermediate; then the overlap-add writes
//           every output sample once, its <= m frames summed in the order
//           of c (no atomics).
//
// DFT route: every other eligible scale (precision "default", whose basis
// is rounded to bf16 and which an FFT cannot reproduce; n_fft not a power
// of two or outside 64..4096). Bound: operations, 8 B frames win F flops
// forward, half that backward, in float32 FMA on the CUDA cores.
//
// The TPU kernel padded hop and F to 128 lanes, split the basis into
// bf16 hi/lo halves for a 3-pass product, and needed hop >= 48 to keep the
// padding small; none of that carries over. DFT route:
//   fwd     one block per (64 frequencies, 64 frames, batch row), 256
//           threads, each holding 4 frames x 4 frequencies x (re, im) of
//           pred and of target. The frames are read straight from the
//           audio, 32 samples at a time into shared memory beside the 32
//           basis rows they meet. The epilogue computes magnitudes, the
//           distances and U (only when a gradient is wanted) and writes
//           one partial sum per block;
//   bwd     one block per (64 samples of a chunk, 64 chunks, batch row):
//           for each c < m, 32 columns of U and of the basis at a time
//           through shared memory; every output sample is written once
//           (an overlap-add without atomics).
// Both routes:
//   reduce  one block adds each batch row's partials (per-row losses, for
//           exact-count evaluation) and then the rows, in float64 and in a
//           fixed order: no float atomics, the same bits on every call.
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
  const float* window;         // [win] periodic Hann (FFT route)
  const float2* twiddle;       // [n_fft] exp(-2 pi i t / n_fft) (FFT route)
  float* frame_grad;           // [B, frames, win] (FFT route backward)
  int batch, length, hop, win, frames, n_freq, start;
  int mse, round_bf16, n_fft;
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

// One bin of both spectra: adds its loss terms to ``sum`` and, where ``u``
// (the frame's row of U) is given, writes U's two values of bin k.
__device__ __forceinline__ void bin_loss(const SpectralParams& P, float re_p,
                                         float im_p, float re_t, float im_t,
                                         __nv_bfloat16* u, int k,
                                         float& sum) {
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
  if (u != nullptr) {
    const float scale = dmag / mag_p;
    u[k] = __float2bfloat16(scale * re_p);
    u[P.n_freq + k] = __float2bfloat16(scale * im_p);
  }
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
      bin_loss(P, acc[q][r][0], acc[q][r][1], acc[q][r][2], acc[q][r][3],
               u_row == nullptr ? nullptr : u_row + (size_t)fr * two_f, k,
               sum);
    }
  }
  sum = block_sum(sum, red);
  if (tid == 0) {
    const int tiles = gridDim.x * gridDim.y;
    P.partial[(size_t)b * tiles + blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
}

// rows[b] = the row's partials, one warp a row, each lane's strided share
// and then the lanes summed in float64 in a fixed order; total = the rows'
// float64 sums, warp by warp in order. No float atomics: the same bits on
// every call. (float64: the FFT route has up to ~340 partials a row; a
// float32 chain of them put rows farther from a float64 evaluation of the
// loss than the plain version.)
__global__ void spectral_reduce_kernel(const float* __restrict__ partial,
                                       int batch, int tiles,
                                       float* __restrict__ rows,
                                       float* __restrict__ total) {
  __shared__ double red[kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  double mine = 0.0;
  for (int b = warp; b < batch; b += n_warps) {
    double s = 0.0;
    for (int t = lane; t < tiles; t += kWarp)
      s += partial[(size_t)b * tiles + t];
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rows[b] = static_cast<float>(s);
    mine += s;
  }
  if (lane == 0) red[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < n_warps; ++w) s += red[w];
    *total = static_cast<float>(s);
  }
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

// -- FFT route ----------------------------------------------------------------

constexpr int kPer = 16;         // complex values a thread holds in a pass
constexpr int kBlockValues = 2048;  // complex values of a block, at least

// A block's geometry for an n_fft of 2^LOGN: T threads, FR transforms of
// N values side by side in shared memory (re and im arrays, padded).
template <int LOGN> struct Geometry {
  static constexpr int N = 1 << LOGN;
  static constexpr int M = N > kBlockValues ? N : kBlockValues;
  static constexpr int T = M / kPer;
  static constexpr int FR = M / N;
  static constexpr int SMEM = M + M / 32;
  // passes: a radix-2 or radix-4 first where LOGN is not a multiple of 3
  static constexpr int FIRST = LOGN % 3 == 0 ? 8 : (LOGN % 3 == 1 ? 2 : 4);
  static constexpr int PASSES = LOGN / 3 + (LOGN % 3 != 0);
};

// one float of padding every 32: the strided stores of a pass spread over
// the banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a times -i (forward) or +i (inverse)
template <bool kInv> __device__ __forceinline__ float2 rot90(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// In-register DFTs of R values v[o..o+R), natural order in and out; the
// forward takes exp(-2 pi i j n / R), the inverse exp(+...).
template <bool kInv>
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <bool kInv>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2,
                                     float2& x3) {
  const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2);
  const float2 t2 = cadd(x1, x3), t3 = rot90<kInv>(csub(x1, x3));
  x0 = cadd(t0, t2);
  x2 = csub(t0, t2);
  x1 = cadd(t1, t3);
  x3 = csub(t1, t3);
}

// sqrt(1/2) x, with sqrt(1/2) as a float32 pair (hi + lo): the float32 hi
// alone is 1.7e-8 short, and radix-8 passes apply it to a quarter of the
// values each, which biased the loss low (a bias, not noise)
__device__ __forceinline__ float half_sqrt2(float x) {
  constexpr float hi = 0.707106769084930419921875f;
  constexpr float lo = 1.2101617152815436e-08f;  // sqrt(1/2) - hi
  return fmaf(hi, x, lo * x);
}

template <bool kInv>
__device__ __forceinline__ void dft8(float2* v) {
  dft4<kInv>(v[0], v[2], v[4], v[6]);  // even samples: E0..E3
  dft4<kInv>(v[1], v[3], v[5], v[7]);  // odd samples: O0..O3
  // O_k times exp(-+2 pi i k / 8)
  const float2 o1 = v[3], o3 = v[7];
  const float2 w1 =
      kInv ? make_float2(half_sqrt2(o1.x - o1.y), half_sqrt2(o1.x + o1.y))
           : make_float2(half_sqrt2(o1.x + o1.y), half_sqrt2(o1.y - o1.x));
  const float2 w2 = rot90<kInv>(v[5]);
  const float2 w3 =
      kInv ? make_float2(-half_sqrt2(o3.x + o3.y), half_sqrt2(o3.x - o3.y))
           : make_float2(half_sqrt2(o3.y - o3.x), -half_sqrt2(o3.x + o3.y));
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, w1);
  v[5] = csub(e1, w1);
  v[2] = cadd(e2, w2);
  v[6] = csub(e2, w2);
  v[3] = cadd(e3, w3);
  v[7] = csub(e3, w3);
}

template <int R, bool kInv>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) dft2<kInv>(v);
  if constexpr (R == 4) dft4<kInv>(v[0], v[1], v[2], v[3]);
  if constexpr (R == 8) dft8<kInv>(v);
}

// Pass S of a Stockham FFT (radix R, sub-transforms of P values so far):
// butterfly i < N/R of a transform takes values i + j N/R, j < R, twiddles
// value j by exp(-+2 pi i j k / (P R)) with k = i mod P, runs its R-point
// DFT and stores value j at (i - k) R + k + j P. A thread holds the
// kPer / R butterflies tid + r T of the block's FR transforms.
template <int LOGN, int S> struct Pass {
  using G = Geometry<LOGN>;
  static constexpr int R = S == 0 ? G::FIRST : 8;
  static constexpr int P = S == 0 ? 1 : G::FIRST << (3 * (S - 1));
  static constexpr int NR = G::N / R;

  // transform (of the block's FR) and butterfly of the thread's r-th
  __device__ static __forceinline__ int transform(int tid, int r) {
    return (tid + r * G::T) / NR;
  }
  __device__ static __forceinline__ int butterfly(int tid, int r) {
    return (tid + r * G::T) % NR;
  }

  __device__ static __forceinline__ void load(float2 (&v)[kPer],
                                              const float* re,
                                              const float* im, int tid) {
#pragma unroll
    for (int r = 0; r < kPer / R; ++r) {
      const int base = transform(tid, r) * G::N + butterfly(tid, r);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int at = padded(base + j * NR);
        v[r * R + j] = make_float2(re[at], im[at]);
      }
    }
  }

  template <bool kInv>
  __device__ static __forceinline__ void compute(
      float2 (&v)[kPer], const float2* __restrict__ twiddle, int tid) {
#pragma unroll
    for (int r = 0; r < kPer / R; ++r) {
      if constexpr (P > 1) {
        const int k = butterfly(tid, r) % P;
#pragma unroll
        for (int j = 1; j < R; ++j) {
          float2 w = __ldg(twiddle + j * k * (G::N / (P * R)));
          if (kInv) w.y = -w.y;
          v[r * R + j] = cmul(v[r * R + j], w);
        }
      }
      dft<R, kInv>(v + r * R);
    }
  }

  __device__ static __forceinline__ void store(const float2 (&v)[kPer],
                                               float* re, float* im,
                                               int tid) {
#pragma unroll
    for (int r = 0; r < kPer / R; ++r) {
      const int i = butterfly(tid, r), k = i % P;
      const int base = transform(tid, r) * G::N + (i - k) * R + k;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int at = padded(base + j * P);
        re[at] = v[r * R + j].x;
        im[at] = v[r * R + j].y;
      }
    }
  }
};

// Passes S.. of the block's transforms. v holds pass 0's inputs (S == 0,
// loaded by the caller); the result ends in re/im in natural order, visible
// to every thread.
template <int LOGN, bool kInv, int S = 0>
__device__ __forceinline__ void fft_passes(float2 (&v)[kPer], float* re,
                                           float* im,
                                           const float2* __restrict__ twiddle,
                                           int tid) {
  using Q = Pass<LOGN, S>;
  if constexpr (S > 0) Q::load(v, re, im, tid);
  Q::template compute<kInv>(v, twiddle, tid);
  if constexpr (S > 0) __syncthreads();  // every read of the pass is done
  Q::store(v, re, im, tid);
  __syncthreads();
  if constexpr (S + 1 < Geometry<LOGN>::PASSES)
    fft_passes<LOGN, kInv, S + 1>(v, re, im, twiddle, tid);
}

// Forward: block (group g of FR frames, batch row b). z = w x_pred + i w
// x_target of each frame, zero-padded at the end; the loss of its bins
// 0..N/2 and their U; one partial sum per block.
template <int LOGN>
__global__ void __launch_bounds__(Geometry<LOGN>::T)
    spectral_fft_fwd_kernel(SpectralParams P) {
  using G = Geometry<LOGN>;
  using Q = Pass<LOGN, 0>;
  constexpr int N = G::N;
  __shared__ float re[G::SMEM];
  __shared__ float im[G::SMEM];
  __shared__ float red[33];

  const int b = blockIdx.y, f0 = blockIdx.x * G::FR, tid = threadIdx.x;
  const float* xp = P.pred + (size_t)b * P.length + P.start;
  const float* xt = P.target + (size_t)b * P.length + P.start;

  float2 v[kPer];
#pragma unroll
  for (int r = 0; r < kPer / Q::R; ++r) {
    const int f = f0 + Q::transform(tid, r);
    const int i = Q::butterfly(tid, r);
#pragma unroll
    for (int j = 0; j < Q::R; ++j) {
      const int n = i + j * Q::NR;
      float2 z = make_float2(0.f, 0.f);
      if (n < P.win && f < P.frames) {
        const size_t off = (size_t)f * P.hop + n;
        const float w = __ldg(P.window + n);
        z = make_float2(w * __ldg(xp + off), w * __ldg(xt + off));
      }
      v[r * Q::R + j] = z;
    }
  }
  fft_passes<LOGN, false>(v, re, im, P.twiddle, tid);

  float sum = 0.f;
  const int two_f = 2 * P.n_freq;
  for (int idx = tid; idx < G::FR * P.n_freq; idx += G::T) {
    const int fr = idx / P.n_freq, k = idx % P.n_freq;
    const int f = f0 + fr;
    if (f >= P.frames) break;
    const int a = padded(fr * N + k), c = padded(fr * N + ((N - k) & (N - 1)));
    // P = (Z[k] + conj Z[N-k]) / 2, T = (Z[k] - conj Z[N-k]) / 2i; the
    // basis's +sin gives im = -Im
    const float re_p = 0.5f * (re[a] + re[c]);
    const float im_p = 0.5f * (im[c] - im[a]);
    const float re_t = 0.5f * (im[a] + im[c]);
    const float im_t = 0.5f * (re[a] - re[c]);
    bin_loss(P, re_p, im_p, re_t, im_t,
             P.u == nullptr ? nullptr
                            : P.u + ((size_t)b * P.frames + f) * two_f,
             k, sum);
  }
  sum = block_sum(sum, red);
  if (tid == 0) P.partial[(size_t)b * gridDim.x + blockIdx.x] = sum;
}

// Backward: block (group g of 2 FR frames, batch row b). Frames 2s and
// 2s + 1 of the group share transform s: Y = H_1 + i H_2 with H the
// Hermitian spectrum H[0] = U_re[0], H[N/2] = U_re[N/2], H[k] = (U_re[k]
// - i U_im[k]) / 2 = conj H[N - k], whose inverse transform is real; then
// frame_grad[b, f, n] = w[n] y_f[n] for n < win.
template <int LOGN>
__global__ void __launch_bounds__(Geometry<LOGN>::T)
    spectral_fft_bwd_kernel(SpectralParams P) {
  using G = Geometry<LOGN>;
  using Q = Pass<LOGN, 0>;
  constexpr int N = G::N, H = N / 2;
  __shared__ float re[G::SMEM];
  __shared__ float im[G::SMEM];

  const int b = blockIdx.y, f0 = blockIdx.x * 2 * G::FR, tid = threadIdx.x;
  const int two_f = 2 * P.n_freq;
  const __nv_bfloat16* U = P.u_in + (size_t)b * P.frames * two_f;

  float2 v[kPer];
#pragma unroll
  for (int r = 0; r < kPer / Q::R; ++r) {
    const int f = f0 + 2 * Q::transform(tid, r);
    const int i = Q::butterfly(tid, r);
#pragma unroll
    for (int j = 0; j < Q::R; ++j) {
      const int m = i + j * Q::NR;
      const int k = m <= H ? m : N - m;
      float a1 = 0.f, b1 = 0.f, a2 = 0.f, b2 = 0.f;
      if (f < P.frames) {
        a1 = __bfloat162float(U[(size_t)f * two_f + k]);
        b1 = __bfloat162float(U[(size_t)f * two_f + P.n_freq + k]);
      }
      if (f + 1 < P.frames) {
        a2 = __bfloat162float(U[(size_t)(f + 1) * two_f + k]);
        b2 = __bfloat162float(U[(size_t)(f + 1) * two_f + P.n_freq + k]);
      }
      float2 y;
      if (m == 0 || m == H)
        y = make_float2(a1, a2);
      else if (m < H)
        y = make_float2(0.5f * (a1 + b2), 0.5f * (a2 - b1));
      else
        y = make_float2(0.5f * (a1 - b2), 0.5f * (a2 + b1));
      v[r * Q::R + j] = y;
    }
  }
  fft_passes<LOGN, true>(v, re, im, P.twiddle, tid);

  for (int idx = tid; idx < G::FR * P.win; idx += G::T) {
    const int s = idx / P.win, n = idx % P.win;
    const int f = f0 + 2 * s;
    if (f >= P.frames) break;
    const int at = padded(s * N + n);
    const float w = __ldg(P.window + n);
    float* out = P.frame_grad + ((size_t)b * P.frames + f) * P.win + n;
    out[0] = w * re[at];
    if (f + 1 < P.frames) out[P.win] = w * im[at];
  }
}

// d_pred[b, start + j hop + h] = g sum_{c < m} frame_grad[b, j - c, c hop +
// h] over the frames that exist; one thread per output sample.
__global__ void spectral_overlap_add_kernel(SpectralParams P) {
  const int m = P.win / P.hop;
  const int span = (P.frames + m - 1) * P.hop;
  const int t = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (t >= span) return;
  const int j = t / P.hop, h = t % P.hop;
  const float* fg = P.frame_grad + (size_t)b * P.frames * P.win;
  float s = 0.f;
  for (int c = 0; c < m; ++c) {
    const int f = j - c;
    if (f >= 0 && f < P.frames) s += fg[(size_t)f * P.win + c * P.hop + h];
  }
  P.d_pred[(size_t)b * P.length + P.start + t] = *P.grad * s;
}

template <int LOGN>
int fft_forward(const SpectralParams& P, cudaStream_t s) {
  using G = Geometry<LOGN>;
  const dim3 grid((P.frames + G::FR - 1) / G::FR, P.batch);
  spectral_fft_fwd_kernel<LOGN><<<grid, G::T, 0, s>>>(P);
  ISI_CHECK();
  spectral_reduce_kernel<<<1, 1024, 0, s>>>(P.partial, P.batch, grid.x,
                                            P.rows, P.total);
  ISI_CHECK();
  return 0;
}

template <int LOGN>
int fft_backward(const SpectralParams& P, cudaStream_t s) {
  using G = Geometry<LOGN>;
  const dim3 grid((P.frames + 2 * G::FR - 1) / (2 * G::FR), P.batch);
  spectral_fft_bwd_kernel<LOGN><<<grid, G::T, 0, s>>>(P);
  ISI_CHECK();
  const int span = (P.frames + P.win / P.hop - 1) * P.hop;
  spectral_overlap_add_kernel<<<dim3((span + 255) / 256, P.batch), 256, 0,
                                s>>>(P);
  ISI_CHECK();
  return 0;
}

// log2 n_fft for the FFT route's sizes, else -1
int fft_log2(int n_fft) {
  for (int l = 6; l <= 12; ++l)
    if (n_fft == 1 << l) return l;
  return -1;
}

template <template <int> class Fn>
int dispatch_log2(int l, const SpectralParams& P, cudaStream_t s) {
  switch (l) {
    case 6: return Fn<6>::run(P, s);
    case 7: return Fn<7>::run(P, s);
    case 8: return Fn<8>::run(P, s);
    case 9: return Fn<9>::run(P, s);
    case 10: return Fn<10>::run(P, s);
    case 11: return Fn<11>::run(P, s);
    case 12: return Fn<12>::run(P, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int LOGN> struct FftForward {
  static int run(const SpectralParams& P, cudaStream_t s) {
    return fft_forward<LOGN>(P, s);
  }
};
template <int LOGN> struct FftBackward {
  static int run(const SpectralParams& P, cudaStream_t s) {
    return fft_backward<LOGN>(P, s);
  }
};

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

extern "C" int isi_spectral_fft_forward(const SpectralParams* P,
                                        void* stream) {
  const int l = fft_log2(P->n_fft);
  if (!valid(P) || l < 0 || P->n_freq != P->n_fft / 2 + 1 ||
      P->win > P->n_fft || P->round_bf16)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_log2<FftForward>(l, *P, static_cast<cudaStream_t>(stream));
}

extern "C" int isi_spectral_fft_backward(const SpectralParams* P,
                                         void* stream) {
  const int l = fft_log2(P->n_fft);
  if (!valid(P) || l < 0 || P->n_freq != P->n_fft / 2 + 1 ||
      P->win > P->n_fft || P->win % P->hop != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_log2<FftBackward>(l, *P, static_cast<cudaStream_t>(stream));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
