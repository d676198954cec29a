// Tensor-core products with mma.sync, shared by the kernels that run
// them (train_attention.cu, prefix_prime.cu): bfloat16 as m16n8k16;
// float32 as split TF32, m16n8k8 three times per product (hi*lo + lo*hi +
// hi*hi, where hi = tf32(x) and lo = tf32(x - hi): about 21 bits of each
// operand, so float32's tolerances hold; one TF32 pass keeps about three
// digits). Every product accumulates in float32.
#pragma once

#include "common.cuh"

namespace isi {

// Lane (g = lane / 4, t = lane % 4) of a warp holds, of a 16 x 8 float32
// accumulator, c[0] = (g, 2t), c[1] = (g, 2t + 1), c[2] = (g + 8, 2t),
// c[3] = (g + 8, 2t + 1).

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x % kWarp) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// Fragments of one warp's product C[16 x 8] += A[16 x KS] B[KS x 8], read
// from shared memory or taken from accumulators:
//   load_a(s, ld, k0)         A = s[0..16)[k0..k0 + KS)      (s row-major)
//   load_b_nk(s, lo, ld, n0, k0)  B[k][n] = s[n0 + n][k0 + k]  (s: [n][k])
//   load_b_kn(s, lo, ld, k0, n0)  B[k][n] = s[k0 + k][n0 + n]  (s: [k][n])
//                             (float32: s holds the tf32 hi parts and lo
//                             the lo parts, split once per block by
//                             split_tile; bfloat16 ignores lo)
//   c_to_a(c, j)              A = T(the accumulators of columns
//                             [j KS, (j + 1) KS)), for P V-like products
template <typename T> struct Mma;

// float32 as split TF32. c_to_a takes a 16 x 8 accumulator block whose
// columns lie at 2t and 2t + 1 of lane t, while an m16n8k8 A fragment wants
// t and t + 4: the contraction order is permuted instead (A's k = t is
// column 2t, k = t + 4 is column 2t + 1), and load_b_kn reads B's rows in
// the same permuted order. A sum does not depend on its order of terms
// but for rounding.
template <> struct Mma<float> {
  static constexpr int KS = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ A make_a(float a0, float a1, float a2,
                                             float a3) {
    A a;
    split(a0, a.hi[0], a.lo[0]);
    split(a1, a.hi[1], a.lo[1]);
    split(a2, a.hi[2], a.lo[2]);
    split(a3, a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ void run(float (&c)[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  static __device__ __forceinline__ A load_a(const float* s, int ld, int k0) {
    const int g = lane_g(), t = lane_t();
    const float* p = s + g * ld + k0 + t;
    return make_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
  }
  static __device__ __forceinline__ uint32_t bits(float x) {
    return __float_as_uint(x);
  }
  // B from a tile split once per block (split_tile): hi in place, lo beside
  static __device__ __forceinline__ B load_b_nk(const float* hi,
                                                const float* lo, int ld,
                                                int n0, int k0) {
    const int i = (n0 + lane_g()) * ld + k0 + lane_t();
    return B{{bits(hi[i]), bits(hi[i + 4])}, {bits(lo[i]), bits(lo[i + 4])}};
  }
  static __device__ __forceinline__ B load_b_kn(const float* hi,
                                                const float* lo, int ld,
                                                int k0, int n0) {
    const int i = (k0 + 2 * lane_t()) * ld + n0 + lane_g();
    return B{{bits(hi[i]), bits(hi[i + ld])},
             {bits(lo[i]), bits(lo[i + ld])}};
  }
  static __device__ __forceinline__ A c_to_a(const float (*c)[4], int j) {
    return make_a(c[j][0], c[j][2], c[j][1], c[j][3]);
  }
};

template <> struct Mma<__nv_bfloat16> {
  static constexpr int KS = 16;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };
  using T = __nv_bfloat16;

  static __device__ __forceinline__ uint32_t word(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pair(T lo, T hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
           | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
  }
  static __device__ __forceinline__ uint32_t pair(float lo, float hi) {
    return pair(__float2bfloat16(lo), __float2bfloat16(hi));
  }
  static __device__ __forceinline__ void run(float (&c)[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.x, b.x);
  }
  static __device__ __forceinline__ A load_a(const T* s, int ld, int k0) {
    const T* p = s + lane_g() * ld + k0 + 2 * lane_t();
    return A{{word(p), word(p + 8 * ld), word(p + 8), word(p + 8 * ld + 8)}};
  }
  static __device__ __forceinline__ B load_b_nk(const T* s, const T*, int ld,
                                                int n0, int k0) {
    const T* p = s + (n0 + lane_g()) * ld + k0 + 2 * lane_t();
    return B{{word(p), word(p + 8)}};
  }
  static __device__ __forceinline__ B load_b_kn(const T* s, const T*, int ld,
                                                int k0, int n0) {
    const T* p = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
    return B{{pair(p[0], p[ld]), pair(p[8 * ld], p[9 * ld])}};
  }
  static __device__ __forceinline__ A c_to_a(const float (*c)[4], int j) {
    const float* x = c[2 * j];
    const float* y = c[2 * j + 1];
    return A{{pair(x[0], x[1]), pair(x[2], x[3]), pair(y[0], y[1]),
              pair(y[2], y[3])}};
  }
};


__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace isi
