// One fused decode step for a large batch (aligned decoders).
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/decode_step_batched.py
//           ::fused_decode_step_batched (Pallas kernel _batched_step_kernel).
//
// The same step as decode_step.cu for B > 4 sequences: whole-batch
// [B, d] x [d, 3d | d | d_ff] products, attention over the cache rows < pos
// plus the fresh position, the aligned value gather, MLP, logits, Gumbel
// argmax and the K/V write-back.
//
// Bound on the H100: bytes. Per step the ~55 MB of bf16 weights and, per
// sequence, pos cache rows of 2 x d elements in each of the layers; the
// products are B x 2 x 27 M operations, far below the tensor-core rate at
// B = 16 or 64. The TPU kernel kept the batch's activations in VMEM and
// streamed the cache in (block_k, B, d) chunks from a [l_pad, B, d] layout
// chosen for its DMA slices; here the cache keeps the [B, l_pad, d] layout
// of the small-batch kernel (a head's key row is one coalesced 128-byte
// load) and attention is flash-decoding over 128-key chunks
// (decode_common.cuh), which gives B x H x chunks independent blocks; the
// chunk intermediates are rounded to the cache dtype where the TPU kernel
// rounds them, so bfloat16 runs sample what the JAX package samples.
// The weight products take the batch in groups of 16 sequences: a block
// holds its group's inputs in shared memory (up to 128 KB of float32 for
// the MLP's second product) and each of its warps streams one weight row
// against all 16, so B = 16 reads the weights from device memory once and
// B = 64 four times, mostly out of L2. (A first version ran them as a
// tiled CUDA-core GEMM over the B rows: with 16 rows it filled 16 to 64
// blocks that each walked K in 16 to 64 dependent slices, and a step took
// four times as long; PERF.md.) The step is one host call that enqueues
// ~9 launches per layer on the stream.
#include "decode_common.cuh"

using namespace isi;

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_decode_step_batched(const StepParams* P, int dtype,
                                       void* stream) {
  using Lin = GemvLinear<16, true>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!P->aligned) return cudaErrorInvalidValue;
  return static_cast<int>(dtype == 1
                              ? decode_step_run<__nv_bfloat16, Lin>(*P, s)
                              : decode_step_run<float, Lin>(*P, s));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
