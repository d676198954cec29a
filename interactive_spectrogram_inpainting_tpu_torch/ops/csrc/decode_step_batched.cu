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
// of the small-batch kernel (a head's key row is 128 contiguous bytes) and
// the step is the one persistent cooperative launch of
// decode_step_persistent.cuh. The weight products take the batch in groups
// of 16 sequences on the tensor cores in bf16, so B = 16 reads the weights
// from device memory once and B = 64 stages its four groups at once, each
// warp taking its weight slice through all four (the re-reads hit L1). The
// attention's chunk intermediates are rounded to the cache dtype where the
// TPU kernel rounds them, so bfloat16 runs sample what the JAX package
// samples.
#include "decode_step_persistent.cuh"

using namespace isi;

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_decode_step_batched(const StepParams* P, int dtype,
                                       void* stream) {
  if (!P->aligned) return cudaErrorInvalidValue;
  return step_entry<true>(P, dtype, stream);
}

// info[7]: see step_info. Returns a cudaError_t code (a refused shape).
extern "C" int isi_decode_step_batched_info(const StepParams* P, int dtype,
                                            int* info) {
  if (!P->aligned) return cudaErrorInvalidValue;
  return step_info_entry<true>(P, dtype, info);
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
