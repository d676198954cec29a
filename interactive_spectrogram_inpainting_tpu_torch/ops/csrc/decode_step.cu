// One fused decode step for a small batch.
//
// Replaces: interactive_spectrogram_inpainting_tpu/ops/decode_step_kernel.py
//           ::fused_decode_step (Pallas kernel _fused_step_kernel).
//
// One token step of every sequence of the batch: embed the input token plus
// the positional row, then per decoder layer LN -> qkv, self attention over
// cache rows < pos plus the fresh key with the bias row of pos, cross
// attention (aligned: the value row pos // c; else a softmax over the
// e_src real source rows with the cross-bias row of pos), MLP; final LN,
// logits, / temperature, + Gumbel noise, argmax; the K/V row of pos is
// written into the cache in place.
//
// Bound on the H100: bytes. A step reads every decoder weight once
// (bottom prior, bf16: ~55 MB) for a few MFLOP per sequence, and the cache
// rows below pos of every sequence. The TPU kernel staged each layer's
// weights and the whole cache in VMEM; here every weight product is a
// GEMV-shaped kernel (decode_common.cuh) in which one warp owns an output
// row of a weight stored [out, in], reads it once as 16-byte vectors and
// multiplies it with the inputs of up to 4 sequences held in shared
// memory, so the weights are streamed once per step for the batches of 2
// to 4 this kernel is chosen for (a larger batch, as the relative-bias top
// prior can bring, runs in groups of 4). The LayerNorm in front of a
// product is computed by every block on its own copy of the inputs (a few
// KB), one warp per sequence. Attention is flash-decoding: partials per
// (128-key chunk, head, sequence) and a combine that adds the fresh key
// and stores the new K/V row. The step is one host call that enqueues
// ~8 launches per layer on the stream (~11 with cross attention); no value
// is read back.
#include "decode_common.cuh"

using namespace isi;

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_decode_step(const StepParams* P, int dtype, void* stream) {
  using Lin = GemvLinear<4, false>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 1
                              ? decode_step_run<__nv_bfloat16, Lin>(*P, s)
                              : decode_step_run<float, Lin>(*P, s));
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
