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
// weights and the whole cache in VMEM; no SM holds that, so the weights
// stream from device memory every step. The step is ONE persistent
// cooperative launch (decode_step_persistent.cuh): one block per SM, the
// phases of a layer separated by grid barriers (5 a layer aligned, 8 with
// cross attention, plus 1); the barriers and each phase's memory round
// trips, not the bytes, set its pace. This library serves batches of 2 to 4
// (padded to the 16 rows of a tensor-core product) and the relative-bias
// top prior at any batch (groups of 16).
#include "decode_step_persistent.cuh"

using namespace isi;

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int isi_decode_step(const StepParams* P, int dtype, void* stream) {
  return step_entry<false>(P, dtype, stream);
}

// info[7]: see step_info. Returns a cudaError_t code (a refused shape).
extern "C" int isi_decode_step_info(const StepParams* P, int dtype,
                                    int* info) {
  return step_info_entry<false>(P, dtype, info);
}

extern "C" const char* isi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
