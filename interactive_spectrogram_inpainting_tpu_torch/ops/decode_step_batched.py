"""Batched fused decode step (hand-written CUDA for sm_90a).

Replaces the Pallas kernel
``interactive_spectrogram_inpainting_tpu/ops/decode_step_batched.py::
fused_decode_step_batched``: the token step of ``decode_step_kernel.py`` for
batches above 4 on aligned decoders (the bottom prior sampled for a whole
pitch range at once). Whole-batch weight products, attention over the cache
rows ``< pos`` in chunks with a running softmax plus the fresh position,
the aligned value gather, MLP, logits, Gumbel argmax and the K/V write-back.

What carries over from the JAX function is its contract, not its layout:
the cache keeps the ``[n_layers, 2, B, l_pad, d]`` order of the small-batch
kernel (the JAX kernel's ``[l_pad, B, d]`` order and its ``block_k`` /
``block_b`` arguments served its chunk copies), and the memory values come
as ``mem_v [n_layers, B, E_pad, d]``.

``fused_decode_step_batched`` launches ``csrc/decode_step_batched.cu`` (one
persistent cooperative launch a step, through the per-generation
``StepPlan`` of ``decode_step_kernel.py``) for CUDA tensors and runs
``decode_step_batched_plain`` for CPU tensors, never falling back from one
to the other. ``fused_decode_step_batched.launches`` counts its kernel
launches (one per step that reaches the GPU).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .decode_step_kernel import ATTN_CHUNK, step_plain, step_plan


def decode_step_batched_plain(params, bias_hm, posfull, mem_v, kv, token_in,
                              cur_token, pos, i_index, is_masked, gumbel,
                              temperature, *, n_class, channels, out=None):
    """Plain PyTorch version of the kernel (same arguments, same result):
    the cache is streamed in chunks of 128 rows with a running softmax."""
    new_tok, kv = step_plain(
        params, bias_hm, posfull, (mem_v, mem_v), kv, token_in, cur_token,
        pos, i_index, is_masked, gumbel, temperature, n_class=n_class,
        channels=channels, chunk=ATTN_CHUNK)
    if out is not None:
        out.copy_(new_tok)
        new_tok = out
    return new_tok, kv


def fused_decode_step_batched(params: Dict[str, torch.Tensor],
                              bias_hm: torch.Tensor, posfull: torch.Tensor,
                              mem_v: torch.Tensor, kv: torch.Tensor,
                              token_in: torch.Tensor,
                              cur_token: torch.Tensor, pos: int,
                              i_index: int, is_masked: bool,
                              gumbel: torch.Tensor, temperature: float, *,
                              n_class: int, channels: int,
                              out: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused decode step for a large batch of an aligned decoder.

    Arguments as ``fused_decode_step`` without the cross-attention tables:
    mem_v [n_layers, B, E_pad, d] (the value row ``pos // channels`` of
    every sequence is gathered; zeros past ``E_pad``); kv [n_layers, 2, B,
    l_pad, d], updated in place. Returns (new_token [B, 1], kv)."""
    plan = step_plan("fused_decode_step_batched", params, bias_hm, posfull,
                     (mem_v, mem_v), kv, n_class=n_class, channels=channels,
                     temperature=temperature)
    out = plan.bind(token_in, cur_token, pos, i_index, is_masked, gumbel,
                    out)
    if kv.device.type != "cuda":
        return decode_step_batched_plain(
            params, bias_hm, posfull, mem_v, kv, token_in, cur_token, pos,
            i_index, is_masked, gumbel, temperature, n_class=n_class,
            channels=channels, out=out)
    plan.launch()
    fused_decode_step_batched.launches += 1
    return out, kv


fused_decode_step_batched.launches = 0
