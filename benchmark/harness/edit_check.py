"""The serving cell's comparison with the plain reference, and the model
operations of an interaction: the parts of ``drivers/edit_loop.py`` that
need torch, imported once the card has been checked."""

from __future__ import annotations

import numpy as np
import torch

from harness import flops, serve_child
from harness.edits import column_masks
from harness.seeds import derive
from harness.weights import make_parameters
from reference import prior as ref_prior
from reference import vqvae as ref_vqvae

CHECK_BLOCK = 16  # interactions the reference takes at once


def edit_ops(cfg: dict, cols):
    """(bf16 ops, float32 ops) of one interaction: both priors' prime and
    scan in bfloat16; their encoders and memory projections, the VQ-VAE
    decode and the mel inverse in float32."""
    bf16 = f32 = 0
    for which in ("top_prior", "bottom_prior"):
        g = ref_prior.Geometry(cfg[which])
        per_column = g.l_t // g.t_t if g.self_conditional else (
            g.l_t // cfg["top_prior"]["shape"][1])
        p0, steps = flops.scan_window(g, cols[0] * per_column,
                                      cols[1] * per_column - 1)
        bf16 += flops.prime_ops(g, p0) + flops.scan_ops(g, p0, steps)
        f32 += flops.encoder_ops(g) + flops.memory_ops(g)
    f32 += flops.vqvae_decode_ops(cfg["vqvae"], cfg["top_prior"]["shape"],
                                  cfg["spectrogram"])
    return bf16, f32


def reference_readings(ctx, records):
    """Every interaction of the window against the plain reference, on the
    device, in blocks of ``CHECK_BLOCK``:

    - ``token_gap``: the widest gap, over every sampled token of both
      priors, by which the served token's score (logit over the
      temperature plus its Gumbel noise) lies below the reference's best;
    - ``kept_changed``: cells outside the mask whose code changed;
    - ``audio_lsb``: the largest difference, in 16-bit steps, between the
      served WAV and the reference's decode of the served codes.

    With ``ctx.control``, also the control's readings: ``token_gap``, the
    gap under the float32 reference of the token that the reference
    computed in float8 (below the sampling's bfloat16) ranks first; and
    ``audio_lsb``, the reference's playback in TF32 (below the decode's
    float32) against its float32 playback."""
    cfg, dev = ctx.config, ctx.device
    temperature = float(ctx.mix["temperature"])
    params = {which: make_parameters(
        ref_prior.parameter_spec(ref_prior.Geometry(cfg[which])),
        derive(ctx.seed, "weights", which), dev)
        for which in ("top_prior", "bottom_prior")}
    vq = make_parameters(ref_vqvae.parameter_spec(cfg["vqvae"]),
                         derive(ctx.seed, "weights", "vqvae"), dev)
    gap = control_gap = 0.0
    kept = lsb = control_lsb = 0
    for i in range(0, len(records), CHECK_BLOCK):
        block = records[i:i + CHECK_BLOCK]
        labels = {name: torch.as_tensor(
            [classes.index(r["label"][name]) for r in block], device=dev)
            for name, classes in cfg["labels"].items()}
        masks, bottom_masks = (np.stack(m) for m in zip(
            *(column_masks(cfg, r["cols"]) for r in block)))
        top_in = torch.as_tensor(np.stack([r["top_in"] for r in block]),
                                 device=dev)
        top_out = torch.as_tensor(np.stack([r["top_out"] for r in block]),
                                  device=dev)
        bottom_out = torch.as_tensor(
            np.stack([r["bottom_out"] for r in block]), device=dev)
        kept += int((np.stack([r["top_out"] for r in block])
                     != np.stack([r["top_in"] for r in block]))[~masks].sum())
        kept += int((np.stack([r["bottom_out"] for r in block])
                     != np.stack([r["bottom_in"] for r in block])
                     )[~bottom_masks].sum())
        for which, cond, target, mask in (
                ("top_prior", top_in, top_out, masks),
                ("bottom_prior", top_out, bottom_out, bottom_masks)):
            g = ref_prior.Geometry(cfg[which])
            mask_t = torch.as_tensor(mask, device=dev)
            noise = torch.stack([serve_child.edit_noise(
                cfg, ctx.seed, which.split("_")[0], r["edit"], dev)
                for r in block])[:, g.channels - 1:]
            order = ref_prior.target_order(g)
            served = ref_prior.to_sequence(target, order)
            sampled = ref_prior.to_sequence(mask_t, order)
            with torch.no_grad():
                logits = ref_prior.forward(params[which], g, cond, target,
                                           labels, source_mask=mask_t)
                scores = logits / temperature + noise
                gaps = scores.max(-1).values - scores.gather(
                    -1, served[..., None])[..., 0]
                gap = max(gap, float(gaps[sampled].max()))
                if ctx.control:
                    low = ref_prior.forward(params[which], g, cond, target,
                                            labels, source_mask=mask_t,
                                            prec=ref_prior.FLOAT8)
                    pick = (low / temperature + noise).argmax(-1)
                    low_gaps = scores.max(-1).values - scores.gather(
                        -1, pick[..., None])[..., 0]
                    control_gap = max(control_gap,
                                      float(low_gaps[sampled].max()))
        audio = playback(vq, cfg, top_out, bottom_out)
        for r, a in zip(block, audio):
            served_pcm = r["pcm"].astype(np.int32)
            lsb = max(lsb, pcm_gap(served_pcm, a))
        if ctx.control:
            low = playback(vq, cfg, top_out, bottom_out, tf32=True)
            for a, b in zip(audio, low):
                control_lsb = max(control_lsb, pcm_gap(a, b))
    readings = {"token_gap": gap, "kept_changed": float(kept),
                "audio_lsb": float(lsb)}
    control = ({"token_gap": control_gap, "audio_lsb": float(control_lsb)}
               if ctx.control else None)
    return readings, control


def playback(vq, cfg, top, bottom, tf32: bool = False) -> np.ndarray:
    """The reference's 16-bit samples of the codes' audio (``tf32``: its
    products and convolutions in TF32, the control of a float32 path)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            audio = ref_vqvae.to_audio(
                ref_vqvae.decode(vq, cfg["vqvae"], top, bottom),
                cfg["spectrogram"]).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    return np.stack([ref_vqvae.pcm16(a) for a in audio]).astype(np.int32)


def pcm_gap(a: np.ndarray, b: np.ndarray) -> int:
    """The largest difference in 16-bit steps (65536 when the lengths
    differ)."""
    if a.shape != b.shape:
        return 1 << 16
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
