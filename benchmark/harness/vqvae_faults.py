"""Faults planted in the VQ-VAE trainer on purpose, to show that the
comparison deciding ``correct`` of a VQ-VAE training cell catches each
fault it can have. The benchmark's own runs plant none; the CPU tests and
``calibrate.py --fault <name>`` do (``drivers/vqvae_steps.py`` takes the
name after ``harness.faults:`` from this module).

A fault edits the parts the driver builds the trainer's steps from,
before it builds them: ``parts`` holds the ``model``, the reconstruction
``criterion``, the ``latent_loss_weight`` and the logged step's metric
trio (``metrics``). The cell runs on one card,
so there is no exchange between cards to leave out.
"""

from __future__ import annotations

import dataclasses


def latent_dropped(parts) -> None:
    """The commitment term left out of the loss."""
    parts["latent_loss_weight"] = 0.0


def ema_skipped(parts) -> None:
    """The codebooks' EMA update skipped: the codes are chosen, the
    codebooks stay as they were."""
    model = parts["model"]
    for quantizer in (model.quantize_t, model.quantize_b):
        quantizer._ema_update = lambda *args, **kwargs: None


def scale_dropped(parts) -> None:
    """The Jukebox loss without its last scale (window 240, FFT 512)."""
    from interactive_spectrogram_inpainting_tpu_torch.train.losses import (
        make_spectral_loss_from_spectrogram)
    criterion = parts["criterion"]
    loss = criterion.loss
    parts["criterion"] = make_spectral_loss_from_spectrogram(
        dataclasses.replace(loss, n_ffts=loss.n_ffts[:-1],
                            hop_lengths=loss.hop_lengths[:-1],
                            window_lengths=loss.window_lengths[:-1]),
        criterion.spectrograms_helper)


def trio_skipped(parts) -> None:
    """The logged step without its metric trio: no inversion to audio for
    the metrics."""
    parts["metrics"] = None


def trio_approximate(parts) -> None:
    """The trio's DDSP and Jukebox with their FFTs on bfloat16 operands
    (``--spectral_precision default``) instead of float32."""
    from interactive_spectrogram_inpainting_tpu_torch.train.losses import (
        get_reconstruction_criterion, mse_loss)
    helper = parts["criterion"].spectrograms_helper
    fns = {"MSE": mse_loss}
    for name in ("DDSP", "Jukebox"):
        fns[name] = get_reconstruction_criterion(name, helper,
                                                 precision="default")

    def compute(dec, spec, reduction="mean"):
        dec = dec.float()
        return {f"metric_{n}": fn(dec, spec, reduction)
                for n, fn in fns.items()}
    parts["metrics"] = compute


TRAINING = ("latent_dropped", "ema_skipped", "scale_dropped", "trio_skipped",
            "trio_approximate")


def resolve(spec):
    """``harness.faults:<name>`` (the name ``calibrate.py`` gives), a bare
    name or a callable -> the fault."""
    if callable(spec):
        return spec
    name = str(spec).split(":")[-1]
    if name not in TRAINING:
        raise ValueError(f"no VQ-VAE training fault named {name!r}: "
                         f"{TRAINING}")
    return globals()[name]
