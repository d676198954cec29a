"""Batch audio restyling through the VQ-VAE (process_audio.ipynb
equivalent): run arbitrary wavs through encode -> quantize -> decode,
using the model as an "effect", and write the processed audio as
``<output_directory>/<stem>-vqvae.wav``.

Usage (on the GPU unless ``--device cpu``):
    python -m interactive_spectrogram_inpainting_tpu_torch.examples.process_audio \
        --vqvae_model_parameters_path ... --vqvae_weights_path ... \
        --vqvae_training_parameters_path ... \
        --input_wavs in/*.wav --output_directory processed/
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

from ..data.wav import write_wav
from ..signal.spectrogram import get_spectrograms_helper
from ..utils.checkpoint_io import vqvae_from_parameters_and_weights
from ..utils.device import resolve_device, set_float32_precision


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vqvae_model_parameters_path", required=True)
    p.add_argument("--vqvae_weights_path", required=True)
    p.add_argument("--vqvae_training_parameters_path", required=True)
    p.add_argument("--input_wavs", nargs="+", required=True)
    p.add_argument("--output_directory", default="processed")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision()

    out = pathlib.Path(args.output_directory)
    out.mkdir(parents=True, exist_ok=True)
    with open(args.vqvae_training_parameters_path) as f:
        training_params = json.load(f)
    helper = get_spectrograms_helper(**training_params)
    model = vqvae_from_parameters_and_weights(
        args.vqvae_model_parameters_path, args.vqvae_weights_path).to(device)

    written = []
    for path in args.input_wavs:
        with torch.no_grad():
            dec = model(helper.from_wavfile(path, device=device))[0]
            audio = helper.to_audio(dec)[0].cpu().numpy()
        target = out / (pathlib.Path(path).stem + "-vqvae.wav")
        write_wav(target, audio, helper.fs_hz)
        print("wrote", target)
        written.append(target)
    return written


if __name__ == "__main__":
    main()
