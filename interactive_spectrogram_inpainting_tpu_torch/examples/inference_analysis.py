"""Research analysis driver (Inference.ipynb equivalent).

The reference's ``Inference.ipynb`` performs: reconstruction QA
(original vs VQ-VAE round trip, per-criterion metrics), codebook usage
histograms, latent interpolation between two sounds, and code corruption
probes, exporting paper figures and audio. This module runs the same
analyses headlessly over a list of wavs and writes, under
``--output_directory``, the JAX script's files:

- ``reconstruction_metrics.json``: ``mse`` of the spectrograms,
  ``spectral_ddsp`` and ``spectral_jukebox`` of the audio (on the GPU
  through the spectral-loss kernel), ``perplexity_top`` /
  ``perplexity_bottom``;
- ``<stem>-original.wav`` and ``<stem>-reconstruction.wav`` of each input;
- ``interpolation.wav``: the first two sounds' quantized maps blended in
  ``--interpolation_steps`` steps, each decoded;
- ``corrupted_codes.wav``: the bottom codes moved by -1, 0 or +1 (drawn
  from ``np.random.default_rng(0)``), decoded;
- ``reconstructions.png``, ``code_usage_top.png`` and
  ``code_usage_bottom.png`` where matplotlib is installed (one log line
  instead where it is not).

Usage (on the GPU unless ``--device cpu``):
    python -m interactive_spectrogram_inpainting_tpu_torch.examples.inference_analysis \
        --vqvae_model_parameters_path RUN/vqvae-model_parameters.json \
        --vqvae_weights_path RUN/vqvae-weights.msgpack \
        --vqvae_training_parameters_path RUN/command_line_parameters.json \
        --audio_paths a.wav b.wav --output_directory analysis/
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from ..data.wav import write_wav
from ..signal.spectrogram import get_spectrograms_helper
from ..train.losses import make_ddsp_loss, make_jukebox_loss, mse_loss
from ..utils import visualization
from ..utils.checkpoint_io import vqvae_from_parameters_and_weights
from ..utils.device import resolve_device, set_float32_precision


def write_figures(out: pathlib.Path, helper, specs: np.ndarray,
                  dec: np.ndarray, codes) -> None:
    """The reconstructions' mel images and the two code-usage histograms."""
    if not visualization.have_matplotlib():
        print("figures skipped: matplotlib is not installed")
        return
    visualization.save_figure(visualization.plot_mel_representations_batch(
        np.concatenate([specs[:, 0], dec[:, 0]]),
        np.concatenate([specs[:, 1], dec[:, 1]]),
        hop_length=helper.hop_length, fs_hz=helper.fs_hz),
        out / "reconstructions.png")
    for name, ids, n in codes:
        counts = visualization.code_usage_histogram([ids], n)
        visualization.save_figure(
            visualization.plot_code_usage(counts, f"{name} codebook"),
            out / f"code_usage_{name}.png")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vqvae_model_parameters_path", required=True)
    p.add_argument("--vqvae_weights_path", required=True)
    p.add_argument("--vqvae_training_parameters_path", required=True)
    p.add_argument("--audio_paths", nargs="+", required=True)
    p.add_argument("--output_directory", default="analysis")
    p.add_argument("--interpolation_steps", type=int, default=5)
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
    config = model.config
    ddsp = make_ddsp_loss()
    jukebox = make_jukebox_loss()

    with torch.no_grad():
        specs = torch.cat([helper.from_wavfile(path, device=device)
                           for path in args.audio_paths])

        # 1. reconstruction QA with the reference's metric trio
        dec, _, perp_t, perp_b, id_t, id_b = model(specs)
        audio_orig = helper.to_audio(specs)
        audio_rec = helper.to_audio(dec)
        metrics = {
            "mse": float(mse_loss(dec, specs)),
            "spectral_ddsp": float(ddsp(audio_rec, audio_orig)),
            "spectral_jukebox": float(jukebox(audio_rec, audio_orig)),
            "perplexity_top": float(perp_t),
            "perplexity_bottom": float(perp_b),
        }
        (out / "reconstruction_metrics.json").write_text(
            json.dumps(metrics, indent=2))
        audio_orig = audio_orig.cpu().numpy()
        audio_rec = audio_rec.cpu().numpy()
        for i, path in enumerate(args.audio_paths):
            stem = pathlib.Path(path).stem
            write_wav(out / f"{stem}-original.wav", audio_orig[i],
                      helper.fs_hz)
            write_wav(out / f"{stem}-reconstruction.wav", audio_rec[i],
                      helper.fs_hz)

        # 2. figures: reconstructions and code usage
        write_figures(out, helper, specs.cpu().numpy(), dec.cpu().numpy(),
                      (("top", id_t.cpu().numpy(), config.n_embed_t),
                       ("bottom", id_b.cpu().numpy(), config.n_embed_b)))

        # 3. latent interpolation between the first two sounds
        if len(args.audio_paths) >= 2:
            qt, qb = model.encode(specs[:2])[:2]
            frames = []
            for a in np.linspace(0, 1, args.interpolation_steps):
                a = float(a)
                dec_i = model.decode((1 - a) * qt[0:1] + a * qt[1:2],
                                     (1 - a) * qb[0:1] + a * qb[1:2])
                frames.append(helper.to_audio(dec_i)[0].cpu().numpy())
            write_wav(out / "interpolation.wav", np.concatenate(frames),
                      helper.fs_hz)

        # 4. code-corruption probe: random +/-1 on the bottom codes
        rng = np.random.default_rng(0)
        ids_b = id_b.cpu().numpy()
        corrupted_b = (ids_b + rng.integers(-1, 2, ids_b.shape)) \
            % config.n_embed_b
        dec_corrupt = model.decode_code(
            id_t, torch.as_tensor(corrupted_b, device=device))
        write_wav(out / "corrupted_codes.wav",
                  helper.to_audio(dec_corrupt).cpu().numpy().reshape(-1),
                  helper.fs_hz)

    print(json.dumps(metrics, indent=2))
    print("analysis written to", out)
    return metrics


if __name__ == "__main__":
    main()
