"""Sampling CLI (the reference's ``sample.py``).

Load a VQ-VAE and the top and bottom priors from their (parameters JSON,
weights) pairs, optionally encode conditioning or constraint audio, sample
top -> bottom -> decode, and write under ``--output_directory``, with a
run id ``<date>-<time>-<6 hex>``:

- ``<run id>.wav``: the decoded audio of every batch row, one after the
  other;
- ``<run id>-codemaps.png``: the top and bottom codemaps;
- ``<run id>-spectrogram.png`` and ``<run id>-instantaneous_frequency.png``:
  the decoded channels;
- ``<run id>-command_line_parameters.json``: the arguments (but
  ``--device``) and the seed.

These are the JAX CLI's files. The images are drawn with numpy and zlib
(viridis where matplotlib is installed, gray where it is not), so the CLI
needs no matplotlib.

Run ``isi-sample-torch`` (or ``python -m
interactive_spectrogram_inpainting_tpu_torch.sampling.cli``) with the JAX
CLI's arguments; it samples on the GPU unless ``--device cpu`` is given.
The fused sampler runs unless ``--top_k_sampling_k`` or
``--top_p_sampling_p`` is set (the fused sampler does not filter): then the
dense scan runs, as the JAX CLI's sampler always does. So does a prior the
fused sampler does not cover (``fused_unsupported``) or, on the GPU, whose
geometry a kernel does not take (``fused_refusal``), with one line that
says why. Noise comes from a
``torch.Generator`` seeded from ``--seed``: the same seed gives the same
sounds on the same device, not the JAX CLI's sounds.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import uuid
from datetime import datetime
from typing import Mapping

import numpy as np
import torch

from ..data.label_encoders import load_label_encoders
from ..data.wav import write_wav
from ..signal.spectrogram import get_spectrograms_helper
from ..utils.checkpoint_io import (prior_from_parameters_and_weights,
                                   vqvae_from_parameters_and_weights)
from ..utils.device import resolve_device, set_float32_precision
from ..utils.visualization import colormapped, encode_png, image_grid
from .sample import fused_refusal, fused_unsupported
from .sample import sample_model as _sample_model


def sample_model(*args, use_predictive_sampling=False, **kwargs):
    """``sample_model``; with predictive sampling, print the reference's
    per-run telemetry (the correct-prediction ratio and the relative
    speedup, reference ``sample.py:335-342``)."""
    if not use_predictive_sampling:
        return _sample_model(*args, **kwargs)
    code, diag = _sample_model(*args, use_predictive_sampling=True,
                               return_diagnostics=True, **kwargs)
    num_forwards = int(diag["num_forwards"])
    num_steps = int(diag["num_steps"])
    ratio = 1.0 - num_forwards / num_steps
    print(f"Ratio of correct predictions: {ratio:.2f}"
          f" ===> Relative speedup: "
          f"{num_steps / max(num_forwards, 1):.2f}")
    return code


def make_conditioning_tensors(class_conditioning: Mapping,
                              label_encoders) -> Mapping[str, torch.Tensor]:
    """str / int / (low, high) range values -> encoded label tensors
    (reference ``sample.py:68-103``)."""
    out = {}
    for modality, value in class_conditioning.items():
        encoder = label_encoders[modality]
        if isinstance(value, (tuple, list)) and len(value) == 2:
            lo, hi = int(value[0]), int(value[1])
            assert lo < hi, "provide an increasing range"
            encoded = encoder.transform(list(range(lo, hi)))
        else:
            if modality == "pitch":
                value = int(value)
            encoded = encoder.transform([value])
        out[modality] = torch.as_tensor(np.asarray(encoded))
    return out


def plot_codes(top_codes: np.ndarray, bottom_codes: np.ndarray,
               n_class_top: int, n_class_bottom: int, output_path):
    """Codemap grid image: the top codemaps above the bottom ones, one
    column a batch row, each code a square of pixels (reference
    ``sample.py:350-390``; drawn with numpy and zlib, no matplotlib)."""
    def panels(codes, n_class):
        scale = max(1, 128 // max(codes.shape[1], 1))
        return [colormapped(c, 0, n_class - 1, scale) for c in codes]

    pathlib.Path(output_path).write_bytes(encode_png(image_grid(
        [panels(top_codes, n_class_top),
         panels(bottom_codes, n_class_bottom)])))


def plot_channels(decoded: np.ndarray, output_directory: pathlib.Path,
                  run_id: str) -> None:
    """One image per channel of the decoded spectrograms [B, 2, F, T],
    the batch rows side by side, each on its own value range, low
    frequencies at the bottom: ``<run id>-spectrogram.png`` and
    ``<run id>-instantaneous_frequency.png``."""
    for channel, name in enumerate(["spectrogram",
                                    "instantaneous_frequency"]):
        grid = image_grid([[colormapped(d[channel], lower=True)
                            for d in decoded]])
        (output_directory / f"{run_id}-{name}.png").write_bytes(
            encode_png(grid))


def use_fused(model, args, device: torch.device) -> bool:
    """Whether the fused sampler serves ``model`` (the same decision as the
    server's); prints why not when a prior's own shape rules it out."""
    if args.top_k_sampling_k != 0 or args.top_p_sampling_p != 0.0:
        return False
    reason = fused_unsupported(model) or (
        fused_refusal(model) if device.type == "cuda" else None)
    if reason is not None:
        print(f"dense sampler: {reason}")
    return reason is None


def key_value(arg: str):
    """``key,value`` (or ``key,low...high``, a range) of the class
    conditioning flags."""
    key, value = arg.split(",", 1)
    if len(value.split("...")) == 2:
        value = value.split("...")
    return key, value


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--vqvae_training_parameters_path", required=True)
    parser.add_argument("--vqvae_model_parameters_path", required=True)
    parser.add_argument("--vqvae_weights_path", required=True)
    parser.add_argument("--prediction_top_parameters_path", required=True)
    parser.add_argument("--prediction_top_weights_path", required=True)
    parser.add_argument("--prediction_bottom_parameters_path",
                        required=True)
    parser.add_argument("--prediction_bottom_weights_path", required=True)
    parser.add_argument("--class_conditioning", type=key_value, nargs="*",
                        default=[])
    parser.add_argument("--class_conditioning_top", type=key_value,
                        nargs="*", default=[])
    parser.add_argument("--class_conditioning_bottom", type=key_value,
                        nargs="*", default=[])
    parser.add_argument("--keep_same_top", action="store_true")
    parser.add_argument("--label_encoders_path", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top_p_sampling_p", type=float, default=0.0)
    parser.add_argument("--top_k_sampling_k", type=int, default=0)
    parser.add_argument("--sample_rate_hz", type=int, default=16000)
    parser.add_argument("--condition_top_audio_path", type=str,
                        default=None)
    parser.add_argument("--constraint_top_audio_path", type=str,
                        default=None)
    parser.add_argument("--constraint_top_num_timesteps", type=int,
                        default=None)
    parser.add_argument("--use_predictive_sampling", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--output_directory", type=str, default="./")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


@torch.no_grad()
def main(argv=None) -> pathlib.Path:
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision()
    run_id = (datetime.now().strftime("%Y%m%d-%H%M%S-")
              + str(uuid.uuid4())[:6])
    print("Sample ID:", run_id)
    output_dir = pathlib.Path(args.output_directory).expanduser().absolute()
    output_dir.mkdir(parents=True, exist_ok=True)

    vqvae = vqvae_from_parameters_and_weights(
        args.vqvae_model_parameters_path, args.vqvae_weights_path).to(device)
    model_top = prior_from_parameters_and_weights(
        args.prediction_top_parameters_path,
        args.prediction_top_weights_path).to(device)
    model_bottom = prior_from_parameters_and_weights(
        args.prediction_bottom_parameters_path,
        args.prediction_bottom_weights_path).to(device)
    with open(args.vqvae_training_parameters_path) as f:
        spectrograms_helper = get_spectrograms_helper(**json.load(f))
    label_encoders = (load_label_encoders(args.label_encoders_path)
                      if args.label_encoders_path else {})

    if args.class_conditioning_top:
        assert args.class_conditioning_bottom
        cc_top = dict(args.class_conditioning_top)
        cc_bottom = dict(args.class_conditioning_bottom)
    else:
        cc_top = cc_bottom = dict(args.class_conditioning)
    cc_top_tensors = make_conditioning_tensors(cc_top, label_encoders)
    cc_bottom_tensors = make_conditioning_tensors(cc_bottom, label_encoders)

    seed = args.seed if args.seed is not None else np.random.SeedSequence(
    ).entropy % (2 ** 31)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    options = dict(temperature=args.temperature,
                   top_p_sampling_p=args.top_p_sampling_p,
                   top_k_sampling_k=args.top_k_sampling_k,
                   use_predictive_sampling=args.use_predictive_sampling,
                   device=device)
    top_options = dict(options,
                       use_fused_step=use_fused(model_top, args, device))
    bottom_options = dict(
        options, use_fused_step=use_fused(model_bottom, args, device))

    def encode(path):
        spec = spectrograms_helper.from_wavfile(path, device=device)
        return vqvae.encode_codes_only(spec)

    initial_code = None
    if args.condition_top_audio_path:
        cond_top, cond_bottom = encode(args.condition_top_audio_path)
        top_code = cond_top.expand((args.batch_size,) + cond_top.shape[1:])
        initial_code = cond_bottom.expand(
            (args.batch_size,) + cond_bottom.shape[1:])
    elif args.constraint_top_audio_path:
        # fix the first (num_timesteps - 1) time columns of the top codemap
        # from the encoded audio and generate the rest (the reference's
        # documented intent, sample.py:438-439,535-551)
        assert args.constraint_top_num_timesteps is not None, (
            "--constraint_top_audio_path requires "
            "--constraint_top_num_timesteps")
        cons_top, _ = encode(args.constraint_top_audio_path)
        shape = tuple(model_top.config.shape)
        keep = max(0, min(args.constraint_top_num_timesteps - 1, shape[1]))
        init_top = torch.zeros((1,) + shape, dtype=torch.int32,
                               device=device)
        init_top[..., :keep] = cons_top.to(torch.int32)[..., :shape[0],
                                                         :keep]
        resample = np.ones(shape, bool)
        resample[:, :keep] = False
        top_code = sample_model(
            model_top, generator, 1, class_conditioning=cc_top_tensors,
            initial_code=init_top, mask=resample[None], **top_options)
        top_code = top_code.expand((args.batch_size,) + top_code.shape[1:])
    else:
        batch_size_top = 1 if args.keep_same_top else args.batch_size
        top_code = sample_model(
            model_top, generator, batch_size_top,
            class_conditioning=cc_top_tensors, **top_options)
        if args.keep_same_top:
            top_code = top_code.expand(
                (args.batch_size,) + top_code.shape[1:])

    bottom_code = sample_model(
        model_bottom, generator, args.batch_size, condition=top_code,
        class_conditioning=cc_bottom_tensors, initial_code=initial_code,
        **bottom_options)

    decoded = vqvae.decode_code(top_code.long(), bottom_code.long())
    audio = spectrograms_helper.to_audio(decoded).cpu().numpy()

    with open(output_dir / f"{run_id}-command_line_parameters.json",
              "w") as f:
        # the JAX CLI's keys: the device picks where the run goes, not
        # what it samples
        json.dump(dict({k: v for k, v in vars(args).items()
                        if k != "device"}, seed=int(seed)), f, indent=4,
                  default=str)
    plot_codes(top_code.cpu().numpy(), bottom_code.cpu().numpy(),
               model_top.config.n_class, model_bottom.config.n_class,
               output_dir / f"{run_id}-codemaps.png")
    write_wav(output_dir / f"{run_id}.wav", audio.reshape(-1),
              args.sample_rate_hz)
    plot_channels(decoded.float().cpu().numpy(), output_dir, run_id)
    print("wrote", output_dir / f"{run_id}.wav")
    return output_dir / f"{run_id}.wav"


if __name__ == "__main__":
    main()
