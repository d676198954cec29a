"""Batched codemap extraction: every note of a dataset split through a
trained VQ-VAE into a ``CodemapStore``.

Port of ``interactive_spectrogram_inpainting_tpu/extract/extract_codes.py``.
``extract_split`` batches the notes' audio, runs the forward spectrogram
transform and the VQ-VAE encode on one device and writes the codemaps into
the fixed-stride store that the priors train from; with
``use_pallas_lookup`` in the model's JSON the two lookups of every batch go
through the hand-written kernel. ``decode_back_sanity_check`` (stored codes
-> audio wav) is the pipeline's end-to-end integrity probe. Launched as
several processes (``torchrun``), the data ranks of a ``('data',)`` mesh
(``parallel/mesh.py``) each read, decode and encode their rows of every
batch, and rank 0 writes the gathered codes (the notes' labels it reads
from their metadata), the same bytes as one process writes.

Run: ``python -m interactive_spectrogram_inpainting_tpu_torch.extract.extract_codes
--vqvae_model_parameters_path ... --vqvae_weights_path ...
--vqvae_training_parameters_path ... --dataset_audio_directory_paths DIR
--named_dataset_json_data_paths train=DIR/examples.json
--output_directory OUT`` (GPU by default; ``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.codemap_store import CodemapDataset, CodemapStoreWriter
from ..data.loader import BatchLoader
from ..data.nsynth import NSynth
from ..data.wav import write_wav
from ..models.vqvae.vqvae import VQVAE
from ..parallel.collectives import all_gather_rows
from ..parallel.distributed import initialize_multihost
from ..parallel.mesh import is_master_process, make_mesh, world
from ..signal.spectrogram import (get_spectrograms_helper,
                                  make_masked_phase_transform)
from ..utils.checkpoint_io import vqvae_from_parameters_and_weights
from ..utils.device import DeviceLike, resolve_device, set_float32_precision


def extract_split(model: VQVAE, spectrograms_helper, dataset: NSynth,
                  store_directory, batch_size: int = 128,
                  categorical_fields: Sequence[str] = (
                      "pitch", "instrument_family_str"),
                  n_devices_data: Optional[int] = None,
                  device: DeviceLike = None) -> int:
    """Encode a dataset split into a CodemapStore; returns the record
    count. A short last batch is padded with silence to ``batch_size`` (as
    the JAX package pads to its compiled shape) and the surplus rows are
    dropped.

    ``n_devices_data``: the data ranks the batches split over (default: the
    process group's world size, 1 without one); it must match the world and
    divide ``batch_size``. Every rank must call this; only rank 0 writes."""
    n_devices_data = world()[1] if n_devices_data is None else n_devices_data
    if batch_size % n_devices_data:
        raise ValueError(f"n_devices_data {n_devices_data} must divide "
                         f"batch_size {batch_size}")
    mesh = make_mesh(n_data=n_devices_data)
    rows = mesh.rows(batch_size)
    device = resolve_device(device)
    set_float32_precision()
    model = model.to(device).eval()

    # a thresholded model was trained on spectrograms with sub-threshold IF
    # zeroed, so extraction feeds it the same view
    min_magnitude = model.config.output_spectrogram_min_magnitude
    input_transform = (make_masked_phase_transform(min_magnitude)
                       if min_magnitude is not None else None)

    @torch.no_grad()
    def encode(audio: np.ndarray, group=None):
        spec = spectrograms_helper.to_spectrogram(
            torch.as_tensor(audio, dtype=torch.float32, device=device))
        if input_transform is not None:
            spec = input_transform(spec)
        id_t, id_b = model.encode_codes_only(spec)
        return (all_gather_rows(id_t.contiguous(), group).cpu().numpy(),
                all_gather_rows(id_b.contiguous(), group).cpu().numpy())

    # probe the codemap shapes with one silent note
    id_t, id_b = encode(np.zeros((1, dataset.num_samples), np.float32))
    top_shape, bottom_shape = id_t.shape[1:], id_b.shape[1:]

    # each rank reads and decodes its rows of every batch, the last one
    # padded with silence to a whole batch
    n_batches = math.ceil(len(dataset) / batch_size)
    loader = BatchLoader(_SilencePadded(dataset, n_batches * batch_size),
                         batch_size, shuffle=False, rows=rows)
    cfg = model.config
    writer = (CodemapStoreWriter(
        store_directory, top_shape, bottom_shape,
        attribute_fields=list(categorical_fields),
        label_encoders=dataset.label_encoders,
        n_class=(cfg.n_embed_t if cfg.n_embed_t == cfg.n_embed_b else None),
        n_class_top=cfg.n_embed_t, n_class_bottom=cfg.n_embed_b)
        if is_master_process() else contextlib.nullcontext())
    with writer:
        for b, audio in enumerate(loader):
            id_t, id_b = encode(audio, mesh.data_group)
            if not is_master_process():
                continue
            names = dataset.names[b * batch_size:(b + 1) * batch_size]
            n = len(names)
            labels = [dataset.labels(b * batch_size + i) for i in range(n)]
            attributes = {field: np.asarray([row[k] for row in labels])
                          for k, field in enumerate(categorical_fields)}
            writer.append_batch(id_t[:n], id_b[:n], attributes, names)
    return len(dataset)


class _SilencePadded:
    """A dataset's audio, then silent notes up to ``length``."""

    def __init__(self, dataset, length: int):
        self.dataset, self.length = dataset, length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> np.ndarray:
        if index < len(self.dataset):
            return self.dataset[index][0]
        return np.zeros(self.dataset.num_samples, np.float32)


def decode_back_sanity_check(model: VQVAE, spectrograms_helper,
                             store_directory, output_wav_path,
                             num_samples: int = 4,
                             audio_samples: Optional[int] = None,
                             device: DeviceLike = None) -> None:
    """Read a random stored batch, decode it to audio and write one wav."""
    device = resolve_device(device)
    set_float32_precision()
    model = model.to(device).eval()
    dataset = CodemapDataset(store_directory)
    idx = np.random.default_rng(0).choice(
        len(dataset), size=min(num_samples, len(dataset)), replace=False)
    tops, bottoms, _ = dataset.read_batch(idx)
    with torch.no_grad():
        spec = model.decode_code(torch.as_tensor(tops, device=device),
                                 torch.as_tensor(bottoms, device=device))
        audio = spectrograms_helper.to_audio(
            spec, num_samples=audio_samples).cpu().numpy()
    write_wav(output_wav_path, audio.reshape(-1), spectrograms_helper.fs_hz)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vqvae_model_parameters_path", type=str, required=True)
    p.add_argument("--vqvae_weights_path", type=str, required=True)
    p.add_argument("--vqvae_training_parameters_path", type=str,
                   required=True)
    p.add_argument("--dataset_audio_directory_paths", type=str, nargs="+",
                   required=True)
    p.add_argument("--named_dataset_json_data_paths", type=str, nargs="+",
                   required=True,
                   help="name=path pairs, e.g. train=/x/examples.json")
    p.add_argument("--output_directory", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--valid_pitch_range", type=int, nargs=2,
                   default=[24, 84])
    p.add_argument("--categorical_fields", type=str, nargs="*",
                   default=["pitch", "instrument_family_str"],
                   help="attribute fields stored per codemap")
    p.add_argument("--also_write_lmdb", action="store_true",
                   help="additionally emit an LMDB environment next to "
                        "each store (<split>_lmdb)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    initialize_multihost(device=args.device)

    with open(args.vqvae_training_parameters_path) as f:
        training_parameters = json.load(f)
    spectrograms_helper = get_spectrograms_helper(**training_parameters)
    model = vqvae_from_parameters_and_weights(
        args.vqvae_model_parameters_path, args.vqvae_weights_path)

    for spec_pair in args.named_dataset_json_data_paths:
        name, json_path = spec_pair.split("=", 1)
        dataset = NSynth(
            args.dataset_audio_directory_paths, json_path,
            valid_pitch_range=tuple(args.valid_pitch_range),
            categorical_field_list=list(args.categorical_fields),
            sample_rate=training_parameters.get("fs_hz", 16000),
            duration_seconds=training_parameters.get(
                "dataset_duration_seconds", 4.0))
        store_dir = pathlib.Path(args.output_directory) / name
        t0 = time.time()
        count = extract_split(model, spectrograms_helper, dataset, store_dir,
                              batch_size=args.batch_size,
                              categorical_fields=tuple(
                                  args.categorical_fields),
                              device=args.device)
        if not is_master_process():
            continue
        print(f"{name}: {count} codemaps in {time.time() - t0:.1f}s "
              f"-> {store_dir}")
        decode_back_sanity_check(
            model, spectrograms_helper, store_dir,
            store_dir / "vqvae_codes_extraction_samples.wav",
            audio_samples=dataset.num_samples, device=args.device)
        if args.also_write_lmdb:
            from ..data.lmdb_compat import (store_to_lmdb,
                                            validate_environment)
            lmdb_dir = pathlib.Path(args.output_directory) / f"{name}_lmdb"
            n = store_to_lmdb(store_dir, lmdb_dir)
            stats = validate_environment(lmdb_dir, strict_size=True)
            print(f"{name}: {n} rows -> LMDB {lmdb_dir} "
                  f"(audit: {stats['entries']} entries, "
                  f"{stats['pages']} pages OK)")


if __name__ == "__main__":
    main()
