"""PyTorch port vs the JAX package: the VQ-VAE trainer's entry point.

``train_vqvae.main`` on a seeded NSynth-shaped directory of seven 4096-sample
notes (4 train, 3 validation; the narrow model of
``test_torch_train_vqvae.py``): a dry run with most switches (writes
nothing), a run that writes the checkpoints, the media and the two model
files, which the JAX package's ``from_parameters_and_weights`` loads to the
port's decode (rtol 1e-4, atol 1e-5 x its largest value), and its resume with the statistics from a file.
The ResNet encoders and decoders and a whole ResNet VQ-VAE against the JAX
package in float32 (atol 1e-5), its weights both ways, and one ResNet
train step."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_vqvae import LENGTH, notes
from interactive_spectrogram_inpainting_tpu.models.vqvae import vqvae as jv
from interactive_spectrogram_inpainting_tpu_torch.data.wav import write_wav
from interactive_spectrogram_inpainting_tpu_torch.train import (
    train_vqvae as tt)
from interactive_spectrogram_inpainting_tpu_torch.train.checkpoint import (
    Checkpointer)


# -- main -------------------------------------------------------------------

@pytest.fixture(scope="module")
def nsynth_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("nsynth")
    (path / "audio").mkdir()
    train, valid = {}, {}
    audio = notes(10, batch=7)
    for i in range(7):
        name = f"keyboard_synthetic_{i:03d}-{48 + i:03d}-100"
        write_wav(path / "audio" / f"{name}.wav", audio[i], 16000)
        (valid if i >= 4 else train)[name] = {
            "pitch": 48 + i, "note_str": name,
            "instrument_family_str": "keyboard"}
    (path / "train.json").write_text(json.dumps(train))
    (path / "valid.json").write_text(json.dumps(valid))
    return path


def main_args(path, runs, *extra):
    return ["--dataset_audio_directory_paths", str(path / "audio"),
            "--train_dataset_json_data_path", str(path / "train.json"),
            "--validation_dataset_json_data_path", str(path / "valid.json"),
            "--dataset_duration_seconds", str(LENGTH / 16000),
            "--use_mel_scale", "--n_fft", "512", "--hop_length", "128",
            "--window_length", "512", "--num_hidden_channels", "16",
            "--num_residual_channels", "8", "--num_residual_blocks", "1",
            "--embeddings_dimension", "8", "--num_embeddings", "32",
            "--resolution_factors", "top=2,bottom=4", "--batch_size", "2",
            "--device", "cpu", "--runs_directory", str(runs),
            "--num_tensorboard_audio_samples", "1", *extra]


def test_main_dry_run_writes_nothing(nsynth_dir, tmp_path):
    model = tt.main(main_args(nsynth_dir, tmp_path, "--dry_run", "--bf16",
                              "--reconstruction_criterion", "spectral_ddsp",
                              "--output_spectrogram_threshold",
                              "--sched", "cycle", "--clip_grad_norm", "1.0",
                              "--corrupt_codes", "both",
                              "--restarts_usage_threshold", "0.5"))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert model.config.corruption_weights["top"] == [0.1, 0.8, 0.1]
    assert not any(tmp_path.iterdir())
    # one process: two data ranks do not match the world
    with pytest.raises(SystemExit, match="--num_devices_data 2"):
        tt.main(main_args(nsynth_dir, tmp_path, "--num_devices_data", "2"))


def test_main_trains_resumes_and_the_jax_package_loads_it(nsynth_dir,
                                                          tmp_path):
    runs = tmp_path / "runs"
    model = tt.main(main_args(nsynth_dir, runs, "--num_training_epochs", "1",
                              "--input_normalization", "--pallas_vq",
                              "--reconstruction_criterion",
                              "spectral_jukebox", "--profile",
                              "--enable_image_dumps"))
    (run_dir,) = runs.iterdir()
    for name in ("command_line_parameters.json", "model_parameters.json",
                 "vqvae-model_parameters.json", "vqvae-weights.msgpack",
                 "checkpoints/0/state.pt", "best/0/state.pt",
                 "tb/metrics.jsonl", "tb/media/original_0-2.wav",
                 "tb/media/reconstruction_0-2.wav",
                 "tb/media/reconstructions-2.png", "profile/trace.json",
                 "samples/00001_00000_spectrogram.png",
                 "samples/00001_00000_instantaneous_frequency.png"):
        assert (run_dir / name).exists(), name
    records = [json.loads(line) for line in
               (run_dir / "tb" / "metrics.jsonl").read_text().splitlines()]
    assert any("validation/metric_Jukebox" in r for r in records)
    assert any("training/perplexity_top_ratio" in r for r in records)
    stats = model.config.normalizer_statistics
    assert stats is not None and model.config.use_pallas_lookup

    # the JAX package loads the trained files and decodes as the port does
    jm, variables = jv.from_parameters_and_weights(
        run_dir / "vqvae-model_parameters.json",
        run_dir / "vqvae-weights.msgpack")
    rng = np.random.default_rng(11)
    code_t = rng.integers(0, 32, (2, 32, 4))
    code_b = rng.integers(0, 32, (2, 64, 8))
    ref = jm.apply(variables, jnp.asarray(code_t), jnp.asarray(code_b),
                   method=jv.VQVAE.decode_code)
    with torch.no_grad():
        out = model.eval().decode_code(torch.as_tensor(code_t),
                                       torch.as_tensor(code_b))
    # an unused code's EMA mean reaches 1e5 after an epoch: relative to
    # the decode's largest value
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())

    # resume: one more epoch from epoch 0, with the statistics file fixed
    stats_path = tmp_path / "stats.json"
    stats_path.write_text(json.dumps(stats))
    resumed = tt.main(main_args(
        nsynth_dir, runs, "--num_training_epochs", "2", "--pallas_vq",
        "--resume_training_from", str(run_dir),
        "--precomputed_normalization_statistics", str(stats_path)))
    assert resumed.config.normalizer_statistics == stats
    second = [p for p in runs.iterdir() if p != run_dir]
    assert Checkpointer(second[0]).latest_epoch() == 1
    assert not torch.equal(resumed.quantize_b.embed, model.quantize_b.embed)
