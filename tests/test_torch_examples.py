"""The port's two example drivers (``examples/process_audio.py``,
``examples/inference_analysis.py``) against the JAX package's scripts.

A tiny VQ-VAE is written with the JAX package's checkpoint writer; both
packages' drivers run on the CPU on the same two seeded 4 s notes over a
noise floor. The metrics must agree (MSE and the perplexities rtol 1e-5,
the spectral losses 2e-5: the JAX CPU path takes its FFTs from XLA, the
port's plain version is a DFT product) and every wav within 2e-3, as in
``tests/test_torch_cli.py``. Each package computes its own spectrograms,
so the codes agree only where no instantaneous-frequency value wraps the
other way (a 1-ulp phase change at +/-pi) under a cell whose two best codes
lie close: with the default codebook scale the notes' codes are far from
such ties.
"""

import importlib.util
import json
import pathlib

import matplotlib
import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.models.vqvae import vqvae as jv
from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
    read_wav, write_wav)
from interactive_spectrogram_inpainting_tpu_torch.examples import (
    inference_analysis as tanalysis, process_audio as tprocess)
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    vqvae as tv)
from interactive_spectrogram_inpainting_tpu_torch.utils import visualization
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    init_like_flax, to_flax_params)
from tests.test_torch_encode import harmonic_note

matplotlib.use("Agg")
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
SPEC = dict(fs_hz=16000, n_fft=256, window_length=256, hop_length=64)
FIGURES = {"reconstructions.png", "code_usage_top.png",
           "code_usage_bottom.png"}


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' drivers on the same checkpoint and notes ->
    (output root, the JAX metrics, the port's metrics)."""
    root = tmp_path_factory.mktemp("examples")
    config = tv.VQVAEConfig(num_hidden_channels=16, num_residual_channels=8,
                            embed_dim=8, num_embeddings=32,
                            resolution_factors={"bottom": 4, "top": 2})
    model = init_like_flax(tv.VQVAE(config), torch.Generator().manual_seed(3))
    jv.save_model(root / "ckpt", jv.VQVAEConfig.from_json(config.to_json()),
                  to_flax_params(model))
    (root / "ckpt" / "training.json").write_text(json.dumps(SPEC))
    rng = np.random.default_rng(5)
    notes = []
    for i, f0 in enumerate((220.0, 311.1)):
        notes.append(str(root / f"note{i}.wav"))
        write_wav(notes[-1], harmonic_note(rng, 4 * SPEC["fs_hz"], f0=f0),
                  SPEC["fs_hz"])
    ckpt = ["--vqvae_model_parameters_path",
            str(root / "ckpt" / "vqvae-model_parameters.json"),
            "--vqvae_weights_path", str(root / "ckpt" / "vqvae-weights.msgpack"),
            "--vqvae_training_parameters_path",
            str(root / "ckpt" / "training.json")]
    janalysis, jprocess = (jax_script("inference_analysis"),
                           jax_script("process_audio"))
    # one JAX model load serves both scripts
    loaded = jv.from_parameters_and_weights(*ckpt[1::2][:2])
    with pytest.MonkeyPatch.context() as mp:
        for module in (janalysis, jprocess):
            mp.setattr(module, "from_parameters_and_weights",
                       lambda *_: loaded)
        jmetrics = janalysis.main(ckpt + [
            "--audio_paths", *notes, "--output_directory",
            str(root / "jax")])
        jprocess.main(ckpt + ["--input_wavs", *notes, "--output_directory",
                              str(root / "jax")])
    tmetrics = tanalysis.main(ckpt + [
        "--audio_paths", *notes, "--output_directory", str(root / "port"),
        "--device", "cpu"])
    written = tprocess.main(ckpt + [
        "--input_wavs", *notes, "--output_directory", str(root / "port"),
        "--device", "cpu"])
    assert [p.name for p in written] == ["note0-vqvae.wav", "note1-vqvae.wav"]
    return root, jmetrics, tmetrics


def test_metrics_match_jax(runs):
    root, jmetrics, tmetrics = runs
    stored = json.loads((root / "port" / "reconstruction_metrics.json")
                        .read_text())
    assert stored == tmetrics
    assert set(tmetrics) == set(jmetrics)
    for key, value in jmetrics.items():
        rtol = 2e-5 if key.startswith("spectral") else 1e-5
        assert np.isfinite(tmetrics[key])
        np.testing.assert_allclose(tmetrics[key], value, rtol=rtol,
                                   err_msg=key)


def test_files_and_wavs_match_jax(runs):
    root = runs[0]
    jax_files = {p.name for p in (root / "jax").iterdir()}
    port_files = {p.name for p in (root / "port").iterdir()}
    assert port_files == jax_files
    assert FIGURES <= port_files
    wavs = sorted(name for name in jax_files if name.endswith(".wav"))
    assert len(wavs) == 2 * 3 + 2  # original, reconstruction, processed
    for name in wavs:
        got, sr = read_wav(str(root / "port" / name))
        ref, sr_ref = read_wav(str(root / "jax" / name))
        assert sr == sr_ref == SPEC["fs_hz"] and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-3, err_msg=name)


def test_analysis_without_matplotlib_skips_only_the_figures(
        runs, monkeypatch, capsys):
    root = runs[0]
    monkeypatch.setattr(visualization, "have_matplotlib", lambda: False)
    ckpt = ["--vqvae_model_parameters_path",
            str(root / "ckpt" / "vqvae-model_parameters.json"),
            "--vqvae_weights_path", str(root / "ckpt" / "vqvae-weights.msgpack"),
            "--vqvae_training_parameters_path",
            str(root / "ckpt" / "training.json")]
    tanalysis.main(ckpt + ["--audio_paths", str(root / "note0.wav"),
                           str(root / "note1.wav"), "--output_directory",
                           str(root / "plain"), "--device", "cpu"])
    assert "figures skipped: matplotlib is not installed" in \
        capsys.readouterr().out
    expected = {p.name for p in (root / "port").iterdir()
                if "vqvae" not in p.name} - FIGURES
    assert {p.name for p in (root / "plain").iterdir()} == expected
