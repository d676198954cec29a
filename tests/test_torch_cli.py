"""The port's sampling CLI, dataset split and plotting helpers against the
JAX package's.

Tiny models are written once with the port's checkpoint writer and loaded
by both CLIs. The JAX CLI samples with the dense scan; the port's runs the
fused sampler (its plain versions on the CPU) and is fed the JAX CLI's
noise, so the codes must be equal (float32)."""

import json
import pathlib

import jax
import matplotlib
import numpy as np
import pytest
import torch

from tests.test_torch_sampling import jax_step_gumbel
from interactive_spectrogram_inpainting_tpu.data import split as jsplit
from interactive_spectrogram_inpainting_tpu.sampling import cli as jcli
from interactive_spectrogram_inpainting_tpu.utils import (
    visualization as jvis)
from interactive_spectrogram_inpainting_tpu_torch.data import split as tsplit
from interactive_spectrogram_inpainting_tpu_torch.data.label_encoders import (
    LabelEncoder)
from interactive_spectrogram_inpainting_tpu_torch.data.wav import read_wav
from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
    SelfAttentiveVQTransformer, UpsamplingVQTransformer)
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae import (
    VQVAE)
from interactive_spectrogram_inpainting_tpu_torch.sampling import cli as tcli
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    scan_range)
from interactive_spectrogram_inpainting_tpu_torch.serve.server import (
    make_test_configs)
from interactive_spectrogram_inpainting_tpu_torch.utils import (
    visualization as tvis)
from interactive_spectrogram_inpainting_tpu_torch.utils.checkpoint_io import (
    save_model)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    init_like_flax)

matplotlib.use("Agg")
SEED = 4
FILES = (".wav", "-codemaps.png", "-spectrogram.png",
         "-instantaneous_frequency.png", "-command_line_parameters.json")
INSTRUMENTS = ["bass", "brass", "flute", "guitar", "keyboard", "mallet",
               "organ", "reed", "string", "synth_lead", "vocal"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The tiny test models' files and the CLI arguments that load them."""
    d = tmp_path_factory.mktemp("cli_models")
    spec_kwargs, vq_cfg, top_cfg, bottom_cfg = make_test_configs("tiny")
    gen = torch.Generator().manual_seed(0)
    save_model(d, init_like_flax(VQVAE(vq_cfg), gen), "vqvae")
    save_model(d, init_like_flax(SelfAttentiveVQTransformer(top_cfg), gen),
               "top")
    save_model(d, init_like_flax(UpsamplingVQTransformer(bottom_cfg), gen),
               "bottom")
    (d / "training_parameters.json").write_text(json.dumps(spec_kwargs))
    (d / "label_encoders.json").write_text(json.dumps(
        {"pitch": list(range(24, 85)), "instrument_family_str": INSTRUMENTS}))
    args = [
        "--vqvae_training_parameters_path",
        str(d / "training_parameters.json"),
        "--vqvae_model_parameters_path", str(d / "vqvae-model_parameters.json"),
        "--vqvae_weights_path", str(d / "vqvae-weights.msgpack"),
        "--prediction_top_parameters_path", str(d / "top-model_parameters.json"),
        "--prediction_top_weights_path", str(d / "top-weights.msgpack"),
        "--prediction_bottom_parameters_path",
        str(d / "bottom-model_parameters.json"),
        "--prediction_bottom_weights_path", str(d / "bottom-weights.msgpack"),
        "--label_encoders_path", str(d / "label_encoders.json"),
        "--class_conditioning", "pitch,60", "instrument_family_str,keyboard",
        "--batch_size", "2", "--seed", str(SEED)]
    return args


def recorder(fn, calls, extra=None):
    """``fn`` that records (model, its keyword arguments, its output); with
    ``extra(i, model, args, kwargs)`` it adds keyword arguments first."""
    def wrapped(model, *args, **kwargs):
        if extra is not None:
            kwargs.update(extra(len(calls), model, args, kwargs))
        out = fn(model, *args, **kwargs)
        calls.append((model, kwargs, np.asarray(out)))
        return out
    return wrapped


def jax_cli_noise(i, model, args, kwargs):
    """The noise the JAX CLI's i-th sample_model call draws (top, then
    bottom, each from one half of the split seed key), for the port's
    sampler of the same call."""
    keys = jax.random.split(jax.random.PRNGKey(SEED))
    p0, steps = scan_range(model, None, None)
    batch = args[1]
    noise = jax_step_gumbel(keys[i], p0, steps,
                            (batch, model.config.n_class_target))
    return {"gumbel": noise[:, 0] if batch == 1 else noise}


@pytest.fixture(scope="module")
def both_runs(checkpoints, tmp_path_factory):
    """One run of each CLI on the same files and seed: (JAX calls, port
    calls, JAX output directory, port output directory)."""
    out = tmp_path_factory.mktemp("cli_out")
    j_calls, t_calls = [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jcli, "sample_model", recorder(jcli.sample_model,
                                                  j_calls))
        mp.setattr(tcli, "sample_model",
                   recorder(tcli.sample_model, t_calls, jax_cli_noise))
        jcli.main(checkpoints + ["--output_directory", str(out / "jax")])
        tcli.main(checkpoints + ["--output_directory", str(out / "torch"),
                                 "--device", "cpu"])
    finally:
        mp.undo()
    return j_calls, t_calls, out / "jax", out / "torch"


def test_cli_codes_match_jax(both_runs):
    """Top, then bottom: the port's fused codes equal the JAX CLI's."""
    j_calls, t_calls, _, _ = both_runs
    assert len(j_calls) == len(t_calls) == 2
    for (_, _, j_codes), (_, kwargs, t_codes) in zip(j_calls, t_calls):
        assert kwargs["use_fused_step"]
        assert t_codes.shape == j_codes.shape and t_codes.shape[0] == 2
        np.testing.assert_array_equal(t_codes, j_codes)


def run_files(directory):
    files = sorted(p.name for p in directory.iterdir())
    (wav,) = [f for f in files if f.endswith(".wav")]
    run_id = wav[:-len(".wav")]
    return run_id, files


def test_cli_writes_the_jax_outputs(both_runs):
    """The same files (by run-id suffix), an arguments JSON with the same
    keys, and the same audio: the wavs within 2e-3 (16-bit PCM; the two
    VQ-VAE decodes and inverse transforms differ by float32 sums)."""
    _, _, j_dir, t_dir = both_runs
    j_id, j_files = run_files(j_dir)
    t_id, t_files = run_files(t_dir)
    assert [f[len(j_id):] for f in j_files] == \
        [f[len(t_id):] for f in t_files] == sorted(FILES)
    j_args = json.loads((j_dir / f"{j_id}-command_line_parameters.json")
                        .read_text())
    t_args = json.loads((t_dir / f"{t_id}-command_line_parameters.json")
                        .read_text())
    assert sorted(t_args) == sorted(j_args)
    assert t_args["seed"] == j_args["seed"] == SEED
    j_audio, j_sr = read_wav(j_dir / f"{j_id}.wav")
    t_audio, t_sr = read_wav(t_dir / f"{t_id}.wav")
    assert t_sr == j_sr == 16000 and t_audio.shape == j_audio.shape
    assert np.abs(j_audio).max() > 1e-3
    np.testing.assert_allclose(t_audio, j_audio, atol=2e-3)


def test_cli_top_k_runs_the_dense_sampler(checkpoints, tmp_path, monkeypatch):
    """A filter: every sample_model call with use_fused_step=False (the
    fused sampler would raise), one call per prior."""
    calls = []
    monkeypatch.setattr(tcli, "_sample_model",
                        recorder(tcli._sample_model, calls))
    wav = tcli.main(checkpoints + ["--top_k_sampling_k", "3", "--device",
                                   "cpu", "--output_directory",
                                   str(tmp_path)])
    assert pathlib.Path(wav).exists()
    assert [kw["use_fused_step"] for _, kw, _ in calls] == [False, False]
    assert all(kw["top_k_sampling_k"] == 3 for _, kw, _ in calls)


@pytest.mark.parametrize("arg", ["pitch,60", "pitch,60...64",
                                 "instrument_family_str,keyboard",
                                 "instrument_family_str,flute...guitar"])
def test_key_value_and_conditioning_tensors_match_jax(arg):
    assert tcli.key_value(arg) == jcli.key_value(arg)
    encoders = {"pitch": LabelEncoder(range(24, 85)),
                "instrument_family_str": LabelEncoder(INSTRUMENTS)}
    key, value = tcli.key_value(arg)
    if key == "instrument_family_str" and isinstance(value, list):
        # a range of labels is numeric: the JAX and port tools reject it
        # alike
        for fn in (tcli.make_conditioning_tensors,
                   jcli.make_conditioning_tensors):
            with pytest.raises(ValueError):
                fn(dict([(key, value)]), encoders)
        return
    t = tcli.make_conditioning_tensors(dict([(key, value)]), encoders)
    j = jcli.make_conditioning_tensors(dict([(key, value)]), encoders)
    assert list(t) == list(j)
    np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


def test_create_split_matches_jax(tmp_path):
    """Two NSynth-like directories merged and split with the fixed seed:
    the JAX tool's train and valid keys, in its order."""
    rng = np.random.default_rng(0)
    dirs = []
    for part in range(2):
        d = tmp_path / f"part{part}"
        d.mkdir()
        (d / "examples.json").write_text(json.dumps({
            f"note_{part}_{i:03d}": {"pitch": int(rng.integers(24, 85))}
            for i in range(23 + 14 * part)}))
        dirs.append(d)
    t_paths = tsplit.create_split(dirs, tmp_path / "torch")
    j_paths = jsplit.create_split(dirs, tmp_path / "jax")
    assert sorted(t_paths) == sorted(j_paths) == ["train", "valid"]
    for split in ("train", "valid"):
        assert t_paths[split].read_text() == j_paths[split].read_text()
    n = len(json.loads(t_paths["valid"].read_text()))
    assert n == int(np.ceil(60 * 0.2))
    assert tsplit.train_test_split_keys(list("abcdefghij"), 0.3, 7) == \
        jsplit.train_test_split_keys(list("abcdefghij"), 0.3, 7)


def pixels(fig):
    import matplotlib.pyplot as plt
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def test_visualization_figures_match_jax():
    """Each plotting helper draws the JAX helper's image, pixel for
    pixel."""
    rng = np.random.default_rng(3)
    codemap = rng.integers(0, 32, (16, 8))
    predicted = np.where(rng.random((16, 8)) < 0.7, codemap,
                         rng.integers(0, 32, (16, 8)))
    mask = rng.random((16, 8)) < 0.5
    mels = rng.normal(size=(2, 32, 16)).astype(np.float32)
    ifs = rng.uniform(-1, 1, (2, 32, 16)).astype(np.float32)
    counts_t = tvis.code_usage_histogram([codemap, predicted], 32)
    counts_j = jvis.code_usage_histogram([codemap, predicted], 32)
    np.testing.assert_array_equal(counts_t, counts_j)
    for name, args in (
            ("plot_codemap", (codemap, 32, "top")),
            ("plot_mel_representations_batch", (mels, ifs)),
            ("plot_prediction_success_map", (codemap, predicted, mask)),
            ("plot_prediction_success_map", (codemap, predicted)),
            ("plot_code_usage", (counts_j,))):
        t = pixels(getattr(tvis, name)(*args))
        j = pixels(getattr(jvis, name)(*args))
        assert t.shape == j.shape and t.shape[-1] == 4, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def test_visualization_save_figure(tmp_path):
    path = tvis.save_figure(tvis.plot_code_usage(np.arange(8)),
                            tmp_path / "media" / "usage.png")
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert tvis.have_matplotlib()
