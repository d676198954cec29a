"""PyTorch port vs the JAX package: code extraction, the stores it writes
and the two-file checkpoints.

``extract_split`` of both packages encodes the same eight synthetic notes
through the same weights: codes are equal on every cell whose two best
scores differ by more than 1e-4 (``tests/test_torch_encode.py`` explains
the margin), attributes and names exactly. The notes last 0.512 s, a whole
number of 32-frame blocks: a note that the transform must pad has all-zero
frames at its end, whose phase is 0 or pi by the sign of the FFT library's
zeros, so their instantaneous frequency (and through it a trailing code) is
not comparable across libraries. The port's copies of the store,
dataset, loader and LMDB modules read what the JAX package's write and the
reverse. Checkpoints written by either package's ``save_model`` load in the
other with equal weights (exactly: the files hold the float32 bits).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.data import (
    codemap_store as jstore, lmdb_compat as jlmdb, loader as jloader,
    nsynth as jnsynth)
from interactive_spectrogram_inpainting_tpu.extract import (
    extract_codes as jextract)
from interactive_spectrogram_inpainting_tpu.models.prior import (
    transformer as jprior)
from interactive_spectrogram_inpainting_tpu.models.vqvae import vqvae as jv
from interactive_spectrogram_inpainting_tpu.signal import (
    spectrogram as jspec)
from interactive_spectrogram_inpainting_tpu_torch.data import (
    codemap_store as tstore, lmdb_compat as tlmdb, loader as tloader,
    nsynth as tnsynth)
from interactive_spectrogram_inpainting_tpu_torch.data.label_encoders import (
    LabelEncoder, dump_label_encoders, load_label_encoders)
from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
    read_wav, resample, write_wav)
from interactive_spectrogram_inpainting_tpu_torch.extract import (
    extract_codes as textract)
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    vqvae as tv)
from interactive_spectrogram_inpainting_tpu_torch.signal import (
    spectrogram as tspec)
from interactive_spectrogram_inpainting_tpu_torch.utils import (
    checkpoint_io, weights)
from tests.test_torch_encode import (MARGIN, harmonic_note, score_margin,
                                     to_numpy)

SPEC_KWARGS = dict(fs_hz=16000, n_fft=256, window_length=256, hop_length=64)
VQ_KWARGS = dict(num_hidden_channels=16, num_residual_channels=8,
                 embed_dim=8, num_embeddings=32,
                 resolution_factors={"bottom": 4, "top": 2},
                 use_pallas_lookup=True)
FAMILIES = ["bass", "flute", "organ"]


@pytest.fixture(scope="module")
def nsynth_dir(tmp_path_factory):
    """Eight 0.512 s notes (plus one outside the pitch range) as an
    NSynth-shaped directory: audio/*.wav and examples.json."""
    root = tmp_path_factory.mktemp("nsynth")
    (root / "audio").mkdir()
    rng = np.random.default_rng(0)
    meta = {}
    for i in range(9):
        pitch = 100 if i == 8 else 40 + 3 * i
        name = f"{FAMILIES[i % 3]}_synthetic_{i:03d}-{pitch:03d}-075"
        write_wav(str(root / "audio" / f"{name}.wav"),
                  harmonic_note(rng, 8192, f0=110.0 * (1 + i % 4)), 16000)
        meta[name] = {"pitch": pitch, "note_str": name,
                      "instrument_family_str": FAMILIES[i % 3],
                      "instrument_family": i % 3}
    (root / "examples.json").write_text(json.dumps(meta))
    return root


def datasets(nsynth_dir):
    kwargs = dict(valid_pitch_range=(24, 84),
                  categorical_field_list=["pitch", "instrument_family_str"],
                  duration_seconds=0.512)
    return (jnsynth.NSynth(nsynth_dir, nsynth_dir / "examples.json", **kwargs),
            tnsynth.NSynth(nsynth_dir, nsynth_dir / "examples.json", **kwargs))


@pytest.fixture(scope="module")
def vqvae_pair():
    jcfg = jv.VQVAEConfig(**VQ_KWARGS)
    jmodel = jv.VQVAE(jcfg)
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 16, 8)))
    tmodel = tv.VQVAE(tv.VQVAEConfig.from_json(jcfg.to_json()))
    tmodel.load_state_dict(weights.from_flax_params(to_numpy(variables)))
    return jmodel, variables, tmodel.eval()


def test_dataset_and_loader_copies_match_jax(nsynth_dir):
    jds, tds = datasets(nsynth_dir)
    assert len(tds) == len(jds) == 8 and tds.names == jds.names
    assert tds.num_samples == 8192
    for field, encoder in jds.label_encoders.items():
        assert tds.label_encoders[field].classes_ == encoder.classes_
    for i in (0, 5):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
    assert tds.metadata(3) == jds.metadata(3)
    for kwargs in (dict(shuffle=False, drop_last=False, prefetch=0),
                   dict(shuffle=True, seed=3, drop_last=True)):
        jl = jloader.BatchLoader(jds, 3, **kwargs)
        tl = tloader.BatchLoader(tds, 3, **kwargs)
        assert len(tl) == len(jl)
        for tb, jb in zip(tl, jl):
            for a, b in zip(tb, jb):
                np.testing.assert_array_equal(a, b)
    # one data rank's block of every batch of the one-process loader
    whole = tloader.BatchLoader(tds, 4, seed=3)
    block = tloader.BatchLoader(tds, 4, seed=3, rows=slice(2, 4))
    assert len(block) == len(whole) == 2
    for tb, wb in zip(block, whole):
        for a, b in zip(tb, wb):
            np.testing.assert_array_equal(a, b[2:4])


def test_wav_resample_and_label_encoder_files_match_jax(tmp_path):
    from interactive_spectrogram_inpainting_tpu.data import (
        label_encoders as jle, wav as jwav)
    audio = harmonic_note(np.random.default_rng(1), 3000)
    for target in (8000, 24000):
        np.testing.assert_array_equal(resample(audio, 16000, target),
                                      jwav.resample(audio, 16000, target))
    assert resample(audio, 16000, 16000) is audio
    encoders = {"pitch": LabelEncoder([40, 43]),
                "instrument_family_str": LabelEncoder(FAMILIES)}
    dump_label_encoders(encoders, tmp_path / "t.json")
    jle.dump_label_encoders(encoders, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()
    loaded = load_label_encoders(tmp_path / "j.json")
    assert loaded["instrument_family_str"].classes_ == FAMILIES
    assert list(loaded["pitch"].transform([43, 40])) == [1, 0]


def test_store_and_lmdb_copies_interoperate_with_jax(tmp_path):
    rng = np.random.default_rng(2)
    tops = rng.integers(0, 32, (5, 4, 2))
    bottoms = rng.integers(0, 32, (5, 8, 4))
    attrs = {"pitch": np.arange(5), "instrument_family_str": np.arange(5) % 3}
    names = [f"note_{i}" for i in range(5)]
    encoders = {"pitch": LabelEncoder(list(range(40, 45))),
                "instrument_family_str": LabelEncoder(FAMILIES)}
    for writer_mod, reader_mod, sub in ((tstore, jstore, "t2j"),
                                        (jstore, tstore, "j2t")):
        with writer_mod.CodemapStoreWriter(
                tmp_path / sub, (4, 2), (8, 4), list(attrs), encoders,
                n_class=32) as writer:
            writer.append_batch(tops, bottoms, attrs, names)
        kwargs = {"use_native": False} if reader_mod is jstore else {}
        ds = reader_mod.CodemapDataset(tmp_path / sub, **kwargs)
        assert len(ds) == 5 and ds.filenames == names and ds.n_class == 32
        top, bottom, row = ds[3]
        np.testing.assert_array_equal(top, tops[3])
        np.testing.assert_array_equal(bottom, bottoms[3])
        assert dict(row) == {"pitch": 3, "instrument_family_str": 0}
        bt, bb, ba = ds.read_batch([4, 1])
        np.testing.assert_array_equal(bt, tops[[4, 1]])
        np.testing.assert_array_equal(bb, bottoms[[4, 1]])
        np.testing.assert_array_equal(ba["pitch"], [4, 1])
        assert ds.label_encoders["instrument_family_str"].classes_ == FAMILIES
    # the two writers produce the same bytes
    for name in ("codes.bin", "store.json", "filenames.json"):
        assert (tmp_path / "t2j" / name).read_bytes() == (
            tmp_path / "j2t" / name).read_bytes()
    # LMDB environments: written by one package, read by the other
    for writer_mod, reader_mod, sub in ((tlmdb, jlmdb, "lmdb_t"),
                                        (jlmdb, tlmdb, "lmdb_j")):
        assert writer_mod.store_to_lmdb(tmp_path / "t2j",
                                        tmp_path / sub) == 5
        stats = reader_mod.validate_environment(tmp_path / sub,
                                                strict_size=True)
        assert stats["entries"] >= 5
        ds = reader_mod.open_codes_dataset(
            tmp_path / sub,
            classes_for_conditioning=["pitch", "instrument_family_str"])
        assert len(ds) == 5
        bt, bb, ba = ds.read_batch([0, 2])
        np.testing.assert_array_equal(bt, tops[[0, 2]])
        np.testing.assert_array_equal(bb, bottoms[[0, 2]])
        np.testing.assert_array_equal(ba["pitch"], [0, 2])
    assert isinstance(tlmdb.open_codes_dataset(tmp_path / "t2j"),
                      tstore.CodemapDataset)
    with pytest.raises(FileNotFoundError):
        tlmdb.open_codes_dataset(tmp_path / "nothing")


def test_extract_split_matches_jax(nsynth_dir, vqvae_pair, tmp_path):
    jmodel, variables, tmodel = vqvae_pair
    jds, tds = datasets(nsynth_dir)
    jh = jspec.get_spectrograms_helper(**SPEC_KWARGS)
    th = tspec.get_spectrograms_helper(**SPEC_KWARGS)
    # batch 3: two full batches and a padded last one
    n_j = jextract.extract_split(jmodel, variables, jh, jds,
                                 tmp_path / "j", batch_size=3)
    n_t = textract.extract_split(tmodel, th, tds, tmp_path / "t",
                                 batch_size=3, device="cpu")
    assert n_t == n_j == 8
    jd = tstore.CodemapDataset(tmp_path / "j")
    td = tstore.CodemapDataset(tmp_path / "t")
    assert td.filenames == jd.filenames == tds.names
    assert td.top_shape == jd.top_shape == (16, 16)
    assert td.bottom_shape == jd.bottom_shape == (32, 32)
    assert (td.n_class, td.n_class_top) == (32, 32)
    tt, tb, ta = td.read_batch(range(8))
    jt, jb, ja = jd.read_batch(range(8))
    for field in ("pitch", "instrument_family_str"):
        np.testing.assert_array_equal(ta[field], ja[field])

    # margins from the port's own lookup inputs
    audio = np.stack([tds[i][0] for i in range(8)])
    with torch.no_grad():
        spec = th.to_spectrogram(torch.as_tensor(audio))
        enc_b = tmodel.enc_b(spec)
        qt_in = tmodel.quantize_conv_t(tmodel.enc_t(enc_b))
        qb_in = tmodel.quantize_conv_b(torch.cat(
            [tmodel.dec_t(tmodel.quantize_t(qt_in)[0]), enc_b], dim=1))
    for name, mine, theirs, lookup_in, level in (
            ("top", tt, jt, qt_in, tmodel.quantize_t),
            ("bottom", tb, jb, qb_in, tmodel.quantize_b)):
        flat = lookup_in.permute(0, 2, 3, 1).reshape(-1, 8)
        clear = score_margin(flat, level.embed) > MARGIN
        print(f"{name}: {int((~clear).sum())} of {clear.size} cells within "
              f"{MARGIN} of a tie")
        assert clear.mean() > 0.98
        differ = mine.reshape(-1) != theirs.reshape(-1)
        if name == "bottom" and not np.array_equal(tt, jt):
            continue  # a flipped top code changes the bottom's input
        assert not (differ & clear).any()

    textract.decode_back_sanity_check(
        tmodel, th, tmp_path / "t", tmp_path / "t.wav", num_samples=2,
        audio_samples=8192, device="cpu")
    jextract.decode_back_sanity_check(
        jmodel, variables, jh, tmp_path / "t", tmp_path / "j.wav",
        num_samples=2, audio_samples=8192)
    back_t, sr = read_wav(str(tmp_path / "t.wav"))
    back_j, _ = read_wav(str(tmp_path / "j.wav"))
    assert sr == 16000 and back_t.shape == back_j.shape == (1, 16384)
    # 16-bit files of the same audio: one quantization step apart at most
    np.testing.assert_allclose(back_t, back_j, atol=2.0 / 32767)

    # one process: a mesh of four data ranks does not cover the world
    with pytest.raises(ValueError, match="world size 1"):
        textract.extract_split(tmodel, th, tds, tmp_path / "x",
                               n_devices_data=4, device="cpu")


def test_extract_main_runs_from_checkpoint_files(nsynth_dir, vqvae_pair,
                                                 tmp_path):
    """The CLI with the JAX CLI's arguments, from files the JAX package's
    ``save_model`` wrote."""
    jmodel, variables, tmodel = vqvae_pair
    jv.save_model(tmp_path / "ckpt", jmodel.config, variables)
    (tmp_path / "ckpt" / "training.json").write_text(json.dumps(
        dict(SPEC_KWARGS, dataset_duration_seconds=0.512)))
    textract.main([
        "--vqvae_model_parameters_path",
        str(tmp_path / "ckpt" / "vqvae-model_parameters.json"),
        "--vqvae_weights_path",
        str(tmp_path / "ckpt" / "vqvae-weights.msgpack"),
        "--vqvae_training_parameters_path",
        str(tmp_path / "ckpt" / "training.json"),
        "--dataset_audio_directory_paths", str(nsynth_dir),
        "--named_dataset_json_data_paths",
        f"valid={nsynth_dir / 'examples.json'}",
        "--output_directory", str(tmp_path / "out"), "--batch_size", "8",
        "--also_write_lmdb", "--device", "cpu"])
    store = tstore.CodemapDataset(tmp_path / "out" / "valid")
    assert len(store) == 8
    assert (tmp_path / "out" / "valid"
            / "vqvae_codes_extraction_samples.wav").exists()
    assert len(tlmdb.open_codes_dataset(tmp_path / "out" / "valid_lmdb")) == 8


# -- checkpoints --------------------------------------------------------------

def assert_trees_equal(a, b):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(path))


def test_vqvae_checkpoint_both_ways(vqvae_pair, tmp_path):
    jmodel, variables, tmodel = vqvae_pair
    jv.save_model(tmp_path / "j", jmodel.config, variables)
    loaded = checkpoint_io.vqvae_from_parameters_and_weights(
        tmp_path / "j" / "vqvae-model_parameters.json",
        tmp_path / "j" / "vqvae-weights.msgpack")
    assert loaded.config == tmodel.config and not loaded.training
    for key, value in tmodel.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key

    checkpoint_io.save_model(tmp_path / "t", tmodel, "vqvae")
    assert json.loads((tmp_path / "t" / "vqvae-model_parameters.json"
                       ).read_text()) == json.loads(
        (tmp_path / "j" / "vqvae-model_parameters.json").read_text())
    _, back = jv.from_parameters_and_weights(
        tmp_path / "t" / "vqvae-model_parameters.json",
        tmp_path / "t" / "vqvae-weights.msgpack")
    assert_trees_equal(to_numpy(back), to_numpy(variables))


@pytest.mark.parametrize("which", ["top", "bottom"])
def test_prior_checkpoint_both_ways(which, tmp_path):
    from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
        transformer as tprior)
    common = dict(
        n_class=16, d_model=32, embeddings_dim=8,
        positional_embeddings_dim=8, dropout=0.0, d_ff=64,
        conditional_model_num_encoder_layers=1,
        conditional_model_num_decoder_layers=1, conditional_model_nhead=4,
        class_conditioning_num_classes_per_modality={"pitch": 5},
        class_conditioning_embedding_dim_per_modality={"pitch": 4},
        class_conditioning_prepend_to_dummy_input=True)
    if which == "top":
        cfg = jprior.TransformerConfig(shape=(4, 2), condition_shape=(4, 2),
                                       self_conditional_model=True, **common)
    else:
        cfg = jprior.TransformerConfig(shape=(8, 4), condition_shape=(4, 2),
                                       use_aligned_decoder=True, **common)
    jmodel = jprior.VQNSynthTransformer(cfg)
    variables = jax.jit(lambda key: jmodel.init(
        {"params": key}, jnp.zeros((1,) + tuple(cfg.shape), jnp.int32),
        jnp.zeros((1,) + tuple(cfg.condition_shape), jnp.int32),
        class_conditioning={"pitch": jnp.zeros((1,), jnp.int32)},
        method=jprior.VQNSynthTransformer.full_init))(jax.random.PRNGKey(1))
    jprior.save_model(tmp_path / "j", cfg, variables, which)
    loaded = checkpoint_io.prior_from_parameters_and_weights(
        tmp_path / "j" / f"{which}-model_parameters.json",
        tmp_path / "j" / f"{which}-weights.msgpack")
    expected = weights.from_flax_params(to_numpy(variables))
    assert set(loaded.state_dict()) == set(expected)
    for key, value in expected.items():
        assert torch.equal(loaded.state_dict()[key], value), key
    assert isinstance(loaded, tprior.VQNSynthTransformer)

    checkpoint_io.save_model(tmp_path / "t", loaded, which)
    _, back = jprior.from_parameters_and_weights(
        tmp_path / "t" / f"{which}-model_parameters.json",
        tmp_path / "t" / f"{which}-weights.msgpack")
    assert_trees_equal(to_numpy(back), to_numpy(variables))


def test_msgpack_subset_against_the_library():
    """The port's reader and writer against the msgpack package on the value
    types flax's files use, at every length form."""
    import msgpack
    value = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33,
                 -129, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1e300], "none": None, "flags": [True, False],
        "str": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
        "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "list16": list(range(20)), "map16": {str(i): i for i in range(20)},
    }
    packed = checkpoint_io.msgpack_pack(value)
    assert packed == msgpack.packb(value, use_bin_type=True)
    assert checkpoint_io.msgpack_unpack(packed) == value
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": {"c": np.zeros((0, 4), np.int32)},
              "scalar": np.float32(2.5)}
    from flax import serialization
    theirs = serialization.msgpack_restore(
        checkpoint_io.msgpack_pack(arrays))
    mine = checkpoint_io.msgpack_unpack(
        serialization.msgpack_serialize(arrays))
    for tree in (theirs, mine):
        np.testing.assert_array_equal(tree["a"], arrays["a"])
        assert tree["b"]["c"].shape == (0, 4)
        assert tree["b"]["c"].dtype == np.int32
        assert tree["scalar"] == np.float32(2.5)
    with pytest.raises(ValueError):
        checkpoint_io.msgpack_unpack(packed[:-3])
    with pytest.raises(ValueError):
        checkpoint_io.msgpack_unpack(packed + b"\x00")
    with pytest.raises(TypeError):
        checkpoint_io.msgpack_pack({"a": object()})
