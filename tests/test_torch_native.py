"""The port's C++ runtime (``data/native.py``, ``data/csrc/isi_native.cpp``)
against the port's numpy paths and the JAX package's native library.

The store reader must give the batches of the port's numpy memmap path and
of the JAX package's ``CodemapDataset(use_native=True)``, bit for bit, on a
store written by the JAX writer and on one written by the port's; the WAV
encoder the bytes of the JAX native encoder; the decoder the samples of
the port's ``read_wav`` for PCM 16 / 24 / 32 and float32.
"""

import pathlib
import struct

import numpy as np
import pytest

from interactive_spectrogram_inpainting_tpu.data import (
    codemap_store as jstore, native as jnative)
from interactive_spectrogram_inpainting_tpu_torch.data import (
    codemap_store as tstore, native)
from interactive_spectrogram_inpainting_tpu_torch.data.label_encoders import (
    LabelEncoder)
from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
    read_wav, write_wav)

TOP, BOTTOM = (4, 2), (8, 4)
FIELDS = ["pitch", "instrument_family_str"]
RECORDS = 23


def store_rows():
    rng = np.random.default_rng(0)
    tops = rng.integers(0, 512, (RECORDS,) + TOP)
    bottoms = rng.integers(0, 512, (RECORDS,) + BOTTOM)
    attrs = {"pitch": rng.integers(0, 61, RECORDS),
             "instrument_family_str": rng.integers(0, 11, RECORDS)}
    names = [f"note_{i}" for i in range(RECORDS)]
    return tops, bottoms, attrs, names


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{writer: store directory}: the same rows by the JAX writer (one
    ``append`` a row) and by the port's (``append`` for the first rows,
    ``append_batch`` for the rest)."""
    tops, bottoms, attrs, names = store_rows()
    out = {}
    for name, module in (("jax", jstore), ("port", tstore)):
        directory = tmp_path_factory.mktemp(f"store_{name}")
        with module.CodemapStoreWriter(
                directory, top_shape=TOP, bottom_shape=BOTTOM,
                attribute_fields=FIELDS, n_class=512,
                label_encoders={"pitch": LabelEncoder(list(range(61)))}
                ) as w:
            if name == "jax":
                for i in range(RECORDS):
                    w.append(tops[i], bottoms[i],
                             {f: attrs[f][i] for f in FIELDS}, names[i])
            else:
                w.append(tops[0], bottoms[0], {f: attrs[f][0] for f in FIELDS},
                         names[0])
                w.append_batch(tops[1:], bottoms[1:],
                               {f: v[1:] for f, v in attrs.items()},
                               names[1:])
        out[name] = directory
    return out


def test_library_builds_into_its_build_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("ISI_TORCH_NATIVE_DIR", str(tmp_path / "native"))
    lib = native.load_library()
    path = native.library_path()
    assert path.parent == tmp_path / "native" and path.exists()
    assert path.name.startswith("libisi_native-") and path.suffix == ".so"
    assert sorted(p.name for p in path.parent.iterdir()) == [path.name]
    assert native.load_library() is lib


def test_writers_write_the_same_store(stores):
    for name in ("codes.bin", "filenames.json", "label_encoders.json"):
        assert ((stores["jax"] / name).read_bytes()
                == (stores["port"] / name).read_bytes()), name


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("classes", [None, ["pitch"]])
def test_reader_matches_numpy_path_and_jax_reader(stores, writer, classes):
    directory = stores[writer]
    ds_native = tstore.CodemapDataset(directory, classes, use_native=True)
    ds_numpy = tstore.CodemapDataset(directory, classes)
    ds_jax = jstore.CodemapDataset(directory, classes, use_native=True)
    assert ds_jax._native is not None, "the JAX native reader did not load"
    assert ds_numpy._native is None
    rng = np.random.default_rng(1)
    for idx in ([0], [5, 3, 3, 22, 0], rng.permutation(RECORDS),
                rng.integers(0, RECORDS, 64)):
        got = ds_native.read_batch(idx)
        for other in (ds_numpy.read_batch(idx), ds_jax.read_batch(idx)):
            for a, b in zip(got[:2], other[:2]):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
            assert list(got[2]) == list(other[2])
            for field in got[2]:
                assert got[2][field].dtype == other[2][field].dtype
                np.testing.assert_array_equal(got[2][field],
                                              other[2][field])
    tops, bottoms, attrs, _ = store_rows()
    t, b, a = ds_native.read_batch(np.arange(RECORDS))
    np.testing.assert_array_equal(t, tops)
    np.testing.assert_array_equal(b, bottoms)
    np.testing.assert_array_equal(a["pitch"], attrs["pitch"])


def test_reader_out_of_range_and_default(stores):
    assert tstore.CodemapDataset(stores["port"])._native is None
    ds = tstore.CodemapDataset(stores["port"], use_native=True)
    assert isinstance(ds._native, native.NativeStoreReader)
    assert len(ds._native) == RECORDS
    for bad in ([RECORDS], [0, -1]):
        with pytest.raises(IndexError):
            ds.read_batch(bad)
    reader = ds._native
    reader.close()
    with pytest.raises(ValueError):
        reader.read_batch([0])


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_encode_matches_jax_native(channels):
    assert jnative.load_library() is not None, "the JAX native build failed"
    rng = np.random.default_rng(channels)
    audio = (rng.standard_normal((channels, 4001)) * 0.5).astype(np.float32)
    audio[:, :3] = [1.5, -1.5, 0.99998]  # clipped, rounded
    audio = audio[0] if channels == 1 else audio
    blob = native.wav_encode_pcm16(audio, 16000)
    assert blob == jnative.wav_encode_pcm16(audio, 16000)
    decoded, sr = native.wav_decode(blob)
    assert sr == 16000 and decoded.shape == (channels, 4001)
    np.testing.assert_allclose(decoded.reshape(audio.shape),
                               np.clip(audio, -1, 1), atol=2.0 / 32768)


def pcm_wav(samples: np.ndarray, bits: int, fmt_code: int = 1,
            sample_rate: int = 22050) -> bytes:
    """[channels, n] integer (or float32) samples -> WAV bytes."""
    channels = samples.shape[0]
    inter = samples.T.reshape(-1)
    if bits == 24:
        v = inter.astype(np.int64) & 0xFFFFFF
        payload = np.stack([v & 0xFF, (v >> 8) & 0xFF, v >> 16],
                           axis=1).astype(np.uint8).tobytes()
    else:
        dtype = {16: "<i2", 32: "<f4" if fmt_code == 3 else "<i4"}[bits]
        payload = inter.astype(dtype).tobytes()
    fmt = struct.pack("<HHIIHH", fmt_code, channels, sample_rate,
                      sample_rate * channels * bits // 8,
                      channels * bits // 8, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data"
            + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("bits,fmt_code", [(16, 1), (24, 1), (32, 1),
                                           (32, 3)])
def test_wav_decode_round_trips(bits, fmt_code, tmp_path):
    rng = np.random.default_rng(bits + fmt_code)
    if fmt_code == 3:
        samples = rng.uniform(-1, 1, (2, 777)).astype(np.float32)
        expected = samples
    else:
        top = 2 ** (bits - 1)
        samples = rng.integers(-top, top, (2, 777))
        samples[:, :2] = [[-top, top - 1], [0, -1]]
        expected = (samples / float(top)).astype(np.float32)
    blob = pcm_wav(samples, bits, fmt_code)
    decoded, sr = native.wav_decode(blob)
    assert sr == 22050 and decoded.dtype == np.float32
    np.testing.assert_array_equal(decoded, expected)
    np.testing.assert_array_equal(decoded, read_wav(blob)[0])
    if bits == 16:  # and the files the port's writer writes
        path = pathlib.Path(tmp_path) / "w.wav"
        write_wav(path, expected, 22050)
        np.testing.assert_array_equal(native.wav_decode(path.read_bytes())[0],
                                      read_wav(str(path))[0])


def test_wav_decode_rejects_malformed():
    def wav(fmt_payload, data_payload=b"\x00" * 8):
        fmt = b"fmt " + struct.pack("<I", len(fmt_payload)) + fmt_payload
        data = b"data" + struct.pack("<I", len(data_payload)) + data_payload
        body = b"WAVE" + fmt + data
        return b"RIFF" + struct.pack("<I", len(body)) + body

    zero_bits = wav(struct.pack("<HHIIHH", 1, 1, 16000, 0, 0, 0))
    short_fmt = (b"RIFF" + struct.pack("<I", 20) + b"WAVE" + b"fmt "
                 + struct.pack("<I", 16) + b"\x01\x00\x01\x00")
    tiny_fmt = wav(struct.pack("<HH", 1, 1))
    ext_fmt = wav(struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 32000, 2, 16))
    for blob in (zero_bits, short_fmt, tiny_fmt, ext_fmt, b"RIFF"):
        with pytest.raises(ValueError):
            native.wav_decode(blob)
