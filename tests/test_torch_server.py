"""The port's serving slice vs the JAX server, on the tiny test state.

Both servers hold the same weights (the JAX state's variables through
``from_flax_params``). ``/timerange-change`` (top -> bottom cascade, bf16,
both priors primed), ``/generate`` and the padded batch of
``/top-conditioned-sample`` are fed the JAX server's Gumbel noise and must
return the same codemaps, as must the dense and predictive samplers that
``sampling_options`` select; ``/get-audio`` must decode the same audio (1e-4
of its peak) and the same spectrogram (atol 1e-4).

The encode endpoints (``/analyze-audio``, ``/erase``) return the JAX server's
codes on every cell whose two best scores differ by more than 1e-4 in the
port's own scores (``tests/test_torch_encode.py`` explains the margin);
uploads are whole 32-frame blocks long and carry a noise floor in every
band, since the phase of an all-zero padding frame, or of a bin whose
magnitude is below the FFT's float32 rounding, depends on the FFT library.
``/get-spectrogram-image`` is within one palette step of the JAX server's
image and of the host oracle. The bucket functions agree exactly."""

import io
import json
import struct
import types
import zipfile
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_decode import jax_gumbel
from tests.test_torch_encode import MARGIN, harmonic_note, score_margin
from interactive_spectrogram_inpainting_tpu.models.vqvae.vqvae import (
    VQVAE as JVQVAE)
from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
    read_wav, write_wav)
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    scan_range)
from interactive_spectrogram_inpainting_tpu_torch.serve.http_app import (
    Request)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    from_flax_params)

QUERY = ("layer=top&temperature=1.0&start_index_top=0&pitch=60"
         "&instrument_family_str=keyboard")


@pytest.fixture(scope="module")
def servers():
    from interactive_spectrogram_inpainting_tpu.serve import server as jsrv
    from interactive_spectrogram_inpainting_tpu_torch.serve import (
        server as tsrv)
    jstate = jsrv.make_test_state("tiny")
    tstate = tsrv.make_test_state("tiny", device="cpu")
    for name, variables in (("vqvae", jstate.vqvae_variables),
                            ("top", jstate.top_variables),
                            ("bottom", jstate.bottom_variables)):
        getattr(tstate, name).load_state_dict(from_flax_params(
            jax.tree_util.tree_map(np.asarray, variables)))
    tsrv.STATE = tstate
    return jsrv, jstate, tsrv, tstate


def payload(state, mask):
    rng = np.random.default_rng(0)
    return {"top_code": rng.integers(0, 32, state.top.config.shape).tolist(),
            "bottom_code": rng.integers(
                0, 32, state.bottom.config.shape).tolist(),
            "mask": mask.tolist()}


def post(tsrv, path, query, body):
    response = tsrv.app.handle(Request.synthetic(
        path, query, json.dumps(body).encode()))
    assert response.status == 200, response.body[:2000]
    return response


def test_make_test_state_configs_match_jax(servers):
    jsrv, jstate, tsrv, tstate = servers
    for name in ("top", "bottom"):
        assert json.loads(getattr(jstate, name).config.to_json()) == \
            json.loads(getattr(tstate, name).config.to_json())
    assert (json.loads(jstate.vqvae.config.to_json())
            == json.loads(tstate.vqvae.config.to_json()))


def test_timerange_change_top_cascade_matches_jax(servers):
    jsrv, jstate, tsrv, tstate = servers
    top_shape = tstate.top.config.shape
    bottom_shape = tstate.bottom.config.shape
    mask = np.zeros(top_shape, bool)
    mask[:, 4:6] = True  # known prefix and suffix in both priors
    body = payload(tstate, mask)
    top = np.asarray(body["top_code"], np.int32)[None]
    bottom = np.asarray(body["bottom_code"], np.int32)[None]
    rf = bottom_shape[0] // top_shape[0]
    rt = bottom_shape[1] // top_shape[1]
    mask_b = np.repeat(np.repeat(mask, rf, 0), rt, 1)

    sf, su = jstate.mask_scan_bounds("top", mask[None])
    sf_b, su_b = jstate.mask_scan_bounds("bottom", mask_b)
    assert (sf, su, sf_b, su_b) == (
        tstate.mask_scan_bounds("top", mask[None])
        + tstate.mask_scan_bounds("bottom", mask_b))
    assert sf and sf_b, "both priors must be primed"
    key = np.array([1234, 1], np.uint32)
    cc = jstate.encode_conditioning("60", "keyboard")
    j_top, j_bottom = jstate.cascade_fn(sf, su, sf_b, su_b)(
        key, 1.0, top, bottom, mask, mask_b, cc)

    key_t, key_b = jax.random.split(jnp.asarray(key))
    noise = {}
    for which, k, bounds in (("top", key_t, (sf, su)),
                             ("bottom", key_b, (sf_b, su_b))):
        model = getattr(tstate, which)
        p0, steps = scan_range(model, *bounds)
        noise[which] = torch.as_tensor(jax_gumbel(
            k, p0, steps, model.config.n_class_target))
    tstate.gumbel_source = noise.__getitem__
    try:
        data = json.loads(post(tsrv, "/timerange-change", QUERY, body).body)
    finally:
        tstate.gumbel_source = None
    np.testing.assert_array_equal(np.asarray(data["top_code"]),
                                  np.asarray(j_top)[0])
    np.testing.assert_array_equal(np.asarray(data["bottom_code"]),
                                  np.asarray(j_bottom)[0])
    after_top = np.asarray(data["top_code"])
    after_bottom = np.asarray(data["bottom_code"])
    np.testing.assert_array_equal(after_top[~mask], top[0][~mask])
    np.testing.assert_array_equal(after_bottom[~mask_b], bottom[0][~mask_b])
    assert not np.array_equal(after_bottom[mask_b], bottom[0][mask_b])


def test_timerange_change_other_paths(servers):
    """Bottom layer, uniform sampling and a long-sound window run and keep
    every unmasked cell (drawn noise, no JAX reference)."""
    jsrv, jstate, tsrv, tstate = servers
    top_shape = tstate.top.config.shape
    mask_b = np.zeros(tstate.bottom.config.shape, bool)
    mask_b[:, 6:9] = True
    body = payload(tstate, mask_b)
    data = json.loads(post(tsrv, "/timerange-change",
                           QUERY.replace("layer=top", "layer=bottom"),
                           body).body)
    after = np.asarray(data["bottom_code"])
    before = np.asarray(body["bottom_code"])
    np.testing.assert_array_equal(after[~mask_b], before[~mask_b])
    assert not np.array_equal(after[mask_b], before[mask_b])

    rng = np.random.default_rng(3)
    mask = np.zeros(top_shape, bool)
    mask[:, 2:4] = True
    long_body = {
        "top_code": rng.integers(0, 32, (top_shape[0],
                                         2 * top_shape[1])).tolist(),
        "bottom_code": rng.integers(
            0, 32, (tstate.bottom.config.shape[0],
                    2 * tstate.bottom.config.shape[1])).tolist(),
        "mask": mask.tolist()}
    data = json.loads(post(
        tsrv, "/timerange-change",
        QUERY.replace("start_index_top=0", "start_index_top=4"),
        long_body).body)
    before_top = np.asarray(long_body["top_code"])
    after_top = np.asarray(data["top_code"])
    window = np.zeros_like(before_top, bool)
    window[:, 4:4 + top_shape[1]] = mask
    np.testing.assert_array_equal(after_top[~window], before_top[~window])


def test_get_audio_matches_jax(servers):
    jsrv, jstate, tsrv, tstate = servers
    body = payload(tstate, np.zeros(tstate.top.config.shape, bool))
    top = np.asarray(body["top_code"], np.int32)[None]
    bottom = np.asarray(body["bottom_code"], np.int32)[None]
    ref_spec = np.asarray(jstate.vqvae.apply(
        jstate.vqvae_variables, jnp.asarray(top), jnp.asarray(bottom),
        method=JVQVAE.decode_code))
    with torch.no_grad():
        spec = tstate.vqvae.decode_code(torch.as_tensor(top),
                                        torch.as_tensor(bottom)).numpy()
    np.testing.assert_allclose(spec, ref_spec, atol=1e-4, rtol=1e-4)
    ref_audio = np.asarray(jstate.decode_audio_fn()(top, bottom))
    audio = tstate.decode_audio_fn()(top, bottom).numpy()
    np.testing.assert_allclose(audio, ref_audio,
                               atol=1e-4 * max(1.0, np.abs(ref_audio).max()))
    response = post(tsrv, "/get-audio", "", body)
    assert response.content_type == "audio/wav"
    wav, sr = read_wav(io.BytesIO(response.body))
    assert sr == tstate.fs_hz and wav.shape[-1] == audio.shape[-1]
    assert np.isfinite(wav).all()


def test_generate_matches_jax(servers):
    """``/generate``: the unprimed batch-1 fused scan of the top prior, then
    of the bottom prior under it, with the JAX server's noise."""
    jsrv, jstate, tsrv, tstate = servers
    cc = jstate.encode_conditioning(60, "keyboard")
    keys = {"top": np.array([7, 1], np.uint32),
            "bottom": np.array([7, 2], np.uint32)}
    j_top = jstate.sample_fn("top", 1)(
        keys["top"], 0.9, jnp.zeros((1,) + tuple(jstate.top.config.shape),
                                    jnp.int32), None, None, cc, None, None)
    j_bottom = jstate.sample_fn("bottom", 1)(
        keys["bottom"], 0.9, j_top, None, None, cc, None, None)

    def noise(which):
        model = getattr(tstate, which)
        p0, steps = scan_range(model, None, None)
        return torch.as_tensor(jax_gumbel(
            jnp.asarray(keys[which]), p0, steps,
            model.config.n_class_target))
    tstate.gumbel_source = noise
    try:
        data = json.loads(post(
            tsrv, "/generate",
            "pitch=60&instrument_family_str=keyboard&temperature=0.9",
            {}).body)
    finally:
        tstate.gumbel_source = None
    np.testing.assert_array_equal(np.asarray(data["top_code"]),
                                  np.asarray(j_top)[0])
    np.testing.assert_array_equal(np.asarray(data["bottom_code"]),
                                  np.asarray(j_bottom)[0])
    top_map, bottom_map = jsrv.conditioning_maps(jstate, 60, "keyboard")
    assert data["top_conditioning"] == top_map
    assert data["bottom_conditioning"] == bottom_map


def test_generate_predictive_from_scratch(servers, monkeypatch):
    """``/generate`` on a server started with ``--use_predictive_sampling``:
    the top prior is sampled from scratch by the predictive sampler (its
    codemap starts as the mask token everywhere), then the bottom prior
    under it; the request succeeds with codemaps of the models' shapes
    and classes."""
    jsrv, jstate, tsrv, tstate = servers
    monkeypatch.setattr(tstate, "sampling_options", {"predictive": True})
    data = json.loads(post(
        tsrv, "/generate",
        "pitch=60&instrument_family_str=keyboard&temperature=1.0", {}).body)
    for name in ("top", "bottom"):
        code = np.asarray(data[f"{name}_code"])
        cfg = getattr(tstate, name).config
        assert code.shape == tuple(cfg.shape)
        assert ((code >= 0) & (code < cfg.n_class)).all()


def test_test_generate(servers):
    jsrv, jstate, tsrv, tstate = servers
    data = json.loads(post(tsrv, "/test-generate",
                           "pitch=64&instrument_family_str=organ", {}).body)
    top = np.asarray(data["top_code"])
    bottom = np.asarray(data["bottom_code"])
    assert top.shape == tuple(tstate.top.config.shape)
    assert bottom.shape == tuple(tstate.bottom.config.shape)
    assert (top >= 0).all() and (top < tstate.vqvae.config.n_embed_t).all()
    assert (bottom >= 0).all() \
        and (bottom < tstate.vqvae.config.n_embed_b).all()
    top_map, bottom_map = jsrv.conditioning_maps(jstate, 64, "organ")
    assert data["top_conditioning"] == top_map
    assert data["bottom_conditioning"] == bottom_map


def test_top_conditioned_sample_pads_to_bucket_and_matches_jax(servers):
    """A 3-pitch range runs at the padded batch bucket (16: the batched
    step kernel's path) with one pitch per row, returns exactly 3 wavs named
    per pitch, and samples the JAX server's codemaps under its noise. The
    JAX fused sampler starts every row from row 0's start rows
    (``ROADMAP.md`` section 3), so each row is held to the JAX server's
    request in which the whole batch has that row's pitch.

    The server samples in bfloat16, where a float32 sum taken in another
    order can flip the rounding of an activation and, with it, a token
    whose two best noisy logits lie within ~1e-3: over the 16 x 512 tokens
    of this request a handful differ (the float32 samplers are held to
    exact equality in ``test_torch_sampling.py``), so at most 0.5 % may."""
    jsrv, jstate, tsrv, tstate = servers
    assert tstate.pitch_batch_buckets == jstate.pitch_batch_buckets
    bucket = tstate.pitch_batch_buckets[0]
    body = payload(tstate, np.zeros(tstate.top.config.shape, bool))
    top = np.asarray(body["top_code"], np.int32)[None]
    pitches = [70, 71, 72]
    padded = pitches + [72] * (bucket - 3)
    key = np.array([9, 1], np.uint32)
    condition = jnp.broadcast_to(top, (bucket,) + top.shape[1:])
    j_bottom = None
    for pitch in sorted(set(padded)):
        cc = {"pitch": jnp.asarray(
                  jstate.label_encoders["pitch"].transform([pitch] * bucket)),
              "instrument_family_str": jnp.asarray(
                  jstate.label_encoders["instrument_family_str"].transform(
                      ["keyboard"] * bucket))}
        out = np.asarray(jstate.sample_fn("bottom", bucket)(
            key, 1.0, condition, None, None, cc, None, None))
        rows = np.asarray(padded) == pitch
        if j_bottom is None:
            j_bottom = out.copy()
        j_bottom[rows] = out[rows]

    model = tstate.bottom
    p0, steps = scan_range(model, None, None)
    keys = jax.random.split(jnp.asarray(key), steps)[p0:]
    noise = torch.as_tensor(np.array(jax.vmap(lambda k: jax.random.gumbel(
        k, (bucket, model.config.n_class_target)))(keys)))
    sampled = []
    real_sample = tstate._sample

    def recording_sample(which, generator, batch_size, *args):
        out = real_sample(which, generator, batch_size, *args)
        sampled.append((which, batch_size, out))
        return out
    tstate._sample = recording_sample
    tstate.gumbel_source = lambda which: noise
    try:
        response = post(
            tsrv, "/top-conditioned-sample",
            "instrument_family_str=keyboard&min_pitch=70&max_pitch=73"
            "&temperature=1.0", body)
    finally:
        tstate.gumbel_source = None
        del tstate._sample
    assert response.content_type == "application/zip"
    [(which, batch_size, t_bottom)] = sampled
    assert (which, batch_size) == ("bottom", bucket)
    assert t_bottom.shape == j_bottom.shape
    assert np.mean(t_bottom.numpy() != j_bottom) <= 0.005
    assert not np.array_equal(j_bottom[0], j_bottom[1])
    j_audio = np.asarray(jstate.decode_audio_fn()(
        condition, jnp.asarray(t_bottom.numpy())))
    with zipfile.ZipFile(io.BytesIO(response.body)) as zf:
        assert zf.namelist() == [f"keyboard-{p}.wav" for p in pitches]
        for row, name in enumerate(zf.namelist()):
            wav, sr = read_wav(io.BytesIO(zf.read(name)))
            assert sr == tstate.fs_hz
            assert wav.shape[-1] == j_audio.shape[-1]
            np.testing.assert_allclose(
                wav.reshape(-1), j_audio[row],
                atol=2e-4 * max(1.0, np.abs(j_audio).max()))


@pytest.mark.parametrize("options,sampler", [
    ({}, "_fused_scan_sample"),
    ({"top_k": 4, "top_p": 0.0}, "_scan_sample"),
    ({"top_k": 0, "top_p": 0.8}, "_scan_sample"),
    ({"predictive": True}, "_predictive_sample")],
    ids=["fused", "top_k", "top_p", "predictive"])
def test_sampling_options_route_like_jax(servers, monkeypatch, caplog,
                                         options, sampler):
    """``sampling_options`` leave the fused kernels for the dense scan
    (top-k / top-p) or the predictive sampler exactly where the JAX
    server's ``_fused_ok`` does, and the served function inpaints through
    that sampler. (Token equality with the JAX samplers is held in
    float32 by ``test_torch_sampling.py``; the server samples in bfloat16,
    where filtered logits tie within one rounding.)"""
    from interactive_spectrogram_inpainting_tpu_torch.sampling import sample
    jsrv, jstate, tsrv, tstate = servers
    top_shape = tuple(tstate.top.config.shape)
    rng = np.random.default_rng(11)
    initial = rng.integers(0, 32, (1,) + top_shape).astype(np.int32)
    mask = np.zeros(top_shape, bool)
    mask[:, 2:4] = True
    cc = tstate.encode_conditioning(60, "keyboard")
    sf, su = tstate.mask_scan_bounds("top", mask)
    calls = []
    for name in ("_fused_scan_sample", "_scan_sample", "_predictive_sample"):
        def spy(*args, _name=name, _fn=getattr(sample, name), **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(sample, name, spy)
    monkeypatch.setattr(jstate, "sampling_options", dict(options))
    monkeypatch.setattr(tstate, "sampling_options", dict(options))
    for which in ("top", "bottom"):
        assert tstate._fused_ok(which) == jstate._fused_ok(which)
    assert tstate._fused_ok("top") == (sampler == "_fused_scan_sample")
    with caplog.at_level("INFO", logger="isi-server-torch"):
        out = tstate.sample_fn("top", 1, sf, su)(
            tstate.next_rng(), 1.0, initial, initial, mask[None], cc, None,
            None).numpy()
    assert calls == [sampler]
    assert ("predictive sampling (top)" in caplog.text) == (
        sampler == "_predictive_sample")
    assert out.shape == (1,) + top_shape
    assert (out >= 0).all() and (out < tstate.top.config.n_class).all()
    np.testing.assert_array_equal(out[0][~mask], initial[0][~mask])
    assert not np.array_equal(out[0][mask], initial[0][mask])


def test_main_parses_sampling_flags(monkeypatch):
    from interactive_spectrogram_inpainting_tpu_torch.serve import (
        server as tsrv)
    seen = {}
    state = types.SimpleNamespace(codes_dataset=None)

    def fake_state(size, device, seed, sampling_options):
        seen.update(size=size, device=device, options=sampling_options)
        return state

    monkeypatch.setattr(tsrv, "make_test_state", fake_state)
    monkeypatch.setattr(tsrv.app, "run", lambda host, port: None)
    monkeypatch.setattr(
        tsrv, "warmup", lambda st, log, long_sounds: seen.update(
            warmed=st is state, long_sounds=long_sounds) or 0)
    old = tsrv.STATE
    try:
        tsrv.main(["--test_models", "tiny", "--device", "cpu",
                   "--sampling_top_k", "5", "--sampling_top_p", "0.9",
                   "--use_predictive_sampling",
                   "--spectrograms_upsampling_factor", "2",
                   "--warmup_long"])
        with pytest.raises(SystemExit):  # neither test models nor files
            tsrv.main(["--device", "cpu"])
    finally:
        tsrv.STATE = old
    assert seen == {"size": "tiny", "device": "cpu", "options": {
        "top_k": 5, "top_p": 0.9, "predictive": True},
        "warmed": True, "long_sounds": True}
    assert state.spectrograms_upsampling_factor == 2


# -- the encode endpoints -----------------------------------------------------

def jax_handle(jsrv, jstate, path, query, body=None, files=None):
    from interactive_spectrogram_inpainting_tpu.serve.http_app import (
        Request as JRequest)
    request = JRequest.synthetic(
        path, query, json.dumps(body).encode() if body is not None else b"")
    if files:
        request.files = dict(files)
    old, jsrv.STATE = jsrv.STATE, jstate
    try:
        response = jsrv.app.handle(request)
    finally:
        jsrv.STATE = old
    assert response.status == 200, response.body[:2000]
    return response


def assert_codes_match(tstate, spec, mine, theirs):
    """Top and bottom codes equal wherever the port's own lookup inputs for
    ``spec`` are more than MARGIN away from a tie."""
    vq = tstate.vqvae
    with torch.no_grad():
        enc_b = vq.enc_b(spec)
        qt_in = vq.quantize_conv_t(vq.enc_t(enc_b))
        qb_in = vq.quantize_conv_b(torch.cat(
            [vq.dec_t(vq.quantize_t(qt_in)[0]), enc_b], dim=1))
    top_equal = True
    for name, lookup_in, level in (("top_code", qt_in, vq.quantize_t),
                                   ("bottom_code", qb_in, vq.quantize_b)):
        flat = lookup_in.permute(0, 2, 3, 1).reshape(-1, level.dim)
        clear = (score_margin(flat, level.embed) > MARGIN).reshape(
            lookup_in.shape[2:])
        a, b = np.asarray(mine[name]), np.asarray(theirs[name])
        assert a.shape == b.shape
        clear = clear[:, :a.shape[1]]
        print(f"{name}: {int((~clear).sum())} of {clear.size} cells within "
              f"{MARGIN} of a tie")
        assert clear.mean() > 0.98
        if name == "bottom_code" and not top_equal:
            continue  # a flipped top code changes the bottom's input
        np.testing.assert_array_equal(a[clear], b[clear])
        top_equal = np.array_equal(a, b)


def wav_upload(audio, sample_rate):
    buf = io.BytesIO()
    write_wav(buf, audio, sample_rate)
    return {"audio": buf.getvalue()}


@pytest.mark.parametrize("n,sample_rate,cols", [
    (8192, 16000, 16),   # the longest bucket of the tiny state
    (8192, 32000, 8),    # resampled to 4096 samples: the shortest bucket
    (9000, 16000, 16),   # trimmed to the maximum duration
])
def test_analyze_audio_matches_jax(servers, n, sample_rate, cols):
    jsrv, jstate, tsrv, tstate = servers
    audio = harmonic_note(np.random.default_rng(n), n, fs=sample_rate)
    files = wav_upload(audio, sample_rate)
    query = "pitch=62&instrument_family_str=organ"
    request = Request.synthetic("/analyze-audio", query, b"")
    request.files = dict(files)
    response = tsrv.app.handle(request)
    assert response.status == 200, response.body[:2000]
    mine = json.loads(response.body)
    theirs = json.loads(jax_handle(jsrv, jstate, "/analyze-audio", query,
                                   files=files).body)
    assert np.asarray(mine["top_code"]).shape == (16, cols)
    assert np.asarray(mine["bottom_code"]).shape == (32, 2 * cols)
    assert mine["top_conditioning"] == theirs["top_conditioning"]
    assert mine["bottom_conditioning"] == theirs["bottom_conditioning"]
    decoded, _ = read_wav(files["audio"])
    decoded = decoded[0]
    if sample_rate != 16000:
        from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
            resample)
        decoded = resample(decoded, sample_rate, 16000)
    spec = tstate.helper.to_spectrogram(
        torch.as_tensor(decoded[:tstate.snap_analyze_duration(
            min(8192, decoded.shape[-1]))])[None])
    assert_codes_match(tstate, spec, mine, theirs)


def test_erase_matches_jax(servers):
    jsrv, jstate, tsrv, tstate = servers
    top_shape = tstate.top.config.shape
    mask = np.zeros(top_shape, bool)
    mask[4:12, 2:5] = True
    body = payload(tstate, mask)
    body["top_conditioning"] = {"pitch": [[60]]}
    body["bottom_conditioning"] = {"pitch": [[61]]}
    query = "eraser_amplitude=0.7&start_index_top=0"
    mine = json.loads(post(tsrv, "/erase", query, body).body)
    theirs = json.loads(jax_handle(jsrv, jstate, "/erase", query, body).body)
    assert mine["top_conditioning"] == {"pitch": [[60]]}
    assert mine["bottom_conditioning"] == {"pitch": [[61]]}
    # the port's own masked spectrogram, for the margins
    top = torch.as_tensor(np.asarray(body["top_code"])[None])
    bottom = torch.as_tensor(np.asarray(body["bottom_code"])[None])
    with torch.no_grad():
        spec = tstate.vqvae.decode_code(top, bottom)
    full_mask = 200.0 * 0.7 * np.repeat(np.repeat(
        mask.astype(np.float32), 8, axis=0), 8, axis=1)
    spec = torch.cat([spec[:, 0:1] - torch.as_tensor(full_mask)[None, None],
                      spec[:, 1:2]], dim=1)
    assert_codes_match(tstate, spec, mine, theirs)
    # erasing changes codes under the mask and the request's codes differ
    assert mine["top_code"] != body["top_code"]
    # a window further right on a sound twice as long
    long_body = {"top_code": np.tile(np.asarray(body["top_code"]),
                                     (1, 2)).tolist(),
                 "bottom_code": np.tile(np.asarray(body["bottom_code"]),
                                        (1, 2)).tolist(),
                 "mask": mask.tolist()}
    query = "eraser_amplitude=1.0&start_index_top=8"
    mine = json.loads(post(tsrv, "/erase", query, long_body).body)
    theirs = json.loads(jax_handle(jsrv, jstate, "/erase", query,
                                   long_body).body)
    a, b = np.asarray(mine["top_code"]), np.asarray(theirs["top_code"])
    assert a.shape == b.shape == (16, 16)
    assert (a == b).mean() > 0.98


def png_indices(blob, lut):
    width, height = struct.unpack(">II", blob[16:24])
    idat = blob[blob.index(b"IDAT") + 4:blob.rindex(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + width * 3)
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and (raw[:, 0] == 0).all()
    rgb = raw[:, 1:].reshape(height, width, 3)
    inverse = {tuple(c): i for i, c in enumerate(lut)}
    return np.array([[inverse[tuple(px)] for px in row] for row in rgb])


def test_get_spectrogram_image_matches_jax_and_host_oracle(servers):
    jsrv, jstate, tsrv, tstate = servers
    body = payload(tstate, np.zeros(tstate.top.config.shape, bool))
    response = post(tsrv, "/get-spectrogram-image", "", body)
    assert response.content_type == "image/png"
    np.testing.assert_array_equal(tsrv._viridis_lut(), jsrv._viridis_lut())
    mine = png_indices(response.body, tsrv._viridis_lut())
    assert mine.shape == (128, 64 * 4)  # F x (T x upsampling factor)
    theirs = png_indices(jax_handle(jsrv, jstate, "/get-spectrogram-image",
                                    "", body).body, jsrv._viridis_lut())
    assert int(np.abs(mine - theirs).max()) <= 1
    assert (mine == theirs).mean() > 0.99
    with torch.no_grad():
        spec = tstate.vqvae.decode_code(
            torch.as_tensor(np.asarray(body["top_code"])[None]),
            torch.as_tensor(np.asarray(body["bottom_code"])[None]))
    oracle = png_indices(tsrv.render_spectrogram_png(
        spec[0, 0].numpy(), upsampling_factor=4), tsrv._viridis_lut())
    assert int(np.abs(mine - oracle).max()) <= 1
    # the factor is read per request
    tstate.spectrograms_upsampling_factor = 1
    try:
        blob = post(tsrv, "/get-spectrogram-image", "", body).body
    finally:
        tstate.spectrograms_upsampling_factor = 4
    assert struct.unpack(">II", blob[16:24]) == (64, 128)
    # the device routine against the JAX one on a plain array
    a = np.random.default_rng(3).normal(size=(64, 32)).astype(
        np.float32).cumsum(axis=1)
    for factor in (1, 4):
        dev = tsrv.spectrogram_image_indices(torch.as_tensor(a),
                                             factor).numpy()
        ref = np.asarray(jsrv.spectrogram_image_indices(jnp.asarray(a),
                                                        factor))
        assert dev.dtype == np.uint8 and dev.shape == ref.shape
        assert int(np.abs(dev.astype(int) - ref.astype(int)).max()) <= 1


def test_sample_from_dataset(servers, tmp_path):
    from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store \
        import CodemapStoreWriter
    from interactive_spectrogram_inpainting_tpu_torch.data.lmdb_compat \
        import open_codes_dataset
    jsrv, jstate, tsrv, tstate = servers
    top_shape = tuple(tstate.top.config.shape)
    bottom_shape = tuple(tstate.bottom.config.shape)
    enc = tstate.label_encoders
    rng = np.random.default_rng(3)
    stored = {}
    with CodemapStoreWriter(tmp_path / "codes", top_shape, bottom_shape,
                            ["pitch", "instrument_family_str"],
                            label_encoders=enc, n_class=32) as writer:
        for i, (pitch, family) in enumerate(
                [(60, "keyboard"), (62, "string"), (64, "brass")]):
            stored[pitch] = rng.integers(0, 32, top_shape)
            writer.append(
                stored[pitch], rng.integers(0, 32, bottom_shape),
                {"pitch": enc["pitch"].transform([pitch])[0],
                 "instrument_family_str":
                     enc["instrument_family_str"].transform([family])[0]},
                f"note-{i}")
    with pytest.raises(Exception):
        assert tsrv.app.handle(Request.synthetic(
            "/sample-from-dataset", "", b"")).status != 200
        raise ValueError("no dataset: the handler refused")
    tstate.codes_dataset = open_codes_dataset(tmp_path / "codes")
    try:
        data = json.loads(post(tsrv, "/sample-from-dataset",
                               "pitch=62&instrument_family_str=string",
                               {}).body)
        np.testing.assert_array_equal(np.asarray(data["top_code"]),
                                      stored[62])
        assert data["top_conditioning"]["pitch"][0][0] == 62
        assert data["bottom_conditioning"]["instrument_family_str"][0][0] \
            == "string"
        data = json.loads(post(tsrv, "/sample-from-dataset",
                               "pitch_class=4&octave=5", {}).body)
        np.testing.assert_array_equal(np.asarray(data["top_code"]),
                                      stored[64])
        data = json.loads(post(tsrv, "/sample-from-dataset",
                               f"duration_top={2 * top_shape[1]}", {}).body)
        top = np.asarray(data["top_code"])
        assert top.shape == (top_shape[0], 2 * top_shape[1])
        np.testing.assert_array_equal(
            top[:, top_shape[1]:],
            np.repeat(top[:, -1:], top_shape[1], axis=1))
        assert np.asarray(data["bottom_code"]).shape == (
            bottom_shape[0], 2 * bottom_shape[1])
        data = json.loads(post(tsrv, "/sample-from-dataset", "pitch=70",
                               {}).body)
        assert data == {"error": "no sample matching constraints"}
    finally:
        tstate.codes_dataset = None


def test_duration_buckets_match_jax(servers):
    jsrv, jstate, tsrv, tstate = servers
    assert tstate.max_sound_duration_s == jstate.max_sound_duration_s
    assert tstate.top_column_resolution_n() == \
        jstate.top_column_resolution_n() == 512
    assert tstate.analyze_duration_buckets() == \
        jstate.analyze_duration_buckets()
    for n in (1, 4095, 4096, 4300, 4352, 4353, 6000, 8192, 20000):
        assert tstate.snap_analyze_duration(n) == \
            jstate.snap_analyze_duration(n)

    def fake(module, max_s, res, td):
        state = types.SimpleNamespace(
            fs_hz=16000, max_sound_duration_s=max_s,
            analyze_dense_duration_s=8.0, analyze_coarse_stride_s=4.0,
            top_column_resolution_n=lambda: res,
            top=types.SimpleNamespace(config=types.SimpleNamespace(
                target_duration=td)))
        state.analyze_duration_buckets = (
            lambda: module.ServerState.analyze_duration_buckets(state))
        return state

    # the full geometry (16384 samples per top column) at 8 s and 60 s
    for max_s in (8.0, 60.0, 2.0):
        fj, ft = fake(jsrv, max_s, 16384, 4), fake(tsrv, max_s, 16384, 4)
        buckets = ft.analyze_duration_buckets()
        assert buckets == fj.analyze_duration_buckets()
        for n in range(1000, int(max_s * 16000) + 40000, 7919):
            assert tsrv.ServerState.snap_analyze_duration(ft, n) == \
                jsrv.ServerState.snap_analyze_duration(fj, n)
    assert len(fake(tsrv, 60.0, 16384, 4).analyze_duration_buckets()) == 18
    assert fake(tsrv, 8.0, 16384, 4).analyze_duration_buckets() == [
        16384 * m for m in range(4, 9)]


def test_warmup_drives_every_handler(servers, monkeypatch):
    """One request per handler and per shape: /generate, both layers of
    /timerange-change, /get-audio, /get-spectrogram-image and /erase at the
    standard and (long_sounds) the doubled duration, /analyze-audio once
    per duration bucket, /top-conditioned-sample once per batch bucket."""
    jsrv, jstate, tsrv, tstate = servers
    seen = []
    real = tsrv.app.handle

    def recording(request):
        response = real(request)
        body = json.loads(request._body) if request._body else {}
        seen.append((request.path, request.args.get("layer"),
                     len(body.get("top_code", [[]])[0]),
                     len(request.files.get("audio", b""))))
        return response

    monkeypatch.setattr(tsrv.app, "handle", recording)
    # keep the batched samplers out of this test: they are held elsewhere
    monkeypatch.setattr(tstate, "pitch_batch_buckets", (2,))
    logged = []
    n = tsrv.warmup(tstate, log=logged.append, long_sounds=True)
    buckets = tstate.analyze_duration_buckets()
    assert n == len(seen) == len(logged) == 1 + 2 * 5 + len(buckets) + 1
    paths = [entry[0] for entry in seen]
    assert paths.count("/generate") == 1
    for width in (8, 16):
        for path, layer in (("/timerange-change", "top"),
                            ("/timerange-change", "bottom"),
                            ("/get-audio", None),
                            ("/get-spectrogram-image", None),
                            ("/erase", "top")):
            assert (path, layer, width, 0) in seen, (path, layer, width)
    uploads = sorted(entry[3] for entry in seen
                     if entry[0] == "/analyze-audio")
    assert uploads == [44 + 2 * b for b in buckets]  # 16-bit wav files
    assert paths.count("/top-conditioned-sample") == 1
    seen.clear()
    assert tsrv.warmup(tstate) == 1 + 5 + len(buckets) + 1
    other = tsrv.make_test_state("tiny", device="cpu")
    with pytest.raises(ValueError):
        tsrv.warmup(other)  # handlers read STATE


def test_handlers_and_warmup_share_one_persistent_thread(servers,
                                                         monkeypatch):
    """The CUDA libraries keep per-thread plans and handles: every request,
    over HTTP or from warmup, runs on the app's one handler thread."""
    import threading
    import urllib.request
    jsrv, jstate, tsrv, tstate = servers
    threads = []
    real = tsrv.app.handle

    def recording(request):
        threads.append(threading.current_thread())
        return real(request)

    monkeypatch.setattr(tsrv.app, "handle", recording)
    monkeypatch.setattr(tstate, "pitch_batch_buckets", (2,))
    http = tsrv.app.run(host="127.0.0.1", port=0, background=True)
    try:
        url = (f"http://127.0.0.1:{http.server_address[1]}/test-generate"
               "?pitch=60&instrument_family_str=organ")
        for _ in range(3):
            with urllib.request.urlopen(url, timeout=60) as r:
                assert r.status == 200
        tsrv.warmup(tstate)
    finally:
        http.shutdown()
        http.server_close()
    assert len(threads) > 3 and len(set(threads)) == 1
    assert threads[0] is not threading.current_thread()
    assert threads[0].name.startswith(tsrv.app.name + "-handler")


def test_use_pallas_lookup_keyword_reaches_the_vqvae():
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    from interactive_spectrogram_inpainting_tpu_torch.serve import (
        server as tsrv)
    assert not tsrv.make_test_configs("full")[1].use_pallas_lookup
    assert tsrv.make_test_configs("full", True)[1].use_pallas_lookup
    on = tsrv.make_test_state("tiny", device="cpu", use_pallas_lookup=True)
    off = tsrv.make_test_state("tiny", device="cpu")
    assert on.vqvae.quantize_t.use_pallas_lookup
    assert on.vqvae.quantize_b.use_pallas_lookup
    assert not off.vqvae.quantize_b.use_pallas_lookup
    # same seed, same weights: the flag does not change the codes
    audio = harmonic_note(np.random.default_rng(0), 8192)[None]
    launches = fused_vq_lookup.launches
    for a, b in zip(on.analyze_fn()(audio), off.analyze_fn()(audio)):
        assert torch.equal(a, b)
    assert fused_vq_lookup.launches == launches  # CPU: the plain version


def test_load_state_from_checkpoints(servers, tmp_path):
    """The seven files the JAX package's ``save_model`` functions write give
    a state that encodes and decodes as the carried-over one does."""
    from interactive_spectrogram_inpainting_tpu.models.prior import (
        transformer as jprior)
    from interactive_spectrogram_inpainting_tpu.models.vqvae import (
        vqvae as jvq)
    from interactive_spectrogram_inpainting_tpu_torch.data.label_encoders \
        import dump_label_encoders
    jsrv, jstate, tsrv, tstate = servers
    jvq.save_model(tmp_path, jstate.vqvae.config, jstate.vqvae_variables)
    jprior.save_model(tmp_path, jstate.top.config, jstate.top_variables,
                      "top")
    jprior.save_model(tmp_path, jstate.bottom.config,
                      jstate.bottom_variables, "bottom")
    (tmp_path / "training.json").write_text(json.dumps(dict(
        fs_hz=16000, n_fft=256, window_length=256, hop_length=64)))
    dump_label_encoders(tstate.label_encoders, tmp_path / "encoders.json")
    paths = [str(tmp_path / name) for name in (
        "vqvae-model_parameters.json", "vqvae-weights.msgpack",
        "training.json", "top-model_parameters.json", "top-weights.msgpack",
        "bottom-model_parameters.json", "bottom-weights.msgpack")]
    loaded = tsrv.load_state_from_checkpoints(
        *paths, label_encoders_path=str(tmp_path / "encoders.json"),
        max_sound_duration_s=0.512, device="cpu")
    for name in ("vqvae", "top", "bottom"):
        mine = getattr(loaded, name).state_dict()
        for key, value in getattr(tstate, name).state_dict().items():
            assert torch.equal(mine[key], value), (name, key)
    assert loaded.helper == tstate.helper
    assert loaded.label_encoders["pitch"].classes_ == \
        tstate.label_encoders["pitch"].classes_
    assert loaded.analyze_duration_buckets() == \
        tstate.analyze_duration_buckets()
    audio = harmonic_note(np.random.default_rng(1), 4096)[None]
    for a, b in zip(loaded.analyze_fn()(audio), tstate.analyze_fn()(audio)):
        assert torch.equal(a, b)
