"""The port's serving slice vs the JAX server, on the tiny test state.

Both servers hold the same weights (the JAX state's variables through
``from_flax_params``). ``/timerange-change`` (top -> bottom cascade, bf16,
both priors primed), ``/generate`` and the padded batch of
``/top-conditioned-sample`` are fed the JAX server's Gumbel noise and must
return the same codemaps, as must the dense and predictive samplers that
``sampling_options`` select; ``/get-audio`` must decode the same audio (1e-4
of its peak) and the same spectrogram (atol 1e-4)."""

import io
import json
import zipfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_decode import jax_gumbel
from interactive_spectrogram_inpainting_tpu.models.vqvae.vqvae import (
    VQVAE as JVQVAE)
from interactive_spectrogram_inpainting_tpu_torch.data.wav import read_wav
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
    per pitch, and samples the JAX server's codemaps under its noise.

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
    cc = {"pitch": jnp.asarray(
              jstate.label_encoders["pitch"].transform(padded)),
          "instrument_family_str": jnp.asarray(
              jstate.label_encoders["instrument_family_str"].transform(
                  ["keyboard"] * bucket))}
    key = np.array([9, 1], np.uint32)
    condition = jnp.broadcast_to(top, (bucket,) + top.shape[1:])
    j_bottom = np.asarray(jstate.sample_fn("bottom", bucket)(
        key, 1.0, condition, None, None, cc, None, None))

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
    monkeypatch.setattr(
        tsrv, "make_test_state",
        lambda size, device, seed, sampling_options: seen.update(
            size=size, device=device, options=sampling_options))
    monkeypatch.setattr(tsrv.app, "run", lambda host, port: None)
    old = tsrv.STATE
    try:
        tsrv.main(["--test_models", "tiny", "--device", "cpu",
                   "--sampling_top_k", "5", "--sampling_top_p", "0.9",
                   "--use_predictive_sampling"])
    finally:
        tsrv.STATE = old
    assert seen == {"size": "tiny", "device": "cpu", "options": {
        "top_k": 5, "top_p": 0.9, "predictive": True}}
