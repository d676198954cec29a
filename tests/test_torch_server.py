"""The port's serving slice vs the JAX server, on the tiny test state.

Both servers hold the same weights (the JAX state's variables through
``from_flax_params``). ``/timerange-change`` (top -> bottom cascade, bf16,
both priors primed) is fed the JAX server's Gumbel noise and must return
the same codemaps; ``/get-audio`` must decode the same audio (1e-4 of its
peak) and the same spectrogram (atol 1e-4)."""

import io
import json

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
