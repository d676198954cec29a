"""PyTorch port vs the JAX package: the encode path.

The VQ lookup's plain version, the EMA bottleneck (evaluation, training,
restarts, corruption), the encoder stack, the whole VQ-VAE encode / forward
and the forward spectrogram transform, on the CPU at small sizes, with the
JAX package's weights carried over by ``from_flax_params`` and inputs drawn
from a numpy seed. The JAX Pallas lookup runs in interpret mode, as in the
JAX package's own tests.

Tolerances. The lookup on identical inputs: ids and counts exact, quantize
atol 1e-5, embed_sum atol 1e-3 (``tests/test_ops.py``). Module outputs and
EMA buffers: atol 1e-4. Codes of a full pipeline are compared on the cells
whose two best scores differ by more than ``MARGIN`` in the port's own
scores (a float32 convolution summed in another order may flip a nearer
tie); the number of excluded cells is printed. Spectrograms: log-magnitude
atol 5e-3 where it is above -6, and everywhere the magnitudes themselves
within 5e-5 (near the ``safelog`` floor of 1e-6 the FFTs' float32 rounding is
as large as the magnitude, so the logarithm says nothing there);
instantaneous frequency modulo 2 (a phase step at +/-pi wraps the other way
on a 1-ulp change) with atol 2e-3 where the log-magnitude is above -4. On the
mel scale such a wrap in one linear bin moves the mel IF of that frame by 2
times a filter weight, not by 2: up to 2 % of the loud mel cells may differ.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.models.vqvae import (
    bottleneck as jbn, encoder_decoder as jed, vqvae as jv)
from interactive_spectrogram_inpainting_tpu.ops import vq_lookup as jvq
from interactive_spectrogram_inpainting_tpu.signal import (
    normalizer as jnorm, spectrogram as jspec)
from interactive_spectrogram_inpainting_tpu_torch.data.wav import write_wav
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    bottleneck as tbn, encoder_decoder as ted, vqvae as tv)
from interactive_spectrogram_inpainting_tpu_torch.ops import vq_lookup as tvq
from interactive_spectrogram_inpainting_tpu_torch.signal import (
    normalizer as tnorm, spectrogram as tspec)
from interactive_spectrogram_inpainting_tpu_torch.utils import weights

MARGIN = 1e-4


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def score_margin(flat: torch.Tensor, embed: torch.Tensor) -> np.ndarray:
    """Per row, the gap between the two best codes' scores."""
    scores = (embed * embed).sum(0)[None] - 2.0 * (flat @ embed)
    best2 = torch.topk(scores, 2, dim=1, largest=False).values
    return (best2[:, 1] - best2[:, 0]).numpy()


def harmonic_note(rng, n, fs=16000, f0=220.0):
    t = np.arange(n) / fs
    note = sum(a * np.sin(2 * np.pi * f0 * (h + 1) * t + p)
               for h, (a, p) in enumerate(zip(
                   [0.5, 0.25, 0.12, 0.06], rng.uniform(0, 6.28, 4))))
    envelope = np.exp(-2.0 * t) * np.minimum(1.0, t * 50.0)
    return (note * envelope + 1e-3 * rng.standard_normal(n)
            ).astype(np.float32)


# -- the lookup ---------------------------------------------------------------

def test_reference_vq_lookup_matches_jax_kernel_and_reference():
    rng = np.random.default_rng(0)
    n, dim, k = 700, 64, 512  # n no tile divides
    flat = rng.standard_normal((n, dim)).astype(np.float32)
    embed = rng.standard_normal((dim, k)).astype(np.float32)
    out = tvq.reference_vq_lookup(torch.as_tensor(flat),
                                  torch.as_tensor(embed))
    # on a CPU tensor the wrapper is the plain version
    out_w = tvq.fused_vq_lookup(torch.as_tensor(flat), torch.as_tensor(embed))
    for a, b in zip(out, out_w):
        assert torch.equal(a, b)
    assert out[0].dtype == torch.int32
    for ref in (jvq.fused_vq_lookup(jnp.asarray(flat), jnp.asarray(embed),
                                    interpret=True),
                jvq.reference_vq_lookup(jnp.asarray(flat),
                                        jnp.asarray(embed))):
        ids, quant, counts, esum = (np.asarray(r) for r in ref)
        np.testing.assert_array_equal(out[0].numpy(), ids)
        np.testing.assert_allclose(out[1].numpy(), quant, atol=1e-5)
        np.testing.assert_array_equal(out[2].numpy(), counts)
        np.testing.assert_allclose(out[3].numpy(), esum, atol=1e-3)
    # quantize is the codebook row itself
    assert torch.equal(out[1], torch.as_tensor(embed).T[out[0].long()])


def test_vq_lookup_ties_and_refusals():
    base = np.random.default_rng(5).standard_normal((8, 12)).astype(
        np.float32)
    embed = torch.as_tensor(np.concatenate([base, base], axis=1))
    flat = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (50, 8)).astype(np.float32))
    ids = tvq.fused_vq_lookup(flat, embed)[0]
    assert int(ids.max()) < 12  # the lowest of two equal codes, as argmin
    with pytest.raises(ValueError):
        tvq.fused_vq_lookup(flat.requires_grad_(), embed)
    with pytest.raises(ValueError):
        tvq.fused_vq_lookup(torch.zeros(4, 7), embed)


# -- the bottleneck -----------------------------------------------------------

def bottleneck_pair(rng, dim, n_embed, **kwargs):
    """A JAX bottleneck's variables and the port module holding them."""
    jmod = jbn.QuantizedBottleneck(dim=dim, n_embed=n_embed, **kwargs)
    embed = rng.standard_normal((dim, n_embed)).astype(np.float32)
    variables = {"codebook": {
        "embed": jnp.asarray(embed),
        "cluster_size": jnp.asarray(rng.uniform(0.5, 2.0, n_embed).astype(
            np.float32)),
        "embed_avg": jnp.asarray(embed * 1.25)}}
    tmod = tbn.QuantizedBottleneck(dim, n_embed, **kwargs)
    tmod.load_state_dict({k: torch.as_tensor(np.array(v))
                          for k, v in variables["codebook"].items()})
    return jmod, variables, tmod


def assert_bottleneck_outputs(out_t, out_j):
    quant_t, diff_t, ids_t, perp_t = out_t
    quant_j, diff_j, ids_j, perp_j = out_j
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(
        quant_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(quant_j),
        atol=1e-4)
    np.testing.assert_allclose(float(diff_t), float(diff_j), atol=1e-4)
    np.testing.assert_allclose(float(perp_t), float(perp_j), atol=1e-4,
                               rtol=1e-5)


def assert_buffers(tmod, jvars):
    for name in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(
            getattr(tmod, name).numpy(),
            np.asarray(jvars["codebook"][name]), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("use_pallas_lookup", [False, True])
def test_bottleneck_eval_and_training_match_jax(use_pallas_lookup):
    rng = np.random.default_rng(1)
    jmod, variables, tmod = bottleneck_pair(
        rng, 16, 64, use_pallas_lookup=use_pallas_lookup)
    xs = [rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
          for _ in range(3)]
    x_t = [torch.as_tensor(x).permute(0, 3, 1, 2) for x in xs]
    assert_bottleneck_outputs(tmod(x_t[0], train=False),
                              jmod.apply(variables, jnp.asarray(xs[0])))
    assert_buffers(tmod, variables)  # evaluation leaves the state alone
    for step in range(3):
        out_j, mutated = jmod.apply(variables, jnp.asarray(xs[step]),
                                    train=True, mutable=["codebook"])
        variables = {"codebook": mutated["codebook"]}
        assert_bottleneck_outputs(tmod(x_t[step], train=True), out_j)
        assert_buffers(tmod, variables)  # after one and after three steps


def test_bottleneck_straight_through_gradient():
    rng = np.random.default_rng(2)
    _, _, tmod = bottleneck_pair(rng, 8, 16)
    x = torch.as_tensor(rng.standard_normal((1, 8, 4, 4)).astype(
        np.float32)).requires_grad_()
    quant, diff, _, _ = tmod(x, train=False)
    (quant.sum() + diff).backward()
    # d quant / dx is the identity; diff adds 2 (x - q) / numel
    expected = 1.0 + 2.0 * (x.detach() - quant.detach()) / x.numel()
    np.testing.assert_allclose(x.grad.numpy(), expected.numpy(), atol=1e-6)


def test_bottleneck_corruption_with_the_jax_draws(monkeypatch):
    rng = np.random.default_rng(3)
    jmod, variables, tmod = bottleneck_pair(
        rng, 8, 16, corruption_weights=[0.3, 0.4, 0.3])
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    drawn = []
    real = jax.random.categorical

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "categorical", recording)
    out_j, mutated = jmod.apply(
        variables, jnp.asarray(x), train=True, mutable=["codebook"],
        rngs={"corruption": jax.random.PRNGKey(7)})
    shift = torch.as_tensor(drawn[0]) - 1
    assert set(np.unique(shift.numpy())) <= {-1, 0, 1}
    out_t = tmod(torch.as_tensor(x).permute(0, 3, 1, 2), train=True,
                 shift=shift)
    assert_bottleneck_outputs(out_t, out_j)
    assert_buffers(tmod, mutated)
    # the port's own draw: every code moves by exactly +/-1 under [1, 0, 1]
    _, _, forced = bottleneck_pair(rng, 8, 16,
                                   corruption_weights=[1.0, 0.0, 1.0])
    x_t = torch.as_tensor(x).permute(0, 3, 1, 2)
    clean = forced(x_t, train=False)[2]
    moved = forced(x_t, train=True,
                   generator=torch.Generator().manual_seed(0))[2]
    assert set(np.unique((clean - moved).numpy() % 16)) <= {1, 15}


def test_bottleneck_restarts_with_the_jax_draws(monkeypatch):
    rng = np.random.default_rng(4)
    jmod, variables, tmod = bottleneck_pair(
        rng, 8, 32, restart_threshold=0.9, decay=0.5)
    # a few distinct rows only: most codes fall under the usage threshold
    rows = rng.standard_normal((3, 8)).astype(np.float32)
    x = rows[rng.integers(0, 3, (2, 4, 4))]
    drawn = []
    real = jax.random.randint

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "randint", recording)
    out_j, mutated = jmod.apply(
        variables, jnp.asarray(x), train=True, mutable=["codebook"],
        rngs={"restart": jax.random.PRNGKey(1)})
    before = tmod.embed.clone()
    out_t = tmod(torch.as_tensor(x).permute(0, 3, 1, 2), train=True,
                 restart_src=torch.as_tensor(drawn[0]))
    assert_bottleneck_outputs(out_t, out_j)
    assert_buffers(tmod, mutated)
    reseeded = (tmod.embed[:, :, None] == torch.as_tensor(rows).T[:, None, :]
                ).all(0).any(1)
    assert 0 < int(reseeded.sum()) < 32 and not torch.equal(before,
                                                            tmod.embed)
    # the port's own draw re-seeds dead codes from rows of the batch
    _, _, own = bottleneck_pair(rng, 8, 32, restart_threshold=0.9,
                                decay=0.5)
    own(torch.as_tensor(x).permute(0, 3, 1, 2), train=True,
        generator=torch.Generator().manual_seed(0))
    own_reseeded = (own.embed[:, :, None]
                    == torch.as_tensor(rows).T[:, None, :]).all(0).any(1)
    assert int(own_reseeded.sum()) == int(reseeded.sum())


def test_unquantized_bottleneck_passes_through():
    cfg = dict(num_hidden_channels=16, num_residual_channels=8, embed_dim=8,
               num_embeddings=32, disable_quantization=True)
    jmodel = jv.VQVAE(jv.VQVAEConfig(**cfg))
    x = np.random.default_rng(0).standard_normal((1, 2, 32, 16)).astype(
        np.float32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                     jnp.asarray(x))
    tmodel = tv.VQVAE(tv.VQVAEConfig(**cfg))
    state = weights.from_flax_params(
        {"params": to_numpy(variables["params"]), "codebook": {}})
    tmodel.load_state_dict(state)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.as_tensor(x))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    assert float(out[1]) == 0.0 and np.isinf(float(out[2]))
    assert not out[4].any() and out[4].shape == (1, 4, 2)
    with pytest.raises(NotImplementedError):
        tmodel.quantize_t.embed_code(out[4])


# -- the encoder stack --------------------------------------------------------

@pytest.mark.parametrize("factor,local,groups,in_channel", [
    (4, False, 1, 2), (16, False, 1, 2), (2, True, 2, 16)])
def test_encoder_matches_jax(factor, local, groups, in_channel):
    rng = np.random.default_rng(factor)
    jmod = jed.Encoder(channel=16, n_res_block=2, res_channel=8,
                       resolution_factor=factor, groups=groups,
                       use_local_kernels=local)
    x = rng.standard_normal((2, in_channel, 2 * factor, 3 * factor)).astype(
        np.float32)
    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), x_nhwc)
    tmod = ted.Encoder(in_channel, 16, 2, 8, factor, groups, local)
    sd = {}
    weights._encoder_state_dict(sd, "enc", to_numpy(variables["params"]))
    tmod.load_state_dict({k[len("enc."):]: v for k, v in sd.items()})
    ref = np.transpose(np.asarray(jax.jit(jmod.apply)(variables, x_nhwc)),
                       (0, 3, 1, 2))
    with torch.no_grad():
        out = tmod(torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 2, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)


# -- the whole VQ-VAE ---------------------------------------------------------

def vqvae_pair(factors, **kwargs):
    cfg = dict(num_hidden_channels=16, num_residual_channels=8, embed_dim=8,
               num_embeddings=[32, 24], resolution_factors=factors, **kwargs)
    jcfg = jv.VQVAEConfig(**cfg)
    jmodel = jv.VQVAE(jcfg)
    f = jcfg.total_resolution_factor
    probe = jnp.zeros((1, 2, 2 * f, f), jnp.float32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                     probe)
    tmodel = tv.VQVAE(tv.VQVAEConfig.from_json(jcfg.to_json()))
    tmodel.load_state_dict(weights.from_flax_params(to_numpy(variables)))
    return jmodel, variables, tmodel.eval()


def whole_jax(model, variables, x):
    """One jitted pass: what feeds the two lookups (channel-first), the
    outputs of ``encode`` and the decoded spectrogram."""
    def fn(m, inp):
        encoded = m.encode(inp)
        if m.normalizer is not None:
            inp = m.normalizer.normalize(inp)
        enc_b = m.enc_b(jnp.transpose(inp, (0, 2, 3, 1)))
        qt_in = m.quantize_conv_t(m.enc_t(enc_b))
        quant_t = m.quantize_t(qt_in)[0]
        qb_in = m.quantize_conv_b(jnp.concatenate(
            [m.dec_t(quant_t), enc_b], axis=-1))
        return (jnp.transpose(qt_in, (0, 3, 1, 2)),
                jnp.transpose(qb_in, (0, 3, 1, 2)), encoded,
                m.decode(encoded[0], encoded[1]))
    return jax.jit(functools.partial(model.apply, method=fn))(
        variables, jnp.asarray(x))


def lookup_inputs_port(model, x):
    with torch.no_grad():
        inp = torch.as_tensor(x)
        if model.normalizer is not None:
            inp = model.normalizer.normalize(inp)
        enc_b = model.enc_b(inp)
        qt_in = model.quantize_conv_t(model.enc_t(enc_b))
        quant_t = model.quantize_t(qt_in)[0]
        qb_in = model.quantize_conv_b(torch.cat(
            [model.dec_t(quant_t), enc_b], dim=1))
    return qt_in, qb_in


def assert_codes_equal_above_margin(name, ids_t, ids_j, lookup_in, embed):
    flat = lookup_in.permute(0, 2, 3, 1).reshape(-1, embed.shape[0])
    clear = score_margin(flat, embed) > MARGIN
    print(f"{name}: {int((~clear).sum())} of {clear.size} cells within "
          f"{MARGIN} of a tie")
    assert clear.mean() > 0.98
    np.testing.assert_array_equal(
        np.asarray(ids_t).reshape(-1)[clear],
        np.asarray(ids_j).reshape(-1)[clear])
    return bool(clear.all())


@pytest.mark.parametrize("factors,extra", [
    ({"bottom": 4, "top": 2}, {}),
    ({"bottom": 16, "top": 2}, dict(
        use_pallas_lookup=True, output_spectrogram_min_magnitude=0.05,
        normalizer_statistics={"min_logmag": -12.0, "max_logmag": 3.0,
                               "min_IF": -1.0, "max_IF": 1.0})),
])
def test_vqvae_encode_and_forward_match_jax(factors, extra):
    jmodel, variables, tmodel = vqvae_pair(factors, **extra)
    f = tmodel.config.total_resolution_factor
    rng = np.random.default_rng(f)
    x = np.stack([rng.normal(-4.0, 2.0, (2, 2 * f, 3 * f)),
                  rng.uniform(-1.0, 1.0, (2, 2 * f, 3 * f))],
                 axis=1).astype(np.float32)
    # what feeds the two lookups
    qt_j, qb_j, ref, dec_j = whole_jax(jmodel, variables, x)
    qt_t, qb_t = lookup_inputs_port(tmodel, x)
    np.testing.assert_allclose(qt_t.numpy(), np.asarray(qt_j), atol=1e-4)

    with torch.no_grad():
        out = tmodel.encode(torch.as_tensor(x))
        id_t, id_b = tmodel.encode_codes_only(torch.as_tensor(x))
    assert torch.equal(id_t, out[3]) and torch.equal(id_b, out[4])
    assert id_t.shape == (2, 2, 3)
    assert id_b.shape == (2, 2 * factors["top"], 3 * factors["top"])
    top_clear = assert_codes_equal_above_margin(
        "top", out[3], ref[3], qt_t, tmodel.quantize_t.embed)
    assert top_clear, "pick another seed: a top code sits on a near tie"
    np.testing.assert_allclose(qb_t.numpy(), np.asarray(qb_j), atol=1e-4)
    bottom_clear = assert_codes_equal_above_margin(
        "bottom", out[4], ref[4], qb_t, tmodel.quantize_b.embed)
    assert bottom_clear
    for i in (0, 1):  # quant_t, quant_b: channel-first in both packages
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   atol=1e-4)
    for i in (2, 5, 6):  # diff, perplexities
        np.testing.assert_allclose(float(out[i]), float(ref[i]), atol=1e-4,
                                   rtol=1e-5)

    # forward = (decode(encode), diff, perplexities, ids)
    with torch.no_grad():
        fwd = tmodel(torch.as_tensor(x))
    np.testing.assert_allclose(fwd[0].numpy(), np.asarray(dec_j), atol=1e-4)
    for mine, theirs in zip(fwd[1:], (out[2], out[5], out[6], out[3],
                                      out[4])):
        assert torch.equal(mine, theirs)


def test_vqvae_training_step_updates_both_codebooks_like_jax():
    jmodel, variables, tmodel = vqvae_pair({"bottom": 4, "top": 2},
                                           use_pallas_lookup=True)
    rng = np.random.default_rng(11)
    x = np.stack([rng.normal(-4.0, 2.0, (2, 32, 16)),
                  rng.uniform(-1.0, 1.0, (2, 32, 16))],
                 axis=1).astype(np.float32)
    ref, mutated = jax.jit(functools.partial(
        jmodel.apply, train=True, mutable=["codebook"]))(
            variables, jnp.asarray(x))
    out = tmodel(torch.as_tensor(x), train=True)
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(ref[0]),
                               atol=1e-4)
    for level in ("quantize_t", "quantize_b"):
        assert_buffers(getattr(tmodel, level),
                       {"codebook": mutated["codebook"][level]})
    # the straight-through estimator carries the loss to the encoder
    (out[0].sum() + out[1]).backward()
    grad = tmodel.enc_b.downsample[0].weight.grad
    assert grad is not None and float(grad.abs().max()) > 0


def test_vqvae_refuses_only_the_resnet_variant():
    # the name is kept from when the ResNet variant raised: it is ported now
    # (models/vqvae/resnet.py) and no variant is refused; the ResNet model
    # is held against the JAX package in tests/test_torch_vqvae_resnet.py
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
        resnet as tres)
    model = tv.VQVAE(tv.VQVAEConfig(use_resnet=True))
    assert isinstance(model.enc_b, tres.XResNetEncoder)
    assert isinstance(model.dec, tres.NoSkipUnetDecoder)
    tv.VQVAE(tv.VQVAEConfig(num_hidden_channels=8, num_residual_channels=4,
                            embed_dim=4, num_embeddings=8,
                            disable_quantization=True))


# -- the forward transform ----------------------------------------------------

def assert_spectrograms_close(out, ref, mel=False):
    assert out.shape == ref.shape
    audible = ref[:, 0] > -6.0
    np.testing.assert_allclose(out[:, 0][audible], ref[:, 0][audible],
                               atol=5e-3)
    np.testing.assert_allclose(np.exp(out[:, 0]), np.exp(ref[:, 0]),
                               atol=5e-5)
    loud = ref[:, 0] > -4.0
    assert loud.mean() > 0.02
    wrapped = (out[:, 1] - ref[:, 1] + 1.0) % 2.0 - 1.0
    differ = np.abs(wrapped[loud]) > 2e-3
    print(f"IF differs in {int(differ.sum())} of {differ.size} loud cells")
    assert differ.mean() <= (0.02 if mel else 0.0)


SPEC_KWARGS = [
    dict(fs_hz=16000, n_fft=256, window_length=256, hop_length=64),
    dict(fs_hz=16000, n_fft=256, window_length=192, hop_length=80),
    dict(fs_hz=16000, n_fft=512, window_length=512, hop_length=128,
         use_mel_scale=True),
]


@pytest.mark.parametrize("kwargs", SPEC_KWARGS)
def test_to_spectrogram_matches_jax(kwargs):
    jh = jspec.get_spectrograms_helper(**kwargs)
    th = tspec.get_spectrograms_helper(**kwargs)
    rng = np.random.default_rng(3)
    n = 5000  # not a multiple of the hop: the frame count pads up to 32s
    audio = np.stack([harmonic_note(rng, n), harmonic_note(rng, n, f0=523.0)])
    assert th.num_frames(n) == jh.num_frames(n)
    assert th._pad_right(n) == jh._pad_right(n)
    np.testing.assert_allclose(
        th._frame(torch.as_tensor(audio)).numpy(),
        np.asarray(jh._frame(jnp.asarray(audio))), atol=1e-7)
    ref = np.asarray(jh.to_spectrogram(jnp.asarray(audio)))
    out = th.to_spectrogram(torch.as_tensor(audio)).numpy()
    assert out.shape == (2, 2, jh.num_freq_bins, jh.num_frames(n))
    assert_spectrograms_close(out, ref, mel=hasattr(jh, "linear_to_mel"))
    # one-dimensional input, and the complex STFT pair
    np.testing.assert_array_equal(
        th.to_spectrogram(torch.as_tensor(audio[0])).numpy(), out[0])
    stft = th.stft(torch.as_tensor(audio))
    np.testing.assert_allclose(stft.numpy(),
                               np.asarray(jh.stft(jnp.asarray(audio))),
                               atol=2e-4)
    back = th.istft(stft, n).numpy()
    np.testing.assert_allclose(back, audio, atol=1e-4)


def test_mel_maps_match_jax():
    kwargs = SPEC_KWARGS[2]
    jh = jspec.get_spectrograms_helper(**kwargs)
    th = tspec.get_spectrograms_helper(**kwargs)
    rng = np.random.default_rng(4)
    spec = np.stack([rng.normal(-2.0, 1.0, (jh.num_freq_bins, 32)),
                     rng.uniform(-0.9, 0.9, (jh.num_freq_bins, 32))]
                    )[None].astype(np.float32)
    mel_ref = np.asarray(jh.linear_to_mel(jnp.asarray(spec)))
    mel = th.linear_to_mel(torch.as_tensor(spec)).numpy()
    assert_spectrograms_close(mel, mel_ref, mel=True)
    lin_ref = np.asarray(jh.mel_to_linear(jnp.asarray(mel_ref)))
    lin = th.mel_to_linear(torch.as_tensor(mel_ref)).numpy()
    assert_spectrograms_close(lin, lin_ref, mel=True)


def test_instantaneous_frequency_matches_jax():
    rng = np.random.default_rng(5)
    phase = rng.uniform(-3.1, 3.1, (2, 7, 5)).astype(np.float32)
    for axis in (-1, -2):
        np.testing.assert_allclose(
            tspec.instantaneous_frequency(torch.as_tensor(phase),
                                          time_axis=axis).numpy(),
            np.asarray(jspec.instantaneous_frequency(jnp.asarray(phase),
                                                     time_axis=axis)),
            atol=1e-6)


@pytest.mark.parametrize("kwargs", [SPEC_KWARGS[0], SPEC_KWARGS[2]])
def test_round_trip_and_from_wavfile(kwargs, tmp_path):
    jh = jspec.get_spectrograms_helper(**kwargs)
    th = tspec.get_spectrograms_helper(**kwargs)
    rng = np.random.default_rng(6)
    n = 32 * th.hop_length
    audio = harmonic_note(rng, n)
    spec = th.to_spectrogram(torch.as_tensor(audio)[None])
    back = th.to_audio(spec, num_samples=n)[0].numpy()
    inner = slice(th.window_length, n - th.window_length)
    noise = back[inner] - audio[inner]
    snr = 10 * np.log10((audio[inner] ** 2).sum() / (noise ** 2).sum())
    # the linear transform inverts itself; the mel warp loses resolution
    assert snr > (15.0 if kwargs.get("use_mel_scale") else 40.0), snr

    path = tmp_path / "note.wav"
    half_rate = harmonic_note(rng, n // 2, fs=8000)
    write_wav(str(path), half_rate, 8000)  # resampled to fs_hz on load
    ref = np.asarray(jh.from_wavfile(str(path), duration_n=6000))
    out = th.from_wavfile(str(path), duration_n=6000).numpy()
    assert out.shape == ref.shape == (1, 2, th.num_freq_bins,
                                      th.num_frames(6000))
    assert_spectrograms_close(out, ref, mel=hasattr(jh, "linear_to_mel"))


def test_normalizer_matches_jax(tmp_path):
    stats = {"min_logmag": -11.5, "max_logmag": 4.0, "min_IF": -0.9,
             "max_IF": 1.0}
    jn, tn = jnorm.DataNormalizer(stats), tnorm.DataNormalizer(stats)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    normalized = tn.normalize(torch.as_tensor(x))
    np.testing.assert_allclose(normalized.numpy(),
                               np.asarray(jn.normalize(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(tn.denormalize(normalized).numpy(), x,
                               atol=1e-5)
    batches = [x, 2.0 * x]
    ref = jnorm.DataNormalizer.compute_statistics(batches)
    got = tnorm.DataNormalizer.compute_statistics(
        [torch.as_tensor(b) for b in batches])
    assert vars(got) == {k: getattr(ref, k) for k in vars(got)}
    tnorm.DataNormalizer(got).dump_statistics(tmp_path / "stats.json")
    loaded_j = jnorm.DataNormalizer.load_statistics(tmp_path / "stats.json")
    loaded_t = tnorm.DataNormalizer.load_statistics(tmp_path / "stats.json")
    assert vars(loaded_t.statistics) == vars(got)
    assert loaded_j.statistics.max_logmag == got.max_logmag
