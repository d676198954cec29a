"""Interactive inpainting HTTP service: the NOTONO sampling endpoints.

Port of ``interactive_spectrogram_inpainting_tpu/serve/server.py`` for the
generation, inpainting and playback endpoints, with the JAX server's JSON
schemas:

- ``/generate``          sample a full sound (top prior, then bottom) from
                         pitch / instrument-family conditioning;
- ``/test-generate``     random codemaps (plumbing test, no model needed);
- ``/timerange-change``  the core inpaint op: masked regeneration of a
                         transformer-sized frame, top prior cascading into
                         the bottom prior (``layer=top``) or the bottom
                         prior alone (``layer=bottom``), with time-index
                         remapping for sounds longer than the frame;
- ``/top-conditioned-sample``  the bottom prior sampled for a whole pitch
                         range at once under one top codemap -> zip of wavs;
- ``/get-audio``         codemaps -> VQ-VAE decode -> mel inverse -> wav.

By default both priors sample through the fused kernels in bfloat16, as
the JAX server does: prefix priming plus the whole-scan kernel at batch 1,
the step kernels for a batch. ``--sampling_top_k`` / ``--sampling_top_p``
move every request to the dense KV scan and ``--use_predictive_sampling``
to the predictive sampler. ``/analyze-audio``, ``/erase``,
``/get-spectrogram-image``, ``/sample-from-dataset``, the warmup lattice
and checkpoint loading are not ported yet; ``--test_models tiny|full``
serves randomly initialized models.

Run: ``python -m interactive_spectrogram_inpainting_tpu_torch.serve.server
--test_models full`` (GPU by default; ``--device cpu`` for the plain path).
"""

from __future__ import annotations

import argparse
import io
import logging
import threading
import time
import zipfile
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.label_encoders import LabelEncoder
from ..data.wav import write_wav
from ..models.prior.transformer import (
    SelfAttentiveVQTransformer, TransformerConfig, UpsamplingVQTransformer,
    VQNSynthTransformer)
from ..models.vqvae.vqvae import VQVAE, VQVAEConfig
from ..sampling.sample import precompute_decode_state, sample_model
from ..signal.spectrogram import get_spectrograms_helper
from ..utils.device import DeviceLike, resolve_device, set_float32_precision
from ..utils.weights import init_like_flax
from .http_app import App, Request, jsonify, send_bytes

app = App("interactive-spectrogram-inpainting-tpu-torch")
logger = logging.getLogger("isi-server-torch")


def make_time_indexes(start_index: int, codemap_duration: int,
                      transformer_duration: int) -> List[int]:
    """Positional re-indexing for sounds longer than the training duration:
    pin the first column (attack) and last (release), stretch the middle."""
    time_indexes_full = [0]
    num_steps_to_repeat = transformer_duration - 2
    if num_steps_to_repeat <= 0:
        return list(range(transformer_duration))
    steps_repetitions = max(
        1, (codemap_duration - 2) // num_steps_to_repeat)
    for i in range(num_steps_to_repeat - 1):
        time_indexes_full += [i + 1] * steps_repetitions
    time_indexes_full += [num_steps_to_repeat] * (
        (codemap_duration - 2) - (len(time_indexes_full) - 1))
    time_indexes_full += [transformer_duration - 1]
    return time_indexes_full[start_index: start_index
                             + transformer_duration]


def _log_predictive_speedup(which: str, diag) -> None:
    """Per-request predictive-sampling telemetry: forwards run, the
    correct-prediction ratio and the relative speedup over one forward per
    token (the mode's latency depends on the data)."""
    if diag is None:
        return
    num_forwards = int(diag["num_forwards"])
    num_steps = int(diag["num_steps"])
    ratio = 1.0 - num_forwards / max(num_steps, 1)
    logger.info(
        "predictive sampling (%s): %d/%d forwards, correct ratio %.2f, "
        "relative speedup %.2f", which, num_forwards, num_steps, ratio,
        num_steps / max(num_forwards, 1))


class ServerState:
    """Models, decode tables and the per-request sampling closures.

    ``sampling_options`` (``top_k``, ``top_p``, ``predictive``) choose the
    sampler for every request: the fused kernels unless filtering or
    predictive sampling is asked for (``_fused_ok``).

    ``gumbel_source``, when set, is called as ``gumbel_source(which)``
    (``'top'`` or ``'bottom'``) and returns the Gumbel noise of that
    prior's scan instead of drawing it from the request's generator: a
    caller can replay a fixed noise stream through the endpoints."""

    def __init__(self, vqvae_model: VQVAE, top_model: VQNSynthTransformer,
                 bottom_model: VQNSynthTransformer, spectrograms_helper,
                 label_encoders: Mapping[str, LabelEncoder],
                 fs_hz: int = 16000, device: DeviceLike = None,
                 seed: Optional[int] = None,
                 sampling_options: Optional[Dict] = None):
        self.device = resolve_device(device)
        set_float32_precision()
        self.vqvae = vqvae_model.to(self.device).eval()
        self.top = top_model.to(self.device).eval()
        self.bottom = bottom_model.to(self.device).eval()
        self.helper = spectrograms_helper
        self.label_encoders = dict(label_encoders)
        self.fs_hz = fs_hz
        self.sampling_options = sampling_options or {}
        self._seed = (time.time_ns() if seed is None else seed) & 0xFFFFFFFF
        self._rng_counter = 0
        self._fn_cache: Dict = {}
        # one request at a time on the device; reentrant because a sampling
        # call builds its decode tables while it holds the lock
        self._lock = threading.RLock()
        self.gumbel_source: Optional[
            Callable[[str], Optional[torch.Tensor]]] = None

    def next_rng(self) -> torch.Generator:
        """A fresh generator on the serving device for each request."""
        with self._lock:
            self._rng_counter += 1
            counter = self._rng_counter
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self._seed << 32) | counter)
        return gen

    def mask_scan_bounds(self, which: str, mask_np
                         ) -> Tuple[Optional[int], Optional[int]]:
        """Bucketed (scan_from, scan_until) token bounds of a request mask
        (granularity L/4, as the JAX server buckets its compilations)."""
        model = self.top if which == "top" else self.bottom
        helper = model.config.target_codemaps_helper()
        mask_np = np.asarray(mask_np, bool)
        if mask_np.ndim == 3:
            mask_np = mask_np[0]
        mask_seq = mask_np.reshape(-1)[helper.flatten_permutation]
        nz = np.nonzero(mask_seq)[0]
        length = int(mask_seq.shape[0])
        if not len(nz):
            return 0, 0
        g = max(1, length // 4)
        scan_from = (int(nz.min()) // g) * g
        scan_until = min(length, ((int(nz.max()) + g) // g) * g)
        return (scan_from or None,
                scan_until if scan_until < length else None)

    def decode_state(self, which: str) -> dict:
        """Model-constant bfloat16 decode tables, built once per prior."""
        key = ("decode_state", which)
        with self._lock:
            if key not in self._fn_cache:
                model = self.top if which == "top" else self.bottom
                self._fn_cache[key] = precompute_decode_state(
                    model, compute_dtype=torch.bfloat16)
        return self._fn_cache[key]

    def _gumbel(self, which: str) -> Optional[torch.Tensor]:
        return self.gumbel_source(which) if self.gumbel_source else None

    def _fused_ok(self, which: str) -> bool:
        cfg = (self.top if which == "top" else self.bottom).config
        top_k = int(self.sampling_options.get("top_k", 0))
        top_p = float(self.sampling_options.get("top_p", 0.0))
        if self.sampling_options.get("predictive", False):
            return False  # predictive sampling runs full forwards
        return (top_k == 0 and top_p == 0.0
                and not cfg.positional_class_conditioning
                and (cfg.use_aligned_decoder
                     or not cfg.use_identity_memory_mask))

    def _sample(self, which: str, generator, batch_size: int, temperature,
                condition, initial_code, mask, class_conditioning, ti_src,
                ti_tgt, scan_from, scan_until):
        """One ``sample_model`` call under the server's sampling options:
        bfloat16 everywhere; the logits, the filtering and the sampling
        stay float32."""
        model = self.top if which == "top" else self.bottom
        fused_ok = self._fused_ok(which)
        predictive = bool(self.sampling_options.get("predictive", False))
        out = sample_model(
            model, generator, batch_size, temperature=temperature,
            condition=condition, class_conditioning=class_conditioning,
            initial_code=initial_code, mask=mask,
            time_indexes_source=ti_src, time_indexes_target=ti_tgt,
            top_k_sampling_k=int(self.sampling_options.get("top_k", 0)),
            top_p_sampling_p=float(self.sampling_options.get("top_p", 0.0)),
            use_predictive_sampling=predictive,
            compute_dtype=torch.bfloat16, use_fused_step=fused_ok,
            scan_from=scan_from, scan_until=scan_until,
            decode_state=self.decode_state(which) if fused_ok else None,
            return_diagnostics=predictive, gumbel=self._gumbel(which),
            bounds_from_mask=False, device=self.device)
        if predictive:
            out, diag = out
            _log_predictive_speedup(which, diag)
        return out

    def sample_fn(self, which: str, batch_size: int,
                  scan_from: Optional[int] = None,
                  scan_until: Optional[int] = None):
        def fn(generator, temperature, condition, initial_code, mask,
               class_conditioning, ti_src, ti_tgt):
            with self._lock:
                return self._sample(
                    which, generator, batch_size, temperature, condition,
                    initial_code, mask, class_conditioning, ti_src, ti_tgt,
                    scan_from, scan_until)
        return fn

    def cascade_fn(self, sf_t, su_t, sf_b, su_b, long_sound=False):
        """Top inpaint -> bottom cascade (the core interactive op)."""
        def fn(generator, temperature, top_frame, bottom_frame, mask_top,
               mask_bottom, class_conditioning, ti_top=None, ti_bottom=None):
            assert (ti_top is not None) == bool(long_sound)
            with self._lock:
                new_top = self._sample(
                    "top", generator, 1, temperature, top_frame, top_frame,
                    mask_top, class_conditioning, ti_top, ti_top, sf_t, su_t)
                new_bottom = self._sample(
                    "bottom", generator, 1, temperature, new_top,
                    bottom_frame, mask_bottom, class_conditioning, ti_top,
                    ti_bottom, sf_b, su_b)
            return new_top, new_bottom
        return fn

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def decode_audio_fn(self):
        """codemaps -> audio: VQ-VAE decode then the inverse transform."""
        def fn(top_code, bottom_code):
            with self._lock, torch.no_grad():
                spec = self.vqvae.decode_code(self._on_device(top_code),
                                              self._on_device(bottom_code))
                return self.helper.to_audio(spec)
        return fn

    # batch-size buckets for /top-conditioned-sample: a pitch range pads up
    # to one of these, so the batched sampler sees a small fixed set of
    # batch sizes (surplus rows are sliced off)
    pitch_batch_buckets: Tuple[int, ...] = (16, 64)

    def encode_conditioning(self, pitch, instrument_family_str,
                            batch: int = 1):
        cc = {}
        if pitch is not None and "pitch" in self.label_encoders:
            cc["pitch"] = np.asarray(self.label_encoders["pitch"].transform(
                [int(pitch)] * batch))
        if (instrument_family_str is not None
                and "instrument_family_str" in self.label_encoders):
            cc["instrument_family_str"] = np.asarray(
                self.label_encoders["instrument_family_str"].transform(
                    [instrument_family_str] * batch))
        return cc


STATE: Optional[ServerState] = None


# -- request/response helpers -------------------------------------------------

def parse_codes(request: Request):
    data = request.get_json()
    top = np.asarray(data["top_code"], np.int32)[None]
    bottom = np.asarray(data["bottom_code"], np.int32)[None]
    return top, bottom


def parse_mask(request: Request):
    return np.asarray(request.get_json()["mask"], bool)[None]


def parse_conditioning(request: Request):
    data = request.get_json()
    if "top_conditioning" not in data:
        return None, None
    return data["top_conditioning"], data["bottom_conditioning"]


def make_matrix(shape, value):
    return [[value] * int(shape[1])] * int(shape[0])


def conditioning_maps(state: ServerState, pitch, family):
    top_map = {"pitch": make_matrix(state.top.config.shape, pitch),
               "instrument_family_str": make_matrix(
                   state.top.config.shape, family)}
    bottom_map = {"pitch": make_matrix(state.bottom.config.shape, pitch),
                  "instrument_family_str": make_matrix(
                      state.bottom.config.shape, family)}
    return top_map, bottom_map


def make_response(top_code, bottom_code, top_conditioning,
                  bottom_conditioning):
    return jsonify({
        "top_code": _host(top_code)[0].astype(int).tolist(),
        "bottom_code": _host(bottom_code)[0].astype(int).tolist(),
        "top_conditioning": top_conditioning,
        "bottom_conditioning": bottom_conditioning,
    })


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- endpoints ----------------------------------------------------------------

@app.route("/generate", methods=["GET", "POST"])
def generate(request: Request):
    state = STATE
    temperature = float(request.args.get("temperature", 1.0))
    pitch = int(request.args["pitch"])
    family = str(request.args["instrument_family_str"])
    cc = state.encode_conditioning(pitch, family)

    top_code = state.sample_fn("top", 1)(
        state.next_rng(), temperature, np.zeros(
            (1,) + tuple(state.top.config.shape), np.int32),
        None, None, cc, None, None)
    bottom_code = state.sample_fn("bottom", 1)(
        state.next_rng(), temperature, top_code, None, None, cc, None, None)
    top_map, bottom_map = conditioning_maps(state, pitch, family)
    return make_response(top_code, bottom_code, top_map, bottom_map)


@app.route("/test-generate", methods=["GET", "POST"])
def test_generate(request: Request):
    state = STATE
    pitch = int(request.args["pitch"])
    family = str(request.args["instrument_family_str"])
    rng = np.random.default_rng()
    top_code = rng.integers(
        0, state.vqvae.config.n_embed_t,
        (1,) + tuple(state.top.config.shape))
    bottom_code = rng.integers(
        0, state.vqvae.config.n_embed_b,
        (1,) + tuple(state.bottom.config.shape))
    top_map, bottom_map = conditioning_maps(state, pitch, family)
    return make_response(top_code, bottom_code, top_map, bottom_map)


@app.route("/timerange-change", methods=["POST"])
def timerange_change(request: Request):
    state = STATE
    layer = str(request.args["layer"])
    temperature = float(request.args.get("temperature", 1.0))
    start_index_top = int(request.args.get("start_index_top", 0))
    uniform_sampling = request.args.get(
        "uniform_sampling", "false").lower() in ("true", "1", "yes")
    pitch = request.args.get("pitch")
    family = request.args.get("instrument_family_str")
    cc = state.encode_conditioning(pitch, family)

    top_code, bottom_code = parse_codes(request)
    mask = parse_mask(request)
    input_top_cond, input_bottom_cond = parse_conditioning(request)

    top_shape = state.top.config.shape
    bottom_shape = state.bottom.config.shape
    ratio_t = bottom_shape[1] // top_shape[1]
    ratio_f = bottom_shape[0] // top_shape[0]
    end_top = start_index_top + top_shape[1]
    start_bottom = ratio_t * start_index_top
    end_bottom = start_bottom + bottom_shape[1]
    top_frame = top_code[..., start_index_top:end_top]
    bottom_frame = bottom_code[..., start_bottom:end_bottom]

    long_sound = top_code.shape[-1] > top_shape[1]
    ti_top = (make_time_indexes(start_index_top, top_code.shape[-1],
                                top_shape[1]) if long_sound else None)
    ti_bottom = (make_time_indexes(start_bottom, bottom_code.shape[-1],
                                   bottom_shape[1]) if long_sound else None)
    top_code = top_code.copy()
    bottom_code = bottom_code.copy()

    if layer == "bottom":
        if uniform_sampling:
            rnd = np.random.default_rng().integers(
                0, state.bottom.config.n_class_target, bottom_frame.shape)
            new_bottom_frame = np.where(mask, rnd, bottom_frame)
        else:
            sf, su = state.mask_scan_bounds("bottom", mask)
            if su == 0:  # nothing masked: the frame is already known
                new_bottom_frame = bottom_frame
            else:
                new_bottom_frame = _host(state.sample_fn("bottom", 1, sf, su)(
                    state.next_rng(), temperature, top_frame, bottom_frame,
                    mask[0], cc, ti_top, ti_bottom))
        bottom_code[..., start_bottom:end_bottom] = new_bottom_frame
        return make_response(top_code, bottom_code,
                             input_top_cond, input_bottom_cond)

    assert layer == "top", f"unknown layer {layer}"
    mask_np = mask[0]
    mask_bottom = np.repeat(np.repeat(mask_np, ratio_f, axis=0),
                            ratio_t, axis=1)
    sf, su = state.mask_scan_bounds("top", mask)
    sf_b, su_b = state.mask_scan_bounds("bottom", mask_bottom)
    if uniform_sampling:
        rnd = np.random.default_rng().integers(
            0, state.top.config.n_class_target, top_frame.shape)
        new_top_frame = np.where(mask, rnd, top_frame)
        top_code[..., start_index_top:end_top] = new_top_frame
        # su_b is None for an UNBOUNDED scan; only 0 means nothing masked
        new_bottom_frame = (bottom_frame if su_b == 0 else _host(
            state.sample_fn("bottom", 1, sf_b, su_b)(
                state.next_rng(), temperature, new_top_frame, bottom_frame,
                mask_bottom, cc, ti_top, ti_bottom)))
        bottom_code[..., start_bottom:end_bottom] = new_bottom_frame
    elif su == 0:
        pass  # nothing masked
    else:
        new_top_frame, new_bottom_frame = state.cascade_fn(
            sf, su, sf_b, su_b, long_sound=long_sound)(
                state.next_rng(), temperature, top_frame, bottom_frame,
                mask_np, mask_bottom, cc, ti_top, ti_bottom)
        top_code[..., start_index_top:end_top] = _host(new_top_frame)
        bottom_code[..., start_bottom:end_bottom] = _host(new_bottom_frame)

    # update the bottom conditioning map under the regenerated cells
    new_bottom_cond = input_bottom_cond
    if input_bottom_cond is not None and pitch is not None:
        values = {"pitch": int(pitch), "instrument_family_str": family}
        new_bottom_cond = {}
        for modality, rows in input_bottom_cond.items():
            new_rows = [list(r) for r in rows]
            for f in range(mask_bottom.shape[0]):
                for t in range(mask_bottom.shape[1]):
                    if mask_bottom[f, t]:
                        new_rows[f][start_bottom + t] = values.get(
                            modality, new_rows[f][start_bottom + t])
            new_bottom_cond[modality] = new_rows
    return make_response(top_code, bottom_code,
                         input_top_cond, new_bottom_cond)


@app.route("/get-audio", methods=["POST"])
def get_audio(request: Request):
    state = STATE
    top_code, bottom_code = parse_codes(request)
    audio = _host(state.decode_audio_fn()(top_code, bottom_code))[0]
    buf = io.BytesIO()
    write_wav(buf, audio, state.fs_hz)
    return send_bytes(buf.getvalue(), "audio/wav", "sample.wav")


@app.route("/top-conditioned-sample", methods=["POST"])
def top_conditioned_sample(request: Request):
    state = STATE
    top_code, _ = parse_codes(request)
    family = str(request.args["instrument_family_str"])
    min_pitch = int(request.args["min_pitch"])
    max_pitch = int(request.args["max_pitch"])
    temperature = float(request.args.get("temperature", 1.0))
    num_samples = max_pitch - min_pitch
    if num_samples <= 0:
        raise ValueError("max_pitch must be above min_pitch")

    pitches = list(range(min_pitch, max_pitch))
    # pad each chunk of the pitch range up to a batch bucket (surplus rows
    # repeat the last pitch and are sliced off)
    buckets = state.pitch_batch_buckets
    audio_chunks = []
    for chunk_start in range(0, num_samples, buckets[-1]):
        chunk = pitches[chunk_start:chunk_start + buckets[-1]]
        bucket = next((b for b in buckets if b >= len(chunk)), buckets[-1])
        padded = chunk + [chunk[-1]] * (bucket - len(chunk))
        cc = {}
        if "pitch" in state.label_encoders:
            cc["pitch"] = np.asarray(
                state.label_encoders["pitch"].transform(padded))
        if "instrument_family_str" in state.label_encoders:
            cc["instrument_family_str"] = np.asarray(
                state.label_encoders["instrument_family_str"].transform(
                    [family] * bucket))
        condition = np.repeat(top_code, bucket, axis=0)
        bottom = state.sample_fn("bottom", bucket)(
            state.next_rng(), temperature, condition, None, None, cc,
            None, None)
        chunk_audio = _host(state.decode_audio_fn()(condition, bottom))
        audio_chunks.append(chunk_audio[:len(chunk)])
    audio = np.concatenate(audio_chunks, axis=0)

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for pitch, wave in zip(pitches, audio):
            wav_buf = io.BytesIO()
            write_wav(wav_buf, wave, state.fs_hz)
            zf.writestr(f"{family}-{pitch}.wav", wav_buf.getvalue())
    return send_bytes(buf.getvalue(), "application/zip", "samples.zip")


# -- test state ---------------------------------------------------------------

def make_test_configs(size: str = "tiny"):
    """(spectrogram kwargs, VQVAEConfig, top TransformerConfig, bottom
    TransformerConfig) of the JAX server's ``make_test_state``."""
    if size == "tiny":
        spec_kwargs = dict(fs_hz=16000, n_fft=256, window_length=256,
                           hop_length=64)
        vq_cfg = VQVAEConfig(num_hidden_channels=16,
                             num_residual_channels=8, embed_dim=8,
                             num_embeddings=32,
                             resolution_factors={"bottom": 4, "top": 2})
        top_shape, bottom_shape = (16, 8), (32, 16)
        d_model, d_ff, layers = 32, 64, 1
    elif size == "full":
        spec_kwargs = dict(fs_hz=16000, n_fft=2048, window_length=2048,
                           hop_length=512, use_mel_scale=True)
        vq_cfg = VQVAEConfig(resolution_factors={"bottom": 16, "top": 2})
        top_shape, bottom_shape = (32, 4), (64, 8)
        d_model, d_ff, layers = 512, 2048, None
    else:
        raise ValueError(f"unknown test model size {size!r}")
    modalities = {"pitch": 61, "instrument_family_str": 11}
    dims = {"pitch": 8, "instrument_family_str": 8}
    common = dict(n_class=vq_cfg.n_embed_t, d_model=d_model,
                  embeddings_dim=8, positional_embeddings_dim=8,
                  dropout=0.0, d_ff=d_ff,
                  class_conditioning_num_classes_per_modality=modalities,
                  class_conditioning_embedding_dim_per_modality=dims,
                  class_conditioning_prepend_to_dummy_input=True)
    if layers is not None:
        common.update(conditional_model_num_encoder_layers=layers,
                      conditional_model_num_decoder_layers=layers,
                      conditional_model_nhead=4)
    top_cfg = TransformerConfig(shape=top_shape, condition_shape=top_shape,
                                self_conditional_model=True, **common)
    bottom_cfg = TransformerConfig(shape=bottom_shape,
                                   condition_shape=top_shape,
                                   use_aligned_decoder=True, **common)
    return spec_kwargs, vq_cfg, top_cfg, bottom_cfg


def make_test_state(size: str = "tiny", device: DeviceLike = None,
                    seed: int = 0,
                    sampling_options: Optional[Dict] = None) -> ServerState:
    """Randomly initialized models (weights drawn from ``seed`` with the
    flax initializers' scales) for plumbing and load tests."""
    device = resolve_device(device)
    spec_kwargs, vq_cfg, top_cfg, bottom_cfg = make_test_configs(size)
    gen = torch.Generator().manual_seed(seed)
    vqvae = init_like_flax(VQVAE(vq_cfg), gen)
    top = init_like_flax(SelfAttentiveVQTransformer(top_cfg), gen)
    bottom = init_like_flax(UpsamplingVQTransformer(bottom_cfg), gen)
    label_encoders = {
        "pitch": LabelEncoder(list(range(24, 85))),
        "instrument_family_str": LabelEncoder(
            ["bass", "brass", "flute", "guitar", "keyboard", "mallet",
             "organ", "reed", "string", "synth_lead", "vocal"])}
    return ServerState(
        vqvae, top, bottom, get_spectrograms_helper(**spec_kwargs),
        label_encoders, fs_hz=spec_kwargs["fs_hz"], device=device,
        seed=seed, sampling_options=sampling_options)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test_models", type=str, default=None,
                   choices=["tiny", "full"],
                   help="serve randomly initialized models")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--sampling_top_k", type=int, default=0)
    p.add_argument("--sampling_top_p", type=float, default=0.0)
    p.add_argument("--use_predictive_sampling", dest="predictive_sampling",
                   action="store_true", default=False,
                   help="Gumbel predictive sampling (bfloat16 full forwards "
                        "with skip-on-match, arXiv:2002.09928) instead of "
                        "the fused KV scan; its latency depends on the data")
    p.add_argument("--no_predictive_sampling", dest="predictive_sampling",
                   action="store_false")
    args = p.parse_args(argv)
    if not args.test_models:
        p.error("loading trained checkpoints is not ported yet; "
                "pass --test_models tiny|full")
    global STATE
    logging.basicConfig(level=logging.INFO)
    STATE = make_test_state(
        args.test_models, device=args.device, seed=args.seed,
        sampling_options={"top_k": args.sampling_top_k,
                          "top_p": args.sampling_top_p,
                          "predictive": args.predictive_sampling})
    app.logger = logger
    print(f"serving on {args.host}:{args.port}", flush=True)
    app.run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
