"""Interactive inpainting HTTP service: the NOTONO endpoints.

Port of ``interactive_spectrogram_inpainting_tpu/serve/server.py``, with
the JAX server's nine endpoints and JSON schemas:

- ``/generate``          sample a full sound (top prior, then bottom) from
                         pitch / instrument-family conditioning;
- ``/sample-from-dataset``  rejection-sample a stored codemap;
- ``/test-generate``     random codemaps (plumbing test, no model needed);
- ``/analyze-audio``     wav upload -> forward transform -> VQ-VAE encode
                         -> codemaps;
- ``/timerange-change``  the core inpaint op: masked regeneration of a
                         transformer-sized frame, top prior cascading into
                         the bottom prior (``layer=top``) or the bottom
                         prior alone (``layer=bottom``), with time-index
                         remapping for sounds longer than the frame;
- ``/top-conditioned-sample``  the bottom prior sampled for a whole pitch
                         range at once under one top codemap -> zip of wavs;
- ``/erase``             decode, lower the magnitudes under the mask,
                         encode again;
- ``/get-audio``         codemaps -> VQ-VAE decode -> mel inverse -> wav;
- ``/get-spectrogram-image``  codemaps -> PNG (viridis, time-upsampled).

By default both priors sample through the fused kernels in bfloat16, as
the JAX server does: prefix priming plus the whole-scan kernel at batch 1,
the step kernels for a batch. ``--sampling_top_k`` / ``--sampling_top_p``
move every request to the dense KV scan and ``--use_predictive_sampling``
to the predictive sampler. The encode endpoints run the VQ lookup through
``ops/vq_lookup.py`` when the model's JSON sets ``use_pallas_lookup``.

``warmup`` drives one request per handler and per shape that costs
something cold (kernel libraries, decode tables, an FFT plan per duration,
a convolution plan per shape), on the handler thread the server answers
from. Scan bounds are run-time arguments of
the kernels, so no request shape depends on the mask and the JAX server's
lattice of masks (``warmup_masks``) has no counterpart here.

Run: ``python -m interactive_spectrogram_inpainting_tpu_torch.serve.server
--test_models full --warmup`` (GPU by default; ``--device cpu`` for the
plain path), or with the seven checkpoint paths of a trained model.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import threading
import time
import zipfile
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.label_encoders import LabelEncoder, load_label_encoders
from ..data.wav import read_wav, resample, write_wav
from ..models.prior.transformer import (
    SelfAttentiveVQTransformer, TransformerConfig, UpsamplingVQTransformer,
    VQNSynthTransformer)
from ..models.vqvae.vqvae import VQVAE, VQVAEConfig
from ..ops.vq_lookup import vq_refusal
from ..sampling.sample import (fused_refusal, fused_unsupported,
                               precompute_decode_state, sample_model)
from ..signal.spectrogram import (get_spectrograms_helper,
                                  make_masked_phase_transform)
from ..utils.device import DeviceLike, resolve_device, set_float32_precision
from ..utils.visualization import encode_png as _encode_png
from ..utils.visualization import viridis_lut as _viridis_lut
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


def kernel_refusals(vqvae_model: VQVAE, top_model: VQNSynthTransformer,
                    bottom_model: VQNSynthTransformer) -> Dict[str, str]:
    """The decision a server on the card takes when it loads its models:
    raise for a VQ-VAE with the fused lookup whose embedding the lookup
    kernel does not take; for each prior whose geometry a fused kernel
    does not take (``fused_refusal``, the server's bfloat16), log one line
    naming the kernel and the shape. -> {'top' | 'bottom': reason} of the
    priors the dense sampler serves."""
    vq_cfg = vqvae_model.config
    reason = (vq_refusal(vq_cfg.embed_dim) if vq_cfg.use_pallas_lookup
              else None)
    if reason is not None:
        raise ValueError(f"the VQ-VAE cannot be served: {reason}")
    refusals = {}
    for which, model in (("top", top_model), ("bottom", bottom_model)):
        reason = fused_refusal(model, torch.bfloat16)
        if reason is not None:
            logger.warning("%s prior served by the dense sampler: %s",
                           which, reason)
            refusals[which] = reason
    return refusals


class ServerState:
    """Models, decode tables and the per-request sampling closures.

    ``sampling_options`` (``top_k``, ``top_p``, ``predictive``) choose the
    sampler for every request: the fused kernels unless filtering or
    predictive sampling is asked for (``_fused_ok``).

    On CUDA the models' shapes are checked when the state is built: a
    prior whose geometry a fused kernel does not take (``fused_refusal``)
    is served by the dense sampler, with one log line naming the kernel
    and the shape; a VQ-VAE with the fused lookup whose embedding the
    lookup kernel does not take raises.

    ``gumbel_source``, when set, is called as ``gumbel_source(which)``
    (``'top'`` or ``'bottom'``) and returns the Gumbel noise of that
    prior's scan instead of drawing it from the request's generator: a
    caller can replay a fixed noise stream through the endpoints."""

    def __init__(self, vqvae_model: VQVAE, top_model: VQNSynthTransformer,
                 bottom_model: VQNSynthTransformer, spectrograms_helper,
                 label_encoders: Mapping[str, LabelEncoder],
                 codes_dataset=None, fs_hz: int = 16000,
                 max_sound_duration_s: float = 60.0,
                 device: DeviceLike = None, seed: Optional[int] = None,
                 sampling_options: Optional[Dict] = None,
                 spectrograms_upsampling_factor: int = 4):
        self.device = resolve_device(device)
        set_float32_precision()
        # which: why a fused kernel does not take that prior's geometry
        self._fused_refusals = (
            kernel_refusals(vqvae_model, top_model, bottom_model)
            if self.device.type == "cuda" else {})
        self.vqvae = vqvae_model.to(self.device).eval()
        self.top = top_model.to(self.device).eval()
        self.bottom = bottom_model.to(self.device).eval()
        self.helper = spectrograms_helper
        self.label_encoders = dict(label_encoders)
        self.codes_dataset = codes_dataset
        self.fs_hz = fs_hz
        self.max_sound_duration_s = max_sound_duration_s
        self.sampling_options = sampling_options or {}
        # time-axis upsampling of the rendered spectrogram PNGs
        self.spectrograms_upsampling_factor = spectrograms_upsampling_factor
        # input half of the masked-phase pipeline: a thresholded VQ-VAE was
        # trained on spectrograms with sub-threshold IF zeroed, so the
        # encode paths (/analyze-audio, /erase) feed it the same view
        min_mag = vqvae_model.config.output_spectrogram_min_magnitude
        self.vqvae_input_transform = (
            make_masked_phase_transform(min_mag)
            if min_mag is not None else None)
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
        model = self.top if which == "top" else self.bottom
        if self.sampling_options.get("predictive", False):
            return False  # predictive sampling runs full forwards
        if which in self._fused_refusals:
            return False  # a kernel does not take the prior's geometry
        return fused_unsupported(
            model, int(self.sampling_options.get("top_k", 0)),
            float(self.sampling_options.get("top_p", 0.0))) is None

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

    def decode_image_fn(self):
        """codemaps -> uint8 colormap-index image on the device: VQ-VAE
        decode, then the normalize + time-upsample + 8-bit quantization of
        ``spectrogram_image_indices``; only the palette lookup and the PNG
        deflate stay on the host."""
        def fn(top_code, bottom_code):
            with self._lock, torch.no_grad():
                spec = self.vqvae.decode_code(self._on_device(top_code),
                                              self._on_device(bottom_code))
                return spectrogram_image_indices(
                    spec[0, 0],
                    upsampling_factor=int(
                        self.spectrograms_upsampling_factor))
        return fn

    def _encode_view(self, spec: torch.Tensor):
        if self.vqvae_input_transform is not None:
            spec = self.vqvae_input_transform(spec)
        return self.vqvae.encode_codes_only(spec)

    def analyze_fn(self):
        """audio [B, n] -> codemaps: the forward transform, then the VQ-VAE
        encode. Callers snap uploads to ``analyze_duration_buckets``."""
        def fn(audio):
            with self._lock, torch.no_grad():
                return self._encode_view(self.helper.to_spectrogram(
                    self._on_device(audio).float()))
        return fn

    def erase_fn(self):
        """decode -> lower the log-magnitudes by ``full_mask [F, T]`` ->
        encode again (the /erase op)."""
        def fn(top_code, bottom_code, full_mask):
            with self._lock, torch.no_grad():
                spec = self.vqvae.decode_code(self._on_device(top_code),
                                              self._on_device(bottom_code))
                masked = torch.cat(
                    [spec[:, 0:1] - self._on_device(full_mask)[None, None],
                     spec[:, 1:2]], dim=1)
                # lowering magnitudes can push bins under the phase
                # threshold: the masked view goes through the transform
                return self._encode_view(masked)
        return fn

    # /analyze-audio duration-bucket geometry: per-column (exact) buckets up
    # to analyze_dense_duration_s, then one bucket every
    # analyze_coarse_stride_s up to max_sound_duration_s. Snapping decides
    # which samples are encoded (appended zeros would leak into the
    # trailing codemap columns), so it is kept as the JAX server has it;
    # here each bucket also stands for one FFT plan and one set of
    # convolution algorithms that warmup can build ahead of traffic.
    analyze_dense_duration_s: float = 8.0
    analyze_coarse_stride_s: float = 4.0

    def top_column_resolution_n(self) -> int:
        """Audio samples per top-codemap column: one top column spans
        ``total_resolution_factor`` frames of ``hop_length`` samples."""
        return (self.helper.hop_length
                * self.vqvae.config.total_resolution_factor)

    def analyze_duration_buckets(self) -> List[int]:
        """Every exact audio sample count /analyze-audio can feed to the
        encoder; the handler snaps an upload to the nearest entry."""
        res = self.top_column_resolution_n()
        td = self.top.config.target_duration
        max_n = int(self.max_sound_duration_s * self.fs_hz)
        m_cap = max(td, round(max_n / res))
        m_dense = min(m_cap, max(td, round(
            self.analyze_dense_duration_s * self.fs_hz / res)))
        buckets = [res * m for m in range(td, m_dense + 1)]
        stride_m = max(1, round(
            self.analyze_coarse_stride_s * self.fs_hz / res))
        m = m_dense + stride_m
        while m < m_cap:
            buckets.append(res * m)
            m += stride_m
        if m_cap > m_dense:
            buckets.append(res * m_cap)
        return buckets

    def snap_analyze_duration(self, duration_n: int) -> int:
        """Nearest analyze bucket (ties -> the shorter one): identity in
        the dense region, at most ``analyze_coarse_stride_s / 2`` of trim or
        pad beyond it."""
        return min(self.analyze_duration_buckets(),
                   key=lambda b: (abs(b - duration_n), b))

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


@app.route("/sample-from-dataset", methods=["GET", "POST"])
def sample_from_dataset(request: Request):
    state = STATE
    if state.codes_dataset is None:
        raise ValueError("no codes dataset loaded")
    duration_top = int(request.args.get(
        "duration_top", state.top.config.target_duration))

    constraints = {}
    if request.args.get("pitch") is not None:
        constraints["pitch"] = int(request.args["pitch"])
    if request.args.get("pitch_class") is not None:
        v = int(request.args["pitch_class"])
        if 0 <= v <= 12:
            constraints["pitch_class"] = v
    if request.args.get("octave") is not None:
        v = int(request.args["octave"])
        if v >= 0:
            constraints["octave"] = v
    if request.args.get("instrument_family_str") is not None:
        constraints["instrument_family_str"] = request.args[
            "instrument_family_str"]

    dataset = state.codes_dataset
    rng = np.random.default_rng()
    encoders = state.label_encoders
    for _ in range(len(dataset) * 4):
        index = int(rng.integers(len(dataset)))
        top, bottom, attrs = dataset[index]
        decoded = {}
        if "pitch" in attrs and "pitch" in encoders:
            decoded["pitch"] = encoders["pitch"].inverse_transform(
                [attrs["pitch"]])[0]
            decoded["pitch_class"] = decoded["pitch"] % 12
            decoded["octave"] = decoded["pitch"] // 12
        if "instrument_family_str" in attrs and \
                "instrument_family_str" in encoders:
            decoded["instrument_family_str"] = encoders[
                "instrument_family_str"].inverse_transform(
                [attrs["instrument_family_str"]])[0]
        if all(decoded.get(k) == v for k, v in constraints.items()):
            break
    else:
        return jsonify({"error": "no sample matching constraints"})

    # resize by repeating the last column
    ratio = bottom.shape[-1] // top.shape[-1]

    def resize(codemap, duration):
        codemap = codemap[..., :duration]
        while codemap.shape[-1] < duration:
            codemap = np.concatenate([codemap, codemap[..., -1:]], axis=-1)
        return codemap

    top = resize(top, duration_top)[None]
    bottom = resize(bottom, ratio * duration_top)[None]
    pitch = int(decoded.get("pitch", 0))
    family = str(decoded.get("instrument_family_str", ""))
    top_map = {"pitch": make_matrix(top.shape[1:], pitch),
               "instrument_family_str": make_matrix(top.shape[1:], family)}
    bottom_map = {"pitch": make_matrix(bottom.shape[1:], pitch),
                  "instrument_family_str": make_matrix(bottom.shape[1:],
                                                       family)}
    return make_response(top, bottom, top_map, bottom_map)


@app.route("/analyze-audio", methods=["POST"])
def analyze_audio(request: Request):
    state = STATE
    pitch = int(request.args["pitch"])
    family = str(request.args["instrument_family_str"])
    audio, sr = read_wav(request.files["audio"])
    if audio.ndim > 1:
        audio = audio.mean(axis=0)
    if sr != state.fs_hz:
        audio = resample(audio, sr, state.fs_hz)

    # trim to the maximum duration, then snap to the nearest analyze bucket
    # (identity, i.e. exact per-column rounding, for sounds up to
    # analyze_dense_duration_s) and encode at that exact duration
    duration_n = min(int(state.max_sound_duration_s * state.fs_hz),
                     audio.shape[-1])
    duration_n = state.snap_analyze_duration(duration_n)
    if audio.shape[-1] < duration_n:
        audio = np.pad(audio, (0, duration_n - audio.shape[-1]))
    audio = audio[:duration_n]

    top_code, bottom_code = state.analyze_fn()(
        np.ascontiguousarray(audio, np.float32)[None])
    f = state.vqvae.config.total_resolution_factor
    cols = state.helper.num_frames(duration_n) // f
    ratio_t = state.bottom.config.shape[1] // state.top.config.shape[1]
    top_code = _host(top_code)[..., :cols]
    bottom_code = _host(bottom_code)[..., :cols * ratio_t]
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


@app.route("/erase", methods=["POST"])
def erase(request: Request):
    state = STATE
    amplitude = float(request.args["eraser_amplitude"])
    start_index_top = int(request.args.get("start_index_top", 0))
    top_code, bottom_code = parse_codes(request)
    mask = parse_mask(request)[0]

    # the spectrogram's geometry follows from the codemap's shape: build
    # the amplitude mask on the host
    f = state.vqvae.config.total_resolution_factor
    spec_f = top_code.shape[1] * f
    spec_t = top_code.shape[2] * f
    upsampled = np.repeat(np.repeat(mask.astype(np.float32), f, axis=0),
                          f, axis=1)
    amplitude_mask = 200.0 * amplitude * upsampled
    pad_before = np.zeros((spec_f, f * start_index_top), np.float32)
    remaining = spec_t - pad_before.shape[1] - amplitude_mask.shape[1]
    pad_after = np.zeros((spec_f, max(0, remaining)), np.float32)
    full_mask = np.concatenate([pad_before, amplitude_mask, pad_after],
                               axis=1)[:, :spec_t]

    new_top, new_bottom = state.erase_fn()(top_code, bottom_code, full_mask)
    input_top_cond, input_bottom_cond = parse_conditioning(request)
    return make_response(new_top, new_bottom,
                         input_top_cond, input_bottom_cond)


@app.route("/get-audio", methods=["POST"])
def get_audio(request: Request):
    state = STATE
    top_code, bottom_code = parse_codes(request)
    audio = _host(state.decode_audio_fn()(top_code, bottom_code))[0]
    buf = io.BytesIO()
    write_wav(buf, audio, state.fs_hz)
    return send_bytes(buf.getvalue(), "audio/wav", "sample.wav")


@app.route("/get-spectrogram-image", methods=["POST"])
def get_spectrogram_image(request: Request):
    state = STATE
    top_code, bottom_code = parse_codes(request)
    idx = _host(state.decode_image_fn()(top_code, bottom_code))
    png = _encode_png(_viridis_lut()[idx])
    return send_bytes(png, "image/png", "spectrogram.png")


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


def spectrogram_image_indices(logmag: torch.Tensor,
                              upsampling_factor: int = 4) -> torch.Tensor:
    """[F, T] log-magnitude -> uint8 colormap indices [F, T * factor] on
    ``logmag``'s device, rows flipped for origin='lower': auto vmin/vmax,
    linear interpolation along time."""
    a = logmag.float()
    vmin, vmax = a.min(), a.max()
    scaled = (a - vmin) / torch.clamp(vmax - vmin, min=1e-9)
    if upsampling_factor > 1:
        t = a.shape[1]
        x = torch.arange(t * upsampling_factor, dtype=torch.float32,
                         device=a.device) / upsampling_factor
        i0 = torch.clamp(torch.floor(x).long(), 0, t - 1)
        i1 = torch.clamp(i0 + 1, max=t - 1)
        frac = x - i0
        scaled = scaled[:, i0] * (1.0 - frac) + scaled[:, i1] * frac
    idx = torch.clamp(scaled * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return idx.flip(0)


def render_spectrogram_png(logmag: np.ndarray,
                           upsampling_factor: int = 4) -> bytes:
    """Viridis-colormapped spectrogram PNG, all in numpy on the host: the
    tests' oracle for the device route (``spectrogram_image_indices`` via
    ``ServerState.decode_image_fn``), not a runtime fallback."""
    a = np.asarray(logmag, np.float32)
    vmin, vmax = float(a.min()), float(a.max())
    scaled = (a - vmin) / max(vmax - vmin, 1e-9)
    if upsampling_factor > 1:
        t = a.shape[1]
        x = np.arange(t * upsampling_factor, dtype=np.float32) \
            / upsampling_factor
        i0 = np.clip(np.floor(x).astype(np.int64), 0, t - 1)
        i1 = np.minimum(i0 + 1, t - 1)
        frac = (x - i0).astype(np.float32)
        scaled = scaled[:, i0] * (1.0 - frac) + scaled[:, i1] * frac
    idx = np.clip(scaled * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return _encode_png(_viridis_lut()[idx][::-1])


def warmup(state: ServerState, log=None, long_sounds: bool = False,
           widths=None) -> int:
    """Drive the real handlers once per shape that costs something cold,
    so that no user request pays for a kernel library's load, the decode
    tables, an FFT plan or a convolution algorithm search.

    Warms /generate (both priors, unprimed), /timerange-change on each
    layer (primed scans), /get-audio, /get-spectrogram-image and /erase
    (and, with ``long_sounds``, their 2x-duration forms), /analyze-audio
    once per duration bucket and /top-conditioned-sample once per batch
    bucket. One mask per layer is enough: scan bounds are run-time
    arguments of the kernels. ``widths`` is accepted for compatibility
    with the JAX server's signature and ignored. Returns the number of
    requests issued."""
    del widths
    if STATE is not state:
        raise ValueError("warmup drives handlers, which read STATE")
    log = log or (lambda *_: None)
    rng = np.random.default_rng(0)
    top_shape = tuple(state.top.config.shape)
    bottom_shape = tuple(state.bottom.config.shape)
    n_class = state.top.config.n_class_target
    n_class_b = state.bottom.config.n_class_target

    def codes(scale: int) -> dict:
        return {
            "top_code": rng.integers(
                0, n_class, (top_shape[0], scale * top_shape[1])).tolist(),
            "bottom_code": rng.integers(
                0, n_class_b,
                (bottom_shape[0], scale * bottom_shape[1])).tolist()}

    payloads = [codes(1)] + ([codes(2)] if long_sounds else [])
    pitch = (state.label_encoders["pitch"].classes_[0]
             if "pitch" in state.label_encoders else 60)
    family = (state.label_encoders["instrument_family_str"].classes_[0]
              if "instrument_family_str" in state.label_encoders
              else "keyboard")
    common_q = f"pitch={pitch}&instrument_family_str={family}"
    count = 0

    def drive(path: str, query: str, body: Optional[dict],
              files: Optional[dict] = None) -> None:
        nonlocal count
        t0 = time.time()
        req = Request.synthetic(
            path, query,
            json.dumps(body).encode() if body is not None else b"")
        if files:
            req.files = dict(files)
        resp = app.dispatch(req)  # on the thread that serves
        if resp.status != 200:
            raise RuntimeError(f"warmup {path}?{query} -> {resp.status}: "
                               f"{resp.body[:200]!r}")
        count += 1
        log(f"warm {path}?{query}: {time.time() - t0:.3f}s")

    drive("/generate", f"temperature=1.0&{common_q}", None)
    mask = np.zeros(top_shape, bool)
    mask[:, top_shape[1] // 2:] = True
    ratio_f = bottom_shape[0] // top_shape[0]
    ratio_t = bottom_shape[1] // top_shape[1]
    masks = {"top": mask,
             "bottom": np.repeat(np.repeat(mask, ratio_f, 0), ratio_t, 1)}
    erase_mask = np.zeros(top_shape, bool)
    erase_mask[:, :1] = True
    for body in payloads:
        for layer in ("top", "bottom"):
            drive("/timerange-change",
                  f"layer={layer}&temperature=1.0&start_index_top=0"
                  f"&{common_q}", dict(body, mask=masks[layer].tolist()))
        drive("/get-audio", common_q, body)
        drive("/get-spectrogram-image", common_q, body)
        drive("/erase",
              f"layer=top&eraser_amplitude=1.0&start_index_top=0"
              f"&{common_q}", dict(body, mask=erase_mask.tolist()))

    for bucket_n in state.analyze_duration_buckets():
        wav_buf = io.BytesIO()
        write_wav(wav_buf,
                  0.1 * rng.standard_normal(bucket_n).astype(np.float32),
                  state.fs_hz)
        drive("/analyze-audio", common_q, None,
              files={"audio": wav_buf.getvalue()})

    # /top-conditioned-sample: once per batch bucket, with chunk lengths cut
    # from the longest contiguous run of known pitches
    if "pitch" in state.label_encoders:
        classes = sorted(int(c) for c in
                         state.label_encoders["pitch"].classes_)
        run_start, run_len = classes[0], 1
        best_start, best_len = classes[0], 1
        for prev, cur in zip(classes, classes[1:]):
            run_len = run_len + 1 if cur == prev + 1 else 1
            run_start = run_start if cur == prev + 1 else cur
            if run_len > best_len:
                best_start, best_len = run_start, run_len
        buckets = state.pitch_batch_buckets
        warm_lens = set()
        for i, b in enumerate(buckets):
            lo = buckets[i - 1] + 1 if i else 1
            if lo <= best_len:  # a chunk this long exists: reachable
                warm_lens.add(min(b, best_len))
        for length in sorted(warm_lens):
            drive("/top-conditioned-sample",
                  f"instrument_family_str={family}&min_pitch={best_start}"
                  f"&max_pitch={best_start + length}&temperature=1.0",
                  payloads[0])
    return count


# -- startup ------------------------------------------------------------------

def load_state_from_checkpoints(
        vqvae_model_parameters_path, vqvae_weights_path,
        vqvae_training_parameters_path,
        prediction_top_parameters_path, prediction_top_weights_path,
        prediction_bottom_parameters_path, prediction_bottom_weights_path,
        label_encoders_path=None, codes_dataset_path=None,
        max_sound_duration_s: float = 60.0, sampling_options=None,
        device: DeviceLike = None) -> ServerState:
    """A state from the JAX package's two-file checkpoints
    (``*-model_parameters.json`` plus a weights blob per model) and the
    VQ-VAE's training parameters JSON, which sizes the spectrogram helper."""
    from ..data.lmdb_compat import open_codes_dataset
    from ..utils.checkpoint_io import (prior_from_parameters_and_weights,
                                       vqvae_from_parameters_and_weights)
    with open(vqvae_training_parameters_path) as f:
        training_parameters = json.load(f)
    helper = get_spectrograms_helper(**training_parameters)
    vqvae_model = vqvae_from_parameters_and_weights(
        vqvae_model_parameters_path, vqvae_weights_path)
    top_model = prior_from_parameters_and_weights(
        prediction_top_parameters_path, prediction_top_weights_path)
    bottom_model = prior_from_parameters_and_weights(
        prediction_bottom_parameters_path, prediction_bottom_weights_path)
    label_encoders = (load_label_encoders(label_encoders_path)
                      if label_encoders_path else {})
    codes_dataset = (open_codes_dataset(codes_dataset_path)
                     if codes_dataset_path else None)
    if not label_encoders and codes_dataset is not None:
        label_encoders = codes_dataset.label_encoders
    return ServerState(
        vqvae_model, top_model, bottom_model, helper, label_encoders,
        codes_dataset, fs_hz=training_parameters.get("fs_hz", 16000),
        max_sound_duration_s=max_sound_duration_s, device=device,
        sampling_options=sampling_options)


# -- test state ---------------------------------------------------------------

def make_test_configs(size: str = "tiny", use_pallas_lookup: bool = False):
    """(spectrogram kwargs, VQVAEConfig, top TransformerConfig, bottom
    TransformerConfig) of the JAX server's ``make_test_state``;
    ``use_pallas_lookup`` sets the VQ-VAE's flag of that name."""
    if size == "tiny":
        spec_kwargs = dict(fs_hz=16000, n_fft=256, window_length=256,
                           hop_length=64)
        vq_cfg = VQVAEConfig(num_hidden_channels=16,
                             num_residual_channels=8, embed_dim=8,
                             num_embeddings=32,
                             resolution_factors={"bottom": 4, "top": 2},
                             use_pallas_lookup=use_pallas_lookup)
        top_shape, bottom_shape = (16, 8), (32, 16)
        d_model, d_ff, layers = 32, 64, 1
    elif size == "full":
        spec_kwargs = dict(fs_hz=16000, n_fft=2048, window_length=2048,
                           hop_length=512, use_mel_scale=True)
        vq_cfg = VQVAEConfig(resolution_factors={"bottom": 16, "top": 2},
                             use_pallas_lookup=use_pallas_lookup)
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
                    sampling_options: Optional[Dict] = None,
                    use_pallas_lookup: bool = False) -> ServerState:
    """Randomly initialized models (weights drawn from ``seed`` with the
    flax initializers' scales) for plumbing and load tests."""
    device = resolve_device(device)
    spec_kwargs, vq_cfg, top_cfg, bottom_cfg = make_test_configs(
        size, use_pallas_lookup)
    gen = torch.Generator().manual_seed(seed)
    vqvae = init_like_flax(VQVAE(vq_cfg), gen)
    top = init_like_flax(SelfAttentiveVQTransformer(top_cfg), gen)
    bottom = init_like_flax(UpsamplingVQTransformer(bottom_cfg), gen)
    label_encoders = {
        "pitch": LabelEncoder(list(range(24, 85))),
        "instrument_family_str": LabelEncoder(
            ["bass", "brass", "flute", "guitar", "keyboard", "mallet",
             "organ", "reed", "string", "synth_lead", "vocal"])}
    # the tiny geometry has 512 samples per top column: cap the maximum
    # duration so that the /analyze-audio bucket set stays a handful of
    # entries, as at the full geometry (16384 samples per column)
    return ServerState(
        vqvae, top, bottom, get_spectrograms_helper(**spec_kwargs),
        label_encoders, fs_hz=spec_kwargs["fs_hz"],
        max_sound_duration_s=0.512 if size == "tiny" else 8.0,
        device=device, seed=seed, sampling_options=sampling_options)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vqvae_model_parameters_path", type=str)
    p.add_argument("--vqvae_weights_path", type=str)
    p.add_argument("--vqvae_training_parameters_path", type=str)
    p.add_argument("--prediction_top_parameters_path", type=str)
    p.add_argument("--prediction_top_weights_path", type=str)
    p.add_argument("--prediction_bottom_parameters_path", type=str)
    p.add_argument("--prediction_bottom_weights_path", type=str)
    p.add_argument("--label_encoders_path", type=str, default=None)
    p.add_argument("--codes_dataset_path", type=str, default=None)
    p.add_argument("--test_models", type=str, default=None,
                   choices=["tiny", "full"],
                   help="serve randomly initialized models")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--max_sound_duration_s", type=float, default=60.0,
                   help="uploads past 8 s snap to coarse 4 s duration "
                        "buckets up to this cap")
    p.add_argument("--sampling_top_k", type=int, default=0)
    p.add_argument("--sampling_top_p", type=float, default=0.0)
    p.add_argument("--use_predictive_sampling", dest="predictive_sampling",
                   action="store_true", default=False,
                   help="Gumbel predictive sampling (bfloat16 full forwards "
                        "with skip-on-match, arXiv:2002.09928) instead of "
                        "the fused KV scan; its latency depends on the data")
    p.add_argument("--no_predictive_sampling", dest="predictive_sampling",
                   action="store_false")
    p.add_argument("--spectrograms_upsampling_factor", type=int, default=4,
                   help="time-axis upsampling of the rendered spectrogram "
                        "PNGs")
    p.add_argument("--warmup", action="store_true",
                   help="before serving, drive every handler once per shape "
                        "that costs something cold")
    p.add_argument("--warmup_long", action="store_true",
                   help="also warm the 2x-duration (time-index-remapped) "
                        "requests; implies --warmup")
    args = p.parse_args(argv)
    sampling_options = {"top_k": args.sampling_top_k,
                        "top_p": args.sampling_top_p,
                        "predictive": args.predictive_sampling}
    global STATE
    logging.basicConfig(level=logging.INFO)
    if args.test_models:
        STATE = make_test_state(
            args.test_models, device=args.device, seed=args.seed,
            sampling_options=sampling_options)
        if args.codes_dataset_path:
            from ..data.lmdb_compat import open_codes_dataset
            STATE.codes_dataset = open_codes_dataset(args.codes_dataset_path)
    else:
        checkpoint_paths = (
            args.vqvae_model_parameters_path, args.vqvae_weights_path,
            args.vqvae_training_parameters_path,
            args.prediction_top_parameters_path,
            args.prediction_top_weights_path,
            args.prediction_bottom_parameters_path,
            args.prediction_bottom_weights_path)
        if not all(checkpoint_paths):
            p.error("pass --test_models tiny|full or all seven checkpoint "
                    "paths")
        STATE = load_state_from_checkpoints(
            *checkpoint_paths, args.label_encoders_path,
            args.codes_dataset_path, args.max_sound_duration_s,
            sampling_options, device=args.device)
    STATE.spectrograms_upsampling_factor = (
        args.spectrograms_upsampling_factor)
    app.logger = logger
    if args.warmup or args.warmup_long:
        t0 = time.time()
        n = warmup(STATE, log=print, long_sounds=args.warmup_long)
        print(f"warmup: {n} requests in {time.time() - t0:.1f}s", flush=True)
    print(f"serving on {args.host}:{args.port}", flush=True)
    app.run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
