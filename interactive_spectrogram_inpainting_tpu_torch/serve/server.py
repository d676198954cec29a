"""Interactive inpainting HTTP service: the NOTONO inpaint + playback path.

Port of ``interactive_spectrogram_inpainting_tpu/serve/server.py`` for the
two endpoints of one interaction, with the JAX server's JSON schemas:

- ``/timerange-change``  the core inpaint op: masked regeneration of a
                         transformer-sized frame, top prior cascading into
                         the bottom prior (``layer=top``) or the bottom
                         prior alone (``layer=bottom``), with time-index
                         remapping for sounds longer than the frame;
- ``/get-audio``         codemaps -> VQ-VAE decode -> mel inverse -> wav.

Both priors sample through the fused B=1 path (prefix priming plus the
whole-scan kernel) in bfloat16, as the JAX server does. The other
endpoints, the warmup lattice and checkpoint loading are not ported yet;
``--test_models tiny|full`` serves randomly initialized models.

Run: ``python -m interactive_spectrogram_inpainting_tpu_torch.serve.server
--test_models full`` (GPU by default; ``--device cpu`` for the plain path).
"""

from __future__ import annotations

import argparse
import io
import logging
import threading
import time
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


class ServerState:
    """Models, decode tables and the per-request sampling closures.

    ``gumbel_source``, when set, is called as ``gumbel_source(which)``
    (``'top'`` or ``'bottom'``) and returns the Gumbel noise of that
    prior's scan instead of drawing it from the request's generator: a
    caller can replay a fixed noise stream through the endpoints."""

    def __init__(self, vqvae_model: VQVAE, top_model: VQNSynthTransformer,
                 bottom_model: VQNSynthTransformer, spectrograms_helper,
                 label_encoders: Mapping[str, LabelEncoder],
                 fs_hz: int = 16000, device: DeviceLike = None,
                 seed: Optional[int] = None):
        self.device = resolve_device(device)
        set_float32_precision()
        self.vqvae = vqvae_model.to(self.device).eval()
        self.top = top_model.to(self.device).eval()
        self.bottom = bottom_model.to(self.device).eval()
        self.helper = spectrograms_helper
        self.label_encoders = dict(label_encoders)
        self.fs_hz = fs_hz
        self._seed = (time.time_ns() if seed is None else seed) & 0xFFFFFFFF
        self._rng_counter = 0
        self._fn_cache: Dict = {}
        # one request at a time on the device
        self._lock = threading.Lock()
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

    def sample_fn(self, which: str, batch_size: int,
                  scan_from: Optional[int] = None,
                  scan_until: Optional[int] = None):
        model = self.top if which == "top" else self.bottom
        state = self.decode_state(which)

        def fn(generator, temperature, condition, initial_code, mask,
               class_conditioning, ti_src, ti_tgt):
            with self._lock:
                return sample_model(
                    model, generator, batch_size, temperature=temperature,
                    condition=condition, class_conditioning=class_conditioning,
                    initial_code=initial_code, mask=mask,
                    time_indexes_source=ti_src, time_indexes_target=ti_tgt,
                    compute_dtype=torch.bfloat16, scan_from=scan_from,
                    scan_until=scan_until, decode_state=state,
                    gumbel=self._gumbel(which), bounds_from_mask=False,
                    device=self.device)
        return fn

    def cascade_fn(self, sf_t, su_t, sf_b, su_b, long_sound=False):
        """Top inpaint -> bottom cascade (the core interactive op)."""
        state_t = self.decode_state("top")
        state_b = self.decode_state("bottom")

        def fn(generator, temperature, top_frame, bottom_frame, mask_top,
               mask_bottom, class_conditioning, ti_top=None, ti_bottom=None):
            assert (ti_top is not None) == bool(long_sound)
            with self._lock:
                new_top = sample_model(
                    self.top, generator, 1, temperature=temperature,
                    condition=top_frame, class_conditioning=class_conditioning,
                    initial_code=top_frame, mask=mask_top,
                    time_indexes_source=ti_top, time_indexes_target=ti_top,
                    compute_dtype=torch.bfloat16, scan_from=sf_t,
                    scan_until=su_t, decode_state=state_t,
                    gumbel=self._gumbel("top"), bounds_from_mask=False,
                    device=self.device)
                new_bottom = sample_model(
                    self.bottom, generator, 1, temperature=temperature,
                    condition=new_top, class_conditioning=class_conditioning,
                    initial_code=bottom_frame, mask=mask_bottom,
                    time_indexes_source=ti_top,
                    time_indexes_target=ti_bottom,
                    compute_dtype=torch.bfloat16, scan_from=sf_b,
                    scan_until=su_b, decode_state=state_b,
                    gumbel=self._gumbel("bottom"), bounds_from_mask=False,
                    device=self.device)
            return new_top, new_bottom
        return fn

    def decode_audio_fn(self):
        """codemaps -> audio: VQ-VAE decode then the inverse transform."""
        def fn(top_code, bottom_code):
            with self._lock, torch.no_grad():
                spec = self.vqvae.decode_code(
                    torch.as_tensor(np.asarray(top_code), device=self.device),
                    torch.as_tensor(np.asarray(bottom_code),
                                    device=self.device))
                return self.helper.to_audio(spec)
        return fn

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


def make_response(top_code, bottom_code, top_conditioning,
                  bottom_conditioning):
    return jsonify({
        "top_code": np.asarray(top_code)[0].astype(int).tolist(),
        "bottom_code": np.asarray(bottom_code)[0].astype(int).tolist(),
        "top_conditioning": top_conditioning,
        "bottom_conditioning": bottom_conditioning,
    })


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- endpoints ----------------------------------------------------------------

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
                    seed: int = 0) -> ServerState:
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
        seed=seed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test_models", type=str, default=None,
                   choices=["tiny", "full"],
                   help="serve randomly initialized models")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--host", type=str, default="0.0.0.0")
    args = p.parse_args(argv)
    if not args.test_models:
        p.error("loading trained checkpoints is not ported yet; "
                "pass --test_models tiny|full")
    global STATE
    logging.basicConfig(level=logging.INFO)
    STATE = make_test_state(args.test_models, device=args.device,
                            seed=args.seed)
    app.logger = logger
    print(f"serving on {args.host}:{args.port}", flush=True)
    app.run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
