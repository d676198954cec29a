"""The port's spans (``utils/tracing.py``) on the CPU: off, ``span`` is one
shared null context; under ``torch.profiler`` a served edit-and-listen
interaction over a real socket and two training steps write the spans
the benchmark's readers need, nested and counted as the readers assume,
read back through the benchmark's own trace reader
(``benchmark/harness/trace.py``); and each of those readers
(``benchmark/metrics/*.py``) on hand-built data."""

import importlib.util
import itertools
import json
import pathlib
import sys
import urllib.request

import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
    transformer)
from interactive_spectrogram_inpainting_tpu_torch.serve import server
from interactive_spectrogram_inpainting_tpu_torch.train import (
    scheduler, train_prior)
from interactive_spectrogram_inpainting_tpu_torch.utils import tracing
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    init_like_flax)

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import trace  # noqa: E402

CPU = torch.device("cpu")
QUERY = ("layer=top&temperature=1.0&start_index_top=0&pitch=60"
         "&instrument_family_str=keyboard")


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = tracing.span("sampler.scan"), tracing.span("x")
    assert first is second is tracing._OFF
    with first:
        pass


def traced(run, all_threads=True):
    """Run ``run()`` inside the benchmark's traced window; -> (summary,
    the user annotations [(start_ns, end_ns, name)])."""
    prof, window = trace.start(CPU, all_threads=all_threads)
    try:
        run()
    finally:
        window.__exit__(None, None, None)
        prof.stop()
    return trace.summarize(prof), trace.raw_events(prof)[2]


def counts(summary):
    return {name: s["count"] for name, s in summary["spans"].items()}


def inside(spans, outer_names, annotations):
    """Each span named in ``spans`` lies within one of ``outer_names``."""
    outer = [(a, b) for a, b, n in annotations if n in outer_names]
    return all(any(a <= x and y <= b for a, b in outer)
               for x, y, n in annotations if n in spans)


def post(port, path, query, body) -> bytes:
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}?{query}", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=120) as response:
        assert response.status == 200
        return response.read()


def test_an_interaction_over_http_writes_every_serving_span(monkeypatch):
    """A top-layer edit (the cascade: both priors prime and scan) and its
    playback, as the serving cell drives them, with the handler thread
    started before the profiler."""
    state = server.make_test_state("tiny", device="cpu")
    monkeypatch.setattr(server, "STATE", state)
    rng = np.random.default_rng(3)
    top_cond, bottom_cond = server.conditioning_maps(state, 60, "keyboard")
    mask = np.zeros(state.top.config.shape, bool)
    mask[:, -2:] = True  # the last two columns: a prefix to prime
    body = {"top_code": rng.integers(0, 32, state.top.config.shape).tolist(),
            "bottom_code": rng.integers(
                0, 32, state.bottom.config.shape).tolist(),
            "mask": mask.tolist(), "top_conditioning": top_cond,
            "bottom_conditioning": bottom_cond}
    http = server.app.run(host="127.0.0.1", port=0, background=True)
    port = http.server_address[1]

    def interact():
        edited = json.loads(post(port, "/timerange-change", QUERY, body))
        wav = post(port, "/get-audio", "", {
            "top_code": edited["top_code"],
            "bottom_code": edited["bottom_code"]})
        assert wav[:4] == b"RIFF"

    try:
        interact()  # starts the handler thread, as the cell's warm edit
        summary, annotations = traced(interact)
    finally:
        http.shutdown()
        http.server_close()
    assert counts(summary) == {
        "http.request": 2, "http.dispatch": 2, "http.handle": 2,
        "serve.parse": 2,
        # the conditioning map and the JSON reply; the WAV's response
        "serve.respond": 3,
        "sampler.encode": 2, "sampler.tables": 2, "sampler.prime": 2,
        "sampler.scan": 2, "sampler.codemap": 2, "sampler.readback": 1,
        "playback.decode": 1, "playback.audio": 1, "playback.wav": 1}
    under_handle = {n for n in summary["spans"]
                    if n.split(".")[0] in ("serve", "sampler", "playback")}
    assert inside(under_handle, {"http.handle"}, annotations)
    assert inside({"http.handle"}, {"http.dispatch"}, annotations)
    assert inside({"http.dispatch"}, {"http.request"}, annotations)
    assert not any(n.startswith(trace.KERNEL_SPAN) or n == trace.WINDOW
                   for n in summary["spans"])


class Codes:
    """Seeded codes at the tiny bottom prior's geometry."""

    def __init__(self, cfg, n=8):
        rng = np.random.default_rng(5)
        self.tops = rng.integers(0, cfg.n_class,
                                 (n, *cfg.condition_shape))
        self.bottoms = rng.integers(0, cfg.n_class, (n, *cfg.shape))
        self.labels = {
            name: rng.integers(0, classes, n) for name, classes in
            cfg.class_conditioning_num_classes_per_modality.items()}

    def __len__(self):
        return len(self.tops)

    def read_batch(self, idx):
        return (self.tops[idx], self.bottoms[idx],
                {k: v[idx] for k, v in self.labels.items()})


def test_two_training_steps_write_one_span_of_each_phase_a_step():
    cfg = server.make_test_configs("tiny")[3]
    model = init_like_flax(transformer.UpsamplingVQTransformer(cfg),
                           torch.Generator().manual_seed(0))
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None,
                                        1e-3, 10)
    step, _ = train_prior.make_steps(model, optimizer, "bottom", None, 0.1)
    generator = torch.Generator().manual_seed(1)
    batches = train_prior.iterate_batches(Codes(cfg), 2, True, 0,
                                          device="cpu")

    def run():
        for tops, bottoms, cc, _ in itertools.islice(batches, 2):
            step(tops, bottoms, cc, generator)

    summary, annotations = traced(run, all_threads=False)
    # beside torch.optim's own spans of Adam's step and zero_grad
    assert {n: c for n, c in counts(summary).items()
            if n.startswith("train.")} == {
        "train.batch": 2, "train.forward": 2, "train.backward": 2,
        "train.optimizer": 2}
    # one after the other: a batch's span closes before the step that
    # takes it starts
    spans = sorted(s for s in annotations if s[2].startswith("train."))
    assert [n for _, _, n in spans] == [
        "train.batch", "train.forward", "train.backward",
        "train.optimizer"] * 2
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def load_reader(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serving_data(spans, busy_s=1.0):
    """Two traced edits and their playbacks, and one edit before the
    trace."""
    handled = [{"path": path, "traced": traced}
               for traced in (False, True, True)
               for path in ("/timerange-change", "/get-audio")]
    return {"handled": handled,
            "trace": {"busy_s": busy_s, "window_s": 2.0, "spans": {
                name: {"seconds": s, "count": n}
                for name, (s, n) in spans.items()}}}


def training_data(spans, busy_s=1.0):
    return {"traced_steps": 4,
            "trace": {"busy_s": busy_s, "window_s": 2.0, "spans": {
                name: {"seconds": s, "count": 4}
                for name, s in spans.items()}}}


SERVING = {"sampler.encode": (0.010, 4), "sampler.tables": (0.006, 4),
           "serve.parse": (0.004, 4), "serve.respond": (0.002, 6),
           "http.request": (0.300, 4), "http.dispatch": (0.2904, 4),
           "http.handle": (0.290, 4)}
TRAINING = {"train.batch": 0.008, "train.forward": 0.2,
            "train.backward": 0.3, "train.optimizer": 0.02}


def without(spans, name):
    return {k: v for k, v in spans.items() if k != name}


@pytest.mark.parametrize("name, data, expected", [
    # (10 + 6) ms over two traced edits
    ("sampler_setup_ms.edit", serving_data(SERVING), 8.0),
    ("sampler_setup_ms.edit",
     serving_data(without(SERVING, "sampler.tables")), None),
    ("handler_host_ms.edit", serving_data(SERVING), 3.0),
    ("handler_host_ms.edit",
     serving_data(without(SERVING, "serve.respond")), None),
    ("http_server_ms.edit", serving_data(SERVING), 5.0),
    ("http_server_ms.edit",
     serving_data(without(SERVING, "http.request")), None),
    # 0.4 ms over four handled requests
    ("handler_wait_ms.edit", serving_data(SERVING), 0.1),
    ("handler_wait_ms.edit",
     serving_data(without(SERVING, "http.dispatch")), None),
    ("batch_ms.train", training_data(TRAINING), 2.0),
    ("batch_ms.train", training_data(without(TRAINING, "train.batch")),
     None),
    ("optimizer_ms.train", training_data(TRAINING), 5.0),
    ("optimizer_ms.train",
     training_data(without(TRAINING, "train.optimizer")), None),
    # a trace with no device activity (the CPU): no device-trace reading
    ("sampler_setup_ms.edit", serving_data(SERVING, busy_s=0.0), None),
    ("batch_ms.train", training_data(TRAINING, busy_s=0.0), None),
    # an untraced run
    ("handler_wait_ms.edit", {"handled": [], "trace": None}, None),
    ("optimizer_ms.train", {"traced_steps": 0, "trace": None}, None),
])
def test_reader(name, data, expected):
    value = load_reader(name).read(data)
    if expected is None:
        assert value is None
    else:
        assert value == pytest.approx(expected)
