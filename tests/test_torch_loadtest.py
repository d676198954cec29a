"""The port's load driver (``serve/loadtest.py``) against the JAX package's:
the same payloads from the same seed, the same request mix, and a run
against the port's tiny server on the CPU over real HTTP, and the users'
ramp."""

import threading
import time

import numpy as np
import pytest

from interactive_spectrogram_inpainting_tpu.serve import loadtest as jload
from interactive_spectrogram_inpainting_tpu_torch.serve import (
    loadtest as tload, server as tsrv)


def seeded_payload(module, monkeypatch, seed, *args, **kwargs):
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a: real(seed) if not a else real(*a))
    try:
        return module.make_payload(*args, **kwargs)
    finally:
        monkeypatch.setattr(np.random, "default_rng", real)


@pytest.mark.parametrize("args,long_factor", [
    (((32, 4), (64, 8), 512), 1), (((32, 4), (64, 8), 512), 2),
    (((16, 8), (32, 16), 32), 2)])
def test_payload_and_tasks_match_jax(monkeypatch, args, long_factor):
    assert tload.TASKS == jload.TASKS
    assert [w for _, _, w in tload.TASKS] == [3, 1, 1]
    for seed in (0, 7):
        port = seeded_payload(tload, monkeypatch, seed, *args,
                              long_factor=long_factor)
        ref = seeded_payload(jload, monkeypatch, seed, *args,
                             long_factor=long_factor)
        assert port == ref
    top_shape, bottom_shape, vocab = args
    assert np.asarray(port["top_code"]).shape == (
        top_shape[0], top_shape[1] * long_factor)
    assert np.asarray(port["bottom_code"]).shape == (
        bottom_shape[0], bottom_shape[1] * long_factor)
    assert np.asarray(port["mask"]).shape == top_shape
    assert np.asarray(port["mask"]).sum() == 2 * top_shape[0]


def test_run_load_against_the_port_server():
    state = tsrv.make_test_state("tiny", device="cpu")
    # the payload conditions on pitch 60 and keyboard; every test state
    # (tiny and full) has these label encoders
    assert list(state.label_encoders["pitch"].transform([60])) == [36]
    state.label_encoders["instrument_family_str"].transform(["keyboard"])
    old, tsrv.STATE = tsrv.STATE, state
    http = tsrv.app.run(host="127.0.0.1", port=0, background=True)
    try:
        report = tload.run_load(
            f"http://127.0.0.1:{http.server_address[1]}", users=2,
            duration_s=6.0, top_shape=tuple(state.top.config.shape),
            bottom_shape=tuple(state.bottom.config.shape),
            vocab=state.top.config.n_class, long_fraction=0.5)
    finally:
        http.shutdown()
        http.server_close()
        tsrv.STATE = old
    assert sum(v.get("errors", 0) for v in report.values()) == 0, report
    assert sum(v.get("requests", 0) for v in report.values()) >= 1
    for path, stats in report.items():
        assert path.split(" ")[0] in {t[0] for t in tload.TASKS}
        assert set(stats) == {"requests", "errors", "p50_ms", "p95_ms",
                              "rps"}
        assert stats["p95_ms"] >= stats["p50_ms"] > 0


def test_run_load_ramps_the_users_in(monkeypatch):
    first = {}

    class Reply:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return b"{}"

    def urlopen(request, timeout):
        first.setdefault(threading.get_ident(), time.perf_counter())
        return Reply()

    monkeypatch.setattr(tload.urllib.request, "urlopen", urlopen)
    t0 = time.perf_counter()
    report = tload.run_load("http://127.0.0.1:1", users=4, duration_s=1.6,
                            ramp_s=1.2)
    starts = sorted(t - t0 for t in first.values())
    assert len(starts) == 4
    np.testing.assert_allclose(starts, [0.0, 0.3, 0.6, 0.9], atol=0.15)
    assert sum(v["errors"] for v in report.values()) == 0
