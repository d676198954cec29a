"""The VQ-VAE training cell at a tiny geometry on the CPU: the driver runs
end to end and is correct, each planted fault of ``harness/vqvae_faults.py``
is not, its readers on hand-worked data, and its operation counts by
hand."""

import importlib.util

import pytest

from bench_support import BENCH, checkout

import run  # noqa: E402  (bench_support puts the benchmark on sys.path)
from harness import vqvae_faults, vqvae_flops  # noqa: E402
from harness.peaks import PEAK_OPS, least_seconds  # noqa: E402

CELL = "tiny-vqvae-train"
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("vqvae"))


def test_the_cell_runs_and_is_correct(root):
    result = run.run_cell(CELL, SEED, 0.5, False, "cpu", root=root)
    assert result["correct"] is True, result["compared"]
    assert set(result["compared"]) == {
        "stats_gap", "loss_gap", "trio_gap", "grad_gap", "update_gap",
        "codebook_gap", "feed_rows"}
    assert set(result["metrics"]) == {"setup_s", "train_notes_per_s"}
    assert result["attempted"] == result["checks"]["window_logged_steps"]


def test_a_traced_run_counts_one_span_a_step(root):
    result = run.run_cell(CELL, SEED + 1, 0.5, True, "cpu", root=root)
    assert result["correct"] is True, result["compared"]
    # no device on the CPU: the host-clock metric alone
    assert set(result["metrics"]) == {"vqvae_mfu_pct"}
    checks = result["checks"]
    assert checks["span_counts_match"] is True
    assert checks["traced_span_counts"] == {
        f"train.{name}": 2 for name in (
            "batch", "spectrogram", "forward", "criterion", "backward",
            "optimizer", "trio")}


@pytest.mark.parametrize("fault", vqvae_faults.TRAINING)
def test_each_fault_is_not_correct(root, fault):
    result = run.run_cell(CELL, SEED, 0.5, False, "cpu", root=root,
                          plant=f"harness.faults:{fault}")
    assert result["correct"] is False
    # a fault that leaves a number out has no reading of it
    assert [name for name, item in result["compared"].items()
            if item["value"] is None or not item["value"] <= item["limit"]]


def load_reader(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TRACE = {"busy_s": 1.5, "window_s": 2.0,
         "device_s": {"void spectral_fft_fwd_kernel<11>(SpectralParams)": 0.3,
                      "void spectral_reduce_kernel(float const*)": 0.1,
                      "void vq_assign_kernel(VqLookupParams, int, int)": 0.02,
                      "void vq_stats_kernel<9>(VqLookupParams)": 0.03,
                      "sm80_xmma_gemm_f32f32": 0.5},
         "spans": {"train.batch": {"seconds": 0.04, "count": 4},
                   "train.criterion": {"seconds": 0.08, "count": 4},
                   "train.trio": {"seconds": 0.06, "count": 2}}}
DATA = {"traced_steps": 4, "trace": TRACE, "conv_device_s": 0.2,
        "spectral_bound_s": 0.04, "vq_bound_s": 0.005, "steps": 10,
        "window_s": 2.0, "window_ops": 3.3e12}


@pytest.mark.parametrize("name, data, expected", [
    ("conv_ms.vqvae", DATA, 50.0),
    ("batch_ms.vqvae", DATA, 10.0),
    ("criterion_ms.vqvae", DATA, 20.0),
    ("trio_ms.vqvae", DATA, 30.0),           # over the two logged steps
    ("spectral_loss_roofline_pct", DATA, 10.0),
    ("vq_lookup_roofline_pct", DATA, 10.0),
    ("device_idle_pct.vqvae", DATA, 25.0),
    ("vqvae_mfu_pct", DATA, 100.0 * 3.3e12 / PEAK_OPS["float32"] / 2.0),
    # a program without the spans, a trace without device activity, an
    # untraced run: nothing to read
    ("trio_ms.vqvae", {**DATA, "trace": {**TRACE, "spans": {}}}, None),
    ("batch_ms.vqvae", {**DATA, "trace": {**TRACE, "busy_s": 0.0}}, None),
    ("conv_ms.vqvae", {**DATA, "conv_device_s": None}, None),
    ("spectral_loss_roofline_pct", {**DATA, "trace": None}, None),
    ("vq_lookup_roofline_pct",
     {**DATA, "trace": {**TRACE, "device_s": {}}}, None),
])
def test_reader(name, data, expected):
    value = load_reader(name).read(data)
    if expected is None:
        assert value is None
    else:
        assert value == pytest.approx(expected)


TINY = {"in_channel": 2, "num_hidden_channels": 8,
        "num_residual_channels": 2, "n_res_block": 1, "embed_dim": 4,
        "num_embeddings": 8, "resolution_factors": {"top": 2, "bottom": 2}}


def test_conv_layers_by_hand():
    # input 8 x 4: enc_b 2->4 (4x2) then 3x3 4->8 and a residual block;
    # enc_t 8->4 (2x1), 3x3 4->8, block; 1x1 8->4; dec_t 3x3 4->8, block,
    # up 8->4 (4x2 out); 1x1 12->4; lift 4->4; dec 3x3 8->8, block, up 8->2
    assert vqvae_flops.conv_layers(TINY, (8, 4)) == [
        (2, 4, 16, 8), (4, 8, 9, 8), (8, 2, 9, 8), (2, 8, 1, 8),
        (8, 4, 16, 2), (4, 8, 9, 2), (8, 2, 9, 2), (2, 8, 1, 2),
        (8, 4, 1, 2),
        (4, 8, 9, 2), (8, 2, 9, 2), (2, 8, 1, 2), (8, 4, 16, 2),
        (12, 4, 1, 8),
        (4, 4, 16, 2),
        (8, 8, 9, 8), (8, 2, 9, 8), (2, 8, 1, 8), (8, 2, 16, 8)]
    forward = [2 * 3 * i * o * k * c for i, o, k, c in
               vqvae_flops.conv_layers(TINY, (8, 4))]
    assert vqvae_flops.conv_ops(TINY, 3, (8, 4)) == (
        3 * sum(forward) - forward[0])
    assert vqvae_flops.code_rows(TINY, 3, (8, 4)) == (3 * 2, 3 * 8)


def test_kernel_bounds_by_hand():
    # one 512-point scale on 2 x 1024 samples, hop 128: 5 frames
    fwd, bwd = vqvae_flops.spectral_bound(2, 1024, 512, 128, True)
    u = 2 * 5 * 2 * 257 * 2
    fft = 2 * 5 * 2.5 * 512 * 9
    assert fwd == (2 * 4 * 2048 + u + 12, 2 * fft)
    assert bwd == (u + 4 * 2048 + 4, fft)
    assert vqvae_flops.spectral_bound(2, 1024, 512, 128, False) == (
        (2 * 4 * 2048 + 12, 2 * fft),)
    # a logged step: the Jukebox scales with their backward, the trio's 9
    assert len(vqvae_flops.spectral_calls(2, 65536)) == 6 + 9
    assert len(vqvae_flops.spectral_calls(2, 65536, trio=False)) == 6
    assert vqvae_flops.vq_bound(100, 4, 8) == (
        4 * (800 + 64 + 100 + 8), 6400)
    assert vqvae_flops.vq_bound_s(TINY, 3, (8, 4)) == pytest.approx(
        least_seconds(*vqvae_flops.vq_bound(6, 4, 8), "float32")
        + least_seconds(*vqvae_flops.vq_bound(24, 4, 8), "float32"))
