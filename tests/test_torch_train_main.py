"""The port's prior trainer end to end on the CPU, and its files.

``train_prior.main`` on a tiny codemap store (d_model 32, 2 decoder
layers): dry runs of both priors with every switch of the step (fused
attention, remat, bf16), a run that writes checkpoints, the exported prior
and a profile, its resume, a warm start from a weights file the JAX package
wrote, ``--evaluate_only``; the exported prior loaded by the JAX package
gives the port's logits (atol 1e-4). Also the checkpointer's rolling and
best saves, the metrics file and the step watchdog."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from interactive_spectrogram_inpainting_tpu.models.prior import (
    transformer as jax_tt)
from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store import (
    CodemapStoreWriter)
from interactive_spectrogram_inpainting_tpu_torch.data.label_encoders import (
    LabelEncoder)
from interactive_spectrogram_inpainting_tpu_torch.parallel.distributed import (
    StepWatchdog, maybe_watchdog)
from interactive_spectrogram_inpainting_tpu_torch.train import train_prior
from interactive_spectrogram_inpainting_tpu_torch.train.checkpoint import (
    Checkpointer)
from interactive_spectrogram_inpainting_tpu_torch.utils.metrics import (
    MetricsWriter)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    from_flax_params)

N_RECORDS = 10


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = tmp_path_factory.mktemp("codes")
    rng = np.random.default_rng(0)
    encoders = {"pitch": LabelEncoder(list(range(40, 48))),
                "instrument_family_str": LabelEncoder(["bass", "keyboard"])}
    with CodemapStoreWriter(path, (4, 2), (8, 4),
                            ["pitch", "instrument_family_str"],
                            label_encoders=encoders, n_class=16) as w:
        for i in range(N_RECORDS):
            w.append(rng.integers(0, 16, (4, 2)), rng.integers(0, 16, (8, 4)),
                     {"pitch": i % 8, "instrument_family_str": i % 2},
                     f"note_{i}")
    return path


def args(store, runs, hier, *extra):
    out = ["--hier", hier, "--database_path", str(store), "--device", "cpu",
           "--d_model", "32", "--embeddings_dim", "8",
           "--positional_embeddings_dim", "8", "--num_encoder_layers", "1",
           "--num_decoder_layers", "2", "--num_heads", "4", "--d_ff", "64",
           "--class_conditioning_embedding_dim", "4", "--batch_size", "4",
           "--runs_directory", str(runs), "--seed", "3"]
    if hier == "bottom":
        out.append("--use_aligned_decoder")
    return out + list(extra)


@pytest.mark.parametrize("hier,extra", [
    ("top", []),
    ("bottom", []),
    ("bottom", ["--fused_attention", "on", "--remat", "--bf16",
                "--label_smoothing", "0.1", "--clip_grad_norm", "1.0",
                "--scheduler", "cycle", "--dropout_rng", "rbg"]),
    ("top", ["--mask_sampler", "contiguous-zones", "--optimizer", "radam",
             "--drop_loss_half_DEBUG"]),
])
def test_dry_run(store, tmp_path, hier, extra):
    model = train_prior.main(args(store, tmp_path, hier, "--dry_run",
                                  *extra))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert model.config.fused_attention == ("on" in extra)
    assert model.config.remat == ("--remat" in extra)
    assert not any(tmp_path.iterdir())  # a dry run writes nothing


def test_train_resume_export_and_jax_load(store, tmp_path):
    runs = tmp_path / "runs"
    model = train_prior.main(args(store, runs, "top", "--num_training_epochs",
                                  "1", "--profile"))
    (run_dir,) = runs.iterdir()
    for name in ("command_line_parameters.json", "model_parameters.json",
                 "best_validation_loss.json", "top-model_parameters.json",
                 "top-weights.msgpack", "checkpoints/0/state.pt",
                 "best/0/state.pt", "tb/metrics.jsonl",
                 "profile/trace.json", "tb/media/codemap_prediction-0.png"):
        assert (run_dir / name).exists(), name
    records = [json.loads(line) for line in
               (run_dir / "tb" / "metrics.jsonl").read_text().splitlines()]
    assert any("top/validation/loss" in r for r in records)
    assert any("top/epoch/warm_step_ms" in r for r in records)

    # resuming at the last epoch trains nothing and restores the weights
    resumed = train_prior.main(args(
        store, tmp_path / "r1", "top", "--resume_training_from",
        str(run_dir), "--num_training_epochs", "1",
        "--disable_writes_to_disk"))
    for (k, a), b in zip(model.state_dict().items(),
                         resumed.state_dict().values()):
        assert torch.equal(a, b), k
    # ... and one more epoch continues from there
    train_prior.main(args(store, runs, "top", "--resume_training_from",
                          str(run_dir), "--num_training_epochs", "2"))
    second = [p for p in runs.iterdir() if p != run_dir]
    assert Checkpointer(second[0]).latest_epoch() == 1

    # the exported prior, loaded by the JAX package, gives the port's logits
    jm, variables = jax_tt.from_parameters_and_weights(
        run_dir / "top-model_parameters.json", run_dir / "top-weights.msgpack")
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 16, (2, 4, 2))
    cc = {"pitch": np.array([1, 2]), "instrument_family_str": np.array([0, 1])}
    mask = rng.random((2, 4, 2)) < 0.5
    src, tgt = jm.apply(variables, jnp.asarray(codes), jnp.asarray(codes),
                        class_conditioning={k: jnp.asarray(v)
                                            for k, v in cc.items()},
                        mask=jnp.asarray(mask),
                        method=jax_tt.VQNSynthTransformer.to_sequences)
    j_logits, _ = jm.apply(variables, tgt, src)
    with torch.no_grad():
        t_src, t_tgt = model.to_sequences(
            torch.as_tensor(codes), torch.as_tensor(codes),
            class_conditioning={k: torch.as_tensor(v) for k, v in cc.items()},
            mask=torch.as_tensor(mask))
        t_logits, _ = model(t_tgt, t_src)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)


def test_warm_start_from_jax_weights_and_evaluate_only(store, tmp_path):
    cfg = jax_tt.TransformerConfig(
        shape=(8, 4), condition_shape=(4, 2), n_class=16, d_model=32,
        embeddings_dim=8, positional_embeddings_dim=8,
        conditional_model_num_encoder_layers=1,
        conditional_model_num_decoder_layers=2, conditional_model_nhead=4,
        d_ff=64, use_aligned_decoder=True)
    jm = jax_tt.UpsamplingVQTransformer(cfg)
    variables = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 8, 4), jnp.int32),
        jnp.zeros((1, 4, 2), jnp.int32),
        method=jax_tt.VQNSynthTransformer.full_init))(jax.random.PRNGKey(7))
    weights = tmp_path / "w.msgpack"
    weights.write_bytes(serialization.to_bytes(
        {"params": variables["params"]}))
    config = tmp_path / "p.json"
    config.write_text(cfg.to_json())
    common = args(store, tmp_path / "runs", "bottom",
                  "--initial_weights_path", str(weights),
                  "--initial_model_parameters_path", str(config),
                  "--disable_writes_to_disk")
    model = train_prior.main(common + ["--num_training_epochs", "0"])
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, variables))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    metrics = train_prior.main(common + ["--evaluate_only"])
    assert set(metrics) == {"loss", "accuracy"}
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["accuracy"] <= 1


def test_parallel_flags_name_the_parallel_slice(store, tmp_path,
                                                monkeypatch):
    """The mesh flags (once refused as the parallel slice's): sizes that
    match the world run, others raise ``SystemExit`` naming the flag; a
    ``torchrun``-style environment rendezvous (world size 1, gloo for the
    CPU) runs the step through the data group's collectives, and a second
    call leaves the group as it is."""
    import socket
    import torch.distributed as dist
    from interactive_spectrogram_inpainting_tpu_torch.parallel.distributed \
        import initialize_multihost
    for flag, name in ((["--num_devices_model", "2"], "--num_devices_model"),
                       (["--num_devices_data", "4"], "--num_devices_data")):
        with pytest.raises(SystemExit, match=name):
            train_prior.main(args(store, tmp_path, "top", "--dry_run",
                                  *flag))
    plain = train_prior.main(args(store, tmp_path, "top", "--dry_run",
                                  "--num_devices_data", "1",
                                  "--num_devices_model", "1"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in (("WORLD_SIZE", "1"), ("RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(key, value)
    assert not dist.is_initialized()
    try:
        assert initialize_multihost(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert initialize_multihost(device="cpu")  # left as it is
        grouped = train_prior.main(args(store, tmp_path, "top", "--dry_run",
                                        "--num_devices_data", "1"))
    finally:
        dist.destroy_process_group()
    # a sum over one rank is the identity: the same step, bit for bit
    for k, v in plain.state_dict().items():
        assert torch.equal(v, grouped.state_dict()[k]), k


def test_checkpointer_rolls_and_keeps_the_best(tmp_path):
    ckpt = Checkpointer(tmp_path, save_frequency=1)
    losses = [3.0, 2.0, 2.5, 1.0, 1.5]
    for epoch, loss in enumerate(losses):
        state = {"model": {"w": torch.full((2,), float(epoch))}, "step": epoch}
        assert ckpt.save(epoch, state, loss) == (loss == min(losses[:epoch + 1]))
    assert sorted(int(p.name) for p in (tmp_path / "checkpoints").iterdir()
                  ) == [2, 3, 4]
    assert ckpt.latest_epoch() == 4
    state, epoch = ckpt.restore()
    assert epoch == 4 and torch.equal(state["model"]["w"], torch.full((2,), 4.))
    state, epoch = ckpt.restore(epoch=2)
    assert state["step"] == 2
    best, best_epoch = ckpt.restore_best()
    assert best_epoch == 3 and best["step"] == 3
    assert json.loads((tmp_path / "best_validation_loss.json").read_text()
                      )["epoch"] == 3
    assert Checkpointer(tmp_path).best_validation_loss == 1.0
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore()
    ckpt.store_command_line_parameters({"a": 1, "f": open})
    assert json.loads((tmp_path / "command_line_parameters.json").read_text()
                      ) == {"a": 1}


def test_metrics_writer_appends_jsonl(tmp_path):
    writer = MetricsWriter(tmp_path / "tb")
    writer.scalars("top/training", {"loss": torch.tensor(1.5),
                                    "accuracy": np.float32(0.25)}, 3)
    writer.close()
    (line,) = (tmp_path / "tb" / "metrics.jsonl").read_text().splitlines()
    record = json.loads(line)
    assert record["step"] == 3 and record["top/training/loss"] == 1.5
    off = MetricsWriter(tmp_path / "off", enabled=False)
    off.scalars("x", {"y": 1.0}, 0)
    off.close()
    assert not (tmp_path / "off").exists()


def test_step_watchdog_aborts_a_stalled_run():
    fired = threading.Event()
    dog = StepWatchdog(timeout_s=0.05, poll_s=0.01, abort=fired.set)
    assert fired.wait(timeout=5.0)
    dog.stop()
    calm = threading.Event()
    with StepWatchdog(timeout_s=5.0, poll_s=0.01, abort=calm.set) as dog:
        for _ in range(5):
            dog.pet()
    assert not calm.is_set()
    assert maybe_watchdog(0) is None
