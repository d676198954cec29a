"""Shows that the two-rank checks of ``chip_smoke.py``'s ``phase_parallel``
catch a broken collective.

Builds the kernels and the flagship-width state as ``chip_smoke.py`` does,
writes its training store and notes, then runs the phase's two gloo ranks
on the one card three times, each against the same one-process steps and
tokens, with the phase's own comparison (``chip_smoke.compare_ranks``):

- sound: every run agrees;
- ``copy_backward``: ``copy_to_model``'s backward all-reduce dropped, so a
  model rank's input gradient holds its own heads' share only: the prior
  at model 2 must be flagged;
- ``gradient_mean``: the trainers' gradient mean over the data group
  skipped, so a rank steps on its own rows' gradient: the prior and the
  VQ-VAE at data 2 must be flagged.

The faults are patched into the two ranks' processes at run time; no file
changes. Prints one JSON line a run and exits 1 unless each run is flagged
exactly where it must be. On a card (~4 min): ``python3 parallel_faults.py``.
"""

import functools
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# the runs each fault must make disagree with one process
FLAGGED = {None: set(),
           "copy_backward": {"prior model 2"},
           "gradient_mean": {"prior data 2", "vqvae data 2"}}


def faulty_rank(rank, workdir, fault):
    """``chip_smoke.parallel_rank`` with ``fault`` patched in."""
    from interactive_spectrogram_inpainting_tpu_torch.parallel import (
        collectives)
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        train_prior, train_vqvae)
    if fault == "copy_backward":
        collectives._CopyToModel.backward = staticmethod(
            lambda ctx, grad: (grad, None))
    elif fault == "gradient_mean":
        train_prior.mean_of_gradients = lambda params, group: None
        train_vqvae.mean_of_gradients = lambda params, group: None
    cs.parallel_rank(rank, workdir)


def main():
    torch = cs.setup()
    from interactive_spectrogram_inpainting_tpu_torch.utils.device import (
        set_float32_precision)
    set_float32_precision()
    cs.phase_build()  # prints the card's name and power limit first
    state = cs.full_priors(torch, cs.DEVICE)
    wrong = []
    with tempfile.TemporaryDirectory() as workdir:
        store = os.path.join(workdir, "codes")
        data = os.path.join(workdir, "nsynth")
        cs.write_train_store(torch, state, store)
        cs.write_nsynth_split(torch, data, state.fs_hz)
        sampling = cs.parallel_payload(torch, state, workdir)
        one = cs.parallel_runs(torch, store, data, sampling,
                               lambda name: None)
        torch.cuda.empty_cache()  # the two ranks share the card
        for fault, must in FLAGGED.items():
            ranks, spawn_s = cs.spawn_ranks(
                torch, workdir, functools.partial(faulty_rank, fault=fault))
            report = cs.compare_ranks(torch, ranks, one, sampling)
            flagged = {name for name, entry in report.items()
                       if not entry["ok"]}
            cs.log(json.dumps({"fault": fault, "spawn_s": spawn_s,
                               "flagged": sorted(flagged),
                               "must_flag": sorted(must),
                               "report": report}, default=float))
            if flagged != must:
                wrong.append(fault)
    if wrong:
        cs.fail(f"the two-rank checks flagged the wrong runs under {wrong}")
    cs.log("every planted fault was caught and the sound run passed")


if __name__ == "__main__":
    main()
