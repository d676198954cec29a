"""Multi-process start-up and failure detection of the trainers.

Port of ``interactive_spectrogram_inpainting_tpu/parallel/distributed.py``:
``initialize_multihost`` runs the ``torch.distributed`` rendezvous of a
launch of several processes (one per device, as ``torchrun`` starts them;
the JAX package's ``jax.distributed.initialize``), and the step watchdog
aborts a run whose training steps stall so that a scheduler can restart it
from its last checkpoint.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist


def initialize_multihost(backend: Optional[str] = None,
                         init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         device: Optional[str] = None) -> bool:
    """Join the process group of this launch; returns whether one is up.

    The arguments default to ``torchrun``'s environment: ``WORLD_SIZE``,
    ``RANK`` and the ``env://`` rendezvous at ``MASTER_ADDR`` /
    ``MASTER_PORT``. One process with none of them given does nothing, and
    a process group the caller has already initialized is left as it is.
    The backend follows the device: ``nccl`` for CUDA (the default
    device), ``gloo`` for ``device='cpu'``. With ``LOCAL_RANK`` set, the
    current CUDA device becomes that one."""
    if dist.is_initialized():
        return True
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if (world_size is None and init_method is None and env_world <= 1
            and "MASTER_ADDR" not in os.environ):
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    local_rank = os.environ.get("LOCAL_RANK")
    if local_rank is not None and not on_cpu and torch.cuda.is_available():
        torch.cuda.set_device(int(local_rank))
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=env_world if world_size is None else int(world_size),
        rank=(int(os.environ.get("RANK", "0")) if rank is None
              else int(rank)))
    return True


class StepWatchdog:
    """Calls ``abort`` (by default ``os._exit(42)``) if no training step
    completes within ``timeout_s``.

    Usage::

        watchdog = StepWatchdog(timeout_s=600)
        for batch in loader:
            ... run step ...
            watchdog.pet()
    """

    def __init__(self, timeout_s: float = 600.0, poll_s: float = 10.0,
                 abort: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self._abort = abort if abort is not None else (lambda: os._exit(42))
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def pet(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2 * self.poll_s)

    def __enter__(self) -> "StepWatchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            stalled = time.monotonic() - self._last
            if stalled > self.timeout_s:
                print(f"StepWatchdog: no step for {stalled:.0f}s "
                      f"(> {self.timeout_s:.0f}s); aborting for restart",
                      file=sys.stderr, flush=True)
                self._abort()
                return


def maybe_watchdog(timeout_s: float) -> Optional[StepWatchdog]:
    """CLI adapter for ``--watchdog_timeout_s`` (0 or negative = off)."""
    if timeout_s and timeout_s > 0:
        return StepWatchdog(timeout_s=timeout_s,
                            poll_s=min(10.0, timeout_s / 4))
    return None
