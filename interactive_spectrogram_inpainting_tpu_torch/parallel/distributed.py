"""Multi-process start-up and failure detection of the trainers.

Port of the part of ``interactive_spectrogram_inpainting_tpu/parallel/distributed.py``
that the prior trainer calls: ``initialize_multihost`` (nothing to do for
one process; the ``torch.distributed`` rendezvous of several processes
belongs to the parallel slice, ``ROADMAP.md``) and the step watchdog, which
aborts a run whose training steps stall so that a scheduler can restart it
from its last checkpoint.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional


def initialize_multihost() -> None:
    """One process: nothing to do. A launch of several processes (a
    ``WORLD_SIZE`` above 1, as ``torchrun`` sets it) raises: their
    rendezvous is not ported yet."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "multi-process training is part of the parallel slice of the "
            "port (ROADMAP.md, 'Parallel'); run one process")


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
