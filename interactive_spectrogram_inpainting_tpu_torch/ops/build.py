"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds. Libraries are built at
first use into ``build/torch_kernels/`` beside the package (override with
``ISI_TORCH_KERNEL_DIR``), named by a hash of their sources, so an edited
source is rebuilt and an unchanged one is reused. ``build()`` starts one
``nvcc`` per source, all at once. ``hashed_library``, ``start_compile`` and
``finish_compile`` also build the codemap store's C++ reader
(``data/native.py``).

Set ``ISI_PTXAS_VERBOSE=1`` to print each kernel's registers, shared memory
and spills (``-Xptxas -v``); ``build(ptxas=names)`` asks it for the named
sources alone and keeps their reports in ``PTXAS_LOGS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode_scan", "prefix_prime", "decode_step",
           "decode_step_batched", "decode_attention", "vq_lookup",
           "train_attention", "spectral_loss")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOGS: Dict[str, str] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("ISI_TORCH_KERNEL_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build" / "torch_kernels"


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def hashed_library(directory: pathlib.Path, name: str,
                   inputs: Sequence[pathlib.Path],
                   flags: Sequence[str]) -> pathlib.Path:
    """``directory/lib<name>-<hash>.so``, the hash taken over the inputs'
    bytes and the compiler flags: an edited source names a new library."""
    digest = hashlib.sha256()
    for src in inputs:
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    return directory / f"lib{name}-{digest.hexdigest()[:16]}.so"


def start_compile(cmd: Sequence[str], target: pathlib.Path
                  ) -> Tuple[subprocess.Popen, pathlib.Path]:
    """Start ``cmd -o <temporary file beside target>``; ``finish_compile``
    moves the file into place. Processes that build the same library at
    once each write their own temporary file, and ``os.replace`` is
    atomic, so none loads a half-written library."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp


def finish_compile(proc: subprocess.Popen, tmp: pathlib.Path,
                   target: pathlib.Path) -> Tuple[bool, str]:
    """Wait for a ``start_compile``; on success move its output to
    ``target``. -> (succeeded, the compiler's output)."""
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False, log
    os.replace(tmp, target)
    return True, log


def _library_path(name: str) -> pathlib.Path:
    return hashed_library(
        build_dir(), name, sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"],
        ARCH_FLAGS)


def build(names: Optional[Iterable[str]] = None,
          ptxas: Iterable[str] = ()) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    in parallel; those in ``ptxas`` with ``-Xptxas -v``, their report kept
    in ``PTXAS_LOGS``. Returns the wall seconds each build took (0.0 when
    the library was already there); raises with nvcc's output on
    failure."""
    names = list(names or SOURCES)
    ptxas = set(ptxas)
    verbose = os.environ.get("ISI_PTXAS_VERBOSE") == "1"
    procs = {}
    seconds = {}
    for name in names:
        target = _library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-lineinfo", "-I", str(CSRC),
               str(CSRC / f"{name}.cu")]
        if verbose or name in ptxas:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (*start_compile(cmd, target), target,
                       time.perf_counter())
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        ok, log = finish_compile(proc, tmp, target)
        seconds[name] = time.perf_counter() - t0
        if not ok:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log)
        if name in ptxas:
            PTXAS_LOGS[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_library_path(name)))
    return _LIBS[name]
