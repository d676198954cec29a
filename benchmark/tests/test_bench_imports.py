"""What the benchmark imports: nothing under ``benchmark/`` imports JAX or the
JAX package, and the plain reference imports nothing of the program
either. Module names are compared by their top-level name (the part before
the first dot) whole: the program's name begins with the JAX package's."""

import ast

import pytest

from bench_support import BENCH

JAX = {"jax", "jaxlib", "flax", "interactive_spectrogram_inpainting_tpu"}
PROGRAM = "interactive_spectrogram_inpainting_tpu_torch"


def imported_top_levels(path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert not names & (JAX | {PROGRAM})
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}


def test_top_level_names_are_compared_whole():
    import run
    assert run.forbidden_modules([PROGRAM, f"{PROGRAM}.serve"]) == []
    assert run.forbidden_modules(
        ["interactive_spectrogram_inpainting_tpu.ops", "jax.numpy"]) == [
        "interactive_spectrogram_inpainting_tpu", "jax"]


def test_serving_driver_starts_the_server_before_torch():
    """The edit loop's driver imports no torch itself, so its server
    process imports torch while this one does."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); "
            "import drivers.edit_loop; "
            "print('torch' in sys.modules)" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr
