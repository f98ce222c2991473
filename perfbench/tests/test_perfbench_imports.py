"""What the benchmark and its reference import. A module's top-level name
(the part before the first dot) is compared whole: ``vits_torch`` is the
program, ``vits_tpu`` the JAX package it was ported from."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
NEVER = {"jax", "jaxlib", "flax", "optax", "orbax", "vits_tpu"}
NOT_IN_REFERENCE = NEVER | {"vits_torch"}


def imported(path: Path) -> set[str]:
    """Top-level names of every import in a file, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    banned = NOT_IN_REFERENCE if "reference" in path.relative_to(BENCH).parts else NEVER
    assert not imported(path) & banned


def test_names_are_compared_whole():
    assert "vits_torch" not in NEVER and "vits_tpu" in NEVER
    assert "vits_torch".split(".")[0] != "vits_tpu"


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted((BENCH / "reference").rglob("*.py")) if p.name != "__init__.py"]
    loaded = _loaded_after("import sys; sys.modules['jieba'] = None\n"
                           + "\n".join(f"import {m}" for m in mods))
    assert not loaded & NOT_IN_REFERENCE


def test_benchmark_loads_no_jax():
    mods = ["perfbench.harness", "perfbench.checks", "perfbench.traffic", "perfbench.tracing",
            "perfbench.control", "perfbench.sweep", "perfbench.drivers.train_step",
            "perfbench.drivers.serve_open_loop", "perfbench.drivers.synth_closed_loop",
            "vits_torch.training.step", "vits_torch.serve.engine", "vits_torch.serve.batcher"]
    loaded = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert not loaded & NEVER
