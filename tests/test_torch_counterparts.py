"""The port's map stays whole: every module of the JAX package has its
counterpart in ``vits_torch/`` (a file at the same relative path, or an
entry of ``COUNTERPARTS`` naming the port's files or the reason there are
none), and every ``vits-tpu-*`` script in ``pyproject.toml`` has a
``vits-torch-*`` script whose target has the same function."""

import importlib
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_MODULES = sorted(str(p.relative_to(ROOT / "vits_tpu")) for p in (ROOT / "vits_tpu").rglob("*.py"))
# JAX module -> the port's files in its place, or the reason for none
COUNTERPARTS = {
    "ops/mas_pallas.py": ["csrc/mas.cu", "ops/mas_cuda.py"],
    "utils/convert_torch.py": ["utils/convert_reference.py", "utils/convert_jax.py"],
    "utils/compilation_cache.py": "none: XLA's compilation cache; PyTorch eager compiles nothing",
}
SCRIPTS = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]


@pytest.mark.parametrize("module", JAX_MODULES)
def test_jax_module_has_a_counterpart(module):
    entry = COUNTERPARTS.get(module)
    if entry is None:
        assert (ROOT / "vits_torch" / module).is_file(), f"{module}: no counterpart in vits_torch/"
    elif isinstance(entry, str):
        assert entry.startswith("none: ") and len(entry) > len("none: "), module
    else:
        for port in entry:
            assert (ROOT / "vits_torch" / port).is_file(), f"{module}: {port} is missing"


@pytest.mark.parametrize("module", sorted(COUNTERPARTS))
def test_table_entries_are_needed(module):
    """An entry names a JAX module the port has no same-path file for."""
    assert (ROOT / "vits_tpu" / module).is_file()
    assert not (ROOT / "vits_torch" / module).exists()


@pytest.mark.parametrize("script", sorted(s for s in SCRIPTS if s.startswith("vits-tpu-")))
def test_script_has_a_port_script(script):
    port = script.replace("vits-tpu-", "vits-torch-", 1)
    assert port in SCRIPTS, f"{script}: no {port} in pyproject.toml"
    jax_func = SCRIPTS[script].split(":")[1]
    module, func = SCRIPTS[port].split(":")
    assert module.startswith("vits_torch.") and func == jax_func
    assert callable(getattr(importlib.import_module(module), func))
