"""The port's map stays whole: every module of the JAX package has its
counterpart in ``vits_torch/`` (a file at the same relative path, or an
entry of ``COUNTERPARTS`` naming the port's files or the reason there are
none), every ``vits-tpu-*`` script in ``pyproject.toml`` has a
``vits-torch-*`` script whose target has the same function, and every
top-level script, example and tool of the JAX side (one that imports JAX or
the JAX package) has its port file, or a function of one, or the reason it
needs none in ``TOP_LEVEL``."""

import ast
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
_XLA_TOOL = "none: reads XLA's compiled HLO or a jax.profiler trace; tools/profile_torch_slice.py "
_TABLE_TOOL = ("none: builds or checks a text-frontend table, which the port copies byte for "
               "byte (tests/test_torch_text.py)")
# JAX-side top-level script, example or tool -> the port's file ("file::function"
# where a function of it takes the place), or the reason for none
TOP_LEVEL = {
    "__graft_entry__.py": "vits_torch/graft_entry.py",
    "bench.py": "bench_torch.py",
    "bench_train.py": "bench_train_torch.py",
    "bench_matrix.py": "bench_matrix_torch.py",
    "examples/quickstart_synthetic.py": "examples/quickstart_synthetic_torch.py",
    "examples/serve_batched.py": "examples/serve_batched_torch.py",
    "tools/convergence_v2.py": "tools/convergence_torch.py",
    "tools/hlo_flops.py": "vits_torch/utils/profiling.py::step_flops",
    "tools/dump_step_hlo.py": _XLA_TOOL + "profiles the port's step",
    "tools/analyze_trace.py": _XLA_TOOL + "sums the port's device time by kernel",
    "tools/attribute_trace.py": _XLA_TOOL + "attributes the port's device time to modules",
    "tools/bench_grouped_conv.py": "none: times XLA's lowerings of grouped convolutions; the "
                                   "port's are cuDNN's",
    "tools/bench_posterior_fusion.py": "none: an experiment on XLA's fusion of the two posterior "
                                       "encoders; the port runs them as written",
    "tools/bf16_fusion_map.py": "none: reads the JAX modules' HLO for the port's "
                                "tools/bf16_bisect.py, a tool of the port's own",
    "tools/orbax_to_torch.py": "none: carries the JAX package's Orbax checkpoints into the "
                               "port, a tool of the port's own",
    "tools/derive_pinyin_tail.py": _TABLE_TOOL,
    "tools/en_coverage.py": _TABLE_TOOL,
    "tools/en_lts_accuracy.py": _TABLE_TOOL,
    "tools/merge_en_chunk.py": _TABLE_TOOL,
    "tools/validate_en_dict.py": _TABLE_TOOL,
}


def _imports_jax(path: Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if any(n.split(".")[0] in ("jax", "vits_tpu") for n in names):
            return True
    return False


JAX_SIDE = sorted(
    str(p.relative_to(ROOT))
    for p in [*ROOT.glob("*.py"), *ROOT.glob("examples/*.py"), *ROOT.glob("tools/*.py")]
    if _imports_jax(p)
)


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


@pytest.mark.parametrize("script", JAX_SIDE)
def test_jax_side_script_has_a_counterpart(script):
    assert script in TOP_LEVEL, f"{script}: no entry in TOP_LEVEL"


@pytest.mark.parametrize("script", sorted(TOP_LEVEL))
def test_top_level_entry_names_a_port_file(script):
    assert (ROOT / script).is_file()
    entry = TOP_LEVEL[script]
    if entry.startswith("none: "):
        assert len(entry) > len("none: ")
        return
    path, _, func = entry.partition("::")
    assert (ROOT / path).is_file(), f"{script}: {path} is missing"
    assert not _imports_jax(ROOT / path), path
    if func:
        tree = ast.parse((ROOT / path).read_text())
        assert func in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}, entry
