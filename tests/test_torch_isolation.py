"""The port stands alone: vits_torch and chip_smoke.py import neither JAX nor
the JAX package, and the default device of the entry points is the card."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vits_torch.config import load_hparams
from vits_torch.models.synthesizer import SynthesizerTrn, build_synthesizer
from vits_torch.text.symbols import symbols

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vits_tpu")


def _port_sources():
    return sorted((ROOT / "vits_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "bench_torch.py",
        ROOT / "bench_train_torch.py",
        ROOT / "bench_matrix_torch.py",
        ROOT / "tools" / "profile_torch_slice.py",
        ROOT / "tools" / "probe_mas_fused.py",
        ROOT / "tools" / "probe_step_grads.py",
        ROOT / "tools" / "probe_serve_threads.py",
        ROOT / "tools" / "convergence_torch.py",
        ROOT / "tools" / "bf16_bisect.py",
        ROOT / "tools" / "test_walls.py",
        ROOT / "tools" / "time_phases.py",
        ROOT / "tests" / "_torch_ranks.py",
        ROOT / "tests" / "test_torch_mb_istft.py",
        ROOT / "tests" / "test_torch_mb_istft_train.py",
        ROOT / "examples" / "quickstart_synthetic_torch.py",
        ROOT / "examples" / "serve_batched_torch.py",
    ]


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, vits_torch\n"
        "for m in pkgutil.walk_packages(vits_torch.__path__, 'vits_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_spawned_ranks_load_no_jax():
    """The module the port's multi-process tests' ranks import
    (``tests/_torch_ranks.py``) brings in no JAX, directly or through what it
    imports: a rank starts in the time torch and the port take."""
    code = (
        "import sys\n"
        "import tests._torch_ranks\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_names_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_orbax_converter_stays_outside_the_port():
    """tools/orbax_to_torch.py reads the JAX package's checkpoints (orbax
    imports JAX), so it is no port source and nothing of the port imports
    it; it imports the JAX package only inside its conversion function."""
    tool = ROOT / "tools" / "orbax_to_torch.py"
    assert tool not in _port_sources()
    for path in _port_sources():
        assert "orbax_to_torch" not in path.read_text(), path
    top = [n for n in ast.parse(tool.read_text()).body
           if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [n.module or "" for n in top
                                                      if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid here")
    hps = load_hparams(str(ROOT / "configs" / "config_cje.yaml"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_synthesizer(hps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SynthesizerTrn(**_tiny_kwargs())
    from vits_torch.training.train import main, run

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(hps)
    # the data-parallel entry: cuda:LOCAL_RANK and NCCL unless --device cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["-c", str(ROOT / "configs" / "config_cje.yaml"), "-m", "unused", "--distributed"])
    from vits_torch.parallel.mesh import init_distributed

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()


def test_symbols_copy_keeps_the_reference_inventory():
    assert len(symbols) == 71 and symbols.count("ˌ") == 2


def _tiny_kwargs():
    return dict(
        num_chars=len(symbols), spec_channels=513, segment_size=2048, midi_start=-5,
        midi_end=75, octave_range=24, inter_channels=96, hidden_channels=96,
        filter_channels=128, n_heads=2, n_layers=1, kernel_size=3, p_dropout=0.0,
        resblock="1", resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
        upsample_rates=[8, 8, 2, 2], upsample_initial_channel=64,
        upsample_kernel_sizes=[16, 16, 4, 4], yin_channels=80, yin_start=15,
        yin_scope=50, yin_shift_range=15, n_speakers=3, gin_channels=16,
    )
