"""Builds the port's CUDA sources (``vits_torch/csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, which the kernel's wrapper loads with ``ctypes``. The
libraries land in ``vits_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. ``nvcc``'s ptxas report (registers, shared memory,
spills) is kept beside each library as ``<name>-<hash>.log``.

Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc in the CUDA toolkit PyTorch finds ($CUDA_HOME, $PATH)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together. Returns the seconds each compile took (0.0 if reused).
    Raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    compiler = None
    running = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _libraries:
        build([name])
        _libraries[name] = ctypes.CDLL(str(library_path(name)))
    return _libraries[name]
