"""ctypes binding for the host MAS in C++ (``csrc/mas_host.cpp``; port of
``vits_tpu/ops/mas_native.py``).

Compiled at first use with ``g++ -O3 -fopenmp -shared -fPIC`` into
``vits_torch/_build/``, named by a hash of the source and the flags (as
``_build.py`` names the CUDA libraries), so an edited source is rebuilt.
Nothing is built at import. This is the host-side counterpart of the CUDA
kernel, for CPU debugging and as an independent oracle; nothing on the
training or serving path calls it (the reference's equivalent is the Cython
module monotonic_align/core.pyx).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from vits_torch._build import BUILD_DIR, CSRC_DIR

SRC = CSRC_DIR / "mas_host.cpp"
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_lib = None


def library_path():
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmas_host-{digest.hexdigest()[:16]}.so"


def _compile():
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name} (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_compile()))
    lib.mas_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mas_batch.restype = None
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def maximum_path_native(neg_cent: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Host MAS. neg_cent/mask: [B, T_y, T_x] -> int32 path (masked)."""
    lib = _load()
    neg = np.ascontiguousarray(
        np.where(mask > 0, neg_cent, -1e9), dtype=np.float32
    )
    b, t_y, t_x = neg.shape
    paths = np.zeros((b, t_y, t_x), dtype=np.int32)
    t_ys = np.ascontiguousarray(mask[:, :, 0].sum(axis=1), dtype=np.int32)
    t_xs = np.ascontiguousarray(mask[:, 0, :].sum(axis=1), dtype=np.int32)
    lib.mas_batch(
        neg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b, t_y, t_x,
    )
    return paths * mask.astype(np.int32)
