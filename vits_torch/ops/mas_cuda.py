"""Wrappers of the MAS CUDA kernels (``vits_torch/csrc/mas.cu``).

``mas_fused`` and ``mas_wide`` each replace both ``_forward_kernel`` and
``_backtrack_kernel`` of ``vits_tpu/ops/mas_pallas.py`` in one launch, and
their plain PyTorch version is ``maximum_path_torch`` in
``vits_torch/ops/mas.py``. ``maximum_path`` runs one of them on the card, as
``route`` names by shape: ``mas_fused`` (decisions in shared memory) where it
fits, which includes every shape of ``configs/config_cje.yaml``, and
``mas_wide`` (decisions in device memory, any shape) everywhere else.
``mas_forward`` and ``mas_backtrack`` are the first port, one kernel per
Pallas kernel (plain versions ``mas_decisions`` and ``mas_backtrack``); no
path of the model runs them, and they stay as the fused kernel's yardstick.

Each wrapper checks what the kernel takes, allocates its output with
``torch.empty``, launches on the current stream without synchronising, raises
if the launch was refused, and adds one to its launch count (``launches``).
The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vits_torch import _build

# kernel launches since import or the caller's last reset to 0
launches = {"mas_fused": 0, "mas_forward": 0, "mas_backtrack": 0, "mas_wide": 0}

_MAX_SHARED = 48 * 1024  # dynamic shared memory a block may take by default
_MAX_SHARED_OPT_IN = 232448  # 227 KB, the most a block may take after opting in
_FUSED_MAX_COLS = 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mas")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_max_cols.argtypes = []
    lib.mas_max_cols.restype = i
    lib.mas_forward.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.mas_forward.restype = i
    lib.mas_backtrack.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.mas_backtrack.restype = i
    lib.mas_fused_smem_bytes.argtypes = [i, i]
    lib.mas_fused_smem_bytes.restype = ctypes.c_longlong
    lib.mas_fused.argtypes = [p, p, p, i, i, i, p]
    lib.mas_fused.restype = i
    lib.mas_wide.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.mas_wide.restype = i
    return lib


def _check_layout(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    _check_device(t, name)
    _check_layout(t, name, dtype, ndim)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lengths(t_ys, t_xs, b):
    _check(t_ys, "t_ys", torch.int32, 1)
    _check(t_xs, "t_xs", torch.int32, 1)
    if t_ys.shape[0] != b or t_xs.shape[0] != b:
        raise ValueError("t_ys and t_xs must have one length per batch item")


def mas_forward(
    neg_cent: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor
) -> torch.Tensor:
    """Forward DP. neg_cent: [B, T_y, T_x] f32; t_ys, t_xs: [B] int32 ->
    decisions [B, T_y, T_x] uint8, defined for y < t_y, x < t_x."""
    _check(neg_cent, "neg_cent", torch.float32, 3)
    b, t_y, t_x = neg_cent.shape
    _lengths(t_ys, t_xs, b)
    lib = _lib()
    threads = min(1024, max(32, -(-t_x // 32) * 32))
    if t_x > lib.mas_max_cols() * threads or 2 * t_x * 4 > _MAX_SHARED:
        raise ValueError(f"mas_forward: T_x={t_x} is wider than the kernel takes")
    dec = torch.empty((b, t_y, t_x), dtype=torch.uint8, device=neg_cent.device)
    if b == 0:
        return dec
    with torch.cuda.device(neg_cent.device):
        err = lib.mas_forward(
            neg_cent.data_ptr(), dec.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(),
            b, t_y, t_x, threads, _stream(neg_cent),
        )
    if err != 0:
        raise RuntimeError(f"mas_forward launch failed: cudaError {err}")
    launches["mas_forward"] += 1
    return dec


def mas_backtrack(
    dec: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor
) -> torch.Tensor:
    """Backtrack. dec: [B, T_y, T_x] uint8; t_ys, t_xs: [B] int32 -> path
    [B, T_y, T_x] f32 (0/1, zero outside the walk)."""
    _check(dec, "dec", torch.uint8, 3)
    b, t_y, t_x = dec.shape
    _lengths(t_ys, t_xs, b)
    if t_y * 4 > _MAX_SHARED:
        raise ValueError(f"mas_backtrack: T_y={t_y} is longer than the kernel takes")
    lib = _lib()
    path = torch.empty((b, t_y, t_x), dtype=torch.float32, device=dec.device)
    if b == 0:
        return path
    with torch.cuda.device(dec.device):
        err = lib.mas_backtrack(
            dec.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), path.data_ptr(),
            b, t_y, t_x, 256, _stream(dec),
        )
    if err != 0:
        raise RuntimeError(f"mas_backtrack launch failed: cudaError {err}")
    launches["mas_backtrack"] += 1
    return path


def fused_plan(t_y: int, t_x: int) -> tuple[int, int]:
    """(K, shared bytes) of ``mas_fused_kernel`` at [T_y, T_x], 1 <= T_x <=
    1024, as ``mas.cu`` computes them: K columns a lane, the smallest odd K
    with 32 K >= T_x, or 32; the bytes are a 64-byte header, 4 stages of
    R = min(16, 24 KB / row bytes) rows of scores and a spare row (each
    rounded up to 16 bytes) with 288 bytes of slack, and T_y rows of 32
    decision fields of 1, 2 or 4 bytes."""
    need = -(-t_x // 32)
    k = 32 if need == 32 else need | 1
    field = 1 if k <= 8 else 2 if k <= 16 else 4
    rows = min(16, max(1, 24 * 1024 // (4 * t_x)))
    stage = (rows * t_x * 4 + 15) // 16 * 16 + (t_x * 4 + 15) // 16 * 16 + 288
    return k, 64 + 4 * stage + t_y * 32 * field


def mas_fused(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS in one launch. neg_cent: [B, T_y, T_x] f32 CUDA, T_x <= 1024;
    mask: the same shape, the 0/1 rectangle of each item's lengths, as the
    product of two sequence masks gives it (the kernel counts the lengths in
    its first column and row). Returns the hard path [B, T_y, T_x] f32, equal
    to ``maximum_path_torch(neg_cent, mask)``."""
    _check_layout(neg_cent, "neg_cent", torch.float32, 3)
    _check_layout(mask, "mask", torch.float32, 3)
    if mask.shape != neg_cent.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must have neg_cent's shape {tuple(neg_cent.shape)}")
    b, t_y, t_x = neg_cent.shape
    if t_x > _FUSED_MAX_COLS:
        raise ValueError(f"mas_fused: T_x={t_x} is wider than the kernel takes ({_FUSED_MAX_COLS})")
    smem = fused_plan(t_y, t_x)[1] if t_x > 0 else 0
    if smem > _MAX_SHARED_OPT_IN:
        raise ValueError(
            f"mas_fused: T_y={t_y}, T_x={t_x} needs {smem} bytes of shared memory, "
            f"more than a block takes ({_MAX_SHARED_OPT_IN})"
        )
    _check_device(neg_cent, "neg_cent")
    _check_device(mask, "mask")
    if mask.device != neg_cent.device:
        raise ValueError("neg_cent and mask must be on one device")
    if neg_cent.data_ptr() % 16:
        raise ValueError("neg_cent must start on a 16-byte boundary (the kernel's bulk copies)")
    path = torch.empty((b, t_y, t_x), dtype=torch.float32, device=neg_cent.device)
    if path.numel() == 0:
        return path
    lib = _lib()
    with torch.cuda.device(neg_cent.device):
        err = lib.mas_fused(
            neg_cent.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_y, t_x,
            _stream(neg_cent),
        )
    if err != 0:
        raise RuntimeError(f"mas_fused launch failed: cudaError {err}")
    launches["mas_fused"] += 1
    return path


def route(t_y: int, t_x: int) -> str:
    """The kernel ``maximum_path`` launches at [T_y, T_x]: ``"fused"`` where
    ``mas_fused`` takes the shape (T_x <= 1024 and its shared memory within a
    block's 232,448 bytes), ``"wide"`` everywhere else."""
    if t_x <= _FUSED_MAX_COLS and (t_x <= 0 or fused_plan(t_y, t_x)[1] <= _MAX_SHARED_OPT_IN):
        return "fused"
    return "wide"


def mas_wide(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS in one launch at any shape, the decisions in device memory.
    neg_cent: [B, T_y, T_x] f32 CUDA; mask: the same shape, the 0/1 rectangle
    of each item's lengths (the kernel counts them in its first column and
    row). Returns the hard path [B, T_y, T_x] f32, equal to
    ``maximum_path_torch(neg_cent, mask)``. Allocates the decisions, bit-packed
    ([B, T_y, ceil(T_x / 32)] uint32), and the stripes' edge columns ([2, B,
    T_y] f32) as scratch."""
    _check_layout(neg_cent, "neg_cent", torch.float32, 3)
    _check_layout(mask, "mask", torch.float32, 3)
    if mask.shape != neg_cent.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must have neg_cent's shape {tuple(neg_cent.shape)}")
    _check_device(neg_cent, "neg_cent")
    _check_device(mask, "mask")
    if mask.device != neg_cent.device:
        raise ValueError("neg_cent and mask must be on one device")
    b, t_y, t_x = neg_cent.shape
    path = torch.empty((b, t_y, t_x), dtype=torch.float32, device=neg_cent.device)
    if path.numel() == 0:
        return path
    dev = neg_cent.device
    dec = torch.empty((b, t_y, -(-t_x // 32)), dtype=torch.uint32, device=dev)
    edge = torch.empty((2, b, t_y), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.mas_wide(
            neg_cent.data_ptr(), mask.data_ptr(), path.data_ptr(), dec.data_ptr(),
            edge.data_ptr(), b, t_y, t_x, _stream(neg_cent),
        )
    if err != 0:
        raise RuntimeError(f"mas_wide launch failed: cudaError {err}")
    launches["mas_wide"] += 1
    return path
