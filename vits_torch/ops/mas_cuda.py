"""Wrappers of the MAS CUDA kernels (``vits_torch/csrc/mas.cu``).

``mas_forward`` replaces ``_forward_kernel`` and ``mas_backtrack`` replaces
``_backtrack_kernel`` of ``vits_tpu/ops/mas_pallas.py``. Their plain PyTorch
versions are ``mas_decisions`` and ``mas_backtrack`` in ``vits_torch/ops/mas.py``.

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
launches = {"mas_forward": 0, "mas_backtrack": 0}

_MAX_SHARED = 48 * 1024  # dynamic shared memory a block may take by default


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
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


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


def maximum_path_cuda(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS on the card. neg_cent: [B, T_y, T_x] f32 CUDA; mask: the
    [B, T_y, T_x] rectangle of the per-sample lengths, as the product of two
    sequence masks gives it. Returns the hard path [B, T_y, T_x] f32, equal to
    ``maximum_path_torch(neg_cent, mask)``."""
    t_ys = mask[:, :, 0].sum(dim=1).to(torch.int32).contiguous()
    t_xs = mask[:, 0, :].sum(dim=1).to(torch.int32).contiguous()
    dec = mas_forward(neg_cent.contiguous(), t_ys, t_xs)
    return mas_backtrack(dec, t_ys, t_xs)
