"""Wrappers of the MAS CUDA kernels (``vits_torch/csrc/mas.cu``).

``mas_fused`` and ``mas_wide`` each replace both ``_forward_kernel`` and
``_backtrack_kernel`` of ``vits_tpu/ops/mas_pallas.py`` in one launch, and
their plain PyTorch version is ``maximum_path_torch`` in
``vits_torch/ops/mas.py``. ``maximum_path`` runs one of them on the card, as
``route`` names by shape: ``mas_fused`` (decisions in shared memory) where it
fits, which includes every shape of ``configs/config_cje.yaml``, and
``mas_wide`` (an item's columns over a cluster of blocks, decisions in
device memory, any shape) everywhere else.

Each wrapper checks what the kernel takes, allocates its output with
``torch.empty``, launches on the current stream without synchronising, raises
if the launch was refused, and adds one to its launch count (``launches``).
The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vits_torch import _build

# kernel launches since import or the caller's last reset to 0
launches = {"mas_fused": 0, "mas_wide": 0}

_MAX_SHARED_OPT_IN = 232448  # 227 KB, the most a block may take after opting in
_FUSED_MAX_COLS = 1024
_MAX_CLUSTER = 8  # the portable thread-block cluster size
_H100_SMS = 132


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mas")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_fused_smem_bytes.argtypes = [i, i]
    lib.mas_fused_smem_bytes.restype = ctypes.c_longlong
    lib.mas_fused.argtypes = [p, p, p, i, i, i, p]
    lib.mas_fused.restype = i
    lib.mas_wide.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.mas_wide.restype = i
    lib.mas_wide_plan.argtypes = [i, i, i, i, p]
    lib.mas_wide_plan.restype = i
    lib.mas_wide_active_clusters.argtypes = [i, i, i]
    lib.mas_wide_active_clusters.restype = i
    return lib


def _check_layout(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


class WidePlan(NamedTuple):
    """How ``mas_wide_kernel`` lays out one launch (``mas.cu::wide_plan``)."""

    cluster: int  # C: blocks an item, one cluster
    warps: int  # W: DP warps a block
    k: int  # K: columns a lane, x0 + 32 c + lane for c < K
    group: int  # G: rows one handover between warps carries
    stage_rows: int  # R: rows of scores a stage of the copy ring holds
    stages: int  # S: stages of the copy ring
    depth: int  # D: groups a handover ring holds
    smem: int  # dynamic shared-memory bytes a block

    @property
    def block_cols(self) -> int:
        return self.warps * 32 * self.k

    @property
    def stripe_cols(self) -> int:
        return self.cluster * self.block_cols


# mas.cu's kWide* constants
_WIDE_LANE_COLS, _WIDE_GROUP, _WIDE_DEPTH, _WIDE_STAGE_ROWS, _WIDE_MAX_STAGES = 2, 16, 4, 16, 8
_WIDE_RING_BUDGET, _WIDE_MAX_WARPS, _WIDE_PLAN_WARPS, _WIDE_FILL_WARPS = 160 * 1024, 8, 4, 1
# WideShared (the handover rings, their mbarriers, the stages' mbarriers, the
# length counts of every warp), rounded up to 1024 bytes. This plan is mas.cu's
# written out again for the CPU model of the kernel and the tests; the card
# test test_wide_plan_is_the_kernels holds the two equal.
_WIDE_HEADER = -(-(_WIDE_MAX_WARPS * _WIDE_DEPTH * (4 * _WIDE_GROUP + 16) + 16 * _WIDE_MAX_STAGES
                   + 8 * (_WIDE_MAX_WARPS + 1 + _WIDE_FILL_WARPS) + 7) // 8 * 8 // 1024) * 1024


def wide_plan(b: int, t_y: int, t_x: int, sms: int = _H100_SMS) -> WidePlan:
    """``mas_wide_kernel``'s plan at [B, T_y, T_x] (each >= 1) on a card of
    ``sms`` SMs, as ``mas.cu`` computes it. K = 2 columns a lane; C blocks
    an item, as many as hold 4 DP warps each, at most 8
    and at most sms // B; W DP warps a block, up to 8, as many as the row
    needs over C blocks; then C again, so that no block lies wholly past T_x
    (rows wider than C W 32 K columns run as stripes); G = 16 rows a
    handover, D = 4 of them in a ring; S stages of R = 16 rows, 2 to 8,
    within 160 KB and no more than the T_y - 1 row steps need. The shared
    memory is a header (``_WIDE_HEADER``) and the stages, each row of them
    the block's columns and 16 bytes for the aligned superset the copy
    takes."""
    k = _WIDE_LANE_COLS
    need = -(-t_x // (32 * k))  # warps a row needs
    room = max(1, min(_MAX_CLUSTER, sms // b))
    c = min(room, -(-need // _WIDE_PLAN_WARPS))
    warps = min(_WIDE_MAX_WARPS, -(-need // c))
    cluster = min(c, -(-need // warps))
    stage = _WIDE_STAGE_ROWS * (warps * 32 * k * 4 + 16)
    rows = -(-max(t_y - 1, 1) // _WIDE_STAGE_ROWS)
    stages = max(2, min(_WIDE_MAX_STAGES, _WIDE_RING_BUDGET // stage, rows))
    return WidePlan(cluster, warps, k, _WIDE_GROUP, _WIDE_STAGE_ROWS, stages, _WIDE_DEPTH,
                    _WIDE_HEADER + stages * stage)


def wide_dec_words(t_x: int) -> int:
    """Words of a decision row in ``mas_wide``'s scratch: ceil(T_x / 32),
    padded to a multiple of 2 (a warp stores its K = 2 words as one 8-byte
    store)."""
    return (-(-t_x // 32) + 1) // 2 * 2


def mas_wide(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS in one launch at any shape: an item's columns over a cluster of
    blocks (``wide_plan``), the decisions in device memory. neg_cent:
    [B, T_y, T_x] f32 CUDA; mask: the same shape, the 0/1 rectangle of each
    item's lengths (the kernel counts them in its first column and row).
    Returns the hard path [B, T_y, T_x] f32, equal to
    ``maximum_path_torch(neg_cent, mask)``. Allocates the decisions,
    bit-packed ([B, T_y, wide_dec_words(T_x)] uint32), and the stripes' edge
    columns ([2, B, T_y] f32) as scratch."""
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
    dec = torch.empty((b, t_y, wide_dec_words(t_x)), dtype=torch.uint32, device=dev)
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
