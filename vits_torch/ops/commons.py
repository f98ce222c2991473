"""Mask / path / slicing primitives (port of ``vits_tpu/ops/commons.py``).

Layout as in the JAX package: sequence tensors ``[B, T, C]``, masks
``[B, T]`` or ``[B, T, 1]``, paths ``[B, T_y, T_x]``.

``jax.lax.dynamic_slice`` counts a negative start from the end once and then
clamps the start so the slice stays in bounds; torch indexing does neither.
``slice_segments`` and ``crop_scope`` place their windows the same way
(``dynamic_start``), so an out-of-range offset gives the same window in both
packages.
"""

from __future__ import annotations

import torch


def sequence_mask(length: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask [B, T] with True where t < length[b]."""
    x = torch.arange(max_length, dtype=length.dtype, device=length.device)
    return x[None, :] < length[:, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hard monotonic path from integer durations.

    duration: [B, T_x]; mask: [B, T_y, T_x] -> path [B, T_y, T_x] in
    mask's dtype. Frame t goes to phoneme x iff cum[x-1] <= t < cum[x].
    """
    _, t_y, _ = mask.shape
    cum_duration = torch.cumsum(duration, dim=-1)
    frames = torch.arange(t_y, dtype=cum_duration.dtype, device=duration.device)
    path = frames[None, :, None] < cum_duration[:, None, :]
    path_prev = torch.nn.functional.pad(path[..., :-1], (1, 0))
    path = path & ~path_prev
    return path.to(mask.dtype) * mask


def dynamic_start(start, size: int, total: int):
    """The start ``jax.lax.dynamic_slice`` uses: a negative start counts from
    the end once, then the start is clamped into [0, total - size]. Takes a
    python int or an integer tensor."""
    if isinstance(start, torch.Tensor):
        start = torch.where(start < 0, start + total, start)
        return start.clamp(0, total - size)
    start = start + total if start < 0 else start
    return min(max(start, 0), total - size)


def _window_index(starts: torch.Tensor, size: int, total: int) -> torch.Tensor:
    """[B] starts -> [B, size] indices of each sample's window."""
    starts = dynamic_start(starts.to(torch.long), size, total)
    return starts[:, None] + torch.arange(size, device=starts.device)[None, :]


def slice_segments(
    x: torch.Tensor, ids_str: torch.Tensor, segment_size: int
) -> torch.Tensor:
    """Per-sample time slices. x: [B, T, C]; ids_str: [B] -> [B, seg, C]."""
    idx = _window_index(ids_str, segment_size, x.shape[1])
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def rand_slice_segments(
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    segment_size: int,
    u: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Random slices, one offset a row at ``u * (length - segment_size + 1)``
    (VITS's ``commons.rand_slice_segments``). x: [B, T, C]; x_lengths: [B];
    u: [B] uniform draws in [0, 1). Returns (slices [B, seg, C], ids [B]
    int32)."""
    ids_str_max = (x_lengths - segment_size + 1).to(torch.float32)
    ids_str = (u.to(torch.float32) * ids_str_max).to(torch.int32)
    ids_str = torch.clamp(ids_str, min=0)
    return slice_segments(x, ids_str, segment_size), ids_str


def rand_slice_segments_for_cat(
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    segment_size: int,
    u: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Random slices with ONE offset per half-batch, duplicated.

    x: [2B, T, C]; x_lengths: [2B]; u: [B] uniform draws in [0, 1) (the
    JAX version draws them from its key; here they are passed in). Returns
    (slices [2B, seg, C], ids [2B] int32).
    """
    return rand_slice_segments(x, x_lengths, segment_size, torch.cat([u, u], dim=0))


def intersperse_with_language_id(text, lang, item):
    """Blank-interleave a symbol-id list with per-char language ids (lists
    or numpy). Blanks take the language id of the next character; the
    final blank repeats the last one."""
    n = len(text)
    out_text = [item] * (2 * n + 1)
    out_lang = [None] * (2 * n + 1)
    out_text[1::2] = text
    out_lang[1::2] = lang
    out_lang[::2] = list(lang) + [lang[-1]]
    return out_text, out_lang


def subsequent_mask(length: int) -> torch.Tensor:
    """Lower-triangular causal mask [1, 1, T, T]."""
    return torch.tril(torch.ones(length, length))[None, None]


def crop_scope(
    x: torch.Tensor, yin_start: int, yin_scope: int, scope_shift: torch.Tensor
) -> torch.Tensor:
    """Per-sample channel-window crop.

    x: [B, T, C]; scope_shift: [B] int (may be negative) ->
    [B, T, yin_scope] = x[b, :, yin_start + shift[b] : + yin_scope].
    """
    idx = _window_index(yin_start + scope_shift, yin_scope, x.shape[2])
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))
