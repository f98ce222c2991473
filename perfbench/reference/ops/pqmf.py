"""Pseudo-QMF filter bank with a Kaiser prototype (port of
``vits_tpu/ops/pqmf.py``).

The filters are designed on the host in numpy, as the JAX version designs
them; its window is ``scipy.signal.windows.kaiser``, the port's
``np.kaiser``: the same formula, and the f32 filters of every configuration
here are bit for bit scipy's, without the ~2 s import of ``scipy.signal``
that each spawned rank would pay. Analysis and synthesis run as 1-D convs. The
public functions keep the JAX layout: audio ``[B, T, 1]``, sub-bands
``[B, T // N, N]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F


def design_prototype_filter(
    taps: int = 62, cutoff_ratio: float = 0.142, beta: float = 9.0
) -> np.ndarray:
    """Kaiser-window lowpass prototype of ``taps + 1`` coefficients."""
    if taps % 2 != 0 or not 0.0 < cutoff_ratio < 1.0:
        raise ValueError(f"taps must be even and 0 < cutoff < 1: {taps}, {cutoff_ratio}")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio
    w = np.kaiser(taps + 1, beta)
    return h_i * w


@functools.lru_cache(maxsize=None)
def _pqmf_filters(subbands: int, taps: int, cutoff_ratio: float, beta: float):
    """(analysis, synthesis) filters [N, taps + 1], f32."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    n = np.arange(taps + 1) - taps / 2
    k = np.arange(subbands)[:, None]
    phase = (2 * k + 1) * (np.pi / (2 * subbands)) * n[None, :]
    h_analysis = 2 * h_proto[None, :] * np.cos(phase + (-1.0) ** k * np.pi / 4)
    h_synthesis = 2 * h_proto[None, :] * np.cos(phase - (-1.0) ** k * np.pi / 4)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


class PQMF(torch.nn.Module):
    """Analysis/synthesis filter bank. The filters are non-persistent
    buffers: they follow ``.to(device)`` and stay out of the state dict, so
    the discriminator's state dict holds only its convs, as the reference's
    converter expects.

    Analysis is polyphase, as in the JAX version: the padded signal is cut
    into N-wide blocks and one dense N-in / N-out conv over the
    J = ceil((taps + 1) / N) block taps computes exactly the decimated
    outputs of conv(pad=taps//2)[::N], N times fewer products than the
    naive stride-1 conv.
    """

    def __init__(self, subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.142,
                 beta: float = 9.0):
        super().__init__()
        self.subbands = subbands
        self.taps = taps
        h_a, h_s = _pqmf_filters(subbands, taps, cutoff_ratio, beta)
        k = taps + 1
        self.n_blocks = -(-k // subbands)  # J
        h_pad = np.zeros((subbands, self.n_blocks * subbands), np.float32)
        h_pad[:, :k] = h_a
        # conv weight [out k, in r, J]: W[k, r, j] = h_a[k, j*N + r]
        poly = h_pad.reshape(subbands, self.n_blocks, subbands).transpose(0, 2, 1)
        self.register_buffer("poly_analysis", torch.from_numpy(poly.copy()), persistent=False)
        # [1, N, taps + 1]: the N zero-stuffed sub-bands summed into one channel
        self.register_buffer("synthesis_filter", torch.from_numpy(h_s[None]), persistent=False)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, 1] -> [B, ceil(T/N), N], in x's dtype."""
        b, t, _ = x.shape
        n, p, j = self.subbands, self.taps // 2, self.n_blocks
        frames = -(-t // n)
        total = (frames + j - 1) * n  # padded length covering every window
        if total < t + p:
            raise ValueError(f"PQMF analysis: {j} blocks of {n} do not cover {p} taps")
        xp = F.pad(x[:, :, 0], (p, total - t - p))
        blocks = xp.reshape(b, frames + j - 1, n).transpose(1, 2)  # [B, N(r), M]
        y = F.conv1d(blocks, self.poly_analysis.to(x.dtype))  # [B, N(k), frames]
        return y.transpose(1, 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T // N, N] -> [B, T, 1]."""
        b, t, n = x.shape
        up = x.new_zeros((b, n, t * n))
        up[:, :, ::n] = x.transpose(1, 2) * n
        y = F.conv1d(up, self.synthesis_filter.to(x.dtype), padding=self.taps // 2)
        return y.transpose(1, 2)
