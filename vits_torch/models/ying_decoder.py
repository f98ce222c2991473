"""Yin decoder: reconstructs the scope-cropped yingram from z_yin under a
per-sample integer scope shift (port of ``vits_tpu/models/ying_decoder.py``).
The shift, uniform on [-yin_shift_range, yin_shift_range) as the JAX
``randint`` draws it, is passed in. Layout NCL, masks [B, 1, T].
"""

from __future__ import annotations

import torch
from torch import nn

from vits_torch.models.modules import WaveNet, conv1d
from vits_torch.ops.commons import crop_scope


def crop_channels(x, yin_start, yin_scope, scope_shift):
    """``crop_scope`` on an NCL tensor: [B, C, T] -> [B, yin_scope, T]."""
    return crop_scope(x.transpose(1, 2), yin_start, yin_scope, scope_shift).transpose(1, 2)


class YingDecoder(nn.Module):
    def __init__(
        self, hidden_channels, kernel_size, dilation_rate, n_layers, yin_start,
        yin_scope, yin_shift_range, gin_channels=0,
    ):
        super().__init__()
        self.yin_start = yin_start
        self.yin_scope = yin_scope
        self.yin_shift_range = yin_shift_range
        self.pre = conv1d(yin_scope, hidden_channels, 1)
        self.dec = WaveNet(
            hidden_channels, kernel_size, dilation_rate, n_layers,
            gin_channels=gin_channels,
        )
        self.proj = conv1d(hidden_channels, yin_scope, 1)

    def draw_shift(self, batch: int, generator=None, device=None) -> torch.Tensor:
        """[B] int32 shifts, uniform on [-range, range)."""
        r = self.yin_shift_range
        return torch.randint(
            -r, r, (batch,), generator=generator, device=device, dtype=torch.int32
        )

    def _decode(self, z_yin_crop, z_mask, g):
        x = self.pre(z_yin_crop) * z_mask
        x = self.dec(x, z_mask, g=g)
        return self.proj(x) * z_mask

    def forward(self, z_yin, yin_gt, z_mask, g=None, scope_shift=None):
        """z_yin, yin_gt: [B, C_yin, T]; scope_shift: [B] int -> (yin_gt_crop,
        yin_gt_shifted_crop, yin_hat_crop, z_yin_crop, scope_shift)."""
        z_yin_crop = crop_channels(z_yin, self.yin_start, self.yin_scope, scope_shift)
        yin_gt_shifted_crop = crop_channels(
            yin_gt, self.yin_start, self.yin_scope, scope_shift
        )
        yin_gt_crop = crop_channels(
            yin_gt, self.yin_start, self.yin_scope, torch.zeros_like(scope_shift)
        )
        yin_hat_crop = self._decode(z_yin_crop, z_mask, g)
        return yin_gt_crop, yin_gt_shifted_crop, yin_hat_crop, z_yin_crop, scope_shift
