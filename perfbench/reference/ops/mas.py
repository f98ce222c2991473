"""Monotonic Alignment Search as a plain dynamic program on the host.

value[y, x] = neg[y, x] + max(value[y-1, x], value[y-1, x-1]); row 0 is
neg[0] with -1e9 added off column 0; masked cells are -1e9. The decision
dec[y, x] = value[y-1, x] < value[y-1, x-1]. The backtrack walks from
(t_y-1, t_x-1) to row 0, stepping left where the column equals the row or
the decision at the current cell is set, never below column 0.

The lattice is copied to the host and searched in float32 with numpy, one
row of the whole batch at a time; the path comes back on the input's device
in its dtype, times the mask.
"""

from __future__ import annotations

import numpy as np
import torch

BIG_NEG = np.float32(-1e9)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent, mask: [B, T_y, T_x] -> hard path, neg_cent's dtype. On the
    ``meta`` device (a FLOP count) only the shape comes back."""
    if neg_cent.device.type == "meta":
        return torch.empty_like(neg_cent)
    neg = neg_cent.detach().float().cpu().numpy()
    m = mask.detach().float().cpu().numpy()
    b, t_y, t_x = neg.shape
    neg = np.where(m > 0, neg, BIG_NEG).astype(np.float32)
    t_ys = m[:, :, 0].sum(axis=1).astype(np.int64)
    t_xs = m[:, 0, :].sum(axis=1).astype(np.int64)
    dec = np.zeros((b, t_y, t_x), dtype=bool)
    off0 = np.full(t_x, BIG_NEG, dtype=np.float32)
    off0[0] = 0.0
    prev = neg[:, 0] + off0
    for y in range(1, t_y):
        shifted = np.concatenate([np.full((b, 1), BIG_NEG, np.float32), prev[:, :-1]], axis=1)
        dec[:, y] = prev < shifted
        prev = neg[:, y] + np.maximum(prev, shifted)
    path = np.zeros((b, t_y, t_x), dtype=np.float32)
    for i in range(b):
        if t_xs[i] <= 0:
            continue
        x = t_xs[i] - 1
        for y in range(t_ys[i] - 1, -1, -1):
            path[i, y, x] = 1.0
            if x != 0 and (x == y or dec[i, y, x]):
                x -= 1
    out = torch.from_numpy(path).to(neg_cent.device, neg_cent.dtype)
    return out * mask
