"""The benchmark's draws: sub-seeds, the train step's noise and dropout
masks, and the serving noise. The program is handed every one of them, so
that the reference, handed the same, can follow it."""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

from perfbench.reference.ops.phaseaug import sample_phi


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's seed and ``tags`` (ints, strings,
    or tuples of them)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    flat = []
    stack = list(reversed(tags))
    while stack:
        t = stack.pop()
        if isinstance(t, (tuple, list)):
            stack.extend(reversed(t))
        else:
            flat.append(t)
    for t in flat:
        words.append(zlib.crc32(t.encode()) if isinstance(t, str) else int(t) & 0xFFFFFFFF)
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def train_noise(b: int, t_x: int, t_y: int, spec_ch: int, yin_ch: int, shift_range: int,
                seed: int, device) -> dict:
    """Every draw of one train step at batch b, as the program's
    ``train_step(noise=...)`` takes them (channels-last)."""
    g = torch.Generator(device).manual_seed(seed)
    return {
        "eps_spec": torch.randn((b, t_y, spec_ch), generator=g, device=device),
        "eps_yin": torch.randn((b, t_y, yin_ch), generator=g, device=device),
        "scope_shift": torch.randint(-shift_range, shift_range, (b,), generator=g,
                                     device=device, dtype=torch.int32),
        "e_q": torch.randn((b, t_x, 2), generator=g, device=device),
        "slice_u": torch.rand((b,), generator=g, device=device),
        "phi_d": sample_phi(2 * b, g, device),
        "phi_g": sample_phi(2 * b, g, device),
    }


class SeededDropout(nn.Module):
    """Dropout whose masks come from a generator of its own, reseeded for
    every step from (run seed, step, the module's name); put in place of
    each ``nn.Dropout`` of the program's model and of the reference's, so
    that both drop the same units."""

    def __init__(self, p: float, name: str, device, original: nn.Dropout | None = None):
        super().__init__()
        self.p = float(p)
        self.name = name
        # the module it stands in for, put back by ``restore_dropout``; kept
        # out of the module tree (a plain attribute, not a child)
        self.__dict__["original"] = original
        self.gen = torch.Generator(device)
        # a block of rows of a batch of ``full`` rows (the reference, which
        # runs a batch in blocks): the mask is drawn for the whole batch
        self.rows: tuple[int, int, int] | None = None

    def reseed(self, seed: int, step) -> None:
        self.gen.manual_seed(subseed(seed, step, self.name))

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        shape = x.shape if self.rows is None else (self.rows[2], *x.shape[1:])
        keep = torch.rand(shape, generator=self.gen, device=x.device) >= self.p
        if self.rows is not None:
            keep = keep[self.rows[0]: self.rows[1]]
        return x * keep.to(x.dtype) / (1.0 - self.p)


def install_dropout(module: nn.Module, device) -> dict[str, SeededDropout]:
    """Replace every ``nn.Dropout`` under ``module`` by a ``SeededDropout``
    named by its path; returns them by name."""
    found = {}
    for parent_name, parent in list(module.named_modules()):
        for child_name, child in list(parent.named_children()):
            if type(child) is nn.Dropout:
                name = f"{parent_name}.{child_name}" if parent_name else child_name
                sd = SeededDropout(child.p, name, device, original=child)
                setattr(parent, child_name, sd)
                found[name] = sd
    return found


def restore_dropout(module: nn.Module) -> None:
    """Put back the ``nn.Dropout`` each ``SeededDropout`` under ``module``
    stands in for."""
    for parent in list(module.modules()):
        for child_name, child in list(parent.named_children()):
            if isinstance(child, SeededDropout) and child.original is not None:
                setattr(parent, child_name, child.original)


def reseed_dropout(drops: dict[str, SeededDropout], seed: int, step) -> None:
    for d in drops.values():
        d.reseed(seed, step)


SDP_TX, EPS_FRAMES = 1024, 2000


def serve_noise(seed: int, shapes: dict, device) -> dict:
    """The engine's ``noise_fn``: one generator seeded with the request's
    seed draws a [1, 1024, 2] SDP noise and a [1, 2000, C] prior noise, and
    each is cut to the shape asked for, so that a position's noise does not
    depend on the bucket the engine pads to."""
    g = torch.Generator(device).manual_seed(int(seed))
    sdp = shapes["sdp_noise"]
    eps = shapes["eps"]
    full_sdp = torch.randn((1, SDP_TX, sdp[2]), generator=g, device=device)
    full_eps = torch.randn((1, EPS_FRAMES, eps[2]), generator=g, device=device)
    return {"sdp_noise": full_sdp[:, : sdp[1]], "eps": full_eps[:, : eps[1]]}
