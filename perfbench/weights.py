"""Seeded weights, made by the benchmark on the device and loaded into both
the program and the reference.

One uniform draw on [-1, 1) covers every parameter, from a ``torch.Generator``
on the device seeded with the run's seed; each leaf then takes its share of
it, scaled by the rule its name matches. The rules follow the initialisation
of the models' own constructors (PyTorch's defaults, VITS's special cases):

- ``weight`` / ``weight_v`` with two or more axes: uniform with bound
  1 / sqrt(fan_in) (PyTorch's default for a conv or linear layer); the
  HiFi-GAN upsampling and residual convs std 0.01 (VITS's ``init_weights``);
- ``bias``: uniform with bound 1 / sqrt(fan_in) of its layer's weight;
- ``weight_g``: the norm of its ``weight_v`` over all axes but the first, so
  the layer's weight is ``weight_v`` itself, as ``weight_norm`` starts it;
- embeddings: std 1 for the speaker table, else 1 / sqrt(width);
- zero: the coupling layers' ``post`` and the spline flows' ``proj`` (flows
  start as the identity), ``ElementwiseAffine``'s ``m`` and ``logs``, LayerNorm
  ``beta``; one: LayerNorm ``gamma``.

A uniform draw with std s has bound s * sqrt(3).
"""

from __future__ import annotations

import math
import re

import torch

_ZERO = re.compile(
    r"(^|\.)flow\.flows\.\d+\.post\.|duration_predictor\.(post_)?flows\.\d+\.proj\."
    r"|duration_predictor\.(post_)?flows\.\d+\.(m|logs)$|\.beta$"
)
_STD_001 = re.compile(r"waveform_decoder\.(ups|resblocks)\.")


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


def _bound(name: str, shape, shapes: dict) -> float:
    """The uniform bound of a leaf that is drawn (not zero, one or a norm)."""
    if "emb" in name:
        std = 1.0 if name.startswith("emb_g") else shape[-1] ** -0.5
        return std * math.sqrt(3.0)
    if name.endswith("bias"):
        stem = name[: -len("bias")]
        w = shapes.get(stem + "weight", shapes.get(stem + "weight_v"))
        return 1.0 / math.sqrt(_fan_in(w)) if w is not None else 0.0
    if _STD_001.search(name) and name.endswith("weight_v"):
        return 0.01 * math.sqrt(3.0)
    return 1.0 / math.sqrt(_fan_in(shape))


@torch.no_grad()
def make(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter named in
    ``shapes`` (name -> shape); the draw is laid out in the names' sorted
    order, so the values do not depend on the order the modules hold them."""
    gen = torch.Generator(device).manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out = {}
    offset = 0
    for name in sorted(shapes):
        shape = shapes[name]
        n = math.prod(shape)
        leaf = flat[offset: offset + n].view(shape)
        offset += n
        if _ZERO.search(name):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("gamma"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith("weight_g"):
            continue  # after its weight_v
        else:
            out[name] = leaf * _bound(name, shape, shapes)
    for name in shapes:
        if name.endswith("weight_g"):
            v = out[name[: -len("weight_g")] + "weight_v"]
            dims = tuple(range(1, v.dim()))
            out[name] = v.norm(dim=dims, keepdim=True).reshape(shapes[name])
    return out


def shapes_of(module: torch.nn.Module) -> dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@torch.no_grad()
def load(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters; the names and shapes
    have to be the same set."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) - set(params))[:5]
        extra = sorted(set(params) - set(weights))[:5]
        raise ValueError(f"parameters differ from the reference's: missing {missing}, "
                         f"not in the reference {extra}")
    for n, p in params.items():
        if tuple(p.shape) != tuple(weights[n].shape):
            raise ValueError(f"{n}: shape {tuple(p.shape)}, reference {tuple(weights[n].shape)}")
        p.copy_(weights[n])
