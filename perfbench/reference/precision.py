"""The reference's numerics, and the lower precision of its control.

``exact()``: float32 with TF32 off in cuBLAS and cuDNN, for the block; the
flags are put back afterwards.

``defaults()``: PyTorch's own flags (TF32 in cuDNN's convolutions, not in
cuBLAS's matrix products), the numerics of a float32 program that leaves
them alone: the yardstick of the serving comparison's audio error.

``fp8()``: the control of a configuration that states bfloat16: the
configuration's bf16 groups computed in float8 e4m3. Inside the block every
operation whose result is bfloat16 (the groups compute in bfloat16) has that
result rounded to e4m3, and every convolution, linear layer and matrix
product there has both operands rounded to e4m3 first; each tensor is scaled
by its own largest magnitude to e4m3's largest finite value (448), as a
float8 path scales it, and products accumulate in higher precision, as the
tensor cores do. The rounding is the forward's: gradients pass straight
through it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@contextlib.contextmanager
def defaults():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, in x's dtype."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    # the rounding is the forward's; the gradient passes straight through
    return x + (q.to(x.dtype) - x).detach()


_PRODUCTS = {F.conv1d, F.conv2d, F.conv_transpose1d, F.linear, torch.matmul, torch.bmm,
             torch.Tensor.matmul, torch.Tensor.__matmul__}


def _round_bf16(out):
    if isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16 and out.is_floating_point():
        return round_e4m3(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_round_bf16(o) for o in out)
    return out


class _Fp8(TorchFunctionMode):
    # the mode is off while its handler runs, so the rounding is not rounded
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and len(args) >= 2 and isinstance(args[0], torch.Tensor) \
                and args[0].dtype == torch.bfloat16 and isinstance(args[1], torch.Tensor):
            args = (round_e4m3(args[0]), round_e4m3(args[1].to(torch.bfloat16)), *args[2:])
        out = func(*args, **kwargs)
        if getattr(func, "__name__", "") in _VIEWS:
            return out
        return _round_bf16(out)


# results that share storage with their input: already rounded
_VIEWS = {"view", "reshape", "transpose", "permute", "narrow", "__getitem__", "squeeze",
          "unsqueeze", "expand", "contiguous", "detach", "split", "chunk", "unbind",
          "select", "t", "flatten", "unflatten", "view_as", "reshape_as", "expand_as",
          "as_strided", "movedim", "__get__", "dim", "size", "numel", "requires_grad_"}


@contextlib.contextmanager
def fp8():
    with _Fp8():
        yield
