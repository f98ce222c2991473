"""The input gradient of a grouped 1-D convolution with few channels a group
(the scale discriminator's, ``models/mpd.py::DiscriminatorS``), and the
autograd Function that uses it.

Two versions of ``grouped_dgrad`` (the gradient of ``F.conv1d(x, w, None,
stride, padding, groups=groups)`` with respect to ``x``):
  * the plain PyTorch version, ``grouped_dgrad_torch``
    (``torch.nn.grad.conv1d_input``);
  * the CUDA kernel in ``vits_torch/csrc/grouped_conv.cu``,
    ``grouped_dgrad_cuda``: float32 multiply-adds throughout, no TF32.

``grouped_dgrad`` takes the plain version only for a CPU tensor. A CUDA
tensor launches the kernel, or raises: there is no fallback.

``GroupedConv1dFunction``'s forward is ``F.conv1d`` (cuDNN on the card, its
kernels and numbers unchanged); its backward computes the input gradient
with ``grouped_dgrad`` where it is needed, and the weight and bias gradients
with ``aten.convolution_backward`` (cuDNN on the card). Each backward call
adds one to the port's counter ``disc.grouped_dgrad``, inside the span
``vits.disc.grouped_dgrad`` (``utils/profiling.py``).

The kernel wrapper checks what the kernel takes (float32 alone), allocates
its output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and adds one to its launch
count (``launches``). The kernel's entry point chooses its launch plan. The
library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from vits_torch import _build
from vits_torch.utils.profiling import count, span

# kernel launches since import or the caller's last reset to 0
launches = {"grouped_dgrad": 0}

# grouped_conv.cu's limits
MAX_CIN_G, MAX_COUT_G, MAX_KERNEL, MAX_STRIDE = 8, 64, 64, 8
_HALF = (torch.bfloat16, torch.float16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("grouped_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_dgrad.argtypes = [p, p, p] + [i] * 9 + [p]
    lib.grouped_dgrad.restype = i
    return lib


def check_shapes(grad_out_shape, weight_shape, t_in: int, stride: int, padding: int,
                 groups: int) -> None:
    """Raises unless the kernel takes these shapes: [B, G*cout_g, T_out]
    and [G*cout_g, cin_g, K], cin_g <= 8, cout_g <= 64, K <= 64, 1 <= stride
    <= 8, padding >= 0, B <= 65535, T_out the forward's."""
    if len(grad_out_shape) != 3 or len(weight_shape) != 3:
        raise ValueError("grad_out and weight must be 3-d")
    b, c_out, t_out = grad_out_shape
    w_out, cin_g, k = weight_shape
    if w_out != c_out or c_out % groups:
        raise ValueError(f"weight {tuple(weight_shape)} does not match grad_out "
                         f"{tuple(grad_out_shape)} at {groups} groups")
    cout_g = c_out // groups
    if not (1 <= cin_g <= MAX_CIN_G and 1 <= cout_g <= MAX_COUT_G and 1 <= k <= MAX_KERNEL
            and 1 <= stride <= MAX_STRIDE and padding >= 0):
        raise ValueError(
            f"grouped_dgrad takes cin_g <= {MAX_CIN_G}, cout_g <= {MAX_COUT_G}, "
            f"K <= {MAX_KERNEL}, 1 <= stride <= {MAX_STRIDE}, padding >= 0; got cin_g "
            f"{cin_g}, cout_g {cout_g}, K {k}, stride {stride}, padding {padding}")
    if not 1 <= b <= 65535:
        raise ValueError(f"grouped_dgrad takes 1 to 65535 rows, got {b}")
    if t_in < 1 or t_out != (t_in + 2 * padding - k) // stride + 1:
        raise ValueError(f"T_out {t_out} is not the forward's at T_in {t_in}")


def grouped_dgrad_cuda(grad_out: torch.Tensor, weight: torch.Tensor, t_in: int, stride: int,
                       padding: int, groups: int) -> torch.Tensor:
    """The kernel. grad_out: [B, G*cout_g, T_out] f32 CUDA, contiguous;
    weight: [G*cout_g, cin_g, K] f32, contiguous, on the same card. Returns
    grad_in [B, G*cin_g, T_in] f32."""
    for name, t in (("grad_out", grad_out), ("weight", weight)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weight.device != grad_out.device:
        raise ValueError("grad_out and weight must be on one device")
    check_shapes(grad_out.shape, weight.shape, t_in, stride, padding, groups)
    b, c_out, t_out = grad_out.shape
    _, cin_g, k = weight.shape
    grad_in = torch.empty((b, groups * cin_g, t_in), dtype=torch.float32,
                          device=grad_out.device)
    with torch.cuda.device(grad_out.device):
        err = _lib().grouped_dgrad(
            grad_out.data_ptr(), weight.data_ptr(), grad_in.data_ptr(), b, groups, cin_g,
            c_out // groups, t_in, t_out, k, stride, padding,
            torch.cuda.current_stream(grad_out.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_dgrad launch failed: cudaError {err}")
    launches["grouped_dgrad"] += 1
    return grad_in


def grouped_dgrad_torch(grad_out: torch.Tensor, weight: torch.Tensor, t_in: int, stride: int,
                        padding: int, groups: int) -> torch.Tensor:
    """The plain version (any device and float dtype)."""
    b, _, _ = grad_out.shape
    return torch.nn.grad.conv1d_input((b, groups * weight.shape[1], t_in), weight, grad_out,
                                      stride, padding, 1, groups)


def grouped_dgrad(grad_out: torch.Tensor, weight: torch.Tensor, t_in: int, stride: int,
                  padding: int, groups: int) -> torch.Tensor:
    """The input gradient: the plain version on the CPU, the kernel on the
    card (or a raise). On the card, bfloat16 or float16 operands (a layer
    under autocast) are widened to float32, which is exact, for the kernel,
    and the gradient comes back in grad_out's dtype."""
    if grad_out.device.type == "cpu":
        return grouped_dgrad_torch(grad_out, weight, t_in, stride, padding, groups)
    if grad_out.dtype in _HALF or weight.dtype in _HALF:
        return grouped_dgrad_cuda(grad_out.float(), weight.float(), t_in, stride, padding,
                                  groups).to(grad_out.dtype)
    return grouped_dgrad_cuda(grad_out, weight, t_in, stride, padding, groups)


class GroupedConv1dFunction(torch.autograd.Function):
    """``F.conv1d(x, weight, bias, stride, padding, groups=groups)`` whose
    input gradient is ``grouped_dgrad``."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride: int, padding: int, groups: int):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, groups, bias is not None)
        return F.conv1d(x, weight, bias, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        stride, padding, groups, has_bias = ctx.conv
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        grad_x = grad_w = grad_b = None
        count("disc.grouped_dgrad")
        with span("disc.grouped_dgrad"):
            grad_out = grad_out.contiguous()
            if need_x:
                grad_x = grouped_dgrad(grad_out, weight.contiguous(), x.shape[-1], stride,
                                       padding, groups)
            if need_w or need_b:
                _, grad_w, grad_b = torch.ops.aten.convolution_backward(
                    grad_out, x, weight, [weight.shape[0]] if has_bias else None, [stride],
                    [padding], [1], False, [0], groups, [False, need_w, need_b and has_bias])
        return grad_x, grad_w, grad_b, None, None, None
