"""Core building blocks: weight-normed 1-D convs, LayerNorm, WaveNet, DDSConv
(port of ``vits_tpu/models/modules.py``).

Layout inside the modules is NCL, as in the torch reference: activations
``[B, C, T]``, masks ``[B, 1, T]``, speaker conditioning ``[B, gin, 1]``.

A conv computes in its input's dtype, its weight and bias cast to it, as the
JAX ``Conv1d`` does (``modules.py``: ``dtype = self.dtype or x.dtype``):
under the bf16 policy the parameters stay f32 and only the compute is bf16,
and the bias is added to the rounded conv output, as there; for an f32
input nothing is cast.

Weight norm is the legacy ``torch.nn.utils.weight_norm`` (dim 0), whose
``weight_g``/``weight_v`` keys are what ``vits_tpu/utils/convert_torch.py``
reads. Its norm is ``||v||`` exactly; the JAX package takes
``sqrt(||v||^2 + 1e-12)``, a relative difference below 1e-12/||v||^2 that is
invisible in f32 for any weight of the models here.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

LRELU_SLOPE = 0.1


def weight_norm(module: nn.Module) -> nn.Module:
    """Legacy weight norm over dim 0 (state-dict keys weight_g / weight_v)."""
    return torch.nn.utils.weight_norm(module)


def _in_dtype_of(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, conv):
    """conv(x, weight, bias) in x's dtype; in another dtype than the
    weight's, the bias is added after the conv's output is rounded."""
    if weight.dtype == x.dtype:
        return conv(x, weight, bias)
    y = conv(x, weight.to(x.dtype), None)
    return y if bias is None else y + bias.to(x.dtype)[:, None]


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in its input's dtype."""

    def _conv_forward(self, input, weight, bias):
        return _in_dtype_of(input, weight, bias, super()._conv_forward)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` computing in its input's dtype (no
    ``output_size`` argument: the port fixes the output by padding)."""

    def forward(self, input):
        return _in_dtype_of(input, self.weight, self.bias, lambda x, w, b: F.conv_transpose1d(
            x, w, b, self.stride, self.padding, self.output_padding, self.groups,
            self.dilation,
        ))


def conv1d(
    in_channels: int,
    out_channels: int,
    kernel_size: int,
    *,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    padding: int = 0,
    bias: bool = True,
    use_weight_norm: bool = False,
    init_std: float | None = None,
    zero_init: bool = False,
) -> nn.Module:
    """``Conv1d`` with torch's default init, or N(0, init_std) weights
    (HiFi-GAN), or zeros (flow output heads); weight-normed on request."""
    conv = Conv1d(
        in_channels, out_channels, kernel_size, stride=stride, dilation=dilation,
        groups=groups, padding=padding, bias=bias,
    )
    if zero_init:
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
    elif init_std is not None:
        nn.init.normal_(conv.weight, 0.0, init_std)
    return weight_norm(conv) if use_weight_norm else conv


class LayerNorm(nn.Module):
    """LayerNorm over channels of an NCL tensor, eps 1e-5 (reference
    LayerNorm.py: parameters ``gamma``/``beta``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, -1)
        x = F.layer_norm(x, (self.channels,), self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)


class WaveNet(nn.Module):
    """Non-causal WaveNet with gated tanh/sigmoid units and global
    conditioning; one 1x1 cond conv sliced per layer. All convs weight-normed.
    """

    def __init__(
        self,
        hidden_channels: int,
        kernel_size: int,
        dilation_rate: int,
        n_layers: int,
        gin_channels: int = 0,
        p_dropout: float = 0.0,
    ):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        self.drop = nn.Dropout(p_dropout)
        if gin_channels != 0:
            self.cond_layer = conv1d(
                gin_channels, 2 * hidden_channels * n_layers, 1, use_weight_norm=True
            )
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate**i
            self.in_layers.append(
                conv1d(
                    hidden_channels, 2 * hidden_channels, kernel_size,
                    dilation=dilation, padding=(kernel_size * dilation - dilation) // 2,
                    use_weight_norm=True,
                )
            )
            res_skip = 2 * hidden_channels if i < n_layers - 1 else hidden_channels
            self.res_skip_layers.append(
                conv1d(hidden_channels, res_skip, 1, use_weight_norm=True)
            )

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        if g is not None:
            g = self.cond_layer(g)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g is not None:
                x_in = x_in + g[:, i * 2 * h : (i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            acts = self.drop(acts)
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (k^i dilation, LayerNorm, exact GELU)."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int, p_dropout=0.0):
        super().__init__()
        self.n_layers = n_layers
        self.drop = nn.Dropout(p_dropout)
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            dilation = kernel_size**i
            self.convs_sep.append(
                conv1d(
                    channels, channels, kernel_size, groups=channels, dilation=dilation,
                    padding=(kernel_size * dilation - dilation) // 2,
                )
            )
            self.convs_1x1.append(conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels))
            self.norms_2.append(LayerNorm(channels))

    def forward(self, x, x_mask, g=None):
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = self.convs_sep[i](x * x_mask)
            y = F.gelu(self.norms_1[i](y))
            y = self.convs_1x1[i](y)
            y = F.gelu(self.norms_2[i](y))
            x = x + self.drop(y)
        return x * x_mask


def xavier_conv1d(in_channels: int, out_channels: int) -> nn.Conv1d:
    """1x1 conv with xavier-uniform weights (attention projections)."""
    conv = nn.Conv1d(in_channels, out_channels, 1)
    nn.init.xavier_uniform_(conv.weight)
    return conv


def embedding(num: int, dim: int, std: float | None = None) -> nn.Embedding:
    emb = nn.Embedding(num, dim)
    if std is not None:
        nn.init.normal_(emb.weight, 0.0, std)
    return emb
