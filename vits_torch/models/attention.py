"""Relative-position multi-head attention + conv FFN transformer
(port of ``vits_tpu/models/attention.py``; windowed relative attention,
window 4, heads share the relative embeddings). Layout NCL, masks [B, 1, T].
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from vits_torch.models.modules import LayerNorm, conv1d, xavier_conv1d


def _relative_position_to_absolute_position(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T] by pad + reshape (no gather)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, t * 2 * t), (0, t - 1))
    return x_flat.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1 :]


def _absolute_position_to_relative_position(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, T] -> [B, H, T, 2T-1] by pad + reshape (no gather)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x_flat = F.pad(x.reshape(b, h, t * t + t * (t - 1)), (t, 0))
    return x_flat.reshape(b, h, t, 2 * t)[:, :, :, 1:]


def _get_relative_embeddings(emb: torch.Tensor, length: int, window_size: int):
    """Pad-then-slice [H_rel, 2W+1, D] to 2*length-1 positions."""
    pad_length = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, start : start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    def __init__(
        self,
        channels: int,
        out_channels: int,
        n_heads: int,
        p_dropout: float = 0.0,
        window_size: int | None = None,
        heads_share: bool = True,
    ):
        super().__init__()
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = xavier_conv1d(channels, channels)
        self.conv_k = xavier_conv1d(channels, channels)
        self.conv_v = xavier_conv1d(channels, channels)
        self.conv_o = conv1d(channels, out_channels, 1)
        self.drop = nn.Dropout(p_dropout)
        if window_size is not None:
            n_heads_rel = 1 if heads_share else n_heads
            std = self.k_channels**-0.5
            shape = (n_heads_rel, window_size * 2 + 1, self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.randn(shape) * std)
            self.emb_rel_v = nn.Parameter(torch.randn(shape) * std)

    def forward(self, x, c, attn_mask=None):
        q, k, v = self.conv_q(x), self.conv_k(c), self.conv_v(c)
        b, d, t_t = q.shape
        t_s = k.shape[2]
        h, kc = self.n_heads, self.k_channels
        query = q.view(b, h, kc, t_t).transpose(2, 3) / math.sqrt(kc)
        key = k.view(b, h, kc, t_s).transpose(2, 3)
        value = v.view(b, h, kc, t_s).transpose(2, 3)
        scores = torch.matmul(query, key.transpose(-2, -1))
        if self.window_size is not None:
            if t_s != t_t:
                raise ValueError("relative attention requires self-attention")
            key_rel = _get_relative_embeddings(self.emb_rel_k, t_s, self.window_size)
            rel_logits = torch.matmul(query, key_rel.transpose(-2, -1))
            scores = scores + _relative_position_to_absolute_position(rel_logits)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = self.drop(torch.softmax(scores, dim=-1))
        output = torch.matmul(p_attn, value)
        if self.window_size is not None:
            rel_weights = _absolute_position_to_relative_position(p_attn)
            value_rel = _get_relative_embeddings(self.emb_rel_v, t_s, self.window_size)
            output = output + torch.matmul(rel_weights, value_rel)
        output = output.transpose(2, 3).reshape(b, d, t_t)
        return self.conv_o(output)


class FeedForwardNetwork(nn.Module):
    """Conv FFN with masked 'same' padding and ReLU."""

    def __init__(self, in_channels, out_channels, filter_channels, kernel_size, p_dropout=0.0):
        super().__init__()
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = conv1d(filter_channels, out_channels, kernel_size)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask):
        y = self.conv_1(F.pad(x * x_mask, self.pad))
        y = self.drop(torch.relu(y))
        y = self.conv_2(F.pad(y * x_mask, self.pad))
        return y * x_mask


class RelativePositionTransformer(nn.Module):
    """n_layers x [rel-attn + LN, conv-FFN + LN] (the reference's Encoder)."""

    def __init__(
        self, hidden_channels, filter_channels, n_heads, n_layers, kernel_size=1,
        p_dropout=0.0, window_size=4,
    ):
        super().__init__()
        self.n_layers = n_layers
        self.drop = nn.Dropout(p_dropout)
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(n_layers):
            self.attn_layers.append(
                MultiHeadAttention(
                    hidden_channels, hidden_channels, n_heads, p_dropout=p_dropout,
                    window_size=window_size,
                )
            )
            self.norm_layers_1.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(
                FeedForwardNetwork(
                    hidden_channels, hidden_channels, filter_channels, kernel_size,
                    p_dropout=p_dropout,
                )
            )
            self.norm_layers_2.append(LayerNorm(hidden_channels))

    def forward(self, x, x_mask):
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)  # [B, 1, T, T]
        x = x * x_mask
        for i in range(self.n_layers):
            y = self.drop(self.attn_layers[i](x, x, attn_mask))
            x = self.norm_layers_1[i](x + y)
            y = self.drop(self.ffn_layers[i](x, x_mask))
            x = self.norm_layers_2[i](x + y)
        return x * x_mask
