"""Text encoder: phoneme + language-id embeddings -> rel-pos transformer ->
prior stats (m, logs) (port of ``vits_tpu/models/text_encoder.py``).

Ids are clipped to the vocabulary as the JAX version clips them (torch would
raise), and the language embedding is zeroed where the language id is 0.
``language_embedding=False`` builds VITS's text encoder: no ``emb_t``, the
language ids unread.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vits_torch.models.attention import RelativePositionTransformer
from vits_torch.models.modules import conv1d, embedding
from vits_torch.ops.commons import sequence_mask

N_LANGUAGES = 6


class TextEncoder(nn.Module):
    def __init__(
        self, n_vocab, out_channels, hidden_channels, filter_channels, n_heads,
        n_layers, kernel_size, p_dropout, language_embedding=True,
    ):
        super().__init__()
        self.n_vocab = n_vocab
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.language_embedding = language_embedding
        self.emb = embedding(n_vocab, hidden_channels, hidden_channels**-0.5)
        if language_embedding:
            self.emb_t = embedding(N_LANGUAGES, hidden_channels, hidden_channels**-0.5)
        self.encoder = RelativePositionTransformer(
            hidden_channels, filter_channels, n_heads, n_layers, kernel_size, p_dropout
        )
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, t, x_lengths):
        """x, t: [B, T] symbol and language ids; x_lengths: [B] ->
        (h [B, H, T], m [B, out, T], logs [B, out, T], x_mask [B, 1, T])."""
        x = self.emb(x.clamp(0, self.n_vocab - 1))
        if self.language_embedding:
            t = t.clamp(0, N_LANGUAGES - 1)
            x = x + self.emb_t(t) * (t != 0).unsqueeze(-1)
        x = x * math.sqrt(self.hidden_channels)  # [B, T, H]
        x = x.transpose(1, 2)
        x_mask = sequence_mask(x_lengths, x.shape[2]).unsqueeze(1).to(x.dtype)
        x = self.encoder(x * x_mask, x_mask)
        stats = self.proj(x) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return x, m, logs, x_mask
