"""What the serving engine computes for one request, written plainly: text
-> ids (the frozen frontend in ``text/``) -> pieces of at most 384 ids cut at
phrase boundaries -> for each piece, the text encoder, the stochastic
duration predictor in reverse, ceil(durations), the length regulator, the
prior sample, the reverse flow and the decoder, at the piece's own length
(no padding, batch 1). Piece i draws its noise from seed + i; noise scales
0.667 (prior) and 0.8 (durations); the frames of a piece are capped at the
engine's ``max_frames``.

A piece also reports its durations before the ceiling (``w``): a token
whose duration lies within a hair of a whole number may round the other way
in a program that computes in another order or precision, and every frame
after it then differs; the comparison uses them to know which frames it can
hold the program to.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ops.commons import intersperse_with_language_id
from perfbench.reference.text import cleaned_text_to_sequence
from perfbench.reference.text.cleaners import clean_text
from perfbench.reference.text.symbols import symbols

NOISE_SCALE, NOISE_SCALE_W = 0.667, 0.8
TEXT_LIMIT = 384


def phonemes(text: str, add_blank: bool = True):
    """Tagged text -> (ids, language ids), int32 arrays."""
    cleaned, lang = clean_text(text)
    seq = cleaned_text_to_sequence(cleaned)
    if not seq:
        raise ValueError("empty phoneme sequence")
    if add_blank:
        seq, lang = intersperse_with_language_id(seq, lang, 0)
    return np.asarray(seq, np.int32), np.asarray(lang, np.int32)


def split_segments(seq, lang, limit: int = TEXT_LIMIT):
    """Pieces of at most ``limit`` ids, cut after the last punctuation mark
    inside the limit, else after the last space, else at the limit."""
    punct = {symbols.index(c) for c in ",.!?…~-" if c in symbols}
    space = symbols.index(" ")
    out, start, n = [], 0, len(seq)
    while n - start > limit:
        window = range(start + limit - 1, start, -1)
        cut = next((i for i in window if int(seq[i]) in punct), None)
        if cut is None:
            cut = next((i for i in window if int(seq[i]) == space), None)
        cut = (cut + 1) if cut is not None else start + limit
        out.append((seq[start:cut], lang[start:cut]))
        start = cut
    out.append((seq[start:], lang[start:]))
    return [(s, la) for s, la in out if len(s) > 0]


@torch.no_grad()
def synth_piece(model, seq, lang, speaker: int, noise_fn, seed: int, max_frames: int,
                duration: float = 1.0) -> dict:
    """One piece: {"audio": float32 [frames * hop], "frames", "w": durations
    before the ceiling [n], "capped"}. ``noise_fn(seed, shapes)`` gives the
    request's draws (``sdp_noise`` [1, n, 2], ``eps`` [1, frames, C])."""
    dev = model.device
    n = len(seq)
    x = torch.as_tensor(np.asarray(seq, np.int64)[None], device=dev)
    t = torch.as_tensor(np.asarray(lang, np.int64)[None], device=dev)
    xl = torch.tensor([n], device=dev)
    sid = torch.tensor([speaker], device=dev)
    x_h, m_p, logs_p, x_mask = model.text_encoder(x, t, xl)
    g = model._speaker_embedding(sid)
    sdp = noise_fn(seed, {"sdp_noise": (1, n, 2), "eps": (1, 1, model.inter_channels)})
    logw = model.duration_predictor.reverse(
        x_h, x_mask, g=g, z=sdp["sdp_noise"].transpose(1, 2), noise_scale=NOISE_SCALE_W)
    w = torch.exp(logw) * x_mask * duration
    w_ceil = torch.ceil(w)
    total = int(w_ceil.sum())
    frames = max(1, min(total, max_frames))
    eps = noise_fn(seed, {"sdp_noise": (1, n, 2), "eps": (1, frames, model.inter_channels)})["eps"]
    dec_in, _, _ = model._expand_and_flow(
        w_ceil[:, 0], m_p, logs_p, x_mask, g, eps.transpose(1, 2), NOISE_SCALE, frames, 0)
    wav = model.waveform_decoder(dec_in, g=g)
    return {"audio": wav[0, 0].float().cpu().numpy(), "frames": frames,
            "w": w[0, 0].float().cpu().numpy(), "capped": total > max_frames}
