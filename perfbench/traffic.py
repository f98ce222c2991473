"""The general traffic generator: reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and makes its inputs from the run's seed.

Every seed gets the same set of sizes (steps, items, sentences, gaps between
arrivals) in another order: the sizes are fixed by the parameters, the seed
permutes them and draws the content (symbols, waveforms, speakers, noise
seeds). So two seeds do the same work, and a seed changes only its order.
The train steps' buckets are the exception: they come in one order for
every seed, since a window that ends inside a cycle would otherwise do
another seed's share of large and small steps.

Kinds:

- ``train_buckets``: train batches. A cycle of steps names each step's frame
  bucket (``cycle``: bucket -> steps a cycle); a bucket's ``B`` items have
  frame lengths evenly spaced over its ``frames`` range and text lengths
  either evenly spaced ``ids_per_frame`` ratios of their frames (capped at
  ``max_ids``) or evenly spaced over ``ids``; text is padded to ``text_pad``
  and frames to the bucket. The waveform is two harmonics of a pitch drawn
  from 90-300 Hz plus noise, cut at the item's length; its linear
  spectrogram and yingram are the reference's (``perfbench.reference.ops``).
- ``sentences``: a bank of tagged sentences built from the mix's clause
  lists (``clauses``: a data file of its own), a language share of the bank
  each, lengths in characters evenly spaced over each language's range; an
  open loop sends them at Poisson arrivals of a fixed ``rate_per_s`` (gaps at
  evenly spaced quantiles of the exponential, permuted).
- ``paragraphs``: paragraphs of one language each, sentences of the bank
  appended until the paragraph's ids after g2p reach ``min_ids``, between
  ``min_sentences`` and ``max_sentences`` sentences.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from perfbench.randomness import subseed

HERE = Path(__file__).resolve().parent
LANG_IDS = {"ZH": 0, "JA": 1, "EN": 3}


def _perm(n: int, seed: int, *tags) -> np.ndarray:
    return np.random.default_rng(subseed(seed, *tags)).permutation(n)


def _spaced(lo: float, hi: float, n: int) -> np.ndarray:
    """n values evenly spaced over [lo, hi] (bin centres)."""
    return lo + (np.arange(n) + 0.5) * (hi - lo) / n


# -- train ---------------------------------------------------------------

def train_buckets(tr) -> list[int]:
    """The mix's buckets, smallest first."""
    return sorted(int(b) for b in tr.cycle)


def check_buckets(tr) -> list[int]:
    """The buckets of the ``check_steps`` steps the reference follows, in
    order: spread evenly over the mix's buckets, the smallest and the
    largest among them."""
    b = train_buckets(tr)
    k = int(tr.check_steps)
    return [b[int(i)] for i in np.rint(np.linspace(0, len(b) - 1, k))]


def train_schedule(tr, n_steps: int) -> list[int]:
    """Each window step's bucket: ``tr.cycle`` over and over, in one order
    for every seed, a bucket's n steps spread evenly over the cycle (its k-th
    at (k + 1/2) / n of it), so that any stretch of steps, a window's last
    part cycle too, holds each bucket at about its share."""
    slots = sorted(((k + 0.5) / int(n), int(b)) for b, n in tr.cycle.items()
                   for k in range(int(n)))
    return [slots[i % len(slots)][1] for i in range(n_steps)]


def item_lengths(tr, bucket: int, seed: int, tag) -> tuple[np.ndarray, np.ndarray]:
    """(frames, ids) of a batch's items in the bucket, permuted by the seed."""
    b = int(tr.batch)
    lo, hi = tr.frames[str(bucket)]
    frames = np.floor(_spaced(lo, hi + 1, b)).astype(np.int64)[_perm(b, seed, "frames", tag)]
    if "ids_per_frame" in tr:
        r = _spaced(*tr.ids_per_frame, b)[_perm(b, seed, "ratio", tag)]
        ids = np.rint(r * frames).astype(np.int64)
    else:
        ids = np.rint(_spaced(*tr.ids, b)).astype(np.int64)[_perm(b, seed, "ids", tag)]
    ids = np.clip(ids, 1, min(int(tr.max_ids), int(tr.text_pad)))
    return frames, np.minimum(ids, frames)


class TrainFeed:
    """Makes a train mix's batches on ``device`` from the run's seed."""

    def __init__(self, tr, data, seed: int, device):
        from perfbench.reference.ops.yin import Yingram

        self.tr, self.data, self.seed, self.device = tr, data, seed, device
        self.yingram = Yingram(data.sampling_rate, data.hop_length, data.ying_window,
                               data.tau_max, data.midi_start, data.midi_end,
                               data.octave_range)

    @torch.no_grad()
    def batch(self, bucket: int, tag) -> dict:
        """One batch in the layout the train step takes (spec [B, T_y, F],
        ying [B, T_y, M], wav [B, T_y * hop, 1]); ``tag`` names it."""
        from perfbench.reference.ops.stft import spectrogram

        tr, data, device = self.tr, self.data, self.device
        frames, ids = item_lengths(tr, bucket, self.seed, tag)
        b, t_x, hop = int(tr.batch), int(tr.text_pad), data.hop_length
        g = torch.Generator(device).manual_seed(subseed(self.seed, "batch", tag))
        n = torch.arange(bucket * hop, device=device, dtype=torch.float32)
        f0 = 90.0 + 210.0 * torch.rand((b, 1), generator=g, device=device)
        ph = 2 * math.pi * f0 * n / data.sampling_rate
        wav = 0.4 * torch.sin(ph) + 0.2 * torch.sin(2 * ph) \
            + 0.02 * torch.randn((b, n.numel()), generator=g, device=device)
        lengths = torch.as_tensor(frames, device=device)
        wav = wav * (n[None, :] < (lengths[:, None] * hop))
        spec = spectrogram(wav, data.filter_length, hop, data.win_length)
        left = data.filter_length - hop
        ying = self.yingram(torch.nn.functional.pad(wav, (left, left + hop)))
        x = torch.randint(1, int(tr.n_symbols), (b, t_x), generator=g, device=device)
        x[:, ::2] = 0  # the blanks add_blank puts between symbols
        pos = torch.arange(t_x, device=device)
        x_lengths = torch.as_tensor(ids, device=device)
        keep = pos[None, :] < x_lengths[:, None]
        langs = torch.tensor([LANG_IDS[k] for k in ("ZH", "JA", "EN")], device=device)
        t = langs[torch.randint(0, 3, (b, 1), generator=g, device=device)].expand(b, t_x)
        sid = torch.randint(0, int(tr.speakers), (b,), generator=g, device=device)
        return {"x": x * keep, "t": t * keep, "x_lengths": x_lengths, "spec": spec,
                "spec_lengths": lengths, "ying": ying, "wav": wav[:, :, None], "sid": sid,
                "host_frames": frames, "host_ids": ids}


# -- serving ---------------------------------------------------------------

def _clauses(tr) -> dict:
    return json.loads((HERE / "traffic" / f"{tr.clauses}.json").read_text())


def _sentence(parts: list[str], lang: str, target: int, start: int, style: dict) -> str:
    """Clauses from ``start`` (cyclically) joined until the text reaches
    ``target`` characters or the next clause would pass its language's top."""
    sep, end, top = style["sep"], style["end"], style["max"]
    text = parts[start % len(parts)]
    k = start + 1
    while len(text) < target:
        nxt = parts[k % len(parts)]
        if len(text) + len(sep) + len(nxt) + len(end) > top:
            break
        text = text + sep + nxt
        k += 1
    return f"[{lang}]{text}{end}[{lang}]"


def sentence_bank(tr) -> list[tuple[str, str]]:
    """(tagged text, language) of the mix's bank, in a fixed order."""
    clauses = _clauses(tr)
    n = int(tr.bank_size)
    bank = []
    for lang, share in tr.languages.items():
        m = int(round(share * n))
        lo, hi = tr.chars[lang]
        style = dict(clauses[lang]["style"], max=hi)
        parts = clauses[lang]["clauses"]
        for i, target in enumerate(np.rint(_spaced(lo, hi, m)).astype(int)):
            bank.append((_sentence(parts, lang, max(int(target), lo), 7 * i, style), lang))
    return bank


def open_loop(tr, seed: int, seconds: float) -> list[dict]:
    """The requests due in a window of ``seconds``: ``due`` (seconds from
    the window's start), ``text``, ``speaker_id`` and ``seed``."""
    bank = sentence_bank(tr)
    rate = float(tr.rate_per_s)
    n = len(bank)
    gaps = -np.log1p(-_spaced(0.0, 1.0, n)) / rate  # exponential quantiles
    out, t, k = [], 0.0, 0
    while True:
        order = _perm(n, seed, "order", k)
        gap = gaps[_perm(n, seed, "gaps", k)]
        spk = np.random.default_rng(subseed(seed, "speakers", k)).integers(0, int(tr.speakers), n)
        for j in range(n):
            t += float(gap[j])
            if t >= seconds:
                return out
            out.append({"due": t, "text": bank[order[j]][0], "speaker_id": int(spk[j]),
                        "seed": subseed(seed, "request", len(out)) & 0xFFFFFFFF})
        k += 1


def paragraph_bank(tr, count_ids) -> list[str]:
    """Tagged paragraphs of one language each; ``count_ids(text)`` gives a
    text's ids after g2p (the reference frontend's)."""
    bank = sentence_bank(tr)
    by_lang: dict[str, list[str]] = {}
    for text, lang in bank:
        by_lang.setdefault(lang, []).append(text)
    out = []
    langs = list(tr.paragraph_languages)
    for i in range(int(tr.paragraphs)):
        lang = langs[i % len(langs)]
        pool = by_lang[lang]
        body, ids, k = [], 0, 0
        while (ids < int(tr.min_ids) or len(body) < int(tr.min_sentences)) \
                and len(body) < int(tr.max_sentences):
            s = pool[(5 * i + 3 * k) % len(pool)]
            body.append(s[4:-4])
            ids = count_ids(f"[{lang}]" + "".join(body) + f"[{lang}]")
            k += 1
        out.append(f"[{lang}]" + "".join(body) + f"[{lang}]")
    return out


def closed_loop_order(n: int, seed: int, k: int) -> np.ndarray:
    return _perm(n, seed, "paragraphs", k)
