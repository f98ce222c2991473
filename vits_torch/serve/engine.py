"""Serving engine: text -> phonemes -> waveform, with pitch and duration
control (port of ``vits_tpu/serve/engine.py``).

Same public surface, buckets and control flow as the JAX engine: text pads
up to ``TEXT_BUCKETS`` and longer text is split at phrase boundaries; the
frame budget escalates through ``FRAME_BUCKETS`` when the duration predictor
wants more; batched requests are grouped by (text bucket, frame bucket) and
padded to ``BATCH_BUCKETS``; long-form decoding runs in overlapping chunk
windows; voice conversion pads to ``VC_BUCKETS`` and cross-fades windows of
longer audio. Noise scales 0.667 (prior) and 0.8 (durations).

Determinism: each request draws its noise at its own row shape from one
``torch.Generator(device).manual_seed(seed)`` (the JAX engine's per-row
``PRNGKey(seed)``), in a fixed order, and a batch stacks the rows, so a
request's audio does not depend on its batchmates beyond the summation
order of the batched kernels (and, on a CUDA device, beyond the frames its
call decodes: see below). ``noise_fn(seed, shapes)`` replaces those
draws: ``shapes`` maps the model's ``noise`` names to shapes (``sdp_noise``
and ``eps`` for synthesis, ``eps_spec`` and ``eps_yin`` for a VC window) and
it returns float32 arrays of those shapes under those names.

Frame budgets: ``synthesize`` (a paragraph's pieces) and
``synthesize_batch`` (the requests' pieces) run their rows through one loop,
``_budget_walk``. Each row starts at its first budget (``_first_frames``).
A round groups the rows by (text bucket, budget), in first-seen order, and
queues every call before its one host read of the predicted lengths. A row
whose length reached its budget moves to the next frame bucket
(``_next_budget``, the one place of that rule) and is made again in the next
round with the other such rows; its batchmates stand. The walk ends when
every row is under its budget or at the last bucket, so a paragraph that
saturates nothing is one round. ``synthesize`` cuts each group into batch
buckets, largest first, so that no call carries an empty row (a text of one
piece is one call at one row); ``synthesize_batch`` cuts each group into
full calls of the largest batch bucket and pads the rest up to a batch
bucket. A call decodes at or below its budget: eagerly at the budget, and
on a CUDA device at the fewest frames of a ladder of multiples of 128 that
hold its rows' predicted lengths (``serve/graphs.py``; one host read of
the longest inside each call), so that a row's last frames, within the
decoder's reach of that size, depend on its longest batchmate's length.
Rows, groups, noise shapes and escalations follow the budget alone. The
kept audio comes to the host in one copy. The chunked and streaming paths
need the pre-decoder alone and walk the budgets a piece at a time, at
batch 1.

Tracing (``utils/profiling.py``, live while tracing is on): spans
``serve.g2p`` (``get_phoneme``), ``serve.noise``, ``serve.infer`` (a call's
inputs to the device and the model's inference call), ``serve.sync`` (the
predicted lengths to the host, which waits for the queued calls' kernels)
and ``serve.d2h`` (the audio to the host); counters ``serve.requests``
(calls of ``synthesize``, ``synthesize_chunked``, ``synthesize_streaming``
and requests of ``synthesize_batch``), ``serve.infer_calls`` and
``serve.escalations`` (budgeted calls, and rows made again at a larger
frame budget), ``serve.rows`` (the real rows of each budgeted call),
``serve.frames_decoded`` (the frames decoded x rows, padding rows included,
of each budgeted call, read from its audio's length),
``serve.sized_calls`` (budgeted calls decoded below their budget) and
``serve.frames_kept`` (the predicted lengths of the rows whose audio is
returned: the frames of a call at which a row saturated are all decoded and
none kept).

Every call runs under ``torch.inference_mode()`` on the engine's device:
``cuda`` unless ``device`` names another. On a CUDA device the budgeted calls
(``synthesize``'s and ``synthesize_batch``'s calls) are replayed from
CUDA graphs of two stages, captured on first use: up to the predicted
lengths at each (rows, text bucket, frame budget), then the frame work at
each (rows, sized frames) (``serve/graphs.py``; counters
``serve.graph_captures`` and ``serve.graph_replays``); duration and scope
shift go in as [rows] tensors, so one graph serves them all. Elsewhere every
call runs eagerly.
``enable_persistent_cache`` of the JAX engine (XLA's compile cache) has no
counterpart: eager PyTorch compiles nothing.

A configuration without a pitch path (``pitch: none``, as MB-iSTFT-VITS) is
served by ``synthesize``, ``synthesize_batch`` and the chunked and streaming
paths alike, its scope shift unread; ``voice_conversion`` refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.nn import functional as F

from vits_torch.config import load_hparams
from vits_torch.models.synthesizer import build_synthesizer, resolve_device
from vits_torch.ops.commons import intersperse_with_language_id
from vits_torch.serve.graphs import InferGraphs
from vits_torch.text import cleaned_text_to_sequence
from vits_torch.text.cleaners import clean_text
from vits_torch.text.symbols import symbols
from vits_torch.training.checkpoint import load_eval_params
from vits_torch.utils.profiling import count, span

NOISE_SCALE, NOISE_SCALE_W = 0.667, 0.8


def _seed(seed) -> int:
    """The JAX engine's uint32 seed."""
    return int(seed) & 0xFFFFFFFF


def _count_infer(frames: int, rows: int = 1, empty: int = 0, budget: int | None = None) -> None:
    """One budgeted model call that decoded ``frames`` over ``rows`` real
    rows and ``empty`` padding rows, at a budget of ``budget`` (``frames``
    if not given): a call decoded below its budget is a sized call."""
    count("serve.infer_calls")
    count("serve.rows", rows)
    count("serve.frames_decoded", frames * (rows + empty))
    if budget is not None and frames < budget:
        count("serve.sized_calls")


class _Row(NamedTuple):
    """One row of a budgeted call: a piece of text (phoneme and language ids,
    at most the largest text bucket) and its controls."""

    seq: np.ndarray
    lang: np.ndarray
    speaker_id: int
    seed: int
    scope_shift: int
    duration: float


class TTSEngine:
    """Loads a config (and optionally a checkpoint: an ``eval_{step}`` file of
    ``training/checkpoint.py``, or a generator ``state_dict`` saved by
    ``torch.save``; strict) and synthesizes speech; without a checkpoint the
    weights are PyTorch's initialization under the current torch seed.

    Arbitrary-length input: text pads up to TEXT_BUCKETS; text longer than
    the largest bucket is split at phrase boundaries and the pieces are
    synthesized and concatenated, nothing is truncated. The frame budget
    escalates through FRAME_BUCKETS when the duration predictor wants more
    than the current budget.
    """

    TEXT_BUCKETS = (64, 128, 256, 384)
    FRAME_BUCKETS = (256, 512, 1000, 2000)
    BATCH_BUCKETS = (1, 2, 4, 8)
    # audio-length buckets for voice conversion (samples; multiples of hop)
    VC_BUCKETS = (32768, 65536, 131072, 262144, 524288)
    # samples of overlap between successive VC windows; seams cross-fade
    VC_OVERLAP = 8192

    def __init__(
        self,
        config_path: str,
        checkpoint_path: str | None = None,
        max_frames: int = 1000,
        bf16: bool = False,
        device=None,
        noise_fn=None,
    ):
        """bf16=True computes the posterior encoders and the HiFi-GAN decoder
        in bfloat16 (parameters stay f32); the audio differs from f32 at
        bf16 rounding level."""
        self.device = resolve_device(device)
        self.hps = load_hparams(config_path)
        self.model = build_synthesizer(self.hps, device=self.device, bf16=bf16)
        if checkpoint_path is not None:
            self.model.load_state_dict(load_eval_params(checkpoint_path, self.device))
        self.model.eval()
        if self.device.type == "cuda":
            self.model.infer_graphs = InferGraphs()
        self.max_frames = max_frames
        self.sampling_rate = self.hps.data.sampling_rate
        self.hop = self.hps.data.hop_length
        self.noise_fn = noise_fn or self.draw_noise
        self._yingram = None

    def draw_noise(self, seed: int, shapes: dict) -> dict:
        """One generator seeded with ``seed`` on the engine's device; one
        standard-normal draw a name, in the order of ``shapes``."""
        gen = torch.Generator(self.device).manual_seed(seed)
        return {k: torch.randn(s, generator=gen, device=self.device) for k, s in shapes.items()}

    def _noise(self, seeds, shapes: dict) -> dict:
        """Each seed's draws at its row shape ([1, ...]), stacked on the
        batch axis; a seed of None is a padding row (zeros)."""
        rows = []
        for seed in seeds:
            if seed is None:
                rows.append({k: torch.zeros(s, device=self.device) for k, s in shapes.items()})
            else:
                got = self.noise_fn(_seed(seed), shapes)
                rows.append({k: torch.as_tensor(got[k], dtype=torch.float32, device=self.device)
                             for k in shapes})
        return {k: torch.cat([r[k] for r in rows]) for k in shapes}

    def _synth_shapes(self, tx: int, frames: int) -> dict:
        return {"sdp_noise": (1, tx, 2), "eps": (1, frames, self.model.inter_channels)}

    def get_phoneme(self, text: str):
        """Tagged text -> (ids, lang ids, IPA string)."""
        with span("serve.g2p"):
            cleaned_text, lang = clean_text(text)
            seq = cleaned_text_to_sequence(cleaned_text)
            if not seq:
                raise ValueError(
                    "empty phoneme sequence — input must contain language-tagged "
                    "blocks like [EN]...[EN], [ZH]...[ZH], [JA]...[JA], [P]...[P]"
                )
            if self.hps.data.add_blank:
                seq, lang = intersperse_with_language_id(seq, lang, 0)
            return np.asarray(seq, np.int32), np.asarray(lang, np.int32), cleaned_text

    def _bucket(self, n: int) -> int:
        for b in self.TEXT_BUCKETS:
            if n <= b:
                return b
        return self.TEXT_BUCKETS[-1]

    def _frame_buckets(self) -> list[int]:
        buckets = sorted({b for b in self.FRAME_BUCKETS if b < self.max_frames})
        return buckets + [self.max_frames]

    def _first_frames(self, n: int, duration: float) -> int:
        want = int(n * 6 * max(duration, 0.25))
        buckets = self._frame_buckets()
        return next((b for b in buckets if b >= want), buckets[-1])

    def _next_budget(self, frames: int, y_len: int) -> int | None:
        """The budget a row is made again at: the frame bucket after
        ``frames`` if its predicted length ``y_len`` reached ``frames``
        (counted in ``serve.escalations``), else None; None at the last
        bucket too, where the row stands whatever its length."""
        if y_len < frames:
            return None
        frames = next((b for b in self._frame_buckets() if b > frames), None)
        if frames is not None:
            count("serve.escalations")
        return frames

    def _rows(self, seq, lang, speaker_id, seed, scope_shift, duration) -> list[_Row]:
        """A text's pieces (``_split_segments``) as rows, piece i seeded
        seed + i."""
        pieces = self._split_segments(seq, lang, self.TEXT_BUCKETS[-1])
        return [_Row(s, la, speaker_id, seed + i, scope_shift, duration)
                for i, (s, la) in enumerate(pieces)]

    def _split_segments(self, seq, lang, limit: int):
        """Split an over-long phoneme sequence at phrase boundaries (after
        punctuation, else at spaces, else hard) so every piece fits a text
        bucket."""
        punct = {symbols.index(c) for c in ",.!?…~-" if c in symbols}
        space = symbols.index(" ")
        segments = []
        start = 0
        n = len(seq)
        while n - start > limit:
            window = range(start + limit - 1, start, -1)
            cut = next((i for i in window if int(seq[i]) in punct), None)
            if cut is None:
                cut = next((i for i in window if int(seq[i]) == space), None)
            cut = (cut + 1) if cut is not None else start + limit
            segments.append((seq[start:cut], lang[start:cut]))
            start = cut
        segments.append((seq[start:], lang[start:]))
        return [(s, la) for s, la in segments if len(s) > 0]

    def _infer_kwargs(self, duration, scope_shift, frames):
        return dict(noise_scale=NOISE_SCALE, noise_scale_w=NOISE_SCALE_W,
                    length_scale=duration, scope_shift=scope_shift, max_frames=frames)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On a CUDA device the copy goes
        through pinned memory and does not block, so it waits for no call
        queued before it."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _call_inputs(self, rows: list[_Row], tx: int, nb: int):
        """(x, t, x_lengths, sid, durations, scope shifts) of one call over
        ``rows`` padded to ``nb`` rows of ``tx`` ids (a padding row: one id 0,
        speaker 0, duration 1, shift 0), on the device: the integers in one
        copy, the durations in another. Every control is a [nb] tensor, so a
        CUDA graph takes it as an input."""
        ids = np.zeros((2, nb, tx), np.int64)
        per_row = np.zeros((3, nb), np.int64)
        per_row[0] = 1
        durations = np.ones(nb, np.float32)
        for r, row in enumerate(rows):
            n = len(row.seq)
            ids[0, r, :n] = row.seq
            ids[1, r, :n] = row.lang
            per_row[:, r] = n, row.speaker_id, row.scope_shift
            durations[r] = row.duration
        ints = self._to_device(np.concatenate([ids.ravel(), per_row.ravel()]))
        x, t = ints[: ids.size].view(2, nb, tx)
        x_lengths, sid, shifts = ints[ids.size:].view(3, nb)
        return x, t, x_lengths, sid, self._to_device(durations), shifts

    def _calls(self, rows: list[_Row], budgets: list[int], fill: bool):
        """The budgeted calls over ``rows``, row i at frame budget
        ``budgets[i]``: (text bucket, frame budget, the rows' indices, rows
        with padding) each. Rows are grouped by (text bucket, budget), in
        first-seen order, and cut into calls of at most the largest batch
        bucket. With ``fill`` a group is full calls and the rest padded up to
        a batch bucket (11 rows: 8 + 3 in a call of 4); without, it is cut
        into batch buckets, largest first, so that no call carries an empty
        row (5 rows: 4 + 1)."""
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (row, frames) in enumerate(zip(rows, budgets)):
            groups.setdefault((self._bucket(len(row.seq)), frames), []).append(i)
        for (tx, frames), members in groups.items():
            while members:
                n = len(members)
                if fill:
                    nb = next((b for b in self.BATCH_BUCKETS if b >= n), self.BATCH_BUCKETS[-1])
                else:
                    nb = max(b for b in self.BATCH_BUCKETS if b <= n)
                yield tx, frames, members[:nb], nb
                members = members[nb:]

    @torch.inference_mode()
    def _infer_rows(self, rows: list[_Row], budgets: list[int], fill: bool) -> list[tuple]:
        """Every budgeted call over ``rows`` (``_calls``) queued on the device
        before any host sync, each row drawing its noise from its own seed at
        its call's shapes; then every row's predicted length read back in one
        copy. Returns, in row order, (predicted length, audio on the device)
        of each row: the audio of the frames its call decoded, at most its
        budget x hop samples (``serve/graphs.py`` decodes the fewest frames
        that hold the call's rows)."""
        calls = []
        for tx, frames, members, nb in self._calls(rows, budgets, fill):
            seeds = [rows[i].seed for i in members] + [None] * (nb - len(members))
            with span("serve.noise"):
                noise = self._noise(seeds, self._synth_shapes(tx, frames))
            with span("serve.infer"):
                x, t, xl, sid, durations, shifts = self._call_inputs(
                    [rows[i] for i in members], tx, nb)
                wav, _, y_lens = self.model.infer(
                    x, t, xl, sid, noise=noise, **self._infer_kwargs(durations, shifts, frames))
            _count_infer(wav.shape[1] // self.hop, len(members), nb - len(members), frames)
            calls.append((members, wav, y_lens[: len(members)]))
        if not calls:
            return []
        with span("serve.sync"):
            lengths = iter(torch.cat([c[2] for c in calls]).tolist())  # the one host sync
        out: list = [None] * len(rows)
        for members, wav, _ in calls:
            for r, i in enumerate(members):
                out[i] = (next(lengths), wav[r, :, 0])
        return out

    @torch.inference_mode()
    def _budget_walk(self, rows: list[_Row], fill: bool) -> list[torch.Tensor]:
        """Each row's audio on the device, its predicted length long: rounds
        of ``_infer_rows``, the first over every row at its first budget,
        each next over the rows that ``_next_budget`` moved on."""
        budgets = [self._first_frames(len(row.seq), row.duration) for row in rows]
        audio: list = [None] * len(rows)
        todo = list(range(len(rows)))
        while todo:
            redo = []
            done = self._infer_rows([rows[i] for i in todo], [budgets[i] for i in todo], fill)
            for i, (y_len, wav) in zip(todo, done):
                frames = self._next_budget(budgets[i], y_len)
                if frames is None:
                    count("serve.frames_kept", y_len)
                    audio[i] = wav[: y_len * self.hop]
                else:
                    budgets[i] = frames
                    redo.append(i)
            todo = redo
        return audio

    def _to_host(self, parts: list[torch.Tensor]) -> np.ndarray:
        """Audio pieces on the device, concatenated, to the host in one copy."""
        if not parts:
            return np.zeros(0, np.float32)
        with span("serve.d2h"):
            return torch.cat(parts).float().cpu().numpy()

    @torch.inference_mode()
    def synthesize(
        self,
        text: str,
        speaker_id: int = 0,
        seed: int = 0,
        scope_shift: int = 0,
        duration: float = 1.0,
    ):
        """Returns (ipa_string, (sampling_rate, waveform np.ndarray)).

        Never truncates: long inputs are split at phrase boundaries and the
        pieces concatenated, piece i drawing its noise from seed + i. The
        pieces run as batched calls, each round's queued before one host
        sync."""
        count("serve.requests")
        seq, lang, phones = self.get_phoneme(text)
        rows = self._rows(seq, lang, speaker_id, seed, scope_shift, duration)
        return phones, (self.sampling_rate, self._to_host(self._budget_walk(rows, fill=False)))

    @torch.inference_mode()
    def synthesize_batch(self, requests: list[dict]):
        """Batched synthesis for dynamic-batching servers.

        requests: list of dicts with keys text, and optionally speaker_id,
        seed, scope_shift, duration. Returns a list in request order whose
        entries are np.float32 waveforms, or the per-request Exception for
        entries that failed (a bad request never poisons its batchmates).
        Every request's pieces (one, unless its phoneme sequence exceeds the
        largest text bucket) are rows of one budget walk: grouped by
        (text-bucket, frame-bucket), cut into calls of at most the largest
        batch bucket and the rest padded up to BATCH_BUCKETS, each row with
        its own noise, duration and scope shift, every call of a round
        queued before one host sync. A request's audio is its pieces'
        concatenated.
        """
        count("serve.requests", len(requests))
        results: list[np.ndarray | Exception | None] = [None] * len(requests)
        rows, owners = [], []  # owners: (request, its first row, its rows)
        for i, req in enumerate(requests):
            try:
                seq, lang, _ = self.get_phoneme(req["text"])
            except Exception as e:
                # a bad request (e.g. untagged text) yields its exception
                results[i] = e
                continue
            pieces = self._rows(seq, lang, int(req.get("speaker_id", 0)), int(req.get("seed", 0)),
                                int(req.get("scope_shift", 0)), float(req.get("duration", 1.0)))
            owners.append((i, len(rows), len(pieces)))
            rows += pieces
        parts = self._budget_walk(rows, fill=True)
        audio = self._to_host(parts)
        offsets = np.cumsum([0] + [len(p) for p in parts])
        for i, first, n in owners:
            results[i] = audio[offsets[first]: offsets[first + n]]
        return results

    def synthesize_chunked(
        self,
        text: str,
        speaker_id: int = 0,
        seed: int = 0,
        scope_shift: int = 0,
        duration: float = 1.0,
        chunk_frames: int = 128,
        overlap_frames: int = 16,
    ):
        """Long-form synthesis with bounded decoder memory: the staged path
        (text encoder -> durations -> length regulation -> reverse flow)
        once, then the decoder over fixed-size chunks with overlap margins
        covering the HiFi-GAN receptive field, the margins trimmed after
        decoding. Memory stays O(chunk) whatever the text length."""
        phones, chunks = self._chunk_stream(
            text, speaker_id, seed, scope_shift, duration, chunk_frames, overlap_frames
        )
        pieces = list(chunks)
        audio = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        return phones, (self.sampling_rate, audio)

    def synthesize_streaming(
        self,
        text: str,
        speaker_id: int = 0,
        seed: int = 0,
        scope_shift: int = 0,
        duration: float = 1.0,
        chunk_frames: int = 128,
        overlap_frames: int = 16,
    ):
        """Streaming synthesis: returns (ipa_string, chunk_iterator).

        The iterator yields np.float32 audio chunks (chunk_frames * hop
        samples each, except the last) as they come off the device; the first
        arrives after one text encode and one chunk decode instead of the
        whole utterance. Concatenating all chunks is bit-identical to
        synthesize_chunked."""
        return self._chunk_stream(
            text, speaker_id, seed, scope_shift, duration, chunk_frames, overlap_frames
        )

    def _chunk_stream(
        self, text, speaker_id, seed, scope_shift, duration, chunk_frames, overlap_frames
    ):
        count("serve.requests")
        seq, lang, phones = self.get_phoneme(text)
        rows = self._rows(seq, lang, speaker_id, seed, scope_shift, duration)
        return phones, self._chunk_iter(rows, chunk_frames, overlap_frames)

    @torch.inference_mode()
    def _chunk_iter(self, rows: list[_Row], chunk_frames, overlap_frames):
        for row in rows:
            tx = self._bucket(len(row.seq))
            x, t, xl, sid, _, _ = self._call_inputs([row], tx, 1)
            frames = self._first_frames(len(row.seq), row.duration)
            while frames is not None:
                with span("serve.noise"):
                    noise = self._noise([row.seed], self._synth_shapes(tx, frames))
                with span("serve.infer"):
                    dec_inputs, _, y_lengths, _ = self.model.infer_pre_decoder(
                        x, t, xl, sid, noise=noise,
                        **self._infer_kwargs(row.duration, row.scope_shift, frames)
                    )
                with span("serve.sync"):
                    total = int(y_lengths[0])
                _count_infer(frames)
                frames = self._next_budget(frames, total)
            count("serve.frames_kept", total)
            dec_inputs = dec_inputs[0]  # [T, C], stays on the device

            # dispatch every chunk's decode before fetching any, so decodes
            # queue on the device while earlier chunks go to the caller
            pending = []
            pos = 0
            while pos < total:
                lo = max(0, pos - overlap_frames)
                hi = min(total, pos + chunk_frames + overlap_frames)
                window = dec_inputs.new_zeros(
                    (1, chunk_frames + 2 * overlap_frames, dec_inputs.shape[-1])
                )
                window[0, : hi - lo] = dec_inputs[lo:hi]
                start = (pos - lo) * self.hop
                end = start + min(chunk_frames, total - pos) * self.hop
                with span("serve.infer"):
                    pending.append((self.model.infer_decode_chunk(window, sid), start, end))
                pos += chunk_frames
            for wav_chunk, start, end in pending:
                with span("serve.d2h"):
                    audio = wav_chunk[0, start:end, 0].float().cpu().numpy()
                yield audio

    def voice_conversion(self, wav: np.ndarray, sid_src: int, sid_tgt: int, seed: int = 0):
        """Waveform -> target-speaker waveform via the shared flow.

        Input pads up to VC_BUCKETS; the padded tail is masked out via the
        true frame count and trimmed. Audio longer than the largest bucket is
        converted in overlapping bucket-sized windows cross-faded at the
        seams; nothing is truncated. A model without a pitch path raises."""
        if not self.model.has_pitch:
            raise ValueError("voice conversion needs a model with the pitch path; this "
                             "configuration has none (pitch: none)")
        n = len(wav)
        limit = self.VC_BUCKETS[-1]
        if n <= limit:
            return self._vc_window(wav, sid_src, sid_tgt, seed)
        step = limit - self.VC_OVERLAP
        out = np.zeros(n, np.float32)
        weight = np.zeros(n, np.float32)
        ramp = np.linspace(0.0, 1.0, self.VC_OVERLAP, dtype=np.float32)
        for start in range(0, n, step):
            piece = wav[start : start + limit]
            conv = self._vc_window(piece, sid_src, sid_tgt, seed)
            m = len(conv)
            w = np.ones(m, np.float32)
            if start > 0:
                w[: self.VC_OVERLAP] = ramp[:m]
            if start + limit < n:
                w[-self.VC_OVERLAP :] = ramp[::-1][-m:]
            out[start : start + m] += conv * w
            weight[start : start + m] += w
            if start + limit >= n:
                break
        return out / np.maximum(weight, 1e-8)

    @torch.inference_mode()
    def _vc_window(self, wav: np.ndarray, sid_src: int, sid_tgt: int, seed: int):
        """STFT + yingram + flow VC of one window padded to its bucket."""
        from vits_torch.ops.stft import spectrogram
        from vits_torch.ops.yin import Yingram

        d = self.hps.data
        hop = d.hop_length
        if self._yingram is None:
            self._yingram = Yingram(d.sampling_rate, hop, 2048, d.tau_max, d.midi_start,
                                    d.midi_end, d.octave_range)
        n = len(wav)
        bucket = next((b for b in self.VC_BUCKETS if b >= n), self.VC_BUCKETS[-1])
        wav_p = np.zeros((1, bucket), np.float32)
        m = min(n, bucket)
        wav_p[0, :m] = wav[:m]
        true_frames = m // hop
        wav_t = torch.from_numpy(wav_p).to(self.device)
        spec = spectrogram(wav_t, d.filter_length, hop, d.win_length)
        # the bucket is a multiple of hop, so the right pad is fixed
        left = d.filter_length - hop
        ying = self._yingram(F.pad(wav_t, (left, left + hop)))
        frames = min(spec.shape[1], ying.shape[1])
        model = self.model
        noise = self._noise([seed], {
            "eps_spec": (1, frames, model.inter_channels - model.yin_channels),
            "eps_yin": (1, frames, model.yin_channels),
        })
        dev = self.device
        o_hat, _, _ = model.voice_conversion(
            spec[:, :frames], ying[:, :frames], torch.tensor([min(true_frames, frames)], device=dev),
            torch.tensor([sid_src], device=dev), torch.tensor([sid_tgt], device=dev), noise=noise,
        )
        return o_hat[0, : true_frames * hop, 0].float().cpu().numpy()


def main():
    import argparse

    import scipy.io.wavfile

    parser = argparse.ArgumentParser(description="vits_torch synthesis CLI")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-p", "--checkpoint", default=None,
                        help="eval_{step} checkpoint or generator state_dict")
    parser.add_argument("-t", "--text", required=True,
                        help="tagged text, e.g. '[EN]hello[EN]'")
    parser.add_argument("-o", "--output", default="out.wav")
    parser.add_argument("-s", "--speaker", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scope-shift", type=int, default=0)
    parser.add_argument("--duration", type=float, default=1.0)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute in the heavy submodules")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()

    torch.manual_seed(args.seed)  # the weights when no checkpoint is given
    engine = TTSEngine(args.config, args.checkpoint, bf16=args.bf16, device=args.device)
    phones, (sr, audio) = engine.synthesize(
        args.text, args.speaker, args.seed, args.scope_shift, args.duration
    )
    scipy.io.wavfile.write(args.output, sr, audio)
    print(f"phonemes: {phones}")
    print(f"wrote {args.output} ({len(audio) / sr:.2f}s @ {sr} Hz)")


if __name__ == "__main__":
    main()
