"""Host-side data pipeline: filelists -> cached features -> bucketed batches
(port of ``vits_tpu/data/dataset.py``).

Behavioral reference: reference TextAudioSpeakerLoader.py,
TextAudioSpeakerCollate.py, DistributedBucketSampler.py, utils.py:170-194.

The same semantics as the JAX package, byte for byte:
  * features cached as .spec.npy / .ying.npy next to the wavs (float64 host
    spectrogram, the reference Yingram padding), so either package reads the
    other's caches; for a pitchless model (``DatasetConfig.pitch`` False) no
    Yingram is computed or cached
  * batches are padded to STATIC bucket shapes: spec/ying/wav to the
    bucket's frame bound, text to a fixed bound
  * the sampler: per-bucket epoch-seeded shuffle, pad-to-multiple by
    repeating indices, rank-strided subsampling ids[rank::num_replicas]
    (DistributedBucketSampler.py:95-146)

In place of the JAX package's thread-pool ``DataIterator``: ``make_loader``,
a ``torch.utils.data.DataLoader`` whose sampler yields whole batches
(bucket index, item indices) and whose workers each load and collate one
batch; the batches come out in the sampler's order. Workers touch no CUDA
(PyTorch refuses it in a forked child). They are forked from the trainer
itself: a worker starts without importing anything (spawned workers took
~16 s to start on the card's 8-core host), is a child of the trainer that
the loader joins when it shuts down, and leaves no server process behind
(a ``forkserver`` outlives the loader and the trainer).
"""

from __future__ import annotations

import multiprocessing
import os
import random
from bisect import bisect_left
from dataclasses import dataclass

import numpy as np
import scipy.io.wavfile
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from vits_torch.ops.commons import intersperse_with_language_id
from vits_torch.ops.yin import yingram_numpy


def load_filepaths_and_text(filename: str, split: str = "|") -> list[list[str]]:
    """Parse `path|speaker|text|lang_seq` lines (reference utils.py:191-194)."""
    with open(filename, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]


def load_wav(full_path: str) -> tuple[np.ndarray, int]:
    """Load + normalize to float32 [-1, 1] (reference utils.py:170-188)."""
    sr, data = scipy.io.wavfile.read(full_path)
    if data.dtype == np.int16:
        norm = 32768.0
    elif data.dtype == np.int32:
        norm = 2147483648.0
    elif data.dtype == np.uint8:
        data = data.astype(np.int16) - 128
        norm = 128.0
    else:
        norm = 1.0
    return (data / norm).astype(np.float32), sr


def _save_cache(path: str, array: np.ndarray) -> None:
    """np.save's bytes, written to a temporary name and renamed: another
    process (a loader worker of another rank) never reads half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.save(f, array)
    os.replace(tmp, path)


def _spectrogram_numpy(audio: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """Host-side float64 spectrogram matching ops.stft.spectrogram semantics
    (reflect pad, center=False, periodic hann, sqrt(.+1e-6)). [T] -> [T', F]."""
    pad = (n_fft - hop) // 2
    y = np.pad(audio.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    spec = np.fft.rfft(frames * window[None, :], n=n_fft, axis=-1)
    return np.sqrt(spec.real**2 + spec.imag**2 + 1e-6).astype(np.float32)


@dataclass
class DatasetConfig:
    data_path: str
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    add_blank: bool = True
    min_text_len: int = 1
    max_text_len: int = 190
    midi_start: int = -5
    midi_end: int = 75
    octave_range: int = 24
    tau_max: int = 2048
    speakers: tuple = ()
    # False for a pitchless model: no Yingram is computed or cached, and an
    # item's ``ying`` is an empty [T', 0] array
    pitch: bool = True


class TextAudioSpeakerDataset(Dataset):
    """Filelist-backed dataset with on-disk feature caches.

    Text is expected pre-cleaned (the `.clr.csv` format: IPA string + space-
    joined language ids, reference preprocess.py:20-34).
    """

    def __init__(self, filelist: str, cfg: DatasetConfig, pt_run: bool = False):
        self.cfg = cfg
        self.items = load_filepaths_and_text(filelist)
        self.speaker_dict = {s: i for i, s in enumerate(cfg.speakers)}
        random.Random(114514).shuffle(self.items)  # reference seed (:49-51)
        self._filter()
        if pt_run:
            for it in self.items:
                self._get_audio(it[0], pt_run=True)

    def _filter(self):
        items_new, lengths = [], []
        for item in self.items:
            if len(item) < 4:
                continue
            wav_path, spk, text, lang = item[:4]
            if not (self.cfg.min_text_len <= len(text) <= self.cfg.max_text_len):
                continue
            full = os.path.join(self.cfg.data_path, wav_path)
            if not os.path.exists(full):
                full = wav_path
                if not os.path.exists(full):
                    continue
            items_new.append([full, spk, text, lang])
            # length estimate from file size (reference :90)
            lengths.append(os.path.getsize(full) // (2 * self.cfg.hop_length))
        self.items = items_new
        self.lengths = lengths

    def __len__(self):
        return len(self.items)

    def _get_audio(self, filename: str, pt_run: bool = False):
        cfg = self.cfg
        audio, sr = load_wav(filename)
        if sr != cfg.sampling_rate:
            raise ValueError(f"{filename}: {sr} != {cfg.sampling_rate}")
        spec_file = filename.replace(".wav", ".spec.npy")
        ying_file = filename.replace(".wav", ".ying.npy")

        if os.path.exists(spec_file) and not pt_run:
            spec = np.load(spec_file)
        else:
            spec = _spectrogram_numpy(
                audio, cfg.filter_length, cfg.hop_length, cfg.win_length
            )
            _save_cache(spec_file, spec)

        if not cfg.pitch:
            ying = np.zeros((spec.shape[0], 0), np.float32)
        elif os.path.exists(ying_file) and not pt_run:
            ying = np.load(ying_file)
        else:
            # reference padding (TextAudioSpeakerLoader.py:140-148)
            n = len(audio)
            left = cfg.filter_length - cfg.hop_length
            right = (
                left
                + (-n) % cfg.hop_length
                + cfg.hop_length * (n % cfg.hop_length == 0)
            )
            padded = np.pad(audio, (left, right))
            ying = yingram_numpy(
                padded[None, :], cfg.sampling_rate, cfg.hop_length,
                cfg.tau_max, cfg.tau_max, cfg.midi_start, cfg.midi_end,
                cfg.octave_range,
            )[0].astype(np.float32)
            _save_cache(ying_file, ying)
        return spec, ying, audio

    def _get_text(self, text: str, lang: str):
        from vits_torch.text import cleaned_text_to_sequence

        seq = cleaned_text_to_sequence(text)
        lang_ids = [int(i) for i in lang.split(" ")]
        if self.cfg.add_blank:
            seq, lang_ids = intersperse_with_language_id(seq, lang_ids, 0)
        return np.asarray(seq, np.int32), np.asarray(lang_ids, np.int32)

    def __getitem__(self, index: int):
        wav_path, spk, text, lang = self.items[index]
        seq, lang_ids = self._get_text(text, lang)
        spec, ying, audio = self._get_audio(wav_path)
        sid = self.speaker_dict.get(spk, 0)
        return {
            "text": seq,
            "lang": lang_ids,
            "spec": spec,     # [T', F]
            "ying": ying,     # [T'', M]
            "wav": audio,     # [T]
            "sid": sid,
        }


class DistributedBucketSampler(Sampler):
    """Length-bucketed, padded, rank-strided batch sampler
    (reference DistributedBucketSampler.py:31-176). Iterating yields one
    ``(bucket_idx, item indices)`` pair a batch, in the JAX package's order."""

    def __init__(
        self,
        lengths: list[int],
        batch_size: int,
        boundaries: list[int],
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
    ):
        self.lengths = lengths
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0
        self.buckets, self.num_samples_per_bucket = self._create_buckets()
        self.total_size = sum(self.num_samples_per_bucket)
        self.num_samples = self.total_size // num_replicas

    def _bisect(self, x):
        i = bisect_left(self.boundaries, x)
        if 0 < i < len(self.boundaries):
            return i - 1
        return -1

    def _create_buckets(self):
        buckets = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(self.lengths):
            idx = self._bisect(length)
            if idx != -1:
                buckets[idx].append(i)
        for i in range(len(buckets) - 1, -1, -1):
            if len(buckets[i]) == 0:
                buckets.pop(i)
                self.boundaries.pop(i + 1)
        num_samples = []
        total_batch = self.num_replicas * self.batch_size
        for bucket in buckets:
            rem = (total_batch - (len(bucket) % total_batch)) % total_batch
            num_samples.append(len(bucket) + rem)
        return buckets, num_samples

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def bucket_bound(self, bucket_idx: int) -> int:
        """Static frame bound for batches from this bucket."""
        return self.boundaries[bucket_idx + 1]

    def __iter__(self):
        g = np.random.default_rng(self.epoch)
        if self.shuffle:
            indices = [g.permutation(len(b)).tolist() for b in self.buckets]
        else:
            indices = [list(range(len(b))) for b in self.buckets]

        batches = []
        for i, bucket in enumerate(self.buckets):
            ids = indices[i]
            len_bucket = len(bucket)
            rem = self.num_samples_per_bucket[i] - len_bucket
            ids = ids + ids * (rem // len_bucket) + ids[: rem % len_bucket]
            ids = ids[self.rank :: self.num_replicas]
            for j in range(len(ids) // self.batch_size):
                batch = [
                    bucket[k]
                    for k in ids[j * self.batch_size : (j + 1) * self.batch_size]
                ]
                batches.append((i, batch))
        if self.shuffle:
            order = g.permutation(len(batches)).tolist()
            batches = [batches[i] for i in order]
        return iter(batches)

    def __len__(self):
        return self.num_samples // self.batch_size


def collate_static(
    items: list[dict],
    frame_bound: int,
    hop_length: int,
    text_bound: int = 384,
) -> dict:
    """Zero-pad a batch to STATIC shapes (reference collate:16-96 pads to the
    batch max; here to the bucket bound). Batch is sorted by spec length
    descending like the reference."""
    order = np.argsort([-it["spec"].shape[0] for it in items])
    items = [items[i] for i in order]
    b = len(items)
    wav_bound = frame_bound * hop_length

    x = np.zeros((b, text_bound), np.int32)
    t = np.zeros((b, text_bound), np.int32)
    x_lengths = np.zeros((b,), np.int32)
    spec = np.zeros((b, frame_bound, items[0]["spec"].shape[1]), np.float32)
    ying = np.zeros((b, frame_bound, items[0]["ying"].shape[1]), np.float32)
    wav = np.zeros((b, wav_bound, 1), np.float32)
    spec_lengths = np.zeros((b,), np.int32)
    sid = np.zeros((b,), np.int32)

    for i, it in enumerate(items):
        n = min(len(it["text"]), text_bound)
        x[i, :n] = it["text"][:n]
        t[i, :n] = it["lang"][:n]
        x_lengths[i] = n
        sf = min(it["spec"].shape[0], frame_bound)
        spec[i, :sf] = it["spec"][:sf]
        yf = min(it["ying"].shape[0], frame_bound)
        ying[i, :yf] = it["ying"][:yf]
        wf = min(len(it["wav"]), wav_bound)
        wav[i, :wf, 0] = it["wav"][:wf]
        spec_lengths[i] = sf
        sid[i] = it["sid"]

    return {
        "x": x, "t": t, "x_lengths": x_lengths,
        "spec": spec, "spec_lengths": spec_lengths,
        "ying": ying, "wav": wav, "sid": sid,
    }


class BucketBatches(Dataset):
    """Whole static batches of ``dataset``: key ``(bucket_idx, indices)`` (what
    ``DistributedBucketSampler`` yields) -> ``collate_static`` of those items
    at the bucket's frame bound, as tensors."""

    def __init__(self, dataset: TextAudioSpeakerDataset, bounds: list[int], text_bound: int):
        self.dataset = dataset
        self.bounds = list(bounds)
        self.text_bound = text_bound

    def __getitem__(self, key):
        bucket_idx, idxs = key
        batch = collate_static(
            [self.dataset[i] for i in idxs], self.bounds[bucket_idx + 1],
            self.dataset.cfg.hop_length, self.text_bound,
        )
        return {k: torch.from_numpy(v) for k, v in batch.items()}


def make_loader(
    dataset: TextAudioSpeakerDataset,
    sampler: DistributedBucketSampler,
    text_bound: int = 384,
    num_workers: int = 4,
    pin_memory: bool = False,
) -> DataLoader:
    """The batches of ``sampler`` (bucket by bucket, in its order, a new order
    each ``set_epoch``), loaded and collated by ``num_workers`` processes
    that live as long as the loader (0: in this process). With
    ``pin_memory`` the batches arrive in page-locked memory, ready for an
    asynchronous copy to the card."""
    return DataLoader(
        BucketBatches(dataset, sampler.boundaries, text_bound),
        sampler=sampler,
        batch_size=None,
        num_workers=num_workers,
        multiprocessing_context=multiprocessing.get_context("fork") if num_workers else None,
        persistent_workers=num_workers > 0,
        pin_memory=pin_memory,
    )
