"""The port's data pipeline against the JAX package's, on the CPU, all exact:
dataset items and the feature caches either package writes (read by the
other), the bucket sampler's batches for several epochs on every rank,
``collate_static``, the port's DataLoader against the JAX ``DataIterator``,
and ``preprocess_filelist`` output byte for byte.

Inputs: int16 noise wavs of a few lengths written with a numpy seed, one
copy of the directory a package (each writes its own .spec.npy / .ying.npy
caches), and pre-cleaned filelists. Tolerance: none; every array, dtype and
byte must match.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from vits_tpu.data import cache_features as jcache
from vits_tpu.data import dataset as jds
from vits_tpu.data import preprocess as jpre

from vits_torch.data import cache_features as cache
from vits_torch.data import dataset as ds
from vits_torch.data import preprocess as pre

FRAMES = [40, 60, 80, 120, 20, 90, 140, 70, 55]  # 20 is below the first boundary
BOUNDARIES = [32, 64, 100, 150]
TEXTS = ["ni→xɑʊ↓↑", "hɛloʊ wəɹɫd", "konn^itʃiwa", "ʃi↓ tsʰɛ↓", "ðə kwɪk bɹaʊn fɑks"]
SPEAKERS = ("S0", "S1", "S2")


def _write_wavs(d, rng):
    lines = []
    for i, n_frames in enumerate(FRAMES):
        wav = (rng.standard_normal(n_frames * 256) * 3000).astype(np.int16)
        scipy.io.wavfile.write(d / f"utt{i}.wav", 22050, wav)
        text = TEXTS[i % len(TEXTS)]
        lang = " ".join([str(i % 4)] * len(text))
        # relative paths (joined to data_path) and one absolute
        path = d / f"utt{i}.wav" if i == 3 else f"utt{i}.wav"
        lines.append(f"{path}|S{i % 3}|{text}|{lang}")
    lines.append("missing.wav|S0|ni|0 0")  # filtered: no such file
    lines.append(f"utt0.wav|S0|{'a' * 30}|{' '.join(['0'] * 30)}")  # filtered: too long
    (d / "train.clr.csv").write_text("\n".join(lines), encoding="utf-8")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(JAX's copy, the port's copy) of one dataset directory."""
    root = tmp_path_factory.mktemp("data")
    a = root / "jax"
    a.mkdir()
    _write_wavs(a, np.random.default_rng(0))
    b = root / "port"
    shutil.copytree(a, b)
    # the absolute path in the port's filelist points into its own copy
    fl = b / "train.clr.csv"
    fl.write_text(fl.read_text(encoding="utf-8").replace(str(a), str(b)), encoding="utf-8")
    return a, b


def _cfgs(d, max_text_len=20):
    kw = dict(data_path=str(d), speakers=SPEAKERS, max_text_len=max_text_len)
    return jds.DatasetConfig(**kw), ds.DatasetConfig(**kw)


def _datasets(dj, dp):
    cj, _ = _cfgs(dj)
    _, cp = _cfgs(dp)
    return (jds.TextAudioSpeakerDataset(str(dj / "train.clr.csv"), cj),
            ds.TextAudioSpeakerDataset(str(dp / "train.clr.csv"), cp))


def _assert_items_equal(ref, out):
    assert set(out) == set(ref)
    for k in ref:
        if k == "sid":
            assert out[k] == ref[k]
            continue
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def both(dirs):
    """Both datasets after every item was read once: each copy holds the
    caches its package wrote."""
    jset, pset = _datasets(*dirs)
    items = [(jset[i], pset[i]) for i in range(len(jset))]
    return jset, pset, items


def test_dataset_filter_order_and_lengths_equal(both):
    jset, pset, _ = both
    assert len(pset) == len(jset) == len(FRAMES)
    assert pset.lengths == jset.lengths
    assert [it[1:] for it in pset.items] == [it[1:] for it in jset.items]
    assert [it[0].rsplit("/", 1)[1] for it in pset.items] == \
        [it[0].rsplit("/", 1)[1] for it in jset.items]
    assert pset.speaker_dict == jset.speaker_dict
    assert isinstance(pset, torch.utils.data.Dataset)


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_dataset_item_equal(both, i):
    _, _, items = both
    _assert_items_equal(*items[i])


@pytest.mark.parametrize("kind", ["spec", "ying"])
def test_feature_caches_byte_equal(both, dirs, kind):
    a, b = dirs
    names = sorted(p.name for p in a.glob(f"*.{kind}.npy"))
    assert len(names) == len(FRAMES)
    assert names == sorted(p.name for p in b.glob(f"*.{kind}.npy"))
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("reader", ["port reads JAX caches", "JAX reads port caches"])
def test_caches_read_by_the_other_package(both, dirs, reader):
    a, b = dirs
    jset, pset, items = both
    if reader == "port reads JAX caches":
        _, cp = _cfgs(a)
        other = ds.TextAudioSpeakerDataset(str(a / "train.clr.csv"), cp)
        refs = [r for r, _ in items]
    else:
        cj, _ = _cfgs(b)
        other = jds.TextAudioSpeakerDataset(str(b / "train.clr.csv"), cj)
        refs = [o for _, o in items]
    for i, ref in enumerate(refs):
        _assert_items_equal(ref, other[i])


def test_cache_features_cli_byte_equal(tmp_path):
    """Both packages' cache_features over a config write the same caches."""
    import yaml

    copies = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        _write_wavs(d, np.random.default_rng(5))
        cfg = {"data": {
            "data_path": str(d), "training_files": str(d / "train.clr.csv"),
            "validation_files": str(d / "train.clr.csv"), "sampling_rate": 22050,
            "filter_length": 1024, "hop_length": 256, "win_length": 1024,
            "add_blank": True, "speakers": list(SPEAKERS), "midi_start": -5,
            "midi_end": 75, "octave_range": 24, "tau_max": 2048, "max_text_len": 20,
        }}
        (d / "config.yaml").write_text(yaml.safe_dump(cfg))
        copies.append(d)
    a, b = copies
    import sys

    argv = sys.argv
    try:
        sys.argv = ["cache_features", "-c", str(a / "config.yaml")]
        jcache.main()
    finally:
        sys.argv = argv
    cache.main(["-c", str(b / "config.yaml")])
    names = sorted(p.name for p in a.glob("*.npy"))
    assert len(names) == 2 * len(FRAMES)
    assert names == sorted(p.name for p in b.glob("*.npy"))
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
def test_load_wav_equal(tmp_path, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000)
    data = {
        "int16": (x * 3000).astype(np.int16), "int32": (x * 2e8).astype(np.int32),
        "uint8": (x * 40 + 128).clip(0, 255).astype(np.uint8),
        "float32": (x * 0.3).astype(np.float32),
    }[dtype]
    path = str(tmp_path / "a.wav")
    scipy.io.wavfile.write(path, 16000, data)
    ref, out = jds.load_wav(path), ds.load_wav(path)
    assert out[1] == ref[1] == 16000
    assert out[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_array_equal(out[0], ref[0])


def _lengths():
    rng = np.random.default_rng(1)
    # outliers at both ends, an empty bucket (500-600), buckets of odd sizes
    return [int(v) for v in rng.integers(10, 500, 61)] + [700, 5, 1600]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("num_replicas,rank", [(1, 0), (2, 0), (2, 1)])
def test_sampler_batches_equal(num_replicas, rank, shuffle):
    lengths, bounds = _lengths(), [32, 100, 200, 300, 500, 600, 800]
    kw = dict(num_replicas=num_replicas, rank=rank, shuffle=shuffle)
    ref = jds.DistributedBucketSampler(lengths, 4, bounds, **kw)
    out = ds.DistributedBucketSampler(lengths, 4, bounds, **kw)
    assert isinstance(out, torch.utils.data.Sampler)
    assert out.boundaries == ref.boundaries and out.buckets == ref.buckets
    assert out.num_samples_per_bucket == ref.num_samples_per_bucket
    assert len(out) == len(ref)
    assert [out.bucket_bound(i) for i in range(len(out.buckets))] == \
        [ref.bucket_bound(i) for i in range(len(ref.buckets))]
    for epoch in range(4):
        ref.set_epoch(epoch)
        out.set_epoch(epoch)
        got = list(out)
        assert got == list(ref), epoch
        assert len(got) == len(out)


@pytest.mark.parametrize("frame_bound,text_bound", [(150, 64), (64, 9), (100, 384)])
def test_collate_static_exact(both, frame_bound, text_bound):
    """Including spec/wav/text longer than their bounds (truncated)."""
    _, _, items = both
    ref = jds.collate_static([r for r, _ in items], frame_bound, 256, text_bound)
    out = ds.collate_static([o for _, o in items], frame_bound, 256, text_bound)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal_data_iterator(dirs, num_workers):
    """Two epochs of the port's DataLoader against the JAX DataIterator:
    the same batches in the same order, arrays and dtypes exact."""
    jset, pset = _datasets(*dirs)
    js = jds.DistributedBucketSampler(jset.lengths, 2, BOUNDARIES, shuffle=True)
    ps = ds.DistributedBucketSampler(pset.lengths, 2, BOUNDARIES, shuffle=True)
    loader = ds.make_loader(pset, ps, text_bound=48, num_workers=num_workers)
    try:
        for epoch in range(2):
            js.set_epoch(epoch)
            ps.set_epoch(epoch)
            ref = list(jds.DataIterator(jset, js, text_bound=48, num_workers=2))
            out = list(loader)
            assert len(out) == len(ref) == len(ps)
            for r, o in zip(ref, out):
                assert set(o) == set(r)
                for k in r:
                    assert isinstance(o[k], torch.Tensor)
                    assert o[k].numpy().dtype == r[k].dtype, k
                    np.testing.assert_array_equal(o[k].numpy(), r[k], err_msg=k)
    finally:
        del loader


def _children() -> set[int]:
    """Pids of this process's live children (Linux /proc)."""
    me, pids = os.getpid(), set()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            state, ppid = stat.read_text().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError, IndexError):
            continue
        if int(ppid) == me and state != "Z":
            pids.add(int(stat.parent.name))
    return pids


def test_loader_leaves_no_process(dirs):
    """The loader's workers are children of this process, and closing the
    loader as the train loop does ends every process the loader started: no
    worker, fork server or resource tracker outlives it."""
    from vits_torch.training.train import _close_loader

    _, pset = _datasets(*dirs)
    ps = ds.DistributedBucketSampler(pset.lengths, 2, BOUNDARIES, shuffle=True)
    before = _children()
    loader = ds.make_loader(pset, ps, text_bound=48, num_workers=2)
    assert len(list(loader)) == len(ps)
    workers = {w.pid for w in loader._iterator._workers}
    assert len(workers) == 2 and workers <= _children() - before
    _close_loader(loader)
    assert _children() - before == set()


RAW = [
    "wavs/a.wav|MY|[ZH]今天天气很好，我们一起去公园散步吧。[ZH]",
    "wavs/b.wav|SR|[JA]こんにちは、今日は東京で友達と会います。[JA]",
    "wavs/c.wav|NA|[EN]The quick brown fox jumps over the lazy dog, it's 3 PM.[EN]",
    "wavs/d.wav|GT|[ZH]你好[ZH][EN]nice to meet you[EN][JA]よろしく[JA]",
    "",
    "wavs/e.wav|SF|[P]ni3#hao3 shi4#jie4[P]",
]


@pytest.mark.parametrize("text_index", [2, 1])
def test_preprocess_filelist_byte_equal(tmp_path, text_index):
    lines = RAW if text_index == 2 else ["|".join(ln.split("|")[1:]) for ln in RAW if ln]
    for name in ("jax", "port"):
        (tmp_path / f"{name}.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    ref = jpre.preprocess_filelist(str(tmp_path / "jax.csv"), text_index=text_index)
    out = pre.preprocess_filelist(str(tmp_path / "port.csv"), text_index=text_index)
    assert out.endswith("port.clr.csv") and ref.endswith("jax.clr.csv")
    data = open(out, "rb").read()
    assert data == open(ref, "rb").read()
    assert data.count(b"\n") == 5


def test_preprocess_cli(tmp_path, capsys):
    p = tmp_path / "list.csv"
    p.write_text("\n".join(RAW[:2]) + "\n", encoding="utf-8")
    pre.main(["--filelists", str(p)])
    assert (tmp_path / "list.clr.csv").exists()
    assert "list.clr.csv" in capsys.readouterr().out
