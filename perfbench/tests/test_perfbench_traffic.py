"""The traffic generator: the same seed gives the same inputs, another seed
the same sizes in another order (train steps' buckets in one order for
every seed), and every size inside its mix's range."""

from __future__ import annotations

import collections
import json

import numpy as np
import pytest
import torch

from perfbench import harness, traffic
from perfbench.cfg import Cfg
from perfbench.reference import serve as ref_serve
from perfbench.tests.tiny import ROOT

SEEDS = (2**31 + 3, 7)


def mix(name):
    return Cfg(json.loads(harness.find_traffic(ROOT, name).read_text()))


@pytest.mark.parametrize("name", ["cje_train_buckets", "cje_long_train_buckets"])
def test_train_sizes(name):
    tr = mix(name)
    n = sum(tr.cycle.values())
    sched = traffic.train_schedule(tr, 4 * n)
    assert sched == traffic.train_schedule(tr, 4 * n) and sched[:n] == sched[n: 2 * n]
    assert collections.Counter(sched[:n]) == {int(b): k for b, k in tr.cycle.items()}
    for end in range(1, 2 * n):  # every stretch from the start: each bucket near its share
        count = collections.Counter(sched[:end])
        for b, k in tr.cycle.items():
            assert abs(count[int(b)] - end * k / n) <= 1
    for bucket in traffic.train_buckets(tr):
        lo, hi = tr.frames[str(bucket)]
        sizes = [traffic.item_lengths(tr, bucket, s, ("window", 0)) for s in SEEDS]
        for frames, ids in sizes:
            assert frames.min() >= lo and frames.max() <= hi <= bucket
            assert ids.min() >= 1 and ids.max() <= min(tr.max_ids, tr.text_pad)
            assert (ids <= frames).all()
        assert sorted(sizes[0][0]) == sorted(sizes[1][0])
        assert not np.array_equal(sizes[0][0], sizes[1][0])


@pytest.mark.parametrize("name", ["cje_train_buckets", "cje_long_train_buckets"])
def test_check_buckets_span_the_mix(name):
    tr = mix(name)
    checked = traffic.check_buckets(tr)
    buckets = traffic.train_buckets(tr)
    assert len(checked) == tr.check_steps and set(checked) <= set(buckets)
    assert checked[0] == buckets[0] and checked[-1] == buckets[-1]
    assert len(set(checked)) == min(len(buckets), tr.check_steps)


def test_train_batch_is_seeded():
    tr = Cfg({**mix("cje_train_buckets"), "batch": 3, "text_pad": 16, "max_ids": 15,
              "frames": {"400": [20, 24]}, "cycle": {"400": 1}})
    data = Cfg(json.loads((ROOT / "perfbench/configs/cje.json").read_text())["data"])
    dev = torch.device("cpu")
    a, b = (traffic.TrainFeed(tr, data, SEEDS[0], dev).batch(400, 1) for _ in range(2))
    c = traffic.TrainFeed(tr, data, SEEDS[1], dev).batch(400, 1)
    assert all(torch.equal(a[k], b[k]) for k in ("x", "wav", "spec", "ying"))
    assert not torch.equal(a["wav"], c["wav"])
    assert a["spec"].shape == (3, 400, 513) and a["ying"].shape == (3, 400, 80)
    assert (a["x"][:, ::2] == 0).all()


def test_open_loop():
    tr = mix("cje_sentences_8rps")
    runs = [traffic.open_loop(tr, s, 30.0) for s in SEEDS]
    assert runs[0] == traffic.open_loop(tr, SEEDS[0], 30.0)
    for reqs in runs:
        due = [r["due"] for r in reqs]
        assert due == sorted(due) and due[-1] < 30.0
        assert abs(len(reqs) / 30.0 - tr.rate_per_s) < 0.15 * tr.rate_per_s
        assert {r["speaker_id"] for r in reqs} <= set(range(tr.speakers))
    n = len(traffic.sentence_bank(tr))
    first = [collections.Counter(r["text"] for r in reqs[:n]) for reqs in runs]
    assert first[0] == first[1]  # one pass over the bank each, in another order
    assert [r["text"] for r in runs[0][:n]] != [r["text"] for r in runs[1][:n]]


def test_sentence_bank_ranges():
    tr = mix("cje_sentences_8rps")
    bank = traffic.sentence_bank(tr)
    assert len(bank) == tr.bank_size
    share = collections.Counter(lang for _, lang in bank)
    for lang, want in tr.languages.items():
        assert share[lang] == round(want * tr.bank_size)
        lo, hi = tr.chars[lang]
        for text, la in bank:
            if la == lang:
                assert text.startswith(f"[{lang}]") and lo <= len(text) - 8 <= hi


def test_paragraphs_split(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "jieba", None)  # as on the card's machine
    tr = mix("cje_paragraphs_closed")
    bank = traffic.paragraph_bank(tr, lambda t: len(ref_serve.phonemes(t)[0]))
    assert len(bank) == tr.paragraphs
    for text in bank:
        ids, lang = ref_serve.phonemes(text)
        assert len(ids) >= tr.min_ids > ref_serve.TEXT_LIMIT
        assert len(ref_serve.split_segments(ids, lang)) >= 2
