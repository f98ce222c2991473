"""The frozen reference against the program (``vits_torch``) at a tiny size
on the CPU, in float32: the same weights and draws give the same training
forward, discriminator, synthesis and ids; and the readers' arithmetic."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import checks, randomness, traffic, weights
from perfbench.cfg import load
from perfbench.reference import peaks
from perfbench.reference import serve as ref_serve
from perfbench.tests.tiny import tiny_config, ROOT


@pytest.fixture(scope="module")
def hps(tmp_path_factory):
    return load(tiny_config("cje", tmp_path_factory.mktemp("ref"), bf16=False))


@pytest.fixture(scope="module")
def pair(hps):
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.models.avocodo import probe_discriminator

    torch.manual_seed(0)
    g, d = build_synthesizer(hps, device="cpu"), probe_discriminator(
        segment_size=hps.train.segment_size, device="cpu")
    rg, rd = checks.build_reference(hps, "cpu")
    w = weights.make(checks.both_shapes(rg, rd), 5, "cpu")
    checks.load_both(g, d, w)
    checks.load_both(rg, rd, w)
    return g, d, rg, rd


def test_training_forward_and_discriminator(hps, pair):
    g, d, rg, rd = pair
    tr = json.loads((ROOT / "perfbench/traffic/cje_train_buckets.json").read_text())
    tr.update(batch=2, text_pad=24, max_ids=23, frames={"40": [30, 40]}, cycle={"40": 1})
    from perfbench.cfg import Cfg

    batch = traffic.TrainFeed(Cfg(tr), hps.data, 3, torch.device("cpu")).batch(40, 0)
    m = hps.model
    noise = randomness.train_noise(2, 24, 40, m.inter_channels - m.yin_channels,
                                   m.yin_channels, m.yin_shift_range, 9, "cpu")
    args = [batch[k] for k in ("x", "t", "x_lengths", "spec", "spec_lengths", "ying", "sid")]
    for mod in (g, rg):
        mod.eval()
    with torch.no_grad():
        a = g(*args, noise=noise)
        b = rg(*args, noise=noise)
        for k in a:
            va, vb = a[k], b[k]
            for x, y in zip(va if isinstance(va, list) else [va], vb if isinstance(vb, list) else [vb]):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5, msg=k)
        wav = a["wav_hier"]
        da, db = d(wav[-1], wav), rd(wav[-1], wav)
        for x, y in zip(da[0] + da[1], db[0] + db[1]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_synthesis_and_ids(hps, pair):
    g, _, rg, _ = pair
    for mod in (g, rg):
        mod.eval()
    from vits_torch.serve.engine import TTSEngine

    dev = torch.device("cpu")
    noise_fn = lambda seed, shapes: randomness.serve_noise(seed, shapes, dev)  # noqa: E731
    engine = TTSEngine.__new__(TTSEngine)
    engine.device, engine.hps, engine.model, engine.max_frames = dev, hps, g, 1000
    engine.sampling_rate, engine.hop, engine.noise_fn = 22050, 256, noise_fn
    engine._yingram = None
    texts = ["[ZH]今天天气很好，我们一起去公园散步吧。[ZH]",
             "[EN]The weather is lovely today, let's take a walk in the park.[EN]"]
    for i, text in enumerate(texts):
        ids, lang, _ = engine.get_phoneme(text)
        seq, rlang = ref_serve.phonemes(text)
        np.testing.assert_array_equal(ids, seq)
        np.testing.assert_array_equal(lang, rlang)
        _, (_, audio) = engine.synthesize(text, 1, seed=100 + i)
        piece = ref_serve.synth_piece(rg, seq, rlang, 1, noise_fn, 100 + i, 1000)
        assert len(audio) == piece["frames"] * 256
        n = (piece["frames"] - 16) * 256  # the engine decodes a padded bucket
        np.testing.assert_allclose(audio[:n], piece["audio"][:n], rtol=1e-4, atol=1e-5)


def test_flop_count_is_linear_in_frames(hps):
    from perfbench.drivers.train_step import ref_flops_of
    from perfbench.harness import Run
    from perfbench.cfg import Cfg

    tr = Cfg(json.loads((ROOT / "perfbench/traffic/cje_train_buckets.json").read_text()))
    run = Run(root=ROOT, cell={}, config=None, config_path=None,
              traffic=Cfg({**tr, "batch": 2, "text_pad": 24}), limits={}, seed=1, seconds=1,
              trace=True, chips=1)
    models = checks.build_reference(hps, "meta")
    f = [ref_flops_of(run, hps, t, models) for t in (40, 48, 56)]
    assert f[0] < f[1] < f[2] and abs((f[2] - f[1]) - (f[1] - f[0])) <= 1e-9 * f[2]


def test_mas_bound():
    # one item of 2 x 2 cells in a [1, 4, 3] lattice: 16 + 28 + 48 bytes, 12 ops
    assert peaks.mas_bound_s([2], [2], 4, 3) == max(92 / peaks.HBM_BYTES_PER_S,
                                                    12 / peaks.F32_OPS_PER_S)
    assert peaks.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert peaks.peak_bf16_flops("cpu") is None


def test_reference_mas_is_the_program_plain_mas():
    from vits_torch.ops.mas import maximum_path_torch
    from perfbench.reference.ops.mas import maximum_path

    rng = np.random.default_rng(0)
    neg = torch.from_numpy(rng.standard_normal((3, 12, 7)).astype(np.float32))
    ty, tx = [12, 9, 7], [7, 5, 7]
    mask = torch.zeros(3, 12, 7)
    for i in range(3):
        mask[i, : ty[i], : tx[i]] = 1
    torch.testing.assert_close(maximum_path(neg, mask), maximum_path_torch(neg, mask))


def test_ambiguous_tokens_and_compare():
    w = np.array([1.2, 2.9999, 0.4, 3.0004, 1.5])
    assert list(checks.ambiguous(w, 1e-3, 100)) == [1, 3]
    lim = {"ambiguous_rel": 1e-3, "ambiguous_margin": 1, "tail_margin": 1}
    audio = np.arange(4 * 10, dtype=np.float32)
    piece = {"audio": audio, "frames": 10, "w": np.array([4.2, 5.1])}
    one = checks.compare_request([piece], audio.copy(), [1, 2], np.array([1, 2]), 4, lim)
    assert one["ids_off"] == 0 and one["frames_off"] == 0.0 and one["diff"] == 0.0
    assert one["compared"] == 36 and one["samples"] == 40
    assert one["norm"] == pytest.approx(float(audio[:36] @ audio[:36]))
    one = checks.compare_request([piece], audio[:36], [1, 3], np.array([1, 2]), 4, lim)
    assert one["ids_off"] == 1 and one["frames_off"] == 1.0


def test_blocks_add_up_to_the_whole_step(hps):
    """The reference's step a block of rows at a time equals the whole batch
    at once: the same losses and the same gradient of every leaf (the
    updated parameters differ where a gradient element is round-off, which
    Adam's first step turns into a whole step of either sign)."""
    from perfbench.cfg import Cfg
    from perfbench.reference import step as ref_step

    tr = json.loads((ROOT / "perfbench/traffic/cje_train_buckets.json").read_text())
    tr.update(batch=4, text_pad=24, max_ids=23, frames={"40": [30, 40]}, cycle={"40": 1})
    batch = traffic.TrainFeed(Cfg(tr), hps.data, 3, torch.device("cpu")).batch(40, 0)
    m = hps.model
    noise = randomness.train_noise(4, 24, 40, m.inter_channels - m.yin_channels,
                                   m.yin_channels, m.yin_shift_range, 9, "cpu")
    out = []
    for block in (4, 1):
        g, d = checks.build_reference(hps, "cpu")
        checks.load_both(g, d, weights.make(checks.both_shapes(g, d), 5, "cpu"))
        drops = randomness.install_dropout(g, "cpu")

        def before(i, j, full):
            randomness.reseed_dropout(drops, 1, 0)
            for mod in drops.values():
                mod.rows = (i, j, full)

        opt_g, opt_d = ref_step.make_adamw(hps, g), ref_step.make_adamw(hps, d)
        losses = ref_step.train_step_blocks(g, d, opt_g, opt_d, batch, hps, noise, block, before)
        out.append((losses, {**opt_g.first_grads, **{"d." + k: v for k, v in
                                                     opt_d.first_grads.items()}}))
    (whole, gw), (parts, gp) = out
    assert whole["g"] == pytest.approx(parts["g"], rel=1e-5)
    assert whole["d"] == pytest.approx(parts["d"], rel=1e-5)
    top = max(gw.values())
    for k in gw:
        assert gw[k] == pytest.approx(gp[k], rel=1e-3, abs=1e-6 * top), k


def test_pieces_found_from_both_ends():
    """A middle piece with a token that rounded the other way (one frame
    longer in the program): the pieces before it are found from the start,
    those after it from the end, and it is compared up to the token."""
    hop, lim = 2, {"ambiguous_rel": 1e-3, "ambiguous_margin": 1, "tail_margin": 1}
    rng = np.random.default_rng(0)
    w_mid = np.array([2.2, 3.0001, 1.5])  # token 1 may round either way; 7 frames
    pieces = [{"audio": rng.standard_normal(8 * hop).astype(np.float32), "frames": 8,
               "w": np.array([3.5, 4.5])},
              {"audio": rng.standard_normal(7 * hop).astype(np.float32), "frames": 7, "w": w_mid},
              {"audio": rng.standard_normal(6 * hop).astype(np.float32), "frames": 6,
               "w": np.array([5.2, 0.4])}]
    mid = np.concatenate([pieces[1]["audio"][: 3 * hop], np.ones(5 * hop, np.float32)])
    audio = np.concatenate([pieces[0]["audio"], mid, pieces[2]["audio"]])
    one = checks.compare_request(pieces, audio, [1], np.array([1]), hop, lim)
    assert one["frames_off"] == 0.0 and one["diff"] == 0.0
    # piece 0 up to its tail, piece 1 up to a frame before token 1, piece 2 up to its tail
    assert one["compared"] == (7 + 2 + 5) * hop
    audio[-hop:] += 1.0  # the tail is not compared
    assert checks.compare_request(pieces, audio, [1], np.array([1]), hop, lim)["diff"] == 0
    audio[hop] += 1.0
    assert checks.compare_request(pieces, audio, [1], np.array([1]), hop, lim)["diff"] \
        == pytest.approx(1.0, rel=1e-6)
