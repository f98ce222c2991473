"""MB-iSTFT-VITS in the port (``decoder: mb_istft``, ``pitch: none``,
``language_embedding: false``) against the plain reference
``perfbench/reference/models/mb_istft.py`` (an explicit inverse DFT, a loop
over frames, the zero-stuffed PQMF), at test widths on the CPU in float32,
with the benchmark's seeded weights and noise: the inverse STFT, the
decoder, ``infer`` at one and two rows, ``TTSEngine.synthesize`` over a
split paragraph, the chunked and streaming paths against the whole call;
a configuration without the new keys builds the PITS model as the frozen
reference of it (``perfbench/reference/models/synthesizer.py``) and gives
its ``infer`` audio bit for bit; the pitchless model refuses the yin decoder
and voice conversion (its training is ``tests/test_torch_mb_istft_train.py``'s).

The card tests (skipped without one) replay the pitchless model's ``infer``
from the CUDA graphs of its two stages at the configuration's full width
against the eager call at the frames the replay sized, at 1 and 4 rows: the
eager call and the decoder's head read nothing back to the host, the replay
reads one value, its longest length (``torch.cuda.set_sync_debug_mode``).
One float32 pitchless ``train_step`` at the test widths on the card matches
the same step on the CPU, and the step under bfloat16 autocast does not.
``python -m pytest --noconftest
tests/test_torch_mb_istft.py -m cuda``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import checks, randomness, weights
from perfbench.cfg import Cfg
from perfbench.reference import serve as ref_serve
from perfbench.reference.models import mb_istft as ref_mb
from vits_torch.config import load_hparams
from vits_torch.models.synthesizer import build_synthesizer
from vits_torch.ops.stft import InverseSTFT
from vits_torch.serve.engine import TTSEngine

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "perfbench" / "configs" / "ljs_mbistft.json"
TRAIN_CONFIG = ROOT / "perfbench" / "configs" / "ljs_mbistft_train.json"
TINY = dict(inter_channels=96, hidden_channels=48, filter_channels=64, n_layers=1,
            resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
            upsample_initial_channel=32, posterior_layers=2, flow_n_flows=1,
            flow_wn_layers=1, dur_n_flows=1)
SEED = 2**31 + 18
PARAGRAPH = "[EN]" + " ".join(
    ["The quick brown fox jumps over the lazy dog, and the dog sleeps on."] * 8) + "[EN]"
# float32 against float32 computed in another order: the sums of a few
# hundred products (the convs) and the frames' overlap-add round apart by a
# few ulps; the audio is a small difference of large bins, so its relative
# error is some 1e-7 (measured 2e-7 to 5e-7)
AUDIO_REL = 1e-5


def noise_fn(seed, shapes):
    return randomness.serve_noise(seed, shapes, torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    cfg = json.loads(CONFIG.read_text())
    cfg["model"].update(TINY)
    path = tmp_path_factory.mktemp("mb") / "ljs_tiny.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def pair(tiny_path):
    """The port's model and the reference, the same seeded weights, eval."""
    prog = build_synthesizer(load_hparams(str(tiny_path)), device="cpu").eval()
    ref = ref_mb.build(Cfg(json.loads(tiny_path.read_text())))
    w = weights.make(weights.shapes_of(ref), SEED, "cpu")
    weights.load(prog, w)
    weights.load(ref, w)
    return prog, ref


@pytest.fixture(scope="module")
def engine(tiny_path, pair):
    eng = TTSEngine(str(tiny_path), max_frames=1000, device="cpu", noise_fn=noise_fn)
    eng.model.load_state_dict(pair[0].state_dict())
    return eng


def rel(a, b) -> float:
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("frames", [2, 7, 40, 161])
def test_istft_is_torch_istft_and_the_reference(frames):
    g = torch.Generator().manual_seed(frames)
    mag = torch.exp(torch.randn(3, 9, frames, generator=g, dtype=torch.float64))
    phase = math.pi * torch.sin(torch.randn(3, 9, frames, generator=g, dtype=torch.float64))
    want = torch.istft(torch.polar(mag, phase), 16, 4, 16,
                       torch.hann_window(16, dtype=torch.float64), center=True)
    got = InverseSTFT(16, 4)(mag.float(), phase.float())
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 4 * (frames - 1))
    # float32 products and sums against float64: a few ulps of the frames' size
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert rel(got, ref_mb.istft(mag.float(), phase.float(), 16, 4)) < AUDIO_REL


def test_istft_refuses_a_hop_that_does_not_divide_n_fft():
    with pytest.raises(ValueError, match="multiple of hop"):
        InverseSTFT(16, 5)


def test_decoder_is_the_reference(pair):
    prog, ref = pair
    z = torch.randn(2, 96, 37, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = prog.waveform_decoder(z), ref.waveform_decoder(z)
    assert got.shape == want.shape == (2, 1, 37 * 256)
    assert rel(got, want) < AUDIO_REL


def _row(ids: int, seed: int):
    g = np.random.default_rng(seed)
    seq = g.integers(1, 71, ids).astype(np.int32)
    seq[::2] = 0  # the blanks add_blank puts between symbols
    return seq


@pytest.mark.parametrize("rows", [1, 2])
def test_infer_is_the_reference_piece_a_row(pair, rows):
    prog, ref = pair
    tx, frames = 64, 512
    lens = [61, 40][:rows]
    seqs = [_row(n, 7 + r) for r, n in enumerate(lens)]
    x = torch.zeros(rows, tx, dtype=torch.int64)
    for r, s in enumerate(seqs):
        x[r, : len(s)] = torch.from_numpy(s)
    seeds = [100 + r for r in range(rows)]
    draws = [noise_fn(s, {"sdp_noise": (1, tx, 2), "eps": (1, frames, 96)}) for s in seeds]
    noise = {k: torch.cat([d[k] for d in draws]) for k in ("sdp_noise", "eps")}
    with torch.inference_mode():
        wav, _, y_len = prog.infer(x, torch.zeros_like(x), torch.tensor(lens), None, noise=noise,
                                   max_frames=frames, length_scale=torch.ones(rows),
                                   scope_shift=torch.zeros(rows, dtype=torch.int64))
    for r, (s, seed) in enumerate(zip(seqs, seeds)):
        piece = ref_serve.synth_piece(ref, s, np.zeros_like(s), 0, noise_fn, seed, frames)
        assert int(y_len[r]) == piece["frames"]
        n = (piece["frames"] - 16) * 256  # the call decodes the padded budget
        assert rel(wav[r, :n, 0], piece["audio"][:n]) < AUDIO_REL


def test_engine_synthesize_is_the_reference_pieces(engine, pair):
    _, ref = pair
    _, (sr, audio) = engine.synthesize(PARAGRAPH, 0, seed=41, scope_shift=9)
    seq, lang = ref_serve.phonemes(PARAGRAPH)
    assert len(seq) > engine.TEXT_BUCKETS[-1]  # split into pieces
    pieces = [ref_serve.synth_piece(ref, s, la, 0, noise_fn, 41 + i, 1000)
              for i, (s, la) in enumerate(ref_serve.split_segments(seq, lang))]
    lim = {"ambiguous_rel": 1e-4, "ambiguous_margin": 48, "tail_margin": 16}
    got = checks.compare_request(pieces, audio, engine.get_phoneme(PARAGRAPH)[0], seq, 256, lim)
    assert sr == 22050 and len(pieces) >= 2
    assert got["ids_off"] == 0 and got["frames_off"] == 0
    assert got["compared"] > 0.5 * got["samples"]
    assert (got["diff"] / got["norm"]) ** 0.5 < AUDIO_REL
    # no pitch path: the scope shift is unread
    np.testing.assert_array_equal(engine.synthesize(PARAGRAPH, 0, seed=41)[1][1], audio)


def test_chunked_and_streaming_are_the_whole_call(engine):
    text = PARAGRAPH
    _, (_, full) = engine.synthesize(text, 0, seed=5)
    _, (_, chunked) = engine.synthesize_chunked(text, 0, seed=5, chunk_frames=16,
                                                overlap_frames=16)
    assert len(chunked) == len(full) > 0
    err = np.abs(full - chunked)
    rms = np.sqrt((full**2).mean()) + 1e-9
    assert err.max() < 0.05 * rms + 1e-3, (err.max(), rms)  # the engine's seam tolerance
    _, stream = engine.synthesize_streaming(text, 0, seed=5, chunk_frames=16, overlap_frames=16)
    np.testing.assert_array_equal(np.concatenate(list(stream)), chunked)


def test_batch_rows_are_their_single_calls(engine):
    reqs = [{"text": "[EN]Hello world, this is a test.[EN]", "seed": 3},
            {"text": "[EN]Good morning to you all.[EN]", "seed": 4}]
    ns = [len(engine.get_phoneme(r["text"])[0]) for r in reqs]
    assert len({(engine._bucket(n), engine._first_frames(n, 1.0)) for n in ns}) == 1  # 2 rows
    batch = engine.synthesize_batch(reqs)
    for r, got in zip(reqs, batch):
        want = engine.synthesize(r["text"], 0, seed=r["seed"])[1][1]
        assert len(got) == len(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_config_without_the_new_keys_is_the_pitch_model(tmp_path):
    """``perfbench/reference/models/synthesizer.py`` is a frozen copy of the
    port's model before the switches: the same parameters and the same
    ``infer`` audio, bit for bit."""
    from perfbench.reference.models.synthesizer import build_synthesizer as build_frozen
    from perfbench.tests.tiny import tiny_config

    path = tiny_config("cje", tmp_path, bf16=False)
    hps = load_hparams(str(path))
    assert not {"decoder", "pitch", "language_embedding"} & set(hps.model.keys())
    prog = build_synthesizer(hps, device="cpu").eval()
    frozen = build_frozen(Cfg(json.loads(path.read_text())), device="cpu").eval()
    assert list(weights.shapes_of(prog).items()) == list(weights.shapes_of(frozen).items())
    assert {"text_encoder.emb_t.weight", "emb_g.weight"} <= set(weights.shapes_of(prog))
    assert prog.has_pitch and prog.decoder == "hifigan"
    w = weights.make(weights.shapes_of(prog), SEED, "cpu")
    weights.load(prog, w)
    weights.load(frozen, w)
    x = torch.from_numpy(_row(50, 2)[None].astype(np.int64))
    t = torch.full_like(x, 3)
    args = (x, t, torch.tensor([50]), torch.tensor([2]))
    kw = dict(generator=None, max_frames=256, scope_shift=4)
    with torch.inference_mode():
        a = prog.infer(*args, noise=noise_fn(1, {"sdp_noise": (1, 50, 2), "eps": (1, 256, 96)}),
                       **kw)
        b = frozen.infer(*args, noise=noise_fn(1, {"sdp_noise": (1, 50, 2),
                                                   "eps": (1, 256, 96)}), **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_pitchless_model_refuses_what_needs_the_pitch_path(pair, engine):
    prog, _ = pair
    assert not prog.has_pitch and prog.decoder == "mb_istft"
    names = set(weights.shapes_of(prog))
    assert not [n for n in names if n.startswith(("pitch_encoder.", "yin_decoder.", "emb_g."))]
    assert "text_encoder.emb_t.weight" not in names
    z = torch.zeros(1, 8, 1)
    # it trains (tests/test_torch_mb_istft_train.py): its draws have no pitch keys
    assert set(prog.draw_noise(1, 4, 8)) == {"eps_spec", "e_q", "slice_u"}
    with pytest.raises(ValueError, match="pitch path"):
        prog.yin_dec_infer(z, z)
    with pytest.raises(ValueError, match="pitch path"):
        prog.voice_conversion(torch.zeros(1, 8, 513), torch.zeros(1, 8, 80), torch.tensor([8]),
                              torch.tensor([0]), torch.tensor([0]))
    with pytest.raises(ValueError, match="pitch path"):
        engine.voice_conversion(np.zeros(4096, np.float32), 0, 0)


def test_training_needs_the_hifigan_decoder(tiny_path):
    hps = load_hparams(str(tiny_path))
    hps.model.pitch = "yingram"
    for k, v in dict(yin_channels=80, yin_start=15, yin_scope=50, yin_shift_range=15).items():
        hps.model[k] = v
    for k, v in dict(midi_start=-5, midi_end=75, octave_range=24).items():
        hps.data[k] = v
    model = build_synthesizer(hps, device="cpu")
    assert model.has_pitch and model.decoder == "mb_istft"
    with pytest.raises(ValueError, match="HiFi-GAN decoder"):
        model.draw_noise(1, 4, 8)


def test_synthesizer_kwargs_of_the_configuration():
    from vits_torch.config import synthesizer_kwargs
    from vits_torch.text.symbols import symbols

    hps = load_hparams(str(CONFIG))
    kw = synthesizer_kwargs(hps, len(symbols))
    assert kw["n_speakers"] == 0 and kw["gin_channels"] == 0
    assert (kw["decoder"], kw["pitch"], kw["language_embedding"]) == ("mb_istft", "none", False)
    assert (kw["subbands"], kw["gen_istft_n_fft"], kw["gen_istft_hop_size"]) == (4, 16, 4)
    assert json.loads(CONFIG.read_text())["symbols"] == len(symbols)
    with pytest.raises(ValueError, match="unknown decoder"):
        hps.model.decoder = "vocos"
        build_synthesizer(hps, device="cpu")


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs")
    from vits_torch.serve.graphs import InferGraphs

    dev = torch.device("cuda")
    with torch.device(dev):
        model = build_synthesizer(load_hparams(str(CONFIG)), device=dev).eval()
    weights.load(model, weights.make(weights.shapes_of(model), SEED, dev))
    model.infer_graphs = InferGraphs()
    yield model
    model.infer_graphs = None
    torch.cuda.synchronize()


def _card_call(model, rows: int, seed: int):
    dev = torch.device("cuda")
    tx, frames = 384, 1000
    lens = [380, 301, 222, 143][:rows]
    x = torch.zeros(rows, tx, dtype=torch.int64)
    for r, n in enumerate(lens):
        x[r, :n] = torch.from_numpy(_row(n, seed + r).astype(np.int64))
    draws = [randomness.serve_noise(seed + r, {"sdp_noise": (1, tx, 2), "eps": (1, frames, 192)},
                                    dev) for r in range(rows)]
    noise = {k: torch.cat([d[k] for d in draws]) for k in ("sdp_noise", "eps")}
    args = (x.to(dev), torch.zeros(rows, tx, dtype=torch.int64, device=dev),
            torch.tensor(lens, device=dev), torch.zeros(rows, dtype=torch.int64, device=dev))
    kw = dict(noise=noise, noise_scale=0.667, noise_scale_w=0.8, max_frames=frames,
              length_scale=torch.ones(rows, device=dev),
              scope_shift=torch.zeros(rows, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4])
def test_replay_is_the_eager_call_with_no_host_read(card_model, rows):
    import warnings

    from vits_torch.serve.graphs import sized_frames

    model = card_model
    with torch.inference_mode():
        model.infer(*_card_call(model, rows, 1)[0], **_card_call(model, rows, 1)[1])  # capture
        args, kw = _card_call(model, rows, 2)
        frames = sized_frames(int(model._infer(*args, **kw)[2].max()), 1000)
        eager_kw = dict(kw, max_frames=frames, noise=dict(kw["noise"],
                                                          eps=kw["noise"]["eps"][:, :frames]))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as synced:
                warnings.simplefilter("always")
                got = model.infer(*args, **kw)  # a replay
            torch.cuda.set_sync_debug_mode("error")
            want = model._infer(*args, **eager_kw)
            bands = model.waveform_decoder.istft(
                torch.rand(rows, 4, 9, 101, device="cuda"), torch.rand(rows, 4, 9, 101,
                                                                       device="cuda"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert len([w for w in synced if "synchroniz" in str(w.message)]) == 1, synced
    assert bands.shape == (rows, 4, 400)
    assert got[0].shape == (rows, frames * 256, 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _tiny_train_parts(device, path, seed: int = 0):
    """The pitchless model at the CPU tests' widths, the probe MPD + MSD, the
    benchmark's seeded weights, a train state and one batch with its draws,
    on ``device``; ``seed`` varies the weights and the batch."""
    from perfbench.checks import both_shapes
    from perfbench.drivers.train_step_mbistft import make_weights
    from vits_torch.training.step import create_train_state
    from vits_torch.training.train import build_discriminator

    hps = load_hparams(str(path))
    dev = torch.device(device)
    model = build_synthesizer(hps, device=dev)
    disc = build_discriminator(hps, False, dev)
    w = make_weights(both_shapes(model, disc), SEED + seed, "cpu")
    weights.load(model, {k[2:]: v.to(dev) for k, v in w.items() if k.startswith("g.")})
    weights.load(disc, {k[2:]: v.to(dev) for k, v in w.items() if k.startswith("d.")})
    for m in model.modules():  # dropout off: the two devices draw different masks
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    g = torch.Generator().manual_seed(7 + seed)
    b, t_x, t_y = 2, 48, 64
    x = torch.randint(1, 71, (b, t_x), generator=g)
    x[:, ::2] = 0
    n = torch.arange(t_y * 256)
    wav = 0.4 * torch.sin(2 * math.pi * 180.0 * n / 22050)[None].repeat(b, 1) \
        + 0.02 * torch.randn(b, t_y * 256, generator=g)
    from vits_torch.ops.stft import spectrogram

    batch = {"x": x, "x_lengths": torch.tensor([48, 37]), "spec": spectrogram(wav, 1024, 256, 1024),
             "spec_lengths": torch.tensor([64, 51]), "wav": wav[:, :, None]}
    noise = {"eps_spec": torch.randn(b, t_y, 96, generator=g),
             "e_q": torch.randn(b, t_x, 2, generator=g), "slice_u": torch.rand(b, generator=g)}
    state = create_train_state(model, disc, hps, steps_per_epoch=100)
    to = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    return state, hps, to(batch), to(noise)


def tiny_train_config(tmp_path) -> Path:
    cfg = json.loads(TRAIN_CONFIG.read_text())
    cfg["model"].update(TINY, discriminator_size="probe")
    cfg["train"]["segment_size"] = 2048
    path = tmp_path / "tiny_train.json"
    path.write_text(json.dumps(cfg))
    return path


# card_step_gaps's limits for a TF32 step on the card against the CPU, from
# card readings on seeds 0-7 (H100 80GB HBM3, 700 W): the largest loss gap
# 7.4e-5-2.3e-4 and worst gradient leaf 7.5e-3-3.7e-2 in float32 with cuDNN's
# TF32 convs, 2.7e-2-6.6e-2 and 0.27-0.57 under bfloat16 autocast; each limit
# two thirds of the way up, on a log scale, from the float32 to the bf16 readings
LOSS_LIMIT = 5e-3
GRAD_LIMIT = 0.14


def card_step_gaps(path, seed: int = 0, bf16: bool = False) -> dict:
    """One float32 ``train_step`` of the pitchless model on the CPU and on the
    card (under bfloat16 autocast where ``bf16``), the same weights, batch and
    draws. Returns ``loss``, the largest relative gap of the step's losses
    (``each``: every loss's), and ``grad``, the largest gap of a leaf's
    gradient norm over the larger of the CPU's norm of that leaf and the
    median leaf's (the benchmark's measure, ``perfbench/checks.py``)."""
    from vits_torch.training.step import train_step

    out = {}
    for dev in ("cpu", "cuda"):
        state, hps, batch, noise = _tiny_train_parts(dev, path, seed)
        ctx = torch.autocast("cuda", dtype=torch.bfloat16) if bf16 and dev == "cuda" \
            else contextlib.nullcontext()
        with ctx:
            metrics = train_step(state, batch, hps, noise=noise)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {f"{side}.{n}": float(p.grad.norm())
                     for side, m in (("g", state.model), ("d", state.disc))
                     for n, p in m.named_parameters()})
    (m_cpu, g_cpu), (m_card, g_card) = out["cpu"], out["cuda"]
    assert set(m_cpu) == set(m_card) and "loss/g/subband" in m_card
    each = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu if k.startswith("loss/")}
    med = statistics.median(g_cpu.values())
    return {"loss": max(each.values()), "each": each,
            "grad": max(abs(g_card[k] - c) / max(c, med) for k, c in g_cpu.items())}


@pytest.mark.cuda
def test_pitchless_train_step_on_the_card_is_the_cpu_step(tmp_path):
    """One float32 ``train_step`` of the pitchless model against the probe
    MPD + MSD on the card and on the CPU (``card_step_gaps``): the losses and
    each leaf's gradient within ``LOSS_LIMIT`` and ``GRAD_LIMIT``; the same
    step under bfloat16 autocast on the card fails at least one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    path = tiny_train_config(tmp_path)
    got = card_step_gaps(path)
    assert got["loss"] <= LOSS_LIMIT and got["grad"] <= GRAD_LIMIT, got
    bf16 = card_step_gaps(path, bf16=True)
    assert bf16["loss"] > LOSS_LIMIT or bf16["grad"] > GRAD_LIMIT, bf16
