"""The sized frame budget of a graphed serving call (``vits_torch/serve/graphs.py``)
on the CPU, at test widths of ``configs/config_cje.yaml`` (PITS, HiFi-GAN) and
``perfbench/configs/ljs_mbistft.json`` (pitchless, multi-band iSTFT): the
call's two stages, ``SynthesizerTrn._infer_text`` at the budget M and then
``_infer_frames`` on the first F frames, give the eager ``_infer`` at
``max_frames`` F bit for bit, F the sized budget or M; the ladder
``sized_frames``; the engine counts the frames a call decoded, read from its
audio, and a call decoded below its budget, so that the reader of
``engine.pad_share.long`` gives the share that was padding.

The stages' CUDA graphs against the eager call are card tests
(``tests/test_torch_infer_graphs.py -m cuda``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from vits_torch.config import load_hparams
from vits_torch.models.synthesizer import build_synthesizer
from vits_torch.serve.engine import TTSEngine
from vits_torch.serve.graphs import FRAME_STEP, sized_frames
from vits_torch.text.symbols import symbols
from vits_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CJE_TINY = dict(inter_channels=96, hidden_channels=48, filter_channels=64, n_layers=1,
                resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
                upsample_initial_channel=32, gin_channels=16)
LJS_TINY = dict(inter_channels=96, hidden_channels=48, filter_channels=64, n_layers=1,
                resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
                upsample_initial_channel=32, posterior_layers=2, flow_n_flows=1,
                flow_wn_layers=1, dur_n_flows=1)
BUDGET = 1000


@pytest.fixture(scope="module", params=["cje", "ljs_mbistft"])
def tiny(request, tmp_path_factory):
    """(name, a test-width copy of the configuration's file)."""
    out = tmp_path_factory.mktemp(request.param)
    if request.param == "cje":
        cfg = yaml.safe_load((ROOT / "configs" / "config_cje.yaml").read_text())
        cfg["model"].update(CJE_TINY)
        path = out / "cje.yaml"
        path.write_text(yaml.safe_dump(cfg))
    else:
        cfg = json.loads((ROOT / "perfbench" / "configs" / "ljs_mbistft.json").read_text())
        cfg["model"].update(LJS_TINY)
        path = out / "ljs.json"
        path.write_text(json.dumps(cfg))
    return request.param, path


@pytest.fixture(scope="module")
def model(tiny):
    with torch.random.fork_rng():
        torch.manual_seed(3)
        return build_synthesizer(load_hparams(str(tiny[1])), device="cpu").eval()


def _call(model, lens, tx=128, seed=0):
    """One call's arguments at ``len(lens)`` rows of ``tx`` ids, the rows'
    ids ``lens``, the controls as [rows] tensors, and its noise at BUDGET."""
    g = torch.Generator().manual_seed(seed)
    rows = len(lens)
    x = torch.zeros(rows, tx, dtype=torch.int64)
    t = torch.zeros(rows, tx, dtype=torch.int64)
    for r, n in enumerate(lens):
        x[r, :n] = torch.randint(1, len(symbols), (n,), generator=g)
        t[r, :n] = torch.randint(0, 3, (n,), generator=g)
    sid = torch.arange(rows) % max(model.n_speakers, 1)
    noise = {"sdp_noise": torch.randn(rows, tx, 2, generator=g),
             "eps": torch.randn(rows, BUDGET, model.inter_channels, generator=g)}
    controls = dict(length_scale=torch.tensor([1.0, 0.8, 1.2][:rows]),
                    scope_shift=torch.tensor([0, 15, -15][:rows]))
    return (x, t, torch.tensor(lens), sid), noise, controls


@pytest.mark.parametrize("sized", [True, False], ids=["sized", "at_budget"])
def test_two_stages_at_f_are_the_eager_call_at_f(model, sized):
    args, noise, controls = _call(model, [100, 61, 17])
    with torch.inference_mode():
        m_p, logs_p, y_lengths, g = model._infer_text(
            *args, noise["sdp_noise"], controls["length_scale"], noise_scale_w=0.8,
            max_frames=BUDGET)
        longest = int(y_lengths.max())
        f = sized_frames(longest, BUDGET) if sized else BUDGET
        if sized:
            assert longest < f < BUDGET, (longest, f)
        wav, y_mask = model._infer_frames(
            m_p[:, :f], logs_p[:, :f], y_lengths, g, noise["eps"][:, :f],
            controls["scope_shift"], noise_scale=0.667)
        want = model._infer(
            *args, noise={"sdp_noise": noise["sdp_noise"], "eps": noise["eps"][:, :f]},
            noise_scale=0.667, noise_scale_w=0.8, max_frames=f, **controls)
    assert wav.shape == (3, f * model.hop_length, 1)
    assert torch.equal(y_lengths, want[2])
    assert torch.equal(y_mask, want[1])
    assert torch.equal(wav, want[0]), (wav - want[0]).abs().max().item()


def test_expanded_prior_does_not_depend_on_the_budget(model):
    """The first F frames of the prior expanded over M frames are those
    expanded over F: what lets stage 1 run at the budget."""
    args, noise, controls = _call(model, [90, 40], seed=1)
    with torch.inference_mode():
        at_m = model._infer_text(*args, noise["sdp_noise"], controls["length_scale"],
                                 noise_scale_w=0.8, max_frames=BUDGET)
        f = sized_frames(int(at_m[2].max()), BUDGET)
        at_f = model._infer_text(*args, noise["sdp_noise"], controls["length_scale"],
                                 noise_scale_w=0.8, max_frames=f)
    assert torch.equal(at_m[0][:, :f], at_f[0]) and torch.equal(at_m[1][:, :f], at_f[1])
    assert torch.equal(at_m[2], at_f[2])


@pytest.mark.parametrize("longest,cap,want", [
    (1, 1000, 128), (0, 1000, 128), (127, 1000, 128), (128, 1000, 128), (129, 1000, 256),
    (640, 1000, 640), (641, 1000, 768), (896, 1000, 896), (897, 1000, 1000),
    (999, 1000, 1000), (1000, 1000, 1000), (1500, 1000, 1000),
    (1, 512, 128), (128, 512, 128), (300, 512, 384), (511, 512, 512), (512, 512, 512),
    (513, 512, 512),
    (1, 256, 128), (128, 256, 128), (129, 256, 256), (255, 256, 256), (256, 256, 256),
    (700, 256, 256),
    (1, 96, 96), (96, 96, 96),
])
def test_sized_frames(longest, cap, want):
    assert sized_frames(longest, cap) == want


@pytest.mark.parametrize("cap,ladder", [
    (1000, [128, 256, 384, 512, 640, 768, 896, 1000]),
    (512, [128, 256, 384, 512]),
    (256, [128, 256]),
])
def test_ladder_under_a_budget(cap, ladder):
    got = sorted({sized_frames(n, cap) for n in range(1, cap + 1)})
    assert got == ladder
    assert all(f % FRAME_STEP == 0 for f in got[:-1])
    # the fewest frames that hold the row
    assert all(sized_frames(n, cap) >= n for n in range(1, cap + 1))
    assert all(sized_frames(n, cap) - n < FRAME_STEP for n in range(1, cap + 1))


@pytest.fixture(scope="module")
def engine(tiny):
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return TTSEngine(str(tiny[1]), max_frames=BUDGET, device="cpu")


@pytest.fixture
def counted():
    profiling.reset()
    was = profiling.set_tracing(True)
    yield lambda: dict(profiling.snapshot()["counters"])
    profiling.set_tracing(was)
    profiling.reset()


def _pad_reader():
    path = ROOT / "perfbench" / "metrics" / "engine.pad_share.long.py"
    spec = importlib.util.spec_from_file_location("pad_share_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(engine, n):
    """``n`` rows of 40 ids, all in one (text bucket, budget) group."""
    seq = np.full(40, symbols.index("a"), np.int32)
    return [engine._rows(seq, np.zeros(40, np.int32), 0, 7 + r, 0, 1.0)[0] for r in range(n)]


@pytest.mark.parametrize("fill,decoded", [(False, 128), (True, 128), (False, None)],
                         ids=["sized", "sized_padded_rows", "at_budget"])
def test_frames_decoded_counts_the_frames_of_the_audio(engine, counted, monkeypatch, fill,
                                                       decoded):
    """A faked call that decodes ``decoded`` frames of its budget (None: all
    of it) at fixed predicted lengths: ``serve.frames_decoded`` counts those
    frames x rows (3 real, and with ``fill`` one padding row), not the
    budget's; ``serve.sized_calls`` counts a call below its budget; the pad
    share reader gives 1 - kept / decoded."""
    lengths = [120, 97, 31]
    pending = iter(lengths)
    budgets = []

    def infer(x, t, x_lengths, *args, max_frames, **kwargs):
        budgets.append(max_frames)
        f = decoded or max_frames
        wav = torch.zeros(x.shape[0], f * engine.hop, 1)
        y = torch.tensor([next(pending) if n > 1 else 1 for n in x_lengths.tolist()],
                         dtype=torch.int32)
        return wav, torch.ones(x.shape[0], f, 1), y

    monkeypatch.setattr(engine.model, "infer", infer)
    audio = engine._budget_walk(_rows(engine, 3), fill=fill)
    calls = 1 if fill else 2  # 3 rows padded to the batch bucket of 4, or cut 2 + 1
    assert budgets == [256] * calls
    assert [len(a) for a in audio] == [n * engine.hop for n in lengths]
    c = counted()
    f = decoded or 256
    width = 4 if fill else 3
    assert c["serve.infer_calls"] == calls and c["serve.rows"] == 3
    assert c["serve.frames_decoded"] == f * width
    assert c["serve.frames_kept"] == sum(lengths)
    assert c.get("serve.sized_calls", 0) == (calls if decoded else 0)
    assert _pad_reader().read({}) == pytest.approx(100 * (1 - sum(lengths) / (f * width)))


def test_eager_call_decodes_its_budget(engine, counted, monkeypatch):
    """On the CPU every call runs eagerly: it decodes its whole budget and
    none is a sized call."""
    calls, infer = [], engine.model.infer

    def spy(x, *args, max_frames, **kwargs):
        calls.append(x.shape[0] * max_frames)
        return infer(x, *args, max_frames=max_frames, **kwargs)

    monkeypatch.setattr(engine.model, "infer", spy)
    engine._budget_walk(_rows(engine, 2), fill=False)
    c = counted()
    assert c["serve.infer_calls"] == len(calls) >= 1
    assert c["serve.frames_decoded"] == sum(calls)
    assert "serve.sized_calls" not in c
