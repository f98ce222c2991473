"""MB-iSTFT-VITS training in the port (``pitch: none``, ``decoder: mb_istft``,
VITS's MPD + MSD from ``build_discriminator``) against the plain reference
(``perfbench/reference/mb_istft_train.py``, ``reference/models/mpd.py``,
``reference/training/stft_loss.py``) at test widths on the CPU in float32,
with the benchmark's seeded weights and draws: the discriminator's logits and
every feature map (a length no period divides too), the sub-band STFT loss
and its gradient, the generator's training forward, two ``train_step``s
(each loss term, each leaf's first gradient, the parameters after both), the
discriminator ``build_discriminator`` picks, the refusal of a data- or
tensor-parallel step, and two steps of the train CLI on a tiny pitchless
corpus (no Yingram cached, the new spans on its ``profile_step`` trace,
evaluation and a checkpoint).

Tolerances: the port and the reference compute the same float32 products in
another order (the port's discriminator runs the real and generated halves
as one batch, its PQMF analysis is polyphase, its inverse STFT a basis
product), so outputs agree to a few ulps of their size (1e-5 relative); the
losses of two steps, which pass through MAS and the flows, to 1e-5 of their
value; a gradient leaf's norm to 1e-4 of the larger of its own and the
median leaf's (the leaves' norms span six orders); after the first
Adam update a parameter moves by about the learning rate whatever its
gradient's size, so the updated parameters are compared where the gradient's
sign is settled (above a hundredth of the leaf's largest), to a tenth of the
learning rate, on the leaves the benchmark calls moved (a first gradient at
least a thousandth of the median leaf's of both models: an attention key's
bias under softmax has a gradient of round-off alone, and the layers behind
the flows' zero-initialised outputs none at the first step).
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from perfbench import randomness, weights
from perfbench.cfg import Cfg
from perfbench.checks import both_shapes
from perfbench.drivers.train_step_mbistft import make_weights
from perfbench.reference import mb_istft_train as R
from perfbench.reference import step as ref_step
from perfbench.reference.models import mpd as ref_mpd
from perfbench.reference.training import stft_loss as ref_loss
from vits_torch.config import load_hparams
from vits_torch.models.synthesizer import build_synthesizer
from vits_torch.training import losses as L
from vits_torch.training import train as cli
from vits_torch.training.step import create_train_state, replicate_state, train_step

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "perfbench" / "configs" / "ljs_mbistft_train.json"
TINY = dict(inter_channels=96, hidden_channels=48, filter_channels=64, n_layers=1,
            resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
            upsample_initial_channel=32, posterior_layers=2, flow_n_flows=1,
            flow_wn_layers=1, dur_n_flows=1, discriminator_size="probe")
SEED = 2**31 + 22
REL = 1e-5


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tiny_config(tmp: Path, **data) -> Path:
    cfg = json.loads(CONFIG.read_text())
    cfg["model"].update(TINY)
    cfg["train"]["segment_size"] = 2048
    cfg["data"].update(data)
    path = tmp / "ljs_train_tiny.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return tiny_config(tmp_path_factory.mktemp("mbt"))


def parts(path):
    """(program G, program D, reference G, reference D), the same seeded
    weights, the generators' dropout seeded alike."""
    hps = load_hparams(str(path))
    cfg = Cfg(json.loads(path.read_text()))
    pg, pd = build_synthesizer(hps, device="cpu"), cli.build_discriminator(hps, False, "cpu")
    rg, rd = R.build(cfg), ref_mpd.build(cfg)
    w = make_weights(both_shapes(rg, rd), SEED, "cpu")
    for g, d in ((pg, pd), (rg, rd)):
        weights.load(g, {k[2:]: v for k, v in w.items() if k.startswith("g.")})
        weights.load(d, {k[2:]: v for k, v in w.items() if k.startswith("d.")})
    drops = (randomness.install_dropout(pg, "cpu"), randomness.install_dropout(rg, "cpu"))
    return hps, cfg, (pg, pd, rg, rd), drops


def batch_and_noise(b=3, t_x=40, t_y=64, seed=1):
    from perfbench.reference.ops.stft import spectrogram

    g = torch.Generator().manual_seed(seed)
    x = torch.randint(1, 71, (b, t_x), generator=g)
    x[:, ::2] = 0
    x_lengths = torch.tensor([t_x, t_x - 9, t_x - 17][:b])
    x = x * (torch.arange(t_x)[None] < x_lengths[:, None])
    lengths = torch.tensor([t_y, t_y - 11, t_y - 20][:b])
    n = torch.arange(t_y * 256)
    f0 = 90.0 + 210.0 * torch.rand(b, 1, generator=g)
    wav = 0.4 * torch.sin(2 * math.pi * f0 * n / 22050) + 0.02 * torch.randn(b, n.numel(),
                                                                            generator=g)
    wav = wav * (n[None] < lengths[:, None] * 256)
    batch = {"x": x, "x_lengths": x_lengths, "spec": spectrogram(wav, 1024, 256, 1024),
             "spec_lengths": lengths, "wav": wav[:, :, None]}
    noise = {"eps_spec": torch.randn(b, t_y, 96, generator=g),
             "e_q": torch.randn(b, t_x, 2, generator=g), "slice_u": torch.rand(b, generator=g)}
    return batch, noise


def rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("length", [2048, 2053])
def test_discriminator_is_the_reference(path, length):
    _, _, (_, pd, _, rd), _ = parts(path)
    g = torch.Generator().manual_seed(length)
    y, y_hat = torch.randn(2, 1, length, generator=g), torch.randn(2, 1, length, generator=g)
    got, want = pd(y, y_hat), rd(y, y_hat)
    assert len(got[0]) == len(want[0]) == 6
    for a, b in zip(got[0] + got[1], want[0] + want[1]):  # logits
        assert a.shape == b.shape and rel(a, b) < REL
    lengths = [len(f) for f in got[2]]
    assert lengths == [len(f) for f in want[2]] == [7, 6, 6, 6, 6, 6]  # every conv's, conv_post's
    for fa, fb in zip(got[2] + got[3], want[2] + want[3]):
        for a, b in zip(fa, fb):
            assert a.shape == b.shape and rel(a, b) < REL
    assert set(weights.shapes_of(pd)) == set(weights.shapes_of(rd))
    assert "discriminators.5.convs.4.weight_v" in weights.shapes_of(pd)
    assert weights.shapes_of(pd)["discriminators.0.convs.1.weight_v"] == (16, 1, 41)


def test_subband_loss_is_the_reference(path):
    cfg = Cfg(json.loads(path.read_text()))
    t = cfg.train
    g = torch.Generator().manual_seed(3)
    y_mb = 0.1 * torch.randn(2, 4, 512, generator=g)
    y_hat = (0.1 * torch.randn(2, 4, 520, generator=g)).requires_grad_()
    got = L.subband_stft_loss(y_mb, y_hat, t.fft_sizes, t.hop_sizes, t.win_lengths)
    (grad_got,) = torch.autograd.grad(got, y_hat)
    want = ref_loss.subband_stft_loss(cfg, y_mb, y_hat)
    (grad_want,) = torch.autograd.grad(want, y_hat)
    assert abs(float(got.detach()) - float(want.detach())) < REL * float(want.detach())
    assert rel(grad_got, grad_want) < 1e-4
    assert float(grad_got[..., 512:].abs().max()) == 0.0  # the cut samples take no part


def test_training_forward_is_the_reference(path):
    _, _, (pg, _, rg, _), (pdrops, rdrops) = parts(path)
    batch, noise = batch_and_noise()
    for drops in (pdrops, rdrops):
        randomness.reseed_dropout(drops, SEED, "f")
    got = pg(batch["x"], None, batch["x_lengths"], batch["spec"], batch["spec_lengths"], None,
             noise=noise)
    want = rg(batch["x"], batch["x_lengths"], batch["spec"], batch["spec_lengths"], noise=noise)
    assert got["wav"].shape == (3, 2048, 1) and got["wav_bands"].shape == (3, 512, 4)
    for k in ("attn", "ids_slice"):
        assert torch.equal(got[k].float(), want[k].float()), k
    for k in ("wav", "wav_bands", "l_length", "z_p", "m_p", "logs_p", "logs_q", "z_mask"):
        assert got[k].shape == want[k].shape and rel(got[k], want[k]) < REL, k
    # the serving call is the training call's waveform
    z = torch.randn(2, 96, 9, generator=torch.Generator().manual_seed(2))
    wav, bands = pg.waveform_decoder.train_forward(z)
    assert torch.equal(wav, pg.waveform_decoder(z)) and bands.shape == (2, 4, 9 * 64)


def test_two_steps_are_the_reference(path):
    hps, cfg, (pg, pd, rg, rd), (pdrops, rdrops) = parts(path)
    state = create_train_state(pg, pd, hps, steps_per_epoch=100)
    opt_g, opt_d = ref_step.make_adamw(cfg, rg), ref_step.make_adamw(cfg, rd)
    names = ("score", "fm", "mel", "dur", "kl", "subband")
    for s in range(2):
        batch, noise = batch_and_noise(seed=10 + s)
        for drops in (pdrops, rdrops):
            randomness.reseed_dropout(drops, SEED, s)
        got = train_step(state, batch, hps, noise=noise)
        want = R.train_step(rg, rd, opt_g, opt_d, batch, cfg, noise)
        assert set(got) >= {f"loss/g/{k}" for k in names + ("total",)} | {"loss/d/total"}
        for k in names:
            assert abs(float(got[f"loss/g/{k}"]) - float(want[k])) <= REL * abs(float(want[k])), k
        assert abs(float(got["loss/g/total"]) - float(want["g"])) <= REL * float(want["g"])
        assert abs(float(got["loss/d/total"]) - float(want["d"])) <= REL * float(want["d"])
        if s == 0:
            for m, o in ((pg, opt_g), (pd, opt_d)):
                med = statistics.median(o.first_grads.values())
                for n, p in m.named_parameters():
                    want_n = o.first_grads[n]
                    assert abs(float(p.grad.norm()) - want_n) <= 1e-4 * max(want_n, med), n
    lr = float(cfg.train.learning_rate)
    med = statistics.median([*opt_g.first_grads.values(), *opt_d.first_grads.values()])
    for m, r, o in ((pg, rg, opt_g), (pd, rd, opt_d)):
        want = dict(r.named_parameters())
        for n, p in m.named_parameters():
            if o.first_grads[n] < 1e-3 * med:  # round-off alone (an attention key's bias)
                continue
            grad = want[n].grad
            settled = grad.abs() > 1e-2 * grad.abs().max()
            diff = (p - want[n]).detach()[settled].abs()
            assert diff.numel() == 0 or float(diff.max()) < 0.1 * lr, n


def test_build_discriminator_follows_the_model(path):
    from vits_torch.models.avocodo import AvocodoDiscriminator
    from vits_torch.models.mpd import MultiPeriodDiscriminator

    hps = load_hparams(str(path))
    assert isinstance(cli.build_discriminator(hps, False, "cpu"), MultiPeriodDiscriminator)
    with pytest.raises(ValueError, match="computes in float32"):
        cli.build_discriminator(hps, True, "cpu")
    hps.model["pitch"] = "yingram"
    assert isinstance(cli.build_discriminator(hps, False, "cpu"), AvocodoDiscriminator)
    flagship = MultiPeriodDiscriminator(device="cpu")
    assert sum(p.numel() for p in flagship.parameters()) == sum(
        p.numel() for p in ref_mpd.MultiPeriodDiscriminator().parameters())


def test_pitchless_model_has_no_parallel_step(path):
    from vits_torch.parallel import mesh

    hps = load_hparams(str(path))
    model = build_synthesizer(hps, device="cpu")
    state = create_train_state(model, cli.build_discriminator(hps, False, "cpu"), hps, 10)
    with pytest.raises(ValueError, match="trains in one process"):
        replicate_state(state, hps)
    with pytest.raises(ValueError, match="no tensor-parallel"):
        mesh.tp_shard_generator(model)
    hps.model["decoder"] = "hifigan"  # a pitchless HiFi-GAN model has no training forward
    with pytest.raises(ValueError, match="multi-band iSTFT decoder"):
        build_synthesizer(hps, device="cpu").draw_noise(1, 4, 8)


def test_train_cli_trains_two_steps(tmp_path):
    rng = np.random.default_rng(5)
    lines = []
    for i, frames in enumerate((44, 40, 46, 42)):
        n = np.arange(frames * 256)
        wav = 0.3 * np.sin(2 * np.pi * (120 + 20 * i) * n / 22050) \
            + 0.01 * rng.standard_normal(n.size)
        p = tmp_path / f"utt{i}.wav"
        scipy.io.wavfile.write(p, 22050, (wav * 32767).astype(np.int16))
        text = "hɛloʊ wəɹɫd"
        lines.append(f"{p}|ljs|{text}|{' '.join(['3'] * len(text))}")
    for split in ("train", "val"):
        (tmp_path / f"{split}.csv").write_text("\n".join(lines), encoding="utf-8")
    cfg = json.loads(tiny_config(tmp_path, data_path=str(tmp_path),
                                 training_files=str(tmp_path / "train.csv"),
                                 validation_files=str(tmp_path / "val.csv"),
                                 bucket_boundaries=[32, 48], max_text_len=20).read_text())
    cfg["train"].update(batch_size=2, epochs=1, log_interval=1, eval_interval=2,
                        save_interval=2, profile_step=1, seed=3)
    config = tmp_path / "cli.json"
    config.write_text(json.dumps(cfg))
    # the run's logger is process-wide and named by this directory: under
    # "run" it would keep tests/test_train_loop.py's later run in the same
    # worker from writing a train.log of its own
    model_dir = tmp_path / "ljs_run"
    report = cli.main(["-c", str(config), "-m", str(model_dir), "--device", "cpu"])
    assert report.state.step == 2 and len(report.evals) == 1
    assert {"loss/g/subband", "loss/g/total", "loss/d/total"} <= set(report.last_metrics)
    assert all(math.isfinite(v) for v in report.last_metrics.values())
    assert math.isnan(report.evals[0]["scalars"]["val/yin_dec"])
    assert not list(tmp_path.glob("*.ying.npy")) and len(list(tmp_path.glob("*.spec.npy"))) == 4
    assert (model_dir / "train_2").exists() or list(model_dir.glob("*2*"))
    trace = (model_dir / "trace.json").read_text()
    for name in ("vits.disc.msd", "vits.disc.mpd", "vits.train.subband_loss"):
        assert name in trace, name


def test_remat_and_nan_guard_as_for_the_pitch_model(path):
    """``remat_run`` (the forward and each discriminator call replayed in the
    backward) gives the step it replays; ``nan_guard`` keeps a finite update
    and reverts one whose loss is not finite. Dropout off: a replay would draw
    new masks from the seeded modules' own generators."""
    out = {}
    for remat, poison in ((False, False), (True, False), (False, True)):
        hps, _, (pg, pd, _, _), (drops, _) = parts(path)
        for m in drops.values():
            m.p = 0.0
        hps.train["remat_run"], hps.train["nan_guard"] = remat, True
        state = create_train_state(pg, pd, hps, steps_per_epoch=100)
        batch, noise = batch_and_noise()
        if poison:
            batch["spec"][0, 0, 0] = float("nan")
        before = [p.detach().clone() for p in pg.parameters()]
        out[remat, poison] = train_step(state, batch, hps, noise=noise)
        moved = any(not torch.equal(a, p) for a, p in zip(before, pg.parameters()))
        assert moved != poison
    sound, replayed, poisoned = out[False, False], out[True, False], out[False, True]
    assert float(sound["nan_skipped/g"]) == float(replayed["nan_skipped/g"]) == 0.0
    assert float(poisoned["nan_skipped/g"]) == 1.0
    for k in sound:
        assert abs(float(replayed[k]) - float(sound[k])) <= REL * max(abs(float(sound[k])), 1), k
