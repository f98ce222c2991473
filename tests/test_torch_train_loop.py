"""The port's training run (``vits_torch/training/train.py``, ``evaluate.py``)
against the JAX package's, on the CPU at ``tests/test_train_loop.py``'s
TINY_CONFIG:

  * ``evaluate``: the validation scalars within rtol/atol 1e-4 of the JAX
    ``evaluate`` (f32 forward through the tiny generator, XLA against PyTorch
    summation order), the JAX draws of ``PRNGKey(0/1/2)`` handed to the port
    through ``noise=``; the logged sample audio within the same tolerance
    (decoder gains x24 so the audio has signal), the ground truth exact;
  * the batches ``run`` feeds ``train_step``, across an epoch boundary and a
    resume, exactly those of the JAX ``run`` (both steps replaced by a
    recorder, so no model runs);
  * the run's files (checkpoints, ``train.log``, ``config.yaml``,
    ``githash``, TensorBoard events, a profiler trace);
  * resume: 4 steps in one run equal 2 steps plus 2 resumed ones, bit for bit
    (parameters and both optimizers' moments), dropout live: every step
    seeds its noise and dropout from (seed, step). The dataset is one batch
    an epoch, the same batch every epoch, because a resumed run repeats the
    epoch it was saved in (as the JAX loop does).
"""

import copy
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile
import torch
import yaml

import jax

from vits_tpu.config import get_hparams as j_get_hparams, synthesizer_kwargs
from vits_tpu.data.dataset import DataIterator, DistributedBucketSampler
from vits_tpu.models.synthesizer import SynthesizerTrn as JaxSynthesizer
from vits_tpu.text.symbols import symbols as j_symbols
from vits_tpu.training import evaluate as j_eval
from vits_tpu.training import train as j_train
from vits_tpu.training.step import TrainState as JaxTrainState
from vits_tpu.utils import convert_torch as C

from vits_torch.config import get_hparams
from vits_torch.models.synthesizer import build_synthesizer
from vits_torch.training import evaluate as t_eval
from vits_torch.training import train as t_train
from vits_torch.utils import logging_utils
from vits_torch.utils.convert_jax import load_flax_params

from tests.test_torch_modules import perturb_zeros
from tests.test_torch_serve import _scale_gains
from tests.test_train_loop import TINY_CONFIG

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)


def _write_data(d, frames, texts=("ni→xɑʊ↓↑", "hɛloʊ wəɹɫd")):
    rng = np.random.default_rng(0)
    lines = []
    for i, n in enumerate(frames):
        wav = (rng.standard_normal(n * 256) * 2000).astype(np.int16)
        path = d / f"utt{i}.wav"
        scipy.io.wavfile.write(path, 22050, wav)
        text = texts[i % len(texts)]
        lines.append(f"{path}|S{i % 2}|{text}|{' '.join(['0'] * len(text))}")
    return lines


def _config(d, train=None, data=None):
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["data"].update(data_path=str(d), training_files=str(d / "train.csv"),
                       validation_files=str(d / "val.csv"), **(data or {}))
    cfg["train"].update(train or {})
    path = d / "config.yaml"
    path.write_text(yaml.safe_dump(cfg, allow_unicode=True))
    return str(path)


# ---- evaluate --------------------------------------------------------------


def _flax_params(sd, m):
    """Port state_dict -> flax tree at TINY_CONFIG's depths."""
    return {"params": {
        "text_encoder": C._text_encoder(sd, "text_encoder", m["n_layers"]),
        "posterior_encoder": C._posterior_encoder(sd, "posterior_encoder",
                                                  m["posterior_layers"], True),
        "pitch_encoder": C._posterior_encoder(sd, "pitch_encoder", m["posterior_layers"], True),
        "flow": C._coupling_block(sd, "flow", m["flow_n_flows"], m["flow_wn_layers"], True),
        "duration_predictor": C._sdp(sd, "duration_predictor", m["dur_n_flows"], True),
        "waveform_decoder": C._hifigan(sd, "waveform_decoder", 4,
                                       len(m["resblock_kernel_sizes"]),
                                       len(m["resblock_dilation_sizes"][0])),
        "yin_decoder": C._ying_decoder(sd, "yin_decoder", m["yin_dec_layers"], True),
        "emb_g": {"embedding": C._np(sd["emb_g.weight"])},
    }}


class Recorder:
    """A SummaryWriter's surface that keeps what it is given."""

    def __init__(self):
        self.scalars, self.images, self.audios = {}, {}, {}

    def add_scalar(self, k, v, step):
        self.scalars[k] = v

    def add_image(self, k, v, step, dataformats=None):
        self.images[k] = v

    def add_audio(self, k, v, step, sr):
        self.audios[k] = np.asarray(v)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    lines = _write_data(d, [48, 44, 40, 47])
    (d / "train.csv").write_text("\n".join(lines), encoding="utf-8")
    (d / "val.csv").write_text("\n".join(lines), encoding="utf-8")
    cfg = _config(d, train={"n_sample": 2})
    hps = j_get_hparams(cfg, str(d / "jax_run"))
    val_ds = j_train.build_dataset(hps, "val")
    sampler = DistributedBucketSampler(val_ds.lengths, 2, hps.data.bucket_boundaries,
                                       shuffle=False)
    batches = list(DataIterator(val_ds, sampler, text_bound=2 * 20 + 4, num_workers=1))
    assert len(batches) == 2

    with torch.random.fork_rng():
        torch.manual_seed(0)
        port = build_synthesizer(get_hparams(cfg, str(d / "run")), device="cpu")
    params = perturb_zeros(_flax_params(port.state_dict(), TINY_CONFIG["model"]), seed=1)
    params["params"]["waveform_decoder"] = _scale_gains(params["params"]["waveform_decoder"])
    load_flax_params(port, params)
    jm = JaxSynthesizer(**synthesizer_kwargs(hps, len(j_symbols)))
    return hps, batches, jm, params, port


def _jax_draws(hps, batch, n_sample):
    """The draws of the JAX evaluate: PRNGKey(0) for each validation batch
    (split as __call__ splits it), PRNGKey(1) for the sample synthesis
    (split as infer_pre_decoder splits it), PRNGKey(2) for the yin decoder."""
    m = hps.model
    b, t_x = batch["x"].shape
    t_y = batch["spec"].shape[1]
    r = jax.random.split(jax.random.PRNGKey(0), 5)
    r_dur, r_noise = jax.random.split(jax.random.PRNGKey(1), 2)
    draws = {
        "val": {
            "eps_spec": jax.random.normal(r[0], (b, t_y, m.inter_channels - m.yin_channels)),
            "eps_yin": jax.random.normal(r[1], (b, t_y, m.yin_channels)),
            "scope_shift": jax.random.randint(r[2], (b,), -m.yin_shift_range, m.yin_shift_range),
            "e_q": jax.random.normal(r[3], (b, t_x, 2)),
            "slice_u": jax.random.uniform(r[4], (b,)),
        },
        "samples": {
            "sdp_noise": jax.random.normal(r_dur, (n_sample, t_x, 2)),
            "eps": jax.random.normal(r_noise, (n_sample, 1024, m.inter_channels)),
        },
        "yin_dec": {"scope_shift": jax.random.randint(
            jax.random.PRNGKey(2), (n_sample,), -m.yin_shift_range, m.yin_shift_range)},
    }
    return {k: {n: np.asarray(v) for n, v in g.items()} for k, g in draws.items()}


@pytest.fixture(scope="module", params=[0, 2], ids=["step0", "step2"])
def evaluated(request, eval_setup):
    hps, batches, jm, params, port = eval_setup
    assert t_eval.SAMPLE_MAX_FRAMES == 1024  # the JAX evaluate's max_frames
    step = request.param
    jw, tw = Recorder(), Recorder()
    ref = j_eval.evaluate(jm, params["params"], batches, jw, step, hps)
    noise = _jax_draws(hps, batches[0], 2)
    port.train()  # evaluate switches to eval() and back
    out = t_eval.evaluate(port, batches, tw, step, hps, noise=noise)
    assert port.training
    return step, ref, out, jw, tw


def test_evaluate_scalars_match_jax(evaluated):
    _, ref, out, jw, tw = evaluated
    assert set(out) == set(ref) == {"val/mel", "val/yin_dec"}
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], **TOL, err_msg=k)
        np.testing.assert_allclose(tw.scalars[k], jw.scalars[k], **TOL, err_msg=k)


def test_evaluate_sample_payload_matches_jax(evaluated):
    step, _, _, jw, tw = evaluated
    assert set(tw.audios) == set(jw.audios)
    assert set(tw.images) == set(jw.images)
    assert ("gt/0_audio" in tw.audios) == (step == 0) and "gen/1_audio_shift" in tw.audios
    for k, r in jw.audios.items():
        o = tw.audios[k]
        assert o.shape == r.shape and o.dtype == r.dtype, k
        if k.startswith("gt/"):
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            assert np.abs(r).max() > 0.05, k  # audio with signal
            np.testing.assert_allclose(o, r, **TOL, err_msg=k)
    for k, r in jw.images.items():
        assert tw.images[k].shape == r.shape and tw.images[k].dtype == np.uint8, k


def test_evaluate_sample_outputs_match_jax(eval_setup):
    """Every array of the sample synthesis (before plotting) against the JAX
    sample program's."""
    hps, batches, jm, params, port = eval_setup
    j_eval.evaluate(jm, params["params"], batches[:1], Recorder(), 2, hps)
    sample_fn = j_eval._JIT_CACHE["samples"]
    b = batches[0]
    ref = sample_fn(params["params"], *(b[k][:2] for k in ("x", "t", "x_lengths", "sid", "spec")))
    with torch.no_grad():
        out = t_eval._sample_outputs(port.eval(), b, 2, hps, _jax_draws(hps, b, 2))
    assert set(out) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert out[k].shape == r.shape, k
        if k == "y_lengths":
            np.testing.assert_array_equal(out[k], r)
        else:
            np.testing.assert_allclose(out[k], r, **TOL, err_msg=k)


def test_evaluate_max_batches_and_no_writer(eval_setup):
    hps, batches, _, _, port = eval_setup
    noise = _jax_draws(hps, batches[0], 2)
    one = t_eval.evaluate(port, batches, None, 2, hps, max_batches=1, noise=noise)
    both = t_eval.evaluate(port, batches, None, 2, hps, noise=noise)
    first = t_eval.evaluate(port, batches[:1], None, 2, hps, noise=noise)
    assert one == first and one != both
    empty = t_eval.evaluate(port, [], None, 2, hps)
    assert all(np.isnan(v) for v in empty.values())


def test_evaluate_without_matplotlib_logs_audio_only(eval_setup, monkeypatch):
    hps, batches, _, _, port = eval_setup
    monkeypatch.setattr(t_eval, "have_matplotlib", lambda: False)
    w = Recorder()
    t_eval.evaluate(port, batches[:1], w, 0, hps)
    assert not w.images and {"gen/0_audio", "gt/0_audio"} <= set(w.audios)
    assert set(w.scalars) == {"val/mel", "val/yin_dec"}


def test_evaluate_draws_from_seeded_generators(eval_setup):
    """Without noise= the draws come from generators seeded 0, 1 and 2:
    the same scalars and audio every call."""
    hps, batches, _, _, port = eval_setup
    a, b = Recorder(), Recorder()
    ra = t_eval.evaluate(port, batches, a, 2, hps)
    rb = t_eval.evaluate(port, batches, b, 2, hps)
    assert ra == rb
    for k in a.audios:
        np.testing.assert_array_equal(a.audios[k], b.audios[k])


# ---- the batches run feeds the step, against the JAX run -------------------


class _NoJit:
    """The JAX train module's ``jax`` with ``jit`` as the identity, so the
    recorded step sees concrete arrays."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        return fn


def _jax_recorded_run(monkeypatch, cfg, model_dir, fed):
    import jax.numpy as jnp

    def fake_state(rng, model, disc, optim_g, optim_d, batch, jit_init=True):
        return JaxTrainState(step=jnp.zeros((), jnp.int32), g_params={"w": jnp.zeros(2)},
                             d_params={"w": jnp.zeros(2)}, g_opt_state={"m": jnp.zeros(2)},
                             d_opt_state={"m": jnp.zeros(2)})

    def fake_step(state, batch, rng, **kw):
        fed.append((int(state.step) + 1, {k: np.asarray(v) for k, v in batch.items()}))
        return state.replace(step=state.step + 1), {"loss/g/total": 0.0, "loss/d/total": 0.0}

    monkeypatch.setattr(j_train, "jax", _NoJit())
    monkeypatch.setattr(j_train, "create_train_state", fake_state)
    monkeypatch.setattr(j_train, "train_step", fake_step)
    monkeypatch.setattr(j_train, "evaluate", lambda *a, **k: {})
    hps = j_get_hparams(cfg, model_dir)
    # The JAX run's init batch leaves a loader thread running ahead beside
    # the first epoch's, and its dataset writes a voice's feature cache with
    # np.save, not atomically. With create_train_state faked (no XLA init in
    # between), the epoch's thread could load a half-written cache (EOFError):
    # that thread dies and the run waits for its batches forever. The same
    # dataset code caches every voice first, one at a time.
    train_ds = j_train.build_dataset(hps, "train")
    for i in range(len(train_ds)):
        train_ds[i]
    j_train.run(hps)


def _port_recorded_run(monkeypatch, cfg, model_dir, fed):
    def fake_step(state, batch, hps, generator=None, noise=None):
        state.step += 1
        fed.append((state.step, {k: v.numpy() for k, v in batch.items()}))
        return {"loss/g/total": torch.tensor(0.0), "loss/d/total": torch.tensor(0.0)}

    monkeypatch.setattr(t_train, "train_step", fake_step)
    monkeypatch.setattr(t_train, "evaluate", lambda *a, **k: {})
    return t_train.run(get_hparams(cfg, model_dir), device="cpu")


def test_run_feeds_the_steps_the_jax_run_feeds(tmp_path, monkeypatch):
    """Two buckets, 4 batches an epoch: 2 epochs, then resumed to 3 (the
    saved epoch runs again), the same batches in the same order."""
    lines = _write_data(tmp_path, [30, 48, 28, 45, 33, 50, 36, 60],
                        texts=("ni→xɑʊ↓↑", "hɛloʊ wəɹɫd", "a", "konn^itʃiwa"))
    (tmp_path / "train.csv").write_text("\n".join(lines), encoding="utf-8")
    (tmp_path / "val.csv").write_text("\n".join(lines[:2]), encoding="utf-8")
    fed = {"jax": [], "port": []}
    reports = []
    for epochs in (2, 3):
        cfg = _config(tmp_path, train={"epochs": epochs, "save_interval": 4},
                      data={"bucket_boundaries": [16, 40, 64]})
        _jax_recorded_run(monkeypatch, cfg, str(tmp_path / "jax_run"), fed["jax"])
        reports.append(_port_recorded_run(monkeypatch, cfg, str(tmp_path / "port_run"),
                                          fed["port"]))
    assert [s for s, _ in fed["port"]] == [s for s, _ in fed["jax"]] == list(range(1, 17))
    for (step, o), (_, r) in zip(fed["port"], fed["jax"]):
        assert set(o) == set(r)
        for k in r:
            assert o[k].dtype == r[k].dtype, (step, k)
            np.testing.assert_array_equal(o[k], r[k], err_msg=f"step {step} {k}")
    # the resumed run starts the saved epoch again
    assert (reports[1].start_step, reports[1].start_epoch) == (8, 1)
    # batches differ between epochs, so the order was really checked
    assert not np.array_equal(fed["port"][0][1]["x"], fed["port"][4][1]["x"])


# ---- a real run: files, resume ---------------------------------------------


@pytest.fixture(scope="module")
def real_runs(tmp_path_factory):
    """Run A: 4 epochs in one go. Run B: 2 epochs, then resumed to 3 (it
    repeats epoch 1). One batch an epoch: two utterances of different
    lengths, so the collated batch is the same every epoch."""
    d = tmp_path_factory.mktemp("runs")
    lines = _write_data(d, [48, 40])
    (d / "train.csv").write_text("\n".join(lines), encoding="utf-8")
    (d / "val.csv").write_text("\n".join(lines), encoding="utf-8")
    a = t_train.main(["-c", _config(d, train={"epochs": 4, "profile_step": 3}),
                      "-m", str(d / "a"), "--device", "cpu"])
    b1 = t_train.main(["-c", _config(d, train={"epochs": 2}), "-m", str(d / "b"),
                       "--device", "cpu"])
    b2 = t_train.main(["-c", _config(d, train={"epochs": 3}), "-m", str(d / "b"),
                       "--device", "cpu"])
    return d, a, b1, b2


def test_run_writes_its_files(real_runs):
    d, a, _, _ = real_runs
    names = sorted(os.listdir(d / "a"))
    # steps 1-4, save every 2, keep 2
    assert [n for n in names if n.startswith(("train_", "eval_"))] == \
        ["eval_2", "eval_4", "train_2", "train_4"]
    assert {"train.log", "config.yaml", "trace.json"} <= set(names)
    assert ("githash" in names) == (ROOT / ".git").exists()
    assert any("tfevents" in n for n in names)
    log = (d / "a" / "train.log").read_text()
    assert "step 4 | g" in log and "saved checkpoint at step 4" in log
    assert a.state.step == 4 and len(a.evals) == 2 and len(a.checkpoints) == 2
    assert len(a.data_wait_s) == 4 and all(np.isfinite(list(a.last_metrics.values())))


def test_resume_continues_the_step_count(real_runs):
    _, a, b1, b2 = real_runs
    assert (b1.start_step, b1.start_epoch, b1.state.step) == (0, 0, 2)
    assert (b2.start_step, b2.start_epoch, b2.state.step) == (2, 1, 4)
    assert [e["step"] for e in b2.evals] == [4]


@pytest.mark.parametrize("part", ["model", "disc", "optim_g", "optim_d"])
def test_resumed_run_equals_the_unbroken_run(real_runs, part):
    _, a, _, b2 = real_runs
    sa, sb = getattr(a.state, part).state_dict(), getattr(b2.state, part).state_dict()
    if part.startswith("optim"):
        assert sa["param_groups"] == sb["param_groups"]
        sa, sb = sa["state"], sb["state"]
        assert set(sa) == set(sb) and all(int(s["step"]) == 4 for s in sa.values())
        pairs = [(f"{i}.{k}", s[k], sb[i][k]) for i, s in sa.items() for k in s]
    else:
        pairs = [(k, v, sb[k]) for k, v in sa.items()]
    for name, x, y in pairs:
        assert torch.equal(x, y), name
    assert a.last_metrics == b2.last_metrics


def test_step_seeds_are_per_step():
    seeds = [t_train.step_seeds(1234, s) for s in range(50)]
    assert seeds == [t_train.step_seeds(1234, s) for s in range(50)]
    assert len({x for pair in seeds for x in pair}) == 100
    assert t_train.step_seeds(1, 0) != t_train.step_seeds(2, 0)


def test_distributed_is_not_ported_yet(tmp_path, monkeypatch):
    """``--distributed`` is ported (tests/test_torch_graft_entry.py runs it
    under torchrun); started outside torchrun it names what is missing
    before it touches the run's directory."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="needs the environment torchrun sets"):
        t_train.main(["-c", "c.yaml", "-m", str(tmp_path / "run"), "--distributed",
                      "--device", "cpu"])
    assert not (tmp_path / "run").exists()


def test_discriminator_size_typo_raises():
    from vits_torch.config import HParams

    hps = HParams(model={"discriminator_size": "Probe"}, train={"segment_size": 2048})
    with pytest.raises(ValueError, match="flagship' or 'probe"):
        t_train.build_discriminator(hps, False, "cpu")


def test_writer_without_tensorboard_names_it_once(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = logging_utils.get_logger(str(tmp_path))
    w = logging_utils.make_writer(str(tmp_path), logger)
    assert isinstance(w, logging_utils.NullWriter)
    logging_utils.summarize(w, 1, scalars={"a": 1.0}, images={"i": np.zeros((2, 2, 3))},
                            audios={"x": np.zeros(4)})
    w.close()
    for h in logger.handlers:
        h.flush()
    log = (tmp_path / "train.log").read_text()
    assert log.count("no TensorBoard summaries") == 1
    assert not any("tfevents" in n for n in os.listdir(tmp_path))
