"""The port's checkpoints (``vits_torch/training/checkpoint.py``) against the
JAX package's convention, on the CPU: the full ``TrainState`` round trip
(generator, discriminator, both AdamW states, step, epoch), ``keep_ckpts``
pruning and ``latest_checkpoint`` with the JAX package's names, the
``merge_compatible`` counts, the engine's checkpoint loading, and a JAX
``eval_{step}`` carried by ``tools/orbax_to_torch.py`` into the port's engine.

Tolerances: the round trip is exact (``torch.save`` keeps every bit). The
converted checkpoint's audio is held to the JAX engine's at rtol/atol 1e-4,
as ``tests/test_torch_serve.py`` holds the two engines (XLA and PyTorch sum
f32 in other orders), with the decoder's gains raised (x24) so the audio is
not the init's bias-level hum.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from vits_tpu.serve.engine import TTSEngine as JaxEngine
from vits_tpu.training import checkpoint as jckpt
from vits_tpu.training.step import TrainState as JaxTrainState
from vits_tpu.utils.convert_torch import convert_synthesizer

from vits_torch.config import HParams
from vits_torch.models.avocodo import probe_discriminator
from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.serve.engine import TTSEngine
from vits_torch.training import checkpoint as ckpt
from vits_torch.training.step import create_train_state, train_step

from tests.test_torch_modules import perturb_zeros
from tests.test_torch_serve import CFG, _merge, _scale_gains, jax_noise
from tests.test_train_step import TINY, _make_batch

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
HPS = HParams(
    train=dict(learning_rate=2e-4, betas=[0.8, 0.99], eps=1e-9, lr_decay=0.999875,
               segment_size=2048, c_mel=45, c_kl=1.0, c_yin=45.0),
    data=dict(filter_length=1024, hop_length=256, win_length=1024, n_mel_channels=80,
              mel_fmin=0.0, mel_fmax=None, sampling_rate=22050),
)


def _state(seed):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = SynthesizerTrn(**TINY, device="cpu")
        disc = probe_discriminator(segment_size=2048, device="cpu")
    return create_train_state(model, disc, HPS, steps_per_epoch=3)


def _step(state, seed):
    train_step(state, _make_batch(), HPS, generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """A state after two steps, saved at step 2 (epoch 1), loaded into a
    state built from other weights."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    src = _state(0)
    with torch.random.fork_rng():
        torch.manual_seed(1)
        _step(src, 0)
        _step(src, 1)
    sizes = ckpt.save_checkpoint(d, 2, src, epoch=1)
    dst, epoch = ckpt.load_checkpoint(ckpt.latest_checkpoint(d), _state(7))
    return d, src, dst, epoch, sizes


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_save_writes_the_dual_artifacts(round_trip):
    d, _, _, _, sizes = round_trip
    assert sorted(os.listdir(d)) == ["eval_2", "train_2"]
    assert {os.path.basename(p) for p in sizes} == {"eval_2", "train_2"}
    for p, n in sizes.items():
        assert os.path.getsize(p) == n
    payload = torch.load(os.path.join(d, "train_2"), weights_only=True)
    assert set(payload) == {"state", "epoch"}
    assert set(payload["state"]) == {"step", "g_params", "d_params", "g_opt_state",
                                     "d_opt_state"}


@pytest.mark.parametrize("part", ["model", "disc", "optim_g", "optim_d"])
def test_round_trip_exact(round_trip, part):
    _, src, dst, _, _ = round_trip
    a, b = getattr(src, part), getattr(dst, part)
    assert a is not b
    _assert_tree_equal(a.state_dict(), b.state_dict())
    if part.startswith("optim"):  # both Adam moments are live after two steps
        moments = [s["exp_avg_sq"] for s in a.state_dict()["state"].values()]
        assert len(moments) == len(list(getattr(src, "model" if part == "optim_g"
                                                else "disc").parameters()))
        assert all(bool(m.any()) for m in moments)


def test_round_trip_step_and_epoch(round_trip):
    _, src, dst, epoch, _ = round_trip
    assert (dst.step, epoch) == (src.step, 1) == (2, 1)


def test_loaded_state_continues_as_the_saved_one(round_trip):
    """One more step from the loaded state equals one more from the saved
    state, bit for bit (weights, moments, schedule count)."""
    _, src, dst, _, _ = round_trip
    for st in (src, dst):
        for m in (st.model, st.disc):  # same dropout masks from the same seed
            m.train()
        with torch.random.fork_rng():
            torch.manual_seed(3)
            _step(st, 2)
    for part in ("model", "disc", "optim_g", "optim_d"):
        _assert_tree_equal(getattr(src, part).state_dict(), getattr(dst, part).state_dict())


def test_eval_artifact_is_the_generator(round_trip):
    d, _, _, _, _ = round_trip
    g = ckpt.load_eval_params(os.path.join(d, "eval_2"))
    saved = torch.load(os.path.join(d, "train_2"), weights_only=True)["state"]["g_params"]
    _assert_tree_equal(dict(saved), dict(g))
    assert list(g) == list(_state(0).model.state_dict())


def _dummy_jax_state():
    return JaxTrainState(
        step=jnp.asarray(3), g_params={"a": jnp.ones((2, 3))}, d_params={"w": jnp.ones(5)},
        g_opt_state={"m": jnp.zeros((2, 3))}, d_opt_state={"m": jnp.zeros(5)},
    )


def test_keep_ckpts_prunes_as_the_jax_package(tmp_path):
    state = _state(0)
    listings = []
    for name, save, st in (("jax", jckpt.save_checkpoint, _dummy_jax_state()),
                           ("port", ckpt.save_checkpoint, state)):
        d = str(tmp_path / name)
        for step in [10, 20, 30, 40]:
            save(d, step, st, epoch=0, keep_ckpts=2)
        listings.append(sorted(os.listdir(d)))
        assert ckpt.latest_checkpoint(d).endswith("train_40")
        assert ckpt.latest_checkpoint(d, "eval").endswith("eval_40")
    assert listings[1] == listings[0] == ["eval_30", "eval_40", "train_30", "train_40"]


@pytest.mark.parametrize("make", ["empty", "missing", "other files"])
def test_latest_checkpoint_without_checkpoints(tmp_path, make):
    d = tmp_path / "run"
    if make != "missing":
        d.mkdir()
    if make == "other files":
        for n in ("train.log", "train_x", "eval_", "config.yaml", "train_3.tmp"):
            (d / n).write_text("")
    assert ckpt.latest_checkpoint(str(d)) is None
    assert jckpt.latest_checkpoint(str(d)) is None


def test_merge_compatible_counts_as_the_jax_package():
    rng = np.random.default_rng(0)
    init = {"a": np.zeros((2, 3)), "b": np.zeros(4), "new": np.zeros(7), "c.d": np.zeros(2)}
    loaded = {"a": rng.standard_normal((2, 3)), "b": np.ones(5), "old": np.ones(1),
              "c.d": rng.standard_normal(2)}
    ref, used_j, skipped_j = jckpt.merge_compatible(init, loaded)
    out, used, skipped = ckpt.merge_compatible(
        {k: torch.from_numpy(v) for k, v in init.items()},
        {k: torch.from_numpy(v) for k, v in loaded.items()},
    )
    assert (used, skipped) == (used_j, skipped_j) == (2, 2)
    assert list(out) == list(init)
    for k in init:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_merge_compatible_into_a_model():
    """A generator of another width takes only what fits (transfer)."""
    small = _state(0).model.state_dict()
    with torch.random.fork_rng():
        torch.manual_seed(5)
        other = SynthesizerTrn(**dict(TINY, hidden_channels=48), device="cpu").state_dict()
    merged, used, skipped = ckpt.merge_compatible(small, other)
    fits = [k for k in small if k in other and other[k].shape == small[k].shape]
    assert used == len(fits) and skipped == len(small) - len(fits) and 0 < used < len(small)
    for k in small:
        assert torch.equal(merged[k], other[k] if k in fits else small[k])


# ---- the engine's checkpoints; a JAX eval_{step} served by the port ------


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", ROOT / "tools" / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A JAX eval_{step} with the full generator tree, written by the JAX
    package's save_checkpoint, and the port's file made from it by the
    tool; the config of tests/test_torch_serve.py."""
    root = tmp_path_factory.mktemp("convert")
    cfg = root / "config.yaml"
    cfg.write_text(yaml.safe_dump(CFG))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        port = TTSEngine(str(cfg), max_frames=96, device="cpu")
    jeng = JaxEngine(str(cfg), checkpoint_path=None, max_frames=96)
    full = convert_synthesizer(port.model.state_dict(), n_layers_text=1, n_kernels=1,
                               resblock_convs=2)["params"]
    params = perturb_zeros({"params": _merge(full, jeng.params["params"])}, seed=2)["params"]
    params["waveform_decoder"] = _scale_gains(params["waveform_decoder"])
    state = _dummy_jax_state().replace(g_params=params)
    jckpt.save_checkpoint(str(root / "jax"), 40, state, epoch=3)
    src = str(root / "jax" / "eval_40")
    out = _load_tool().main([src, "-c", str(cfg), "--out-dir", str(root / "torch")])
    return cfg, src, out


@pytest.fixture(scope="module")
def served(converted):
    cfg, src, out = converted
    jeng = JaxEngine(str(cfg), checkpoint_path=src, max_frames=96)
    port = TTSEngine(str(cfg), checkpoint_path=out, max_frames=96, device="cpu",
                     noise_fn=jax_noise)
    return jeng, port


def test_converter_writes_a_port_eval_checkpoint(converted):
    cfg, _, out = converted
    assert os.path.basename(out) == "eval_40"
    g = ckpt.load_eval_params(out)
    with torch.random.fork_rng():
        model = TTSEngine(str(cfg), max_frames=96, device="cpu").model
    assert set(g) == set(model.state_dict())


@pytest.mark.parametrize("text,speaker,seed,shift", [
    ("[P]ni3#hao3 shi4#jie4[P]", 0, 1, 0),
    ("[ZH]今天[ZH][EN]good morning[EN][JA]ありがとう[JA]", 1, 2, 5),
])
def test_converted_checkpoint_serves_as_the_jax_engine(served, text, speaker, seed, shift):
    jeng, port = served
    ref = jeng.synthesize(text, speaker, seed, shift)
    out = port.synthesize(text, speaker, seed, shift)
    assert out[0] == ref[0]
    a, r = out[1][1], ref[1][1]
    assert a.shape == r.shape and np.abs(r).max() > 0.05  # audio with signal
    np.testing.assert_allclose(a, r, **TOL)


def test_converted_checkpoint_voice_conversion_as_the_jax_engine(served):
    """VC runs the posterior encoders: the whole saved tree was carried."""
    jeng, port = served
    rng = np.random.default_rng(4)
    t = np.arange(6000) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 150 * t) + 0.01 * rng.standard_normal(6000)).astype(np.float32)
    np.testing.assert_allclose(port.voice_conversion(wav, 0, 1, seed=3),
                               jeng.voice_conversion(wav, 0, 1, seed=3), **TOL)


def test_engine_takes_eval_file_and_bare_state_dict(converted, tmp_path):
    cfg, _, out = converted
    bare = tmp_path / "generator.pt"
    torch.save(ckpt.load_eval_params(out), bare)
    a = TTSEngine(str(cfg), checkpoint_path=out, max_frames=96, device="cpu")
    b = TTSEngine(str(cfg), checkpoint_path=str(bare), max_frames=96, device="cpu")
    _assert_tree_equal(dict(a.model.state_dict()), dict(b.model.state_dict()))
    text = "[P]ni3#hao3[P]"
    np.testing.assert_array_equal(a.synthesize(text, seed=4)[1][1], b.synthesize(text, seed=4)[1][1])


def test_engine_load_is_strict(converted, tmp_path):
    cfg, _, out = converted
    g = dict(ckpt.load_eval_params(out))
    g.pop(next(iter(g)))
    partial = tmp_path / "eval_1"
    torch.save({"g_params": g}, partial)
    with pytest.raises(RuntimeError, match="Missing key"):
        TTSEngine(str(cfg), checkpoint_path=str(partial), max_frames=96, device="cpu")
