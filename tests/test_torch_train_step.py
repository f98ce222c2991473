"""The port's GAN training step (``vits_torch/training/step.py``) against the
JAX package's (``vits_tpu/training/step.py``), on the CPU at the tiny
configuration of ``tests/test_train_step.py`` with the probe discriminator.

Same weights in both (the port's fresh generator, its zero-init heads
perturbed, carried across by the converters; the flax probe discriminator's
init carried into the port), the same batch, and the same randomness: the
JAX step's key folded with the step and split as ``step.py`` and the model
split it, the draws handed to the port through ``noise=``. Dropout cannot be
matched across packages (JAX's masks are not torch's), so the parity step
makes it inert on both sides: the JAX model is a test-side subclass whose
``__call__`` forces ``deterministic=True``, and the port's ``nn.Dropout``s
get p=0. ``test_dropout_is_live_in_the_step`` shows it is live otherwise.

The JAX gradients are read off the JAX step itself: each optimizer is
``optax.chain(keep_grads(), make_optimizer(...))``, which updates exactly as
``make_optimizer`` and keeps the gradient it was given in its state.

Tolerances, by reason:
  METRICS  rtol 1e-4: 13 losses and norms after a generator forward, a D
           update and a G backward, all f32, summed in other orders.
  GRADS    per tensor, |g_port - g_jax| <= 1e-3 |g_jax| + 1e-6 |grad_norm|:
           f32 backward through ~40 layers in another order; a tensor whose
           gradient is at the noise floor of the whole is held absolutely.
  ADAMW    rtol 1e-6, atol 1e-9: the same f32 AdamW arithmetic on identical
           gradients, in another order of operations.
  REMAT    rtol 1e-4 (losses), rtol 1e-3 / atol 1e-6 (parameters), as the
           JAX package holds its own remat step (tests/test_train_step.py).
``attn`` and ``ids_slice`` match exactly.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.models.avocodo import probe_discriminator as j_probe
from vits_tpu.models.synthesizer import SynthesizerTrn as JaxSynthesizer
from vits_tpu.ops.phaseaug import sample_phi as j_sample_phi
from vits_tpu.training import step as j_step
from vits_tpu.utils import convert_torch as C

from vits_torch.config import HParams
from vits_torch.models.avocodo import probe_discriminator
from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.training import step as t_step
from vits_torch.utils.convert_jax import flax_to_state_dict, load_flax_params

from tests.test_torch_modules import perturb_zeros
from tests.test_train_step import HPS as J_HPS, TINY, _make_batch

METRICS = dict(rtol=1e-4, atol=0)
ADAMW = dict(rtol=1e-6, atol=1e-9)
METRIC_NAMES = (
    "loss/g/score", "loss/g/fm", "loss/g/mel", "loss/g/dur", "loss/g/kl", "loss/g/yindec",
    "loss/g/yinshift", "loss/g/total", "loss/d/total", "loss/d/real", "loss/d/gen",
    "grad_norm/g", "grad_norm/d",
)
SEG = 2048
HPS = HParams(**J_HPS.to_dict())


class DeterministicSynthesizer(JaxSynthesizer):
    """The flax generator with dropout off whatever the caller asks."""

    def __call__(self, *args, deterministic=True, **kwargs):
        del deterministic
        return super().__call__(*args, deterministic=True, **kwargs)


def keep_grads() -> optax.GradientTransformation:
    """Passes the updates through and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def _hps(**train):
    return HParams(train={**HPS.train.to_dict(), **train}, data=HPS.data.to_dict())


def _gen_flax_params(sd):
    """Port generator state dict -> flax params, TINY's depths."""
    hif = (4, len(TINY["resblock_kernel_sizes"]), len(TINY["resblock_dilation_sizes"][0]))
    return {
        "text_encoder": C._text_encoder(sd, "text_encoder", TINY["n_layers"]),
        "posterior_encoder": C._posterior_encoder(sd, "posterior_encoder",
                                                  TINY["posterior_layers"], True),
        "pitch_encoder": C._posterior_encoder(sd, "pitch_encoder", TINY["posterior_layers"], True),
        "flow": C._coupling_block(sd, "flow", TINY["flow_n_flows"], TINY["flow_wn_layers"], True),
        "duration_predictor": C._sdp(sd, "duration_predictor", TINY["dur_n_flows"], True),
        "waveform_decoder": C._hifigan(sd, "waveform_decoder", *hif),
        "yin_decoder": C._ying_decoder(sd, "yin_decoder", TINY["yin_dec_layers"], True),
        "emb_g": {"embedding": C._np(sd["emb_g.weight"])},
    }


def _no_dropout(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return module


def _batch():
    return {k: np.asarray(v) for k, v in _make_batch().items()}


@pytest.fixture(scope="module")
def weights():
    """(flax generator params, flax probe-D params): the same numbers the
    port models load."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        fresh = SynthesizerTrn(**TINY, device="cpu")
    g_params = perturb_zeros(_gen_flax_params(fresh.state_dict()), seed=1)
    b = 2
    dummy = [jnp.zeros((2 * b, SEG // s, 1), jnp.float32) for s in (4, 2, 1)]
    d_params = jax.jit(j_probe().init)(jax.random.PRNGKey(3), dummy[-1], dummy)["params"]
    return g_params, d_params


def _port_state(weights, hps=HPS, bf16=False, dropout=False):
    g_params, d_params = weights
    model = load_flax_params(SynthesizerTrn(**TINY, bf16=bf16, device="cpu"), g_params)
    disc = load_flax_params(probe_discriminator(bf16=bf16, segment_size=SEG, device="cpu"),
                            d_params)
    if not dropout:
        _no_dropout(model)
    return t_step.create_train_state(model, disc, hps, steps_per_epoch=10)


def _jax_noise(key, step, b, t_x, t_y):
    """The draws of the JAX step at ``step`` from run key ``key``, as the
    port's ``noise``."""
    rng = jax.random.fold_in(key, step)
    gen_rng, _, aug_d_rng, aug_g_rng = jax.random.split(rng, 4)
    r_spec, r_yin, r_yindec, r_dur, r_slice = jax.random.split(gen_rng, 5)
    spec_ch = TINY["inter_channels"] - TINY["yin_channels"]
    r = TINY["yin_shift_range"]
    noise = {
        "eps_spec": jax.random.normal(r_spec, (b, t_y, spec_ch)),
        "eps_yin": jax.random.normal(r_yin, (b, t_y, TINY["yin_channels"])),
        "scope_shift": jax.random.randint(r_yindec, (b,), -r, r),
        "e_q": jax.random.normal(r_dur, (b, t_x, 2)),
        "slice_u": jax.random.uniform(r_slice, (b,)),
        "phi_d": j_sample_phi(aug_d_rng, 2 * b),
        "phi_g": j_sample_phi(aug_g_rng, 2 * b),
    }
    return {k: np.asarray(v) for k, v in noise.items()}, gen_rng


@pytest.fixture(scope="module")
def step_pair(weights):
    g_params, d_params = weights
    batch = _batch()
    jm, jd = DeterministicSynthesizer(**TINY), j_probe()
    optim = optax.chain(keep_grads(), j_step.make_optimizer(J_HPS, steps_per_epoch=10))
    state = j_step.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
        g_opt_state=optim.init(g_params), d_opt_state=optim.init(d_params),
    )
    key = jax.random.PRNGKey(1)
    fn = jax.jit(lambda s, bt: j_step.train_step(s, bt, key, model=jm, disc=jd, optim_g=optim,
                                                 optim_d=optim, hps=J_HPS))
    j_new, j_metrics = fn(state, batch)
    b, t_x = batch["x"].shape
    noise, gen_rng = _jax_noise(key, 0, b, t_x, batch["spec"].shape[1])
    j_out = jax.jit(lambda p: jm.apply(
        {"params": p}, batch["x"], batch["t"], batch["x_lengths"], batch["spec"],
        batch["spec_lengths"], batch["ying"], batch["sid"], rng=gen_rng))(g_params)

    port = _port_state(weights)
    captured = {}
    hook = port.model.register_forward_hook(lambda m, a, out: captured.update(out))
    t_metrics = t_step.train_step(port, batch, HPS, noise=noise)
    hook.remove()
    return dict(j_new=j_new, j_metrics=j_metrics, j_out=j_out, port=port,
                t_metrics=t_metrics, t_out=captured)


def test_step_returns_the_jax_metric_names(step_pair):
    assert tuple(step_pair["t_metrics"]) == METRIC_NAMES
    assert set(step_pair["j_metrics"]) == set(METRIC_NAMES)


@pytest.mark.parametrize("name", METRIC_NAMES)
def test_step_metric_matches_jax(step_pair, name):
    out = step_pair["t_metrics"][name]
    assert out.dtype == torch.float32 and out.ndim == 0
    np.testing.assert_allclose(out.item(), float(step_pair["j_metrics"][name]), **METRICS)


@pytest.mark.parametrize("key", ["attn", "ids_slice"])
def test_step_alignment_and_slices_are_exact(step_pair, key):
    np.testing.assert_array_equal(step_pair["t_out"][key].numpy(),
                                  np.asarray(step_pair["j_out"][key]))


@pytest.mark.parametrize("side", ["g", "d"])
def test_step_gradients_match_jax_per_tensor(step_pair, side):
    port = step_pair["port"]
    module = port.model if side == "g" else port.disc
    j_grads = getattr(step_pair["j_new"], f"{side}_opt_state")[0]
    ref = flax_to_state_dict(module, j_grads)
    grads = {k: p.grad for k, p in module.named_parameters()}
    assert set(grads) == set(ref)
    total = float(step_pair["j_metrics"][f"grad_norm/{side}"])
    for k, g in grads.items():
        r = np.asarray(ref[k], np.float32).reshape(g.shape)
        err = np.linalg.norm(g.numpy() - r)
        assert err <= 1e-3 * np.linalg.norm(r) + 1e-6 * total, (k, err, np.linalg.norm(r))


def test_step_updates_parameters_as_jax(step_pair):
    """One AdamW step from the same gradients: every parameter moved the
    same way. Adam's first step moves each weight by about +-lr, so the
    gradients (above) are where the comparison is tight; this holds the
    update's sign and size where the gradient is not at the noise floor."""
    port = step_pair["port"]
    for side, module in (("g", port.model), ("d", port.disc)):
        new = flax_to_state_dict(module, getattr(step_pair["j_new"], f"{side}_params"))
        lr = HPS.train.learning_rate
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(new[k]).reshape(p.shape),
                                       rtol=0, atol=2.01 * lr, err_msg=k)
    assert port.step == 1
    assert t_step.update_count(port.optim_g) == t_step.update_count(port.optim_d) == 1


# -- AdamW and the schedule on identical gradients ---------------------------------------------


def test_lr_schedule_matches_optax_staircase():
    hps = _hps(lr_decay=0.5)
    ours = t_step.lr_schedule(hps, steps_per_epoch=3)
    ref = j_step.lr_schedule(hps, steps_per_epoch=3)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)
    assert ours(2) == ours(0) and ours(3) == ours(0) * 0.5


def test_adamw_update_matches_optax_over_epochs():
    """Seven updates on identical gradients, two steps an epoch, decay 0.5
    an epoch: AdamW with weight decay 1e-2 and the staircase schedule, the
    port's ``apply_update`` against the JAX package's ``make_optimizer``."""
    hps = _hps(lr_decay=0.5, learning_rate=1e-2)
    rng = np.random.default_rng(50)
    shapes = [(3, 4), (5,), (2, 1, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = j_step.make_optimizer(hps, steps_per_epoch=2)
    j_params, j_state = list(params), opt.init(list(params))
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    t_opt = t_step.make_optimizer(hps, t_params)
    schedule = t_step.lr_schedule(hps, steps_per_epoch=2)
    for _ in range(7):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        updates, j_state = opt.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for p, g in zip(t_params, grads):
            p.grad = torch.from_numpy(g)
        loss = torch.tensor(1.0)
        norm, skipped = t_step.apply_update(t_opt, schedule, loss, nan_guard=False)
        assert skipped is None
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        for p, r in zip(t_params, j_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), **ADAMW)
    assert t_step.update_count(t_opt) == 7
    assert t_opt.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.5**3)


def test_parameter_without_gradient_still_decays():
    """optax's AdamW decays every parameter each step; the port gives a
    parameter without a gradient a zero one so it does too."""
    hps = _hps()
    p = torch.nn.Parameter(torch.ones(3))
    opt = t_step.make_optimizer(hps, [p])
    t_step.apply_update(opt, t_step.lr_schedule(hps, 10), torch.tensor(0.0), nan_guard=False)
    np.testing.assert_allclose(p.detach().numpy(), 1 - 2e-4 * 1e-2, rtol=1e-7)


def test_step_runs_on_the_card_by_default(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_discriminator()
