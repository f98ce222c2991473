"""The port's training step under its options and its randomness
(``vits_torch/training/step.py``): ``nan_guard``, ``remat_run``, two steps'
progress, the bf16 policy, live dropout and the generator's draws, on the
CPU at ``tests/test_torch_train_step.py``'s tiny configuration and weights.
Each mirrors a test of ``tests/test_train_step.py``. These tests were split
out of ``tests/test_torch_train_step.py`` (the parity step against JAX) so
that pytest-xdist's ``--dist loadfile`` runs the two files on two workers.
"""

import jax
import numpy as np
import torch

from vits_torch.training import step as t_step

from tests.test_torch_train_step import (  # noqa: F401  (weights is a fixture)
    HPS,
    METRIC_NAMES,
    _batch,
    _hps,
    _jax_noise,
    _port_state,
    weights,
)


# -- nan_guard, remat, progress, bf16, dropout ------------------------------------------------


def test_nan_guard_skips_bad_update(weights):
    """Mirrors tests/test_train_step.py::test_nan_guard_skips_bad_update: a
    batch with non-finite losses leaves parameters and Adam moments as they
    were, the counts still advance, and a clean batch under the guard
    updates."""
    hps = _hps(nan_guard=True)
    state, clean = _port_state(weights, hps), _port_state(weights, hps)
    before = {side: [p.detach().clone() for p in m.parameters()]
              for side, m in (("g", state.model), ("d", state.disc))}
    bad = _batch()
    bad["wav"] = np.full_like(bad["wav"], np.nan)
    bad["spec"] = np.full_like(bad["spec"], np.nan)
    metrics = t_step.train_step(state, bad, hps, generator=torch.Generator().manual_seed(0))
    assert metrics["nan_skipped/g"].item() == 1.0 and metrics["nan_skipped/d"].item() == 1.0
    for side, module, optim in (("g", state.model, state.optim_g),
                                ("d", state.disc, state.optim_d)):
        for old, p in zip(before[side], module.parameters()):
            torch.testing.assert_close(p.detach(), old, rtol=0, atol=0)
            st = optim.state[p]
            assert int(st["step"]) == 1
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    assert state.step == 1

    m2 = t_step.train_step(clean, _batch(), hps, generator=torch.Generator().manual_seed(0))
    assert m2["nan_skipped/g"].item() == 0.0 and m2["nan_skipped/d"].item() == 0.0
    assert any(not torch.equal(a, p.detach())
               for a, p in zip(before["d"], clean.disc.parameters()))


def test_remat_matches_plain_step(weights):
    """Mirrors tests/test_train_step.py::test_remat_matches_plain_step:
    ``remat_run`` replays the generator forward and the discriminator in the
    backward and gives the same losses and parameters."""
    noise, _ = _jax_noise(jax.random.PRNGKey(1), 0, 2, 9, 16)
    plain, remat = _port_state(weights), _port_state(weights, _hps(remat_run=True))
    m_plain = t_step.train_step(plain, _batch(), HPS, noise=noise)
    m_remat = t_step.train_step(remat, _batch(), _hps(remat_run=True), noise=noise)
    for k in ("loss/g/total", "loss/d/total"):
        np.testing.assert_allclose(m_remat[k].item(), m_plain[k].item(), rtol=1e-4)
    for a, b in zip(plain.model.parameters(), remat.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-3, atol=1e-6)


def test_two_steps_make_progress(weights):
    """Mirrors tests/test_train_step.py's update and progress tests: after
    two steps every generator parameter and the discriminator have moved and
    the losses stay finite."""
    state = _port_state(weights, dropout=True)
    start_g = [p.detach().clone() for p in state.model.parameters()]
    start_d = [p.detach().clone() for p in state.disc.parameters()]
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        metrics = t_step.train_step(state, _batch(), HPS, generator=gen)
        assert all(torch.isfinite(v) for v in metrics.values()), metrics
    assert state.step == 2 and t_step.update_count(state.optim_g) == 2
    unchanged = [k for (k, p), a in zip(state.model.named_parameters(), start_g)
                 if torch.allclose(a, p.detach())]
    assert not unchanged, unchanged[:10]
    assert all(not torch.allclose(a, p.detach()) for a, p in zip(start_d, state.disc.parameters()))


def test_bf16_step_stays_finite(weights):
    """The config's bf16 policy: a step is finite and parameters stay f32."""
    state = _port_state(weights, bf16=True, dropout=True)
    metrics = t_step.train_step(state, _batch(), HPS, generator=torch.Generator().manual_seed(2))
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    for m in (state.model, state.disc):
        assert all(p.dtype == torch.float32 for p in m.parameters())


def test_dropout_is_live_in_the_step(weights):
    """The same noise and weights, two default-generator seeds: with the
    model's dropout the losses differ, with p=0 they agree bit for bit."""
    noise, _ = _jax_noise(jax.random.PRNGKey(1), 0, 2, 9, 16)

    def total(seed, dropout):
        torch.manual_seed(seed)
        state = _port_state(weights, dropout=dropout)
        return t_step.train_step(state, _batch(), HPS, noise=noise)["loss/g/total"].item()

    assert total(0, True) != total(1, True)
    assert total(0, False) == total(1, False)


def test_generator_draws_are_reproducible(weights):
    """Without ``noise`` every draw comes from the one generator: the same
    seed gives the same step, another seed another."""

    def metrics(seed):
        torch.manual_seed(0)
        state = _port_state(weights)
        return t_step.train_step(state, _batch(), HPS, generator=torch.Generator().manual_seed(seed))

    a, b, c = metrics(3), metrics(3), metrics(4)
    assert all(torch.equal(a[k], b[k]) for k in METRIC_NAMES)
    assert a["loss/g/total"] != c["loss/g/total"]
