"""The port's data-parallel step (``vits_torch/parallel/mesh.py``,
``training/step.py`` under DDP) against one process on the global batch and
against the JAX step on it, on the CPU: two ranks over gloo, launched once
(``mesh.spawn``) for every check here.

The setup is ``tests/test_torch_train_step.py``'s: TINY weights, the probe
discriminator, dropout inert, the JAX step's draws handed in as ``noise``
(drawn for the global batch; each rank keeps its rows). The global batch has
4 rows; rank 0 holds the two long ones, rank 1 the two short ones, so the
ranks' KL and duration denominators differ. Tolerances are that file's:
METRICS rtol 1e-4; gradients per tensor 1e-3 of its norm + 1e-6 of the
global norm; remat rtol 1e-4 (losses), rtol 1e-3 / atol 1e-6 (parameters).
Parameters after one AdamW step: Adam's first step moves an element by
``lr * g / (|g| + eps)``, +-lr wherever the gradient's sign is settled. An
element's sign is settled where its reference gradient exceeds the
gradient tolerance of its tensor (no gradient that passes the gradient
check can have the other sign there); on those elements the parameters
must agree within 1e-3 of the update's norm, elsewhere (a gradient near 0,
either sign) within 2.01 x lr.

The ranks run in new processes (the spawn start method) that import
``tests/_torch_ranks.py`` for ``ddp_rank_steps``: no JAX, one thread, the
model's arguments, hps, weights, batch and draws in the payload.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.models.avocodo import probe_discriminator as j_probe
from vits_tpu.parallel import mesh as j_mesh
from vits_tpu.training import step as j_step

from vits_torch.parallel import mesh
from vits_torch.training import step as t_step
from vits_torch.utils.convert_jax import flax_to_state_dict

from tests._torch_ranks import ddp_rank_steps, state_arrays
from tests.test_torch_train_step import (  # noqa: F401  (weights is a fixture)
    HPS,
    J_HPS,
    METRIC_NAMES,
    METRICS,
    SEG,
    TINY,
    DeterministicSynthesizer,
    _jax_noise,
    _port_state,
    keep_grads,
    weights,
)

WORLD, B, T_X, T_Y = 2, 4, 9, 16
X_LENGTHS = [9, 9, 4, 3]      # rank 0: rows 0-1, long; rank 1: rows 2-3, short
SPEC_LENGTHS = [16, 16, 9, 8]
KEY = jax.random.PRNGKey(1)
LR = HPS.train.learning_rate


def _global_batch():
    rng = np.random.default_rng(7)
    return {
        "x": rng.integers(1, 30, (B, T_X)), "t": rng.integers(0, 6, (B, T_X)),
        "x_lengths": np.array(X_LENGTHS), "spec_lengths": np.array(SPEC_LENGTHS),
        "spec": np.abs(rng.standard_normal((B, T_Y, 513))).astype(np.float32),
        "ying": rng.uniform(0, 1, (B, T_Y, 80)).astype(np.float32),
        "wav": (rng.standard_normal((B, T_Y * 256, 1)) * 0.1).astype(np.float32),
        "sid": rng.integers(0, 3, B),
    }


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    batch = _global_batch()
    noise, _ = _jax_noise(KEY, 0, B, T_X, T_Y)
    fresh = _port_state(weights)
    payload = tmp_path_factory.mktemp("ddp") / "payload.pt"
    torch.save({"g": fresh.model.state_dict(), "d": fresh.disc.state_dict(), "batch": batch,
                "noise": noise, "tiny": TINY, "hps": HPS.to_dict(), "world": WORLD, "seg": SEG},
               payload)
    # the ranks step in their own processes while this one runs the
    # references (the JAX step's XLA compile takes most of the fixture)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mesh.spawn, ddp_rank_steps, WORLD, str(payload), device="cpu",
                            timeout=300)
        one = _port_state(weights)
        m_one = {k: v.item() for k, v in t_step.train_step(one, batch, HPS, noise=noise).items()}

        g_params, d_params = weights
        optim = optax.chain(keep_grads(), j_step.make_optimizer(J_HPS, steps_per_epoch=10))
        j_state = j_step.TrainState(
            step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
            g_opt_state=optim.init(g_params), d_opt_state=optim.init(d_params),
        )
        j_new, j_metrics = jax.jit(lambda s, bt: j_step.train_step(
            s, bt, KEY, model=DeterministicSynthesizer(**TINY), disc=j_probe(), optim_g=optim,
            optim_d=optim, hps=J_HPS))(j_state, batch)
        jax_ref = {}
        for side, module in (("model", one.model), ("disc", one.disc)):
            s = "g" if side == "model" else "d"
            params = flax_to_state_dict(module, getattr(j_new, f"{s}_params"))
            grads = flax_to_state_dict(module, getattr(j_new, f"{s}_opt_state")[0])
            jax_ref[side] = {k: (np.asarray(params[k]).reshape(p.shape),
                                 np.asarray(grads[k], np.float32).reshape(p.shape))
                             for k, p in module.named_parameters()}
        ranks = ranks.result()
    return dict(
        ranks=ranks,
        one=(m_one, state_arrays(one)),
        jax=({k: float(v) for k, v in j_metrics.items()}, jax_ref),
        initial={side: {k: p.detach().numpy().copy()
                        for k, p in getattr(fresh, side).named_parameters()}
                 for side in ("model", "disc")},
    )


def settled_update_error(p, p_ref, p0, g_ref, total):
    """(||p - p_ref|| / ||p_ref - p0|| on the elements whose reference
    gradient exceeds the tensor's gradient tolerance, 1e-3 of its norm +
    1e-6 of the global norm ``total``; max |p - p_ref| on the rest); 0 where
    a part is empty."""
    settled = np.abs(g_ref) > 1e-3 * np.linalg.norm(g_ref) + 1e-6 * total
    rel = (float(np.linalg.norm((p - p_ref)[settled]) / np.linalg.norm((p_ref - p0)[settled]))
           if settled.any() else 0.0)
    rest = float(np.abs(p - p_ref)[~settled].max()) if (~settled).any() else 0.0
    return rel, rest


@pytest.mark.parametrize("ref", ["one", "jax"])
@pytest.mark.parametrize("name", METRIC_NAMES)
def test_ddp_metric_matches_the_global_batch(runs, name, ref):
    np.testing.assert_allclose(runs["ranks"][0]["global"][0][name], runs[ref][0][name],
                               **METRICS)


def test_ranks_agree_bit_for_bit(runs):
    """Both ranks log the same global metrics and hold the same parameters
    after the update (DDP's replicas stay in step)."""
    r0, r1 = (r["global"] for r in runs["ranks"])
    assert r0[0] == r1[0]
    for side in ("model", "disc"):
        for k, (p, g) in r0[1][side].items():
            np.testing.assert_array_equal(p, r1[1][side][k][0], err_msg=k)
            np.testing.assert_array_equal(g, r1[1][side][k][1], err_msg=k)


@pytest.mark.parametrize("side", ["model", "disc"])
@pytest.mark.parametrize("ref", ["one", "jax"])
def test_ddp_gradients_match_per_tensor(runs, ref, side):
    got = runs["ranks"][0]["global"][1][side]
    want = runs[ref][1][side]
    assert set(got) == set(want)
    total = runs[ref][0][f"grad_norm/{'g' if side == 'model' else 'd'}"]
    for k, (_, g) in got.items():
        r = want[k][1]
        err = np.linalg.norm(g - r)
        assert err <= 1e-3 * np.linalg.norm(r) + 1e-6 * total, (k, err, np.linalg.norm(r))


@pytest.mark.parametrize("ref", ["one", "jax"])
def test_ddp_updates_parameters_as_the_global_batch(runs, ref):
    got = runs["ranks"][0]["global"][1]
    for side in ("model", "disc"):
        total = runs[ref][0][f"grad_norm/{'g' if side == 'model' else 'd'}"]
        for k, (p, _) in got[side].items():
            p_ref, g_ref = runs[ref][1][side][k]
            rel, rest = settled_update_error(p, p_ref, runs["initial"][side][k], g_ref, total)
            assert rel <= 1e-3 and rest <= 2.01 * LR, (k, rel, rest)


def test_update_check_sees_a_missing_update(runs):
    """The parameter check fails an update that was skipped (the initial
    weights) or taken against the gradient."""
    total = runs["one"][0]["grad_norm/g"]
    k, (p_ref, g_ref) = next(iter(runs["one"][1]["model"].items()))
    p0 = runs["initial"]["model"][k]
    assert settled_update_error(p0, p_ref, p0, g_ref, total)[0] > 0.5, k
    assert settled_update_error(2 * p0 - p_ref, p_ref, p0, g_ref, total)[0] > 1, k


def test_per_rank_ratio_step_is_not_the_global_step(runs):
    """With each rank's own KL and duration denominators under DDP's plain
    average (what a data-parallel port gets without the shared ones), these
    lengths move both losses and the duration predictor's gradient beyond
    the tolerances the global step meets; every mean loss stays put."""
    naive, glob = runs["ranks"][0]["per_rank_ratio"], runs["ranks"][0]["global"]
    for name in METRIC_NAMES:
        rel = abs(naive[0][name] - glob[0][name]) / abs(glob[0][name])
        if name in ("loss/g/kl", "loss/g/dur"):  # 3.5e-3 and 0.118 measured
            assert rel > 10 * METRICS["rtol"], (name, rel)
        elif name in ("loss/g/total", "grad_norm/g"):  # 2.6e-4 and 7.3e-3
            assert rel > METRICS["rtol"], (name, rel)
        elif not name.startswith("grad_norm"):
            assert rel <= METRICS["rtol"], (name, rel)
    ref = glob[1]["model"]
    worst = max(np.linalg.norm(g - ref[k][1]) / np.linalg.norm(ref[k][1])
                for k, (_, g) in naive[1]["model"].items() if k.startswith("duration_predictor."))
    assert worst > 1e-2


def test_ddp_remat_matches_the_plain_ddp_step(runs):
    """``remat_run`` under DDP checkpoints the module inside the wrapper's
    forward: the same losses and parameters as the plain DDP step."""
    remat, plain = runs["ranks"][0]["remat"], runs["ranks"][0]["global"]
    for k in ("loss/g/total", "loss/d/total"):
        np.testing.assert_allclose(remat[0][k], plain[0][k], rtol=1e-4)
    for side in ("model", "disc"):
        for k, (p, _) in remat[1][side].items():
            np.testing.assert_allclose(p, plain[1][side][k][0], rtol=1e-3, atol=1e-6, err_msg=k)


def test_second_ddp_step_runs(runs):
    """Every parameter got a gradient in the first step (DDP's reducer,
    without find_unused_parameters, raises in the next forward otherwise)
    and the second step is finite and the same on both ranks."""
    second = [r["second"] for r in runs["ranks"]]
    assert second[0] == second[1]
    assert all(np.isfinite(v) for v in second[0].values())
    assert second[0]["loss/g/total"] != runs["ranks"][0]["global"][0]["loss/g/total"]


@pytest.mark.parametrize("global_batch,n_proc", [(8, 1), (8, 2), (64, 4), (6, 4), (5, 2)])
def test_local_batch_rows_matches_jax(monkeypatch, global_batch, n_proc):
    monkeypatch.setattr(mesh, "process_count", lambda: n_proc)
    monkeypatch.setattr(j_mesh.jax, "process_count", lambda: n_proc)
    try:
        want = j_mesh.local_batch_rows(global_batch)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{e}$"):
            mesh.local_batch_rows(global_batch)
        assert global_batch % n_proc
        return
    assert mesh.local_batch_rows(global_batch) == want == global_batch // n_proc


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_rank_rows_splits_the_global_draw(kind):
    """Rows [r*b, (r+1)*b) of every [B] draw, those rows of each half of a
    [2B] draw: the ranks' pieces put back together are the global draw."""
    noise, _ = _jax_noise(KEY, 0, B, T_X, T_Y)
    if kind == "torch":
        noise = {k: torch.from_numpy(v) for k, v in noise.items()}
    pieces = [mesh.rank_rows(noise, r, WORLD, B) for r in range(WORLD)]
    b = B // WORLD
    for k, v in noise.items():
        got = [np.asarray(p[k]) for p in pieces]
        assert all(g.shape[0] == (2 * b if k.startswith("phi") else b) for g in got)
        if k.startswith("phi"):
            whole = np.concatenate([g[:b] for g in got] + [g[b:] for g in got])
        else:
            whole = np.concatenate(got)
        np.testing.assert_array_equal(whole, np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="3 rows"):
        mesh.rank_rows({"e": np.zeros((3, 2))}, 0, WORLD, B)
