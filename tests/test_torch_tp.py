"""The port's tensor parallelism (``vits_torch/parallel/mesh.py``:
``make_mesh_2d``, ``tp_shard_generator``, ``gather_state_dict``) against one
process on the global batch, on the CPU: four gloo ranks on a 2 x 2 (data,
model) mesh, launched once (``mesh.spawn``) for every check here.

The model is the JAX dryrun's tiny one (``graft_entry._dryrun_model_and_batch``)
with the probe discriminator and dropout off; the global batch has 4 rows
(2 a data rank) and one set of draws, made for the global batch, which each
data rank cuts to its rows. Tolerances: metrics rtol 1e-5 (the same f32
sums; the split convs sum each output channel over the same inputs);
gradients and updated parameters as ``tests/test_torch_ddp.py`` holds them
(1e-3 of a tensor's norm + 1e-6 of the global norm; parameters within 1e-3
of the update's norm where the gradient's sign is settled, 2.01 x lr
elsewhere). Model peers hold their replicated parameters bit for bit equal.

The ranks run in new processes (the spawn start method) that import
``tests/_torch_ranks.py`` for ``tp_rank`` (no JAX, one thread); JAX is
imported inside the tests here that use it.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from vits_torch import graft_entry
from vits_torch.ops.phaseaug import sample_phi
from vits_torch.parallel import mesh
from vits_torch.training import step as t_step

from tests._torch_ranks import TP_B as B
from tests._torch_ranks import TP_DATA as N_DATA
from tests._torch_ranks import TP_MODEL as N_MODEL
from tests._torch_ranks import named_arrays, no_dropout, tp_rank, tp_state
METRICS = dict(rtol=1e-5, atol=0)
METRIC_NAMES = (
    "loss/g/score", "loss/g/fm", "loss/g/mel", "loss/g/dur", "loss/g/kl", "loss/g/yindec",
    "loss/g/yinshift", "loss/g/total", "loss/d/total", "loss/d/real", "loss/d/gen",
    "grad_norm/g", "grad_norm/d",
)


def _setup():
    """The tiny models' weights, the global batch of B rows and its draws."""
    hps, model, disc, batch = graft_entry._dryrun_model_and_batch(B)
    gen = torch.Generator().manual_seed(5)
    noise = model.draw_noise(B, batch["x"].shape[1], batch["spec"].shape[1], gen)
    noise.update(phi_d=sample_phi(2 * B, gen), phi_g=sample_phi(2 * B, gen))
    return hps, model, disc, batch, noise


@pytest.fixture(scope="module")
def runs():
    hps, model, disc, batch, noise = _setup()
    no_dropout(model)
    data = {"g": model.state_dict(), "d": disc.state_dict(), "batch": batch, "noise": noise}

    def one_process(bf16=False):
        h, mdl, dsc = tp_state(data, bf16)
        st = t_step.create_train_state(mdl, dsc, h, 100)
        metrics = {k: v.item() for k, v in t_step.train_step(st, batch, h, noise=noise).items()}
        return metrics, {"model": named_arrays(mdl.named_parameters()),
                         "disc": named_arrays(dsc.named_parameters())}

    # the ranks step in their own processes while this one runs the references
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mesh.spawn, tp_rank, N_DATA * N_MODEL, data, device="cpu",
                            timeout=300)
        one, one_bf16 = one_process(), one_process(bf16=True)
        ranks = ranks.result()
    return dict(ranks=ranks, one=one, one_bf16=one_bf16,
                initial={"model": {k: v.numpy() for k, v in data["g"].items()},
                         "disc": {k: v.numpy() for k, v in data["d"].items()}},
                lr=hps.train.learning_rate)


def _grad_errors(got, want, total):
    """{name: (||g - g_ref||, its tolerance)} over one side's tensors."""
    return {k: (float(np.linalg.norm(g - want[k][1])),
                1e-3 * float(np.linalg.norm(want[k][1])) + 1e-6 * total)
            for k, (_, g) in got.items()}


def test_mesh_places_rank_r_at_its_row_and_column(runs):
    assert [r["mesh"] for r in runs["ranks"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", METRIC_NAMES)
def test_tp_metric_matches_the_global_batch(runs, name):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["tp"]["metrics"][name], runs["one"][0][name], **METRICS)


@pytest.mark.parametrize("side", ["model", "disc"])
def test_tp_gradients_match_per_tensor(runs, side):
    got = runs["ranks"][0]["tp"][side]
    want = runs["one"][1][side]
    assert set(got) == set(want)
    total = runs["one"][0][f"grad_norm/{'g' if side == 'model' else 'd'}"]
    bad = {k: e for k, e in _grad_errors(got, want, total).items() if e[0] > e[1]}
    assert not bad, bad


def test_tp_updates_parameters_as_the_global_batch(runs):
    from tests.test_torch_ddp import settled_update_error

    for side in ("model", "disc"):
        total = runs["one"][0][f"grad_norm/{'g' if side == 'model' else 'd'}"]
        for k, (p, _) in runs["ranks"][0]["tp"][side].items():
            p_ref, g_ref = runs["one"][1][side][k]
            rel, rest = settled_update_error(p, p_ref, runs["initial"][side][k], g_ref, total)
            assert rel <= 1e-3 and rest <= 2.01 * runs["lr"], (side, k, rel, rest)


@pytest.mark.parametrize("key", ["tp", "bf16"])
def test_model_peers_hold_equal_replicas(runs, key):
    """Ranks (d, 0) and (d, 1) hold every replicated parameter bit for bit
    alike after the step, and log the same metrics."""
    for d in range(N_DATA):
        a, b = runs["ranks"][2 * d][key], runs["ranks"][2 * d + 1][key]
        assert a["metrics"] == b["metrics"]
        assert set(a["replicated"]) == set(b["replicated"])
        for k, v in a["replicated"].items():
            np.testing.assert_array_equal(v, b["replicated"][k], err_msg=k)


def test_shard_then_gather_is_an_exact_round_trip(runs):
    assert all(r["round_trip"] for r in runs["ranks"])


def test_split_tensors_are_jax_placement(runs):
    """The tensors split on output channels are, through the name
    converter, those JAX's ``tp_shard_generator`` puts on ``'model'`` on
    ``make_mesh_2d(4, 2)``: kernels, biases and Conv1d ``g``. The exception
    is a transposed conv's ``g``: per input channel, JAX splits it on
    ``'model'`` along its input channels (XLA gathers it where it is used);
    the explicit split keeps it whole on every rank, because the rank's
    slice of the weight needs every input channel's scale."""
    import jax

    from vits_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
    from vits_tpu.parallel.mesh import tp_shard_generator as j_tp_shard_generator
    from vits_tpu.utils import convert_torch as C
    from vits_torch.utils.convert_jax import flax_to_state_dict

    _, model, _, _, _ = _setup()
    dec = model.waveform_decoder
    sd = {f"waveform_decoder.{k}": v.numpy() for k, v in dec.state_dict().items()}
    tree = C._hifigan(sd, "waveform_decoder", len(dec.ups), dec.num_kernels,
                      len(dec.resblocks[0].convs1))
    placed = j_tp_shard_generator({"waveform_decoder": tree, "emb_g": {"embedding": np.zeros(
        (3, 16), np.float32)}}, j_make_mesh_2d(4, 2))
    assert all(s is None for s in placed["emb_g"]["embedding"].sharding.spec)
    on_model = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float("model" in tuple(a.sharding.spec)), np.float32),
        placed["waveform_decoder"])
    marks = flax_to_state_dict(dec, on_model)
    jax_split = {f"waveform_decoder.{k}" for k, v in marks.items() if v.all()}
    assert not any(v.any() and not v.all() for v in marks.values())
    transposed_g = {f"waveform_decoder.ups.{i}.weight_g" for i in range(len(dec.ups))}
    port_split = set(runs["ranks"][0]["tp"]["split"])
    assert port_split == jax_split - transposed_g
    assert transposed_g & jax_split  # JAX does place them on 'model'
    assert not port_split & transposed_g
    assert port_split  # the rule splits something at these widths
    for k, shape in runs["ranks"][0]["split_shapes"].items():
        whole = runs["initial"]["model"][k].shape
        dim = runs["ranks"][0]["tp"]["split"][k]
        assert shape[dim] * N_MODEL == whole[dim], k


def test_summed_gather_backward_fails_the_check(runs):
    """A gather whose backward sums over the model ranks multiplies the
    gradient by n_model at every split conv it passes: 2x at the last one
    (the third upsampling stage's second resblock conv), ~127x the norm at
    ``conv_pre`` (seven split convs deep, fewer through the residuals). The
    gradient check fails (Adam's first step is sign-only, so the updated
    parameters alone would not show it)."""
    got, want = runs["ranks"][0]["summed_gather"]["model"], runs["one"][1]["model"]
    errs = _grad_errors(got, want, runs["one"][0]["grad_norm/g"])
    bad = {k for k, (e, tol) in errs.items() if e > tol}
    assert {"waveform_decoder.conv_pre.weight", "waveform_decoder.cond.weight",
            "waveform_decoder.ups.0.weight_v"} <= bad
    k = "waveform_decoder.resblocks.2.convs2.0.weight_v"
    np.testing.assert_allclose(got[k][1], N_MODEL * want[k][1], rtol=1e-4, atol=1e-12)
    k = "waveform_decoder.conv_pre.weight"
    assert np.linalg.norm(got[k][1]) > 100 * np.linalg.norm(want[k][1])


def test_missing_input_all_reduce_fails_the_check(runs):
    """Without the all-reduce of a split conv's input gradient each rank
    passes upstream only its own channels' share: every split conv before
    the last gets a wrong gradient, and the check fails on the upsampling
    convs (``conv_pre``'s is 0.87 of its norm off too, but its norm lies
    below the check's 1e-6 of the global one)."""
    got, want = runs["ranks"][0]["no_input_all_reduce"]["model"], runs["one"][1]["model"]
    errs = _grad_errors(got, want, runs["one"][0]["grad_norm/g"])
    bad = {k for k, (e, tol) in errs.items() if e > tol}
    assert {"waveform_decoder.ups.0.weight_v", "waveform_decoder.ups.1.weight_v"} <= bad
    k = "waveform_decoder.conv_pre.weight"
    assert np.linalg.norm(got[k][1] - want[k][1]) > 0.5 * np.linalg.norm(want[k][1])
    assert "waveform_decoder.resblocks.2.convs2.0.weight_v" not in bad  # the last split conv


def test_bf16_tp_step_gathers_bf16_over_gloo(runs):
    """Under the bf16 policy the split convs gather bf16 activations (gloo
    takes them through f32 on the CPU); the step is finite and its losses
    are the one-process bf16 step's within bf16's rounding."""
    got = runs["ranks"][0]["bf16"]["metrics"]
    assert all(np.isfinite(v) for v in got.values())
    for k in ("loss/g/total", "loss/d/total", "loss/g/mel"):
        np.testing.assert_allclose(got[k], runs["one_bf16"][0][k], rtol=1e-2, err_msg=k)


def test_2d_command_line_runs_the_dryrun(capsys):
    metrics = graft_entry.main(["2d", "4", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == (f"dryrun_multichip_2d(4): ok, loss/g/total={metrics['loss/g/total']:.3f} "
                       f"loss/d/total={metrics['loss/d/total']:.3f}")
    assert np.isfinite(list(metrics.values())).all()


@pytest.mark.parametrize("n", [2, 3, 5])
def test_2d_dryrun_needs_an_even_count_of_four_or_more(n):
    """JAX's ValueError, raised before any process starts."""
    with open(graft_entry.CONFIG.parent.parent / "__graft_entry__.py") as f:
        assert "dryrun_multichip_2d needs an even n_devices >= 4" in f.read()
    with pytest.raises(ValueError, match="^dryrun_multichip_2d needs an even n_devices >= 4$"):
        graft_entry.main(["2d", str(n), "--device", "cpu"])


def test_mesh_needs_the_whole_world():
    with pytest.raises(ValueError, match="a 2 x 2 mesh needs 4 processes; the group has 1"):
        mesh.make_mesh_2d(2, 2)
