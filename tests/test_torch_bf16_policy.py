"""The port's bf16 policy in the discriminator against the JAX package's, on
the CPU, at the probe discriminator's size.

The discriminator is the group the bisection pointed at: under the bf16
policy the port's convergence study drifted off its MAS alignment on the
card, and bf16 in the discriminator alone brought the drift back
(``tools/bf16_bisect.py``; ``docs/convergence_torch.md``, runs 6-7), though
bf16 elsewhere with the discriminator in f32 drifted too (run 11). The
cause is not settled. A variant that rounds where XLA's fusions write (the
tool's ``disc:fused``) kept MAS locked on in two study runs and drifted in
one (runs 9, 13 and 12), so the package keeps its eager rounding: each op rounds its own output to bf16, the bias add after a conv
included (``vits_torch/models/modules.py::_in_dtype_of``).

The JAX discriminator computes its convs in bf16, and XLA fuses what follows
each one (bias add, leaky ReLU, the MDC branches' sum) into one op that
computes in f32 and rounds once where it writes its output.

Every comparison is a relative L2 gap over a group of tensors: the logits,
the feature maps, D's parameter gradients of the D loss, and the gradients G
receives through D (those of the generator and feature-matching losses with
respect to the generated audio). Each is taken against the JAX
discriminator in f32, from the same weights and inputs:

  own gap   |JAX bf16 - JAX f32| / |JAX f32|: what bf16 costs in the
            reference itself (XLA on the CPU)
  gap       |run bf16 - JAX bf16| / |JAX f32|, for the port and for the
            tool's ``disc:fused`` variant

Readings (this file's inputs, the CPU, any thread count), gap / own gap for
the logits, feature maps, D's gradients and G's signal: the port 0.558,
0.319, 0.996, 0.818; the fused variant 1.083, 0.968, 1.002, 0.698. So on
the CPU the fused rounding is not nearer XLA's as a whole: nearer in what G
receives, farther in the forward, and no different in D's own gradients,
where either rounding lies as far from XLA's bf16 as XLA's bf16 from f32.
Tolerances (PORT_OVER_JAX, a multiple of the own gap per group): logits 0.8
and feature maps 0.6, between the two readings; G's signal 1.0 and D's
gradients 1.25, above both. Every one is tighter than
the twice the own gap (in max norm, forward alone) of
``tests/test_torch_gan.py``. The fused variant fails them in the forward,
so these tests see where the package rounds; in G's signal the package
lies farther from XLA's bf16 than the fused variant.

What this cannot show: the card's own bf16 kernels. ``chip_smoke.py`` phase
12 holds the card's gaps to the CPU's for every group of a whole step.
"""

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from vits_tpu.models import avocodo as j_avocodo
from vits_tpu.training import losses as j_losses

from vits_torch.models import avocodo as t_avocodo
from vits_torch.models import modules as t_modules
from vits_torch.training import losses as t_losses
from vits_torch.utils.convert_jax import flax_to_state_dict, load_flax_params

from tests.test_torch_gan import _disc_inputs

PORT_OVER_JAX = {"logits": 0.8, "fmaps": 0.6, "d_grads": 1.25, "g_signal": 1.0}
GROUPS = ("logits", "fmaps", "d_grads", "g_signal")
ROOT = Path(__file__).resolve().parents[1]


def _bisect_tool():
    spec = importlib.util.spec_from_file_location("bf16_bisect", ROOT / "tools" / "bf16_bisect.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _fused_variant():
    """The tool's ``disc:fused`` patches, undone on exit: yields a function
    that marks a discriminator's convs."""
    tool = _bisect_tool()
    saved = [(cls, name, cls.__dict__[name]) for cls, name in (
        (t_modules.Conv1d, "_conv_forward"), (t_modules.ConvTranspose1d, "forward"),
        (t_avocodo.CoMBDBlock, "forward"), (t_avocodo.MDC, "forward"),
        (t_avocodo.SBDBlock, "forward"))]
    tool.patch_convs()
    tool.patch_discriminator()
    try:
        yield lambda disc: tool.apply_variant({"disc": [disc]}, {"disc": "fused"})
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _rel(a, b, ref):
    a, b, ref = (np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in v])
                 for v in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def _jax_groups(jd, params, y, ys_hat):
    """The four groups of the JAX discriminator (as flattened lists)."""
    def d_loss(p):
        y_r, y_g, _, _ = jd.apply(p, y, ys_hat)
        return j_losses.discriminator_loss(y_r, y_g)[0]

    def g_loss(hat):
        _, y_g, f_r, f_g = jd.apply(params, y, hat)
        return j_losses.generator_loss(y_g)[0] + j_losses.feature_loss(f_r, f_g)

    y_r, y_g, f_r, f_g = jax.jit(jd.apply)(params, y, ys_hat)
    d_grads = jax.jit(jax.grad(d_loss))(params)
    signal = jax.jit(jax.grad(g_loss))(ys_hat)
    return d_grads, {
        "logits": jax.tree_util.tree_leaves((y_r, y_g)),
        "fmaps": jax.tree_util.tree_leaves((f_r, f_g)),
        "g_signal": jax.tree_util.tree_leaves(signal),
    }


def _port_groups(td, y, ys_hat):
    """The four groups of the port's discriminator, in the JAX layouts."""
    y_t = torch.from_numpy(np.asarray(y))
    hat = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in ys_hat]
    td.zero_grad(set_to_none=True)
    y_r, y_g, _, _ = td(y_t, [h.detach() for h in hat])
    t_losses.discriminator_loss(y_r, y_g)[0].backward()
    y_r, y_g, f_r, f_g = td(y_t, hat)
    loss = t_losses.generator_loss(y_g)[0] + t_losses.feature_loss(f_r, f_g)
    signal = torch.autograd.grad(loss, hat)

    def leaves(nested):
        return [x.detach().float().numpy() for v in nested
                for x in (v if isinstance(v, list) else [v])]

    return {
        "logits": leaves(y_r) + leaves(y_g),
        "fmaps": [x for v in f_r for x in leaves(v)] + [x for v in f_g for x in leaves(v)],
        "d_grads": [p.grad.numpy() for _, p in td.named_parameters()],
        "g_signal": [s.numpy() for s in signal],
    }


def _probe_pair(y, ys_hat):
    jd = j_avocodo.AvocodoDiscriminator(combd_cfg=j_avocodo.COMBD_PROBE,
                                        sbd_cfg=j_avocodo.SBD_PROBE)
    params = jax.jit(jd.init)(jax.random.PRNGKey(40), y, ys_hat)
    td = load_flax_params(t_avocodo.AvocodoDiscriminator(
        t_avocodo.COMBD_PROBE, t_avocodo.SBD_PROBE, bf16=True, segment_size=2048,
        device="cpu"), params).eval()
    return params, td


@pytest.fixture(scope="module")
def gaps():
    """{"own", "port", "fused"}: {group: gap} (the module docstring)."""
    y, ys_hat = _disc_inputs(2, 2048, 40)
    params, td = _probe_pair(y, ys_hat)
    runs = {}
    for name, bf16 in (("jax f32", False), ("jax bf16", True)):
        jd = j_avocodo.AvocodoDiscriminator(combd_cfg=j_avocodo.COMBD_PROBE,
                                            sbd_cfg=j_avocodo.SBD_PROBE, bf16=bf16)
        grads, groups = _jax_groups(jd, params, y, ys_hat)
        # the JAX parameter gradients in the port's names and shapes
        sd = flax_to_state_dict(td, grads)
        groups["d_grads"] = [np.asarray(sd[k], np.float32).reshape(p.shape)
                             for k, p in td.named_parameters()]
        runs[name] = groups
    runs["port"] = _port_groups(td, y, ys_hat)
    with _fused_variant() as mark:
        mark(td)
        runs["fused"] = _port_groups(td, y, ys_hat)
    ref, jb = runs["jax f32"], runs["jax bf16"]
    out = {"own": {g: _rel(jb[g], ref[g], ref[g]) for g in GROUPS}}
    for name in ("port", "fused"):
        out[name] = {g: _rel(runs[name][g], jb[g], ref[g]) for g in GROUPS}
    return out


@pytest.mark.parametrize("group", GROUPS)
def test_discriminator_rounds_as_the_jax_package(gaps, group):
    """The package's D under bf16 lies within PORT_OVER_JAX[group] x JAX's
    own bf16 gap of the JAX package's bf16."""
    own, port = gaps["own"][group], gaps["port"][group]
    assert own > 0, f"{group}: the JAX bf16 run equals its f32 run"
    assert port <= PORT_OVER_JAX[group] * own, (group, port / own, gaps)


def test_fused_rounding_fails_the_package_tolerances(gaps):
    """The tolerances tell the package's rounding from the fused variant's:
    the fused variant lies outside them in at least one group (measured:
    the logits and the feature maps)."""
    failed = [g for g in GROUPS if gaps["fused"][g] > PORT_OVER_JAX[g] * gaps["own"][g]]
    assert failed, gaps


def test_eager_rounding_is_farther_from_jax_in_what_g_receives(gaps):
    """What G receives through D: the package's eager rounding (the bias
    add, the activation and each branch sum rounded on their own) lies
    farther from the JAX package's bf16 than the fused variant's one
    rounding a fusion (measured 0.818 against 0.698 of the own gap)."""
    assert gaps["port"]["g_signal"] > gaps["fused"]["g_signal"], gaps


def test_a_layer_rounds_once_after_its_conv():
    """Under the tool's ``disc:fused`` a discriminator layer is the conv's
    bf16 output, its bias added and its leaky ReLU applied in f32, rounded
    to bf16 once: bit for bit. The package's eager rounding (the bias add
    and the activation each rounded) gives other bits."""
    torch.manual_seed(0)
    y, ys_hat = _disc_inputs(1, 2048, 41)
    eager_disc = t_avocodo.AvocodoDiscriminator(t_avocodo.COMBD_PROBE, t_avocodo.SBD_PROBE,
                                                bf16=True, segment_size=2048, device="cpu")
    torch.nn.init.normal_(eager_disc.combd.blocks[0].convs[0].bias, 0.0, 1.0)
    block = eager_disc.combd.blocks[0]
    conv = block.convs[0]
    x = torch.randn(2, 1, 2048).bfloat16()
    with torch.no_grad():
        eager = torch.nn.functional.leaky_relu(conv(x), t_avocodo.LRELU)
        with _fused_variant() as mark:
            mark(eager_disc)
            got = block(x, 1, 1)[2][0]
        w = conv.weight.bfloat16()  # the weight-norm hook ran in the calls above
        p = conv.padding
        z = torch.nn.functional.conv1d(x, w, None, conv.stride, p, conv.dilation,
                                       conv.groups).float() + conv.bias[:, None]
        want = torch.nn.functional.leaky_relu(z, t_avocodo.LRELU).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want[:1])
    assert not torch.equal(eager, want)


def test_parameters_stay_f32():
    """The policy's compute is bf16, its parameters f32: the logits and
    feature maps come out in bf16, every parameter stays f32."""
    td = t_avocodo.AvocodoDiscriminator(t_avocodo.COMBD_PROBE, t_avocodo.SBD_PROBE,
                                        bf16=True, segment_size=2048, device="cpu")
    y, ys_hat = _disc_inputs(1, 2048, 41)
    y_r, y_g, f_r, f_g = td(torch.from_numpy(np.asarray(y)),
                            [torch.from_numpy(np.asarray(a)) for a in ys_hat])
    assert all(p.dtype == torch.float32 for p in td.parameters())
    outs = y_r + y_g + [x for f in f_r + f_g for x in f]
    assert outs and all(o.dtype == torch.bfloat16 for o in outs)
