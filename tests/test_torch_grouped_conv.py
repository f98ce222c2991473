"""The scale discriminator's grouped convs (``models/mpd.py::GroupedConv1d``)
and their input gradient (``ops/grouped_conv.py``).

On the CPU: the plain version against ``F.conv1d``'s own autograd at the
published widths a group and at the probe widths, lengths the stride does not
divide among them; ``gradcheck`` of the autograd Function in float64; the
scale discriminator built from ``GroupedConv1d`` against the same one built
from ``Conv1d`` (the parent's layers), bit for bit, in float32 and under
bf16 autocast; the state-dict keys; the wrapper's refusals that need no card;
the ``disc.grouped_dgrad`` counter over a pitchless probe ``train_step`` (4
grouped layers x the D and the G backward).

On the card (``-m cuda``; skipped without one): the kernel against cuDNN's
``conv1d_input`` with TF32 off and against a float64 reference, at the
``ljs_mbistft.train`` cell's four shapes (128 rows), at the probe widths and
at wider ones up to the kernel's limits; the launch count of a backward pass
through the scale discriminator, in float32 and under bf16 autocast; half
operands widened to float32 for the kernel; the refusals. This file imports
no JAX, so it runs where JAX is absent:
``python -m pytest --noconftest tests/test_torch_grouped_conv.py -m cuda``.
"""

from __future__ import annotations

import pytest
import torch
from torch.nn import functional as F

from vits_torch.models import modules, mpd
from vits_torch.ops import grouped_conv as gc
from vits_torch.utils import profiling

K, STRIDE, PAD = 41, 4, 20  # every grouped conv of the scale discriminator
# (cin_g, cout_g, groups, T_in, K, stride, padding): the ljs_mbistft.train
# cell's four layers (128 rows of 8192 samples) and the probe widths'
# (MSD_PROBE)
CELL = [(4, 16, 4, 8192), (4, 16, 16, 2048), (4, 16, 64, 512), (4, 4, 256, 128)]
PROBE = [(1, 4, 4, 2053), (2, 4, 8, 514), (2, 4, 16, 129), (4, 4, 16, 33)]
# the published widths a group at short lengths, for the CPU
SHORT = [(4, 16, 4, 1027), (4, 16, 16, 258), (4, 16, 64, 65), (4, 4, 256, 17)]
CELL, PROBE, SHORT = ([(*shape, K, STRIDE, PAD) for shape in v] for v in (CELL, PROBE, SHORT))
# other widths within the kernel's limits: the widest a group at stride 1 and
# at stride 8, an odd width, kernel and stride with padding beyond the kernel's
# half
WIDE = [(8, 64, 2, 1000, 64, 1, 0), (8, 64, 3, 517, 64, 8, 5), (3, 7, 5, 301, 13, 3, 11)]


def _operands(cin_g, cout_g, groups, t_in, k, stride, pad, rows=2, seed=0,
              dtype=torch.float32, device="cpu"):
    t_out = (t_in + 2 * pad - k) // stride + 1
    g = torch.Generator().manual_seed(seed + t_in)
    x = torch.randn(rows, groups * cin_g, t_in, generator=g, dtype=dtype)
    w = torch.randn(groups * cout_g, cin_g, k, generator=g, dtype=dtype) / (cin_g * k) ** 0.5
    b = torch.randn(groups * cout_g, generator=g, dtype=dtype)
    go = torch.randn(rows, groups * cout_g, t_out, generator=g, dtype=dtype)
    return [t.to(device) for t in (x, w, b, go)]


def _msd_pair(channels, seed=0):
    """(the scale discriminator, the same weights in the parent's Conv1d layers)."""
    torch.manual_seed(seed)
    new = mpd.DiscriminatorS(*channels)
    parent = mpd.DiscriminatorS(*channels)
    parent.load_state_dict(new.state_dict())
    for conv in parent.convs:
        if isinstance(conv, mpd.GroupedConv1d):
            conv.__class__ = modules.Conv1d
    return new, parent


def _run_msd(msd, x, autocast=False):
    """Logits, feature maps, the input's and every parameter's gradient."""
    x = x.detach().clone().requires_grad_()
    msd.zero_grad(set_to_none=True)
    with torch.autocast("cpu", enabled=autocast):
        logits, fmap = msd(x)
    (logits.float().sum() + sum((f.float() ** 2).mean() for f in fmap)).backward()
    return [logits.detach(), *[f.detach() for f in fmap], x.grad,
            *[p.grad for p in msd.parameters()]]


# -- on the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("cin_g,cout_g,groups,t_in,k,stride,pad", SHORT + PROBE + WIDE)
def test_plain_version_is_autograds(cin_g, cout_g, groups, t_in, k, stride, pad):
    x, w, b, go = _operands(cin_g, cout_g, groups, t_in, k, stride, pad)
    x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    F.conv1d(x, w, b, stride, pad, 1, groups).backward(go)
    want = [x.grad, w.grad, b.grad]
    got = gc.grouped_dgrad(go, w.detach(), t_in, stride, pad, groups)
    assert torch.equal(got, want[0])
    for t in (x, w, b):
        t.grad = None
    gc.GroupedConv1dFunction.apply(x, w, b, stride, pad, groups).backward(go)
    for a, e in zip((x.grad, w.grad, b.grad), want):
        assert torch.equal(a, e)


@pytest.mark.parametrize("stride,padding,bias", [(4, 20, True), (3, 2, False), (1, 0, True)])
def test_function_gradcheck(stride, padding, bias):
    g = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 6, 23, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(9, 2, 7, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(9, generator=g, dtype=torch.float64, requires_grad=True) if bias else None
    assert torch.autograd.gradcheck(
        lambda x, w, b: gc.GroupedConv1dFunction.apply(x, w, b, stride, padding, 3), (x, w, b))


@pytest.mark.parametrize("autocast", [False, True], ids=["f32", "bf16_autocast"])
@pytest.mark.parametrize("channels,length", [(mpd.MSD_PROBE, 2053), (mpd.MSD_CHANNELS, 1024)],
                         ids=["probe", "published"])
def test_discriminator_is_the_parents_bit_for_bit(channels, length, autocast):
    new, parent = _msd_pair(channels)
    assert [type(c) for c in new.convs] == [modules.Conv1d] + [mpd.GroupedConv1d] * 4 \
        + [modules.Conv1d]
    x = torch.randn(2, 1, length, generator=torch.Generator().manual_seed(length))
    got, want = _run_msd(new, x, autocast), _run_msd(parent, x, autocast)
    assert len(got) == len(want)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


def test_state_dict_keys_are_vits():
    from perfbench.reference.models import mpd as ref_mpd

    for probe in (False, True):
        keys = list(mpd.MultiPeriodDiscriminator(probe=probe, device="cpu").state_dict())
        assert keys == list(ref_mpd.MultiPeriodDiscriminator(probe=probe).state_dict())
        assert {f"discriminators.0.convs.{n}.{leaf}" for n in range(1, 5)
                for leaf in ("weight_g", "weight_v", "bias")} <= set(keys)


def test_cpu_takes_the_plain_version_and_the_wrapper_refuses_what_needs_a_card():
    x, w, b, go = _operands(*PROBE[0])
    before = dict(gc.launches)
    got = gc.grouped_dgrad(go, w, x.shape[-1], STRIDE, PAD, 4)
    assert torch.equal(got, gc.grouped_dgrad_torch(go, w, x.shape[-1], STRIDE, PAD, 4))
    with pytest.raises(ValueError, match="CUDA"):
        gc.grouped_dgrad_cuda(go, w, x.shape[-1], STRIDE, PAD, 4)
    with pytest.raises(TypeError, match="float32"):
        gc.grouped_dgrad_cuda(go.bfloat16(), w.bfloat16(), x.shape[-1], STRIDE, PAD, 4)
    with pytest.raises(ValueError, match="takes cin_g"):
        gc.check_shapes((2, 8, 10), (8, 9, 5), 20, 2, 2, 1)
    with pytest.raises(ValueError, match="not the forward's"):
        gc.check_shapes(go.shape, w.shape, x.shape[-1] + 4, STRIDE, PAD, 4)
    assert gc.launches == before


def test_probe_train_step_counts_eight_grouped_backwards(tmp_path):
    from tests.test_torch_mb_istft_train import batch_and_noise, parts, tiny_config
    from vits_torch.training.step import create_train_state, train_step

    hps, _, (pg, pd, _, _), _ = parts(tiny_config(tmp_path))
    state = create_train_state(pg, pd, hps, steps_per_epoch=100)
    batch, noise = batch_and_noise()
    was = profiling.set_tracing(True)
    try:
        profiling.reset()
        train_step(state, batch, hps, noise=noise)
        snap = profiling.snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset()
    assert snap["counters"]["disc.grouped_dgrad"] == 8
    assert snap["spans"]["vits.disc.grouped_dgrad"]["count"] == 8


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the grouped-conv kernel is CUDA-only")
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = was


@pytest.mark.cuda
@pytest.mark.parametrize("cin_g,cout_g,groups,t_in,k,stride,pad", CELL + PROBE + WIDE)
def test_kernel_matches_cudnn_on_card(card, cin_g, cout_g, groups, t_in, k, stride, pad):
    """Tolerance: each of two float32 sums of the same n = cout_g * ceil(K /
    s) products (the kernel's FMA chain, cuDNN's order) lies within n * 2^-24
    of the sum of the products' magnitudes (the standard bound of recursive
    summation), so the two lie within twice that of each other, and the
    kernel within once that of the float64 sum."""
    _, w, _, go = _operands(cin_g, cout_g, groups, t_in, k, stride, pad, rows=128,
                            device=card)
    before = gc.launches["grouped_dgrad"]
    got = gc.grouped_dgrad(go, w, t_in, stride, pad, groups)
    torch.cuda.synchronize()
    assert gc.launches["grouped_dgrad"] == before + 1
    shape = (128, groups * cin_g, t_in)
    cudnn = torch.nn.grad.conv1d_input(shape, w, go, stride, pad, 1, groups)
    exact = torch.nn.grad.conv1d_input(shape, w.double(), go.double(), stride, pad, 1, groups)
    scale = torch.nn.grad.conv1d_input(shape, w.double().abs(), go.double().abs(), stride, pad,
                                       1, groups)
    bound = cout_g * -(-k // stride) * 2.0 ** -24 * scale
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((got - cudnn).double().abs() <= 2 * bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("autocast", [False, True], ids=["f32", "bf16_autocast"])
@pytest.mark.parametrize("channels", [mpd.MSD_CHANNELS, mpd.MSD_PROBE], ids=["published", "probe"])
def test_a_backward_through_the_msd_launches_four(card, channels, autocast):
    """Its forward is the parent's cuDNN call: the outputs equal the parent's
    layers' bit for bit. Under bf16 autocast the kernel takes the widened
    bfloat16 gradients."""
    msd, parent = (m.to(card) for m in _msd_pair(channels))
    x = torch.randn(4, 1, 8192, device=card, requires_grad=True)
    for frozen in (False, True):  # the D backward, the G backward through the frozen D
        for p in msd.parameters():
            p.requires_grad_(not frozen)
        before = gc.launches["grouped_dgrad"]
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            logits, fmap = msd(x)
        (logits.float().sum() + sum(f.float().square().mean() for f in fmap)).backward()
        torch.cuda.synchronize()
        assert gc.launches["grouped_dgrad"] == before + 4
        assert bool(x.grad.isfinite().all())
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
        want_logits, want_fmap = parent(x)
    for a, e in zip([logits, *fmap], [want_logits, *want_fmap]):
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.cuda
def test_half_operands_are_widened_for_the_kernel_on_card(card):
    """``grouped_dgrad`` widens bfloat16 and float16 operands to float32,
    which is exact, launches the kernel once and returns grad_out's dtype."""
    _, w, _, go = _operands(*CELL[1], rows=8, device=card)
    t_in = CELL[1][3]
    for half in (torch.bfloat16, torch.float16):
        go_h, w_h = go.to(half), w.to(half)
        before = gc.launches["grouped_dgrad"]
        got = gc.grouped_dgrad(go_h, w_h, t_in, STRIDE, PAD, 16)
        assert gc.launches["grouped_dgrad"] == before + 1 and got.dtype == half
        want = gc.grouped_dgrad_cuda(go_h.float(), w_h.float(), t_in, STRIDE, PAD, 16)
        assert torch.equal(got, want.to(half))


@pytest.mark.cuda
def test_kernel_refuses_on_card(card):
    _, w, _, go = _operands(*PROBE[3], device=card)
    t_in = PROBE[3][3]
    before = dict(gc.launches)
    with pytest.raises(TypeError, match="float32"):
        gc.grouped_dgrad_cuda(go.bfloat16(), w.bfloat16(), t_in, STRIDE, PAD, 16)
    with pytest.raises(TypeError, match="float32"):
        gc.grouped_dgrad(go.double(), w.double(), t_in, STRIDE, PAD, 16)
    with pytest.raises(ValueError, match="contiguous"):
        gc.grouped_dgrad(go.transpose(0, 1).contiguous().transpose(0, 1), w, t_in, STRIDE,
                         PAD, 16)
    wide = [((2, 8, 10), (8, 9, 5), 20, 2, 2, 1),  # cin_g 9
            ((2, 65, 10), (65, 1, 5), 20, 2, 2, 1),  # cout_g 65
            ((2, 8, 10), (8, 1, 65), 20, 1, 27, 1),  # K 65
            ((2, 8, 3), (8, 1, 5), 20, 9, 2, 1)]  # stride 9
    for go_shape, w_shape, t, s, p, g in wide:
        with pytest.raises(ValueError, match="takes cin_g"):
            gc.grouped_dgrad(torch.zeros(go_shape, device=card), torch.zeros(w_shape, device=card),
                             t, s, p, g)
    assert gc.launches == before
