"""``tools/bf16_bisect.py``'s ``fused`` rounding in every bf16 group and its
hold-rate study, on the CPU at tiny sizes.

Each fused epilogue is a ``torch.autograd.Function`` beside a plain version
(the same chain in f32 through autograd, one ``.to``): the forward equals
the plain version bit for bit, the input gradients lie within 1e-2 (relative
L2) of autograd through the plain version, and every activation it saves is
bf16 (a bias it needs is the parameter itself). A ``pe:fused`` WaveNet layer
rounds once a fusion, as ``tests/test_torch_bf16_policy.py`` shows for a
discriminator layer. The study's rule: a run holds when its MAS boundary MAE
is at most 2.8 frames at steps 2000 and 2400; the tally's p values are
``scipy.stats.fisher_exact``'s.
"""

import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.stats import fisher_exact
from torch.nn import functional as F

from vits_torch.models import avocodo, hifigan, modules, posterior_encoder, synthesizer
from vits_torch.training import train as cli

ROOT = Path(__file__).resolve().parents[1]
FUSED = "pe:fused+dec:fused+disc:fused"


def _tool():
    spec = importlib.util.spec_from_file_location("bf16_bisect", ROOT / "tools" / "bf16_bisect.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool()


@contextlib.contextmanager
def installed(variant=FUSED):
    """The tool's patches for ``variant``, undone on exit; yields its {group: mode}."""
    saved = [(obj, name, getattr(obj, name)) for obj, name in (
        (modules.Conv1d, "_conv_forward"), (modules.ConvTranspose1d, "forward"),
        (avocodo.CoMBDBlock, "forward"), (avocodo.MDC, "forward"),
        (avocodo.SBDBlock, "forward"), (posterior_encoder.PosteriorEncoder, "forward"),
        (hifigan.HiFiGANGenerator, "_body"), (cli, "build_synthesizer"),
        (cli, "build_discriminator"), (synthesizer, "build_synthesizer"),
        (avocodo, "AvocodoDiscriminator"))]
    try:
        yield TOOL.install(variant)
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _case(name):
    """(Function, its arguments) of one epilogue at a tiny shape, from a seed."""
    g = torch.Generator().manual_seed(7)

    def t(*shape, dtype=torch.bfloat16, grad=True):
        return (torch.randn(*shape, generator=g) * 2).to(dtype).requires_grad_(grad)

    def p(*shape):
        return torch.nn.Parameter(torch.randn(*shape, generator=g))

    mask = (torch.arange(8) < 6).to(torch.bfloat16).expand(2, 1, 8).contiguous()
    if name == "affine_bf16":
        return TOOL._Affine, (torch.bfloat16, 1, None, t(2, 4, 8, dtype=torch.float32), t(2, 4, 8),
                              p(4)[:, None])
    if name == "affine_f32_masked_mean":
        return TOOL._Affine, (torch.float32, 3, mask, t(2, 4, 8, dtype=torch.float32),
                              t(2, 4, 8, dtype=torch.float32), t(2, 4, 8))
    if name == "lrelu":
        return TOOL._LReLU, (0.1, None, t(2, 4, 8, dtype=torch.float32))
    if name == "lrelu_masked":
        return TOOL._LReLU, (0.2, mask, t(2, 4, 8, dtype=torch.float32))
    if name == "gate":
        return TOOL._Gate, (3, t(2, 6, 8), p(6), t(2, 6, 1), p(6))
    if name == "gate_unconditioned":
        return TOOL._Gate, (3, t(2, 6, 8), p(6), None, None)
    if name == "branch_sum":
        return TOOL._BranchSum, (0.2, t(2, 4, 8), p(4), t(2, 4, 8), p(4), t(2, 4, 8), p(4))
    if name == "tanh":
        return TOOL._Tanh, (t(2, 1, 16),)
    raise KeyError(name)


CASES = ["affine_bf16", "affine_f32_masked_mean", "lrelu", "lrelu_masked", "gate",
         "gate_unconditioned", "branch_sum", "tanh"]


def _run(fn, args):
    """(output, input gradients) for a fixed upstream gradient."""
    out = fn(*args)
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(out.dtype)
    inputs = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
    return out, torch.autograd.grad(out, inputs, dy)


@pytest.mark.parametrize("name", CASES)
def test_function_forward_is_its_plain_version_bit_for_bit(name):
    fn, args = _case(name)
    got = fn.apply(*args)
    want = TOOL.PLAIN[fn](*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_function_gradient_is_autograd_of_its_plain_version(name):
    fn, args = _case(name)
    _, got = _run(fn.apply, args)
    _, want = _run(TOOL.PLAIN[fn], args)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        gap = ((g.double() - w.double()).norm() / w.double().norm()).item()
        assert gap <= 1e-2, (name, gap)


def _saved(fn, args):
    """(dtype, is a parameter, numel) of every tensor the call saves for backward."""
    params = [a for a in args if isinstance(a, torch.nn.Parameter)]
    ptrs = {q.untyped_storage().data_ptr() for q in params}
    seen = []

    def pack(t):
        seen.append((t.dtype, t.untyped_storage().data_ptr() in ptrs, t.numel()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return seen


@pytest.mark.parametrize("name", CASES)
def test_function_saves_only_bf16_activations(name):
    """Every tensor the Function saves is bf16, or a parameter it reads
    (no copy); the plain version saves f32 activations (what the hook sees)."""
    fn, args = _case(name)
    seen = _saved(fn.apply, args)
    assert all(dt == torch.bfloat16 or is_param for dt, is_param, _ in seen), seen
    if fn is not TOOL._Affine:  # a linear chain saves nothing in f32 either way
        plain = _saved(TOOL.PLAIN[fn], args)
        assert any(dt == torch.float32 and not is_param for dt, is_param, _ in plain), plain


def test_parse_variant_takes_fused_in_every_group():
    assert TOOL.parse_variant(FUSED) == {"pe": "fused", "dec": "fused", "disc": "fused"}
    assert TOOL.parse_variant("pe:fused") == {"pe": "fused"}
    assert TOOL.parse_variant("dec:fused+disc") == {"dec": "fused", "disc": "round"}
    assert TOOL.canonical("disc:fused+pe+dec") == "pe+dec+disc:fused"
    assert TOOL.canonical("none") == "none"
    with pytest.raises(SystemExit):
        TOOL.parse_variant("pe:fuse")


def _gate_input(pe, x, lengths, g):
    got = []
    hook = pe.enc.res_skip_layers[0].register_forward_pre_hook(lambda m, a: got.append(a[0]))
    try:
        with torch.no_grad():
            pe(x, lengths, g=g)
    finally:
        hook.remove()
    return got[0]


def test_a_pe_fused_wavenet_layer_rounds_once_per_fusion():
    """Under ``pe:fused`` the first gate's output is: ``pre``'s bf16 output
    + its bias, x mask, in f32, rounded once (in_0's input); in_0's bf16
    output + bias + the conditioning's bf16 output + its bias, tanh x
    sigmoid, in f32, rounded once: bit for bit. The package's eager
    rounding gives other bits."""
    torch.manual_seed(0)
    pe = posterior_encoder.PosteriorEncoder(6, 4, 8, 5, 1, 3, gin_channels=4, bf16=True)
    for m in pe.modules():
        if isinstance(m, torch.nn.Conv1d) and m.bias is not None:
            torch.nn.init.normal_(m.bias, 0.0, 1.0)
    x = torch.randn(2, 6, 16)
    lengths = torch.tensor([16, 12])
    g = torch.randn(2, 4, 1)
    eager = _gate_input(pe, x, lengths, g)
    with installed() as kept:
        TOOL.apply_variant({"pe": [pe]}, kept)
        got = _gate_input(pe, x, lengths, g)
    mask = (torch.arange(16)[None] < lengths[:, None]).float()[:, None]
    bf = torch.bfloat16
    with torch.no_grad():
        xin = ((F.conv1d(x.to(bf), pe.pre.weight.to(bf)).float() + pe.pre.bias[:, None])
               * mask).to(bf)
        in0, cond = pe.enc.in_layers[0], pe.enc.cond_layer  # weight norm ran in the calls above
        c = F.conv1d(xin, in0.weight.to(bf), None, 1, in0.padding, in0.dilation)
        gr = F.conv1d(g.to(bf), cond.weight.to(bf))[:, :16]
        a = (c.float() + in0.bias[:, None]) + (gr.float() + cond.bias[:16, None])
        want = (torch.tanh(a[:, :8]) * torch.sigmoid(a[:, 8:])).to(bf)
    assert got.dtype == bf and torch.equal(got, want)
    assert not torch.equal(eager, want)


def _tiny_step(variant):
    import chip_smoke as cs
    from vits_torch.graft_entry import tiny_hps
    from vits_torch.models.synthesizer import SynthesizerTrn
    from vits_torch.training.step import create_train_state, train_step

    hps = tiny_hps()
    batch, noise = cs.policy_batch(cs.TINY_TRAIN["inter_channels"], cs.TINY_TRAIN["yin_channels"],
                                   2, 9, [16, 16], 0, n_speakers=3)
    torch.manual_seed(0)
    model = SynthesizerTrn(**cs.TINY_TRAIN, device="cpu", bf16=True)
    disc = avocodo.probe_discriminator(segment_size=2048, device="cpu", bf16=True)
    if variant:
        kept = TOOL.parse_variant(variant)
        TOOL.apply_variant(TOOL.model_parts(model), kept)
        TOOL.apply_variant({"disc": [disc]}, kept)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    state = create_train_state(model, disc, hps, steps_per_epoch=10)
    out = {}
    hook = model.register_forward_hook(lambda m, a, o: out.update(o))
    metrics = {k: float(v) for k, v in train_step(state, batch, hps, noise=noise).items()}
    hook.remove()
    return metrics, out


def test_fused_train_step_is_finite():
    """A tiny-config train step with every group fused: finite metrics, and
    the fused rounding did run (the posterior and the audio differ from the
    package's eager rounding)."""
    sys.path.insert(0, str(ROOT))
    eager, e_out = _tiny_step(None)
    with installed():
        fused, f_out = _tiny_step(FUSED)
    assert set(fused) == set(eager) and all(np.isfinite(v) for v in fused.values()), fused
    for key in ("m_q", "wav_hier"):
        a = e_out[key] if key == "m_q" else e_out[key][-1]
        b = f_out[key] if key == "m_q" else f_out[key][-1]
        gap = ((a.float() - b.float()).norm() / a.float().norm()).item()
        assert 0 < gap < 0.05, (key, gap)


def _rows(mae_2000, mae_2400, last=2400):
    return [{"step": s, "mas_boundary_mae": m} for s, m in
            ((1600, 3.0), (2000, mae_2000), (2400, mae_2400)) if s <= last]


@pytest.mark.parametrize("rows, want", [
    (_rows(0.5, 0.6), True),
    (_rows(2.8, 2.8), True),
    (_rows(2.81, 0.5), False),
    (_rows(0.5, 3.4), False),
    (_rows(0.5, 0.5, last=2000), None),
])
def test_held_rule(rows, want):
    assert TOOL.held(rows) is want


def _results(**counts):
    """{variant: (runs, held)} -> result rows."""
    return [{"variant": v.replace("_", "+").replace("-", ":"), "held": i < h}
            for v, (n, h) in counts.items() for i in range(n)]


def test_tally_p_is_scipys_fisher_exact():
    t = TOOL.tally(_results(**{"pe_dec_disc": (6, 1), "pe-fused_dec-fused_disc-fused": (6, 5),
                               "none": (4, 3), "pe_dec_disc-fused": (6, 3)}))
    assert t["counts"]["pe+dec+disc"] == {"runs": 6, "held": 1}
    fused = "pe:fused+dec:fused+disc:fused"
    assert t["p_over_package"][fused] == fisher_exact([[5, 1], [1, 5]], alternative="greater")[1]
    assert t["p_over_package"]["pe+dec+disc:fused"] == \
        fisher_exact([[3, 3], [1, 5]], alternative="greater")[1]
    assert t["p_f32_over_package"] == fisher_exact([[3, 1], [1, 5]], alternative="greater")[1]
    assert t["verdict"].startswith("(a)") and fused in t["verdict"]


@pytest.mark.parametrize("counts, want", [
    ({"pe_dec_disc": (6, 0), "pe-fused_dec-fused_disc-fused": (6, 6)}, "(a)"),
    ({"pe_dec_disc": (6, 0), "pe-fused_dec-fused_disc-fused": (6, 2), "none": (5, 5)}, "(b)"),
    ({"pe_dec_disc": (6, 2), "pe-fused_dec-fused_disc-fused": (6, 3), "none": (4, 2)}, "(c)"),
    ({"pe_dec_disc": (6, 1), "pe-fused_dec-fused_disc-fused": (6, 3), "none": (3, 2)},
     "inconclusive"),
])
def test_verdict_follows_the_rule_in_order(counts, want):
    assert TOOL.tally(_results(**counts))["verdict"].startswith(want)


def test_earlier_runs_are_read_from_the_runs_json():
    """Every port run of the study in the runs JSON that reached step 2400
    names its variant and seed, and the tally counts it by the hold rule."""
    with open(TOOL.RUNS_JSON) as f:
        runs = json.load(f)
    prior = {r["label"]: r for r in TOOL.prior_results()}
    for label, rows in runs.items():
        if label.startswith("JAX") or TOOL.held(rows) is None:
            continue
        assert label in prior, label
        assert prior[label]["held"] is TOOL.held(rows)
        assert label.endswith(f": {prior[label]['variant']}@{prior[label]['seed']}")
    t = TOOL.tally(list(prior.values()))["counts"]
    assert sum(c["runs"] for c in t.values()) == sum(r["held"] is not None
                                                   for r in prior.values())
    assert {"pe+dec+disc", "none", "pe+dec+disc:fused"} <= set(t)


FAKE_RUN = r"""
import json, os, sys, time
workdir, out, name, held = sys.argv[1:5]
os.makedirs(os.path.join(workdir, "run"), exist_ok=True)
with open(os.path.join(workdir, "run", "train.log"), "a") as f:
    for step in (50, 100):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S") + ",000"
        f.write(f"{stamp}\trun\tINFO\tstep {step} | g 1.0 d 1.0\n")
        f.flush()
        time.sleep(0.3)
variant, seed = name.split("@")
rows = [{"step": s, "mas_boundary_mae": 0.5 if held == "1" else 3.5, "mas_frame_acc": 0.5}
        for s in (1600, 2000, 2400)]
result = {"variant": variant.replace("-", ":"), "seed": int(seed), "steps": 2414, "rows": rows,
          "synth": {"n": 8, "exact_order": 8}, "held": held == "1", "step_s_median": 0.5,
          "peak_gib": None}
with open(os.path.join(out, name + ".json"), "w") as f:
    json.dump(result, f)
"""


def test_rates_runs_side_by_side_and_tallies(tmp_path):
    """``rates`` starts the runs (two at once, then the third as one ends),
    collects each run's result and writes the tally with the earlier runs."""
    out = tmp_path / "out"
    runs = ["pe+dec+disc@1", f"{FUSED}@1", "none@2"]

    def worker(r):
        return [sys.executable, "-c", FAKE_RUN, r.workdir, str(out), r.name,
                "0" if r.variant == "pe+dec+disc" else "1"]

    t = TOOL.rates(runs, str(tmp_path / "root"), str(out), 100, "cpu", jobs=2, deadline_s=120.0,
                   max_jobs=2, settle_s=0.0, post_s=0.0, startup_s=0.0, poll_s=0.2,
                   worker=worker)
    names = sorted(p.name for p in out.glob("*@*.json"))
    assert names == sorted(TOOL.run_name(*s.split("@")) + ".json" for s in runs)
    assert json.loads((out / "tally.json").read_text()) == t
    fake = [{"variant": TOOL.canonical(s.split("@")[0]), "held": s != "pe+dec+disc@1"}
            for s in runs]
    assert t == TOOL.tally(fake + TOOL.prior_results())
