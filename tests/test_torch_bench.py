"""The port's benchmark scripts (``bench_torch.py``, ``bench_train_torch.py``,
``bench_matrix_torch.py``) against the JAX package's (``bench.py``,
``bench_train.py``, ``bench_matrix.py``), on the CPU at tiny sizes.

FLOP parity. One f32 train step at ``tests/test_train_step.py``'s TINY
configuration with the probe discriminator, B=2: the port's
``utils/profiling.py::step_flops`` against ``tools/hlo_flops.py``'s count of
the JAX ``train_step`` compiled on the CPU, as bench.py counts it. Tolerance
2% of the JAX count, once two known differences of the JAX count are
settled, each checked here:
  * DOTS   ``hlo_flops.dot_flops`` reads the operand shapes from the dot's
           own line; this XLA prints operands by name only, so the tool
           counts every dot as 0 (~27% of the step: the 1x1 convolutions
           XLA lowers to dots, the mel DFT, attention). The test counts each
           dot by the tool's rule with the operand shapes looked up by name.
  * DENSE DEPTHWISE WEIGHT GRADIENTS  XLA's CPU compiler emits the weight
           gradient of a depthwise convolution (one channel a group, the
           duration predictor's DDS convs) as a dense [C, k, C] convolution
           and keeps its diagonal, so the tool counts it C times (~15% of the
           step). ``step_flops`` counts it once, as the tool counts a
           ``batch_group_count`` convolution on a TPU; the test takes the
           (C - 1) extra copies of each of the port's depthwise weight
           gradients off the JAX count, after checking that the HLO holds
           one such dense convolution for each of them.
What remains (~1.3%, the JAX count higher) is left to the tolerance, with
parts of both signs: the tool counts a strided convolution's data gradient
at ceil(k / stride) taps a stride and the discriminator's explicitly padded
rows, and XLA computes the G step's discriminator data gradient on the
generated rows only, where the port's autograd computes it on the
concatenated real and generated batch (~24.8 MFLOP here). FFTs (the Yingram,
PhaseAug) and MAS are counted by neither.

The lines. Each port line's keys (and the matrix's metric names, in order)
equal the JAX line's, read from the JAX scripts' source
(``chip_smoke.py::jax_bench_lines``); the port's functions run at a tiny
configuration with ``device="cpu"``. The synthetic train batch equals
bench.py's draws, evaluated from bench.py's own source. Without a card and
without ``--device cpu`` each script exits non-zero within seconds.
"""

import ast
import functools
import json
import math
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from vits_tpu.models.avocodo import probe_discriminator as j_probe
from vits_tpu.models.synthesizer import SynthesizerTrn as JaxSynthesizer
from vits_tpu.text.symbols import symbols as j_symbols
from vits_tpu.training import step as j_step

import bench_matrix_torch
import bench_torch
from chip_smoke import jax_bench_lines
from vits_torch.config import HParams, load_hparams
from vits_torch.models.avocodo import probe_discriminator
from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.training import step as t_step
from vits_torch.utils import profiling

from tests._torch_ranks import subprocess_env
from tests.test_train_step import HPS as J_HPS, TINY, _make_batch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import hlo_flops  # noqa: E402

FLOPS_RTOL = 0.02
SCRIPTS = ("bench_torch.py", "bench_train_torch.py", "bench_matrix_torch.py")
# the config_cje data and train sections at the tiny widths of the serving
# tests, depths cut as in TINY, the probe discriminator
TINY_MODEL = dict(
    inter_channels=96, hidden_channels=48, filter_channels=64, n_heads=2, n_layers=1,
    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], upsample_initial_channel=32,
    gin_channels=16, posterior_layers=2, flow_n_flows=1, flow_wn_layers=1, dur_n_flows=1,
    yin_dec_layers=2, discriminator_size="probe",
)


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    cfg = yaml.safe_load((ROOT / "configs" / "config_cje.yaml").read_text())
    cfg["train"]["segment_size"] = 2048
    cfg["model"].update(TINY_MODEL)
    path = tmp_path_factory.mktemp("bench") / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg, allow_unicode=True))
    return str(path)


@pytest.fixture(scope="module")
def scripts(tiny_config, tmp_path_factory):
    """The scripts' subprocesses, started together while the module's other
    fixtures run: each script without a card (and without --device), and
    bench_train_torch.py at a tiny size on the CPU with --trace."""
    trace_dir = tmp_path_factory.mktemp("trace")
    cmds = {s: [s] for s in SCRIPTS}
    cmds["train_cpu"] = ["bench_train_torch.py", "--device", "cpu", "--config", tiny_config,
                         "--batch", "2", "--frames", "32", "--text", "16", "--iters", "1",
                         "--trace", str(trace_dir)]
    procs = {k: subprocess.Popen([sys.executable, *c], cwd=ROOT, env=subprocess_env(),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    yield procs, trace_dir
    for p in procs.values():
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def started(tiny_config):
    """bench_torch.bench_line and bench_matrix_torch.scenario_lines at the
    tiny config on the CPU, in threads that run while the JAX step compiles."""
    dev = torch.device("cpu")
    with ThreadPoolExecutor(2) as pool:
        yield {
            "line": pool.submit(bench_torch.bench_line, tiny_config, dev, infer_iters=1,
                                train_iters=1, train_batch_size=2),
            "matrix": pool.submit(lambda: list(bench_matrix_torch.scenario_lines(
                tiny_config, dev, n=1, train_batch_size=2))),
        }


def _finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


# -- FLOP parity -------------------------------------------------------------------------------


def _hlo_dot_flops(text: str) -> float:
    """Every dot of the HLO counted by ``hlo_flops.dot_flops``'s rule, the
    operand shapes inlined where the line names its operands only."""
    shape_of = {}
    for line in text.splitlines():
        m = hlo_flops._NAME_DEF.match(line)
        sh = m and hlo_flops._SHAPE.search(m.group(2))
        if sh:
            shape_of.setdefault(m.group(1), sh.group(2))
    total = 0.0
    for line in text.splitlines():
        if " dot(" not in line:
            continue
        if len(hlo_flops._shapes(line)) < 2:
            head, rest = line.split(" dot(", 1)
            names, tail = rest.split(")", 1)
            operands = [n.strip() for n in names.split(",")]
            inlined = ", ".join(f"f32[{shape_of[n.lstrip('%')]}] {n}" for n in operands)
            line = f"{head} dot({inlined}){tail}"
        total += hlo_flops.dot_flops(line)
    return total


@pytest.fixture(scope="module")
def jax_step_hlo(scripts, started):
    """The JAX train step's compiled HLO on the CPU, as bench.py lowers it."""
    batch = _make_batch()
    model, disc = JaxSynthesizer(**TINY), j_probe()
    optim_g = j_step.make_optimizer(J_HPS, steps_per_epoch=10)
    optim_d = j_step.make_optimizer(J_HPS, steps_per_epoch=10)
    state = jax.eval_shape(lambda: j_step.create_train_state(
        jax.random.PRNGKey(0), model, disc, optim_g, optim_d, batch))
    fn = jax.jit(functools.partial(j_step.train_step, model=model, disc=disc, optim_g=optim_g,
                                   optim_d=optim_d, hps=J_HPS))
    return fn.lower(state, batch, jax.random.PRNGKey(1)).compile().as_text()


@pytest.fixture(scope="module")
def port_step_flops(started):
    """(step_flops of the port's step, [(C, k, forward FLOPs)] of each
    depthwise weight gradient it counted)."""
    started["line"].result()  # its own step_flops must not run under the patch below
    depthwise = []
    inner = profiling.conv_backward_flops

    def recording(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                  transposed, output_padding, groups, output_mask, out_shape=None, **kw):
        if output_mask[1] and not transposed and groups == x_shape[1] == w_shape[0] > 1:
            forward = inner(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                            transposed, output_padding, groups, [True, False])
            depthwise.append((groups, w_shape[2], forward))
        return inner(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                     transposed, output_padding, groups, output_mask, out_shape)

    hps = HParams(**J_HPS.to_dict())
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = SynthesizerTrn(**TINY, device="cpu")
        disc = probe_discriminator(segment_size=hps.train.segment_size, device="cpu")
    state = t_step.create_train_state(model, disc, hps, steps_per_epoch=10)
    batch = {k: np.asarray(v) for k, v in _make_batch().items()}
    gen = torch.Generator().manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "conv_backward_flops", recording)
        flops = profiling.step_flops(lambda: t_step.train_step(state, batch, hps, generator=gen))
    return flops, depthwise


def test_step_flops_matches_the_jax_hlo_count(jax_step_hlo, port_step_flops):
    flops, depthwise = port_step_flops
    tool = hlo_flops.true_flops_from_hlo(jax_step_hlo)
    dots = _hlo_dot_flops(jax_step_hlo)
    dense_copies = sum((c - 1) * f for c, _, f in depthwise)
    reference = tool["conv"] + dots - dense_copies
    assert dots > 0.1 * reference, (tool, dots)
    assert dense_copies > 0.05 * reference, depthwise
    assert abs(flops - reference) <= FLOPS_RTOL * reference, (flops, reference, tool, dots,
                                                              dense_copies)


def test_the_hlo_holds_a_dense_conv_for_each_depthwise_weight_gradient(jax_step_hlo,
                                                                      port_step_flops):
    _, depthwise = port_step_flops
    dense = Counter()
    for line in jax_step_hlo.splitlines():
        if " convolution(" in line:
            out = hlo_flops._shapes(line)[0][1]
            if len(out) == 3 and out[0] == out[2]:
                dense[(out[0], out[1])] += 1
    want = Counter((c, k) for c, k, _ in depthwise)
    assert want and all(dense[key] >= n for key, n in want.items()), (want, dense)


def test_the_tool_counts_no_dot_of_this_hlo(jax_step_hlo):
    """The first named difference: the tool's own dot count is 0 here."""
    assert " dot(" in jax_step_hlo
    assert hlo_flops.true_flops_from_hlo(jax_step_hlo)["dot"] == 0.0


@pytest.mark.parametrize("groups,transposed", [(1, False), (4, False), (16, False), (4, True)])
def test_step_flops_counts_each_gradient_at_the_forward_cost(groups, transposed):
    """A convolution's data and weight gradients each cost its forward's
    FLOPs, grouped or not (PyTorch's own formula counts a grouped weight
    gradient ``groups`` times)."""
    x = torch.ones(2, 16, 64, requires_grad=True)
    if transposed:
        w = torch.ones(16, 32 // groups, 8, requires_grad=True)

        def conv():
            return torch.nn.functional.conv_transpose1d(x, w, stride=4, padding=2,
                                                        groups=groups)
        forward = 2 * 2 * 64 * 16 * (32 // groups) * 8
    else:
        w = torch.ones(32, 16 // groups, 5, requires_grad=True)

        def conv():
            return torch.nn.functional.conv1d(x, w, stride=2, padding=2, groups=groups)
        forward = 2 * 2 * 32 * 32 * (16 // groups) * 5
    assert profiling.step_flops(conv) == forward
    assert profiling.step_flops(lambda: conv().sum().backward()) == 3 * forward


# -- the lines ---------------------------------------------------------------------------------


def _numbers(line):
    return {k: v for k, v in line.items() if isinstance(v, (int, float))
            and not isinstance(v, bool)}


def test_bench_line_has_the_jax_keys(started):
    (ref,) = jax_bench_lines(ROOT / "bench.py")
    line = started["line"].result(timeout=600)
    assert set(line) == ref["keys"] and line["metric"] == ref["metric"] == "inference_rtf"
    assert line["device"] == "cpu" and line["train_mfu"] is None
    assert line["train_hbm_bytes"] is None and line["train_batch_size"] == 2
    for k, v in _numbers(line).items():
        assert math.isfinite(v) and v > 0, (k, v)
    json.dumps(line)


def test_matrix_lines_have_the_jax_metrics_and_keys(started):
    ref = jax_bench_lines(ROOT / "bench_matrix.py")
    lines = started["matrix"].result(timeout=600)
    assert [ln["metric"] for ln in lines] == [r["metric"] for r in ref] and len(ref) == 6
    for line, r in zip(lines, ref):
        assert set(line) == r["keys"], line["metric"]
        for k, v in _numbers(line).items():
            assert math.isfinite(v) and v > 0, (line["metric"], k, v)


def test_bench_train_line_has_the_jax_keys_and_writes_the_trace(scripts):
    procs, trace_dir = scripts
    rc, out, err = _finish(procs["train_cpu"])
    assert rc == 0, err[-3000:]
    (ref,) = jax_bench_lines(ROOT / "bench_train.py")
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == ref["keys"] and line["metric"] == ref["metric"]
    assert line["batch"] == 2 and line["frames"] == 32 and line["bf16"] is False
    counted = json.loads(err.strip().splitlines()[-1])
    assert counted["script"] == "bench_train_torch.py" and counted["train_steps"] == 2
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_without_a_card_exits_before_building_a_model(scripts, script):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid here")
    rc, out, err = _finish(scripts[0][script], timeout=120)
    assert rc != 0 and not out
    assert "no CUDA card" in err and "--device cpu" in err, err[-2000:]


def test_train_batch_is_bench_py_draws():
    """bench_torch.train_batch from default_rng(0) against the batch dict of
    bench.py's _bench_train, evaluated from bench.py's source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_bench_train")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "batch")
    b, tx, ty, hop = 3, 7, 5, 256
    scope = dict(jnp=jnp, np=np, rng=np.random.default_rng(0), symbols=j_symbols, b=b, tx=tx,
                 ty=ty, hop=hop)
    want = eval(compile(ast.Expression(node.value), "bench.py", "eval"), scope)
    hps = load_hparams(str(ROOT / "configs" / "config_cje.yaml"))
    got = bench_torch.train_batch(np.random.default_rng(0), hps, b, tx, ty, torch.device("cpu"))
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 989e12),
    ("NVIDIA H100 SXM5 80GB, 700.00 W", 989e12),
    ("NVIDIA H100 PCIe, 350.00 W", None),
    ("NVIDIA A100-SXM4-80GB, 400.00 W", None),
    ("cpu", None),
])
def test_peak_bf16_flops(name, peak):
    assert profiling.peak_bf16_flops(name) == peak
