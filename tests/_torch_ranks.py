"""What the port's multi-process tests start: the rank functions of
``tests/test_torch_ddp.py`` and ``tests/test_torch_tp.py``, the CPU share
of each test process, and the environment of the subprocesses.

A rank that ``mesh.spawn`` starts (the spawn start method) imports the
module holding its function. This one imports numpy, torch and vits_torch
only, never JAX or the JAX package, so a rank starts in the time torch and
the port take to import; everything else a rank needs comes in its payload.
Every rank and subprocess runs one intra-op thread: the suite runs its test
files side by side, and the ranks are extra processes beside the workers.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from vits_torch import graft_entry
from vits_torch.config import HParams
from vits_torch.models.avocodo import probe_discriminator
from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.parallel import mesh
from vits_torch.training import step as t_step

# a ``tensorflow`` module that fails to import: tensorboard then uses its own
# stub instead of loading TensorFlow (~11 s a process where it is installed)
NO_TENSORFLOW = Path(__file__).resolve().parent / "_no_tensorflow"


def usable_cpus() -> int:
    """The CPUs this process may run on: its affinity mask, cut to the
    cgroup's CPU quota (``cpu.max``, or v1's ``cfs_quota_us``) where one is
    set. ``os.cpu_count()`` counts the host's cores, which a container may
    not grant."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity on this platform
        n = os.cpu_count() or 1
    for path, parse in (("/sys/fs/cgroup/cpu.max", lambda t: t.split()[:2]),
                        ("/sys/fs/cgroup/cpu/cpu.cfs_quota_us", lambda t: [t.strip(), None])):
        try:
            quota, period = parse(Path(path).read_text())
            if period is None:
                period = Path("/sys/fs/cgroup/cpu/cpu.cfs_period_us").read_text().strip()
            if quota not in ("max", "-1"):
                n = min(n, max(1, int(quota) // int(period)))
            break
        except (OSError, ValueError):
            continue
    return max(1, n)


def worker_threads(workers: int) -> int:
    """Intra-op threads of one of ``workers`` pytest-xdist workers: half its
    share of the usable CPUs (the ranks and subprocesses the tests start
    take the rest), at least one."""
    return max(1, usable_cpus() // (2 * workers))


def subprocess_env() -> dict:
    """The environment of a port subprocess a test starts (a torchrun, an
    example): one OpenMP thread, gloo on the loopback device, TensorFlow
    hidden from tensorboard."""
    path = os.pathsep.join(p for p in (str(NO_TENSORFLOW), os.environ.get("PYTHONPATH")) if p)
    return {**os.environ, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo",
            "PYTHONPATH": path}


def no_dropout(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return module


def state_arrays(state):
    return {side: {k: (p.detach().numpy().copy(), p.grad.numpy().copy())
                   for k, p in getattr(state, side).named_parameters()}
            for side in ("model", "disc")}


# -- tests/test_torch_ddp.py -------------------------------------------------------------


def ddp_rank_steps(payload: str) -> dict:
    """One DDP rank: the global step, a second step (DDP raises there if a
    parameter got no gradient in the first), the step with per-rank ratio
    denominators, and the remat step, each from the same weights. The
    payload holds the model's arguments, hps, the weights, the global batch
    and its draws."""
    torch.set_num_threads(1)
    data = torch.load(payload, weights_only=False)
    world, b = data["world"], data["batch"]["x"].shape[0]
    rows = mesh.rank_rows(data["batch"], mesh.process_index(), world, b)
    hps = HParams(**data["hps"])

    def state(h):
        model = SynthesizerTrn(**data["tiny"], device="cpu")
        model.load_state_dict(data["g"])
        disc = probe_discriminator(segment_size=data["seg"], device="cpu")
        disc.load_state_dict(data["d"])
        st = t_step.create_train_state(no_dropout(model), disc, h, steps_per_epoch=10)
        return t_step.replicate_state(st, h)

    def step(st, h, **kw):
        return {k: v.item() for k, v in t_step.train_step(st, rows, h, **kw).items()}

    out = {}
    st = state(hps)
    out["global"] = step(st, hps, noise=data["noise"]), state_arrays(st)
    out["second"] = step(st, hps, generator=torch.Generator().manual_seed(3))
    shared = t_step.ratio_denominator
    t_step.ratio_denominator = lambda total: total.float()  # each rank's own
    try:
        st = state(hps)
        out["per_rank_ratio"] = step(st, hps, noise=data["noise"]), state_arrays(st)
    finally:
        t_step.ratio_denominator = shared
    remat = HParams(train={**data["hps"]["train"], "remat_run": True}, data=data["hps"]["data"])
    st = state(remat)
    out["remat"] = step(st, remat, noise=data["noise"]), state_arrays(st)
    return out


# -- tests/test_torch_tp.py --------------------------------------------------------------

TP_DATA, TP_MODEL, TP_B = 2, 2, 4


def tp_state(data, bf16=False):
    hps, model, disc, _ = graft_entry._dryrun_model_and_batch(TP_B, bf16=bf16)
    model.load_state_dict(data["g"])
    disc.load_state_dict(data["d"])
    return hps, no_dropout(model), disc


def named_arrays(named):
    return {k: (v.detach().numpy().copy(), v.grad.numpy().copy()) for k, v in named}


def _gathered_grads(model, m):
    out = {}
    for name, p in model.named_parameters():
        dim = getattr(p, "tp_dim", None)
        g = p.grad if dim is None else mesh._all_gather_cat(p.grad, dim, m.model_group,
                                                             m.n_model)
        out[name] = g.numpy().copy()
    return out


class _SummedGather(torch.autograd.Function):
    """A channel gather whose backward sums the gradient over the model
    group before taking the slice (a reduce-scatter, what
    ``torch.distributed.nn.functional.all_gather``'s backward does)."""

    @staticmethod
    def forward(ctx, x, dim, m):
        ctx.dim, ctx.start, ctx.size, ctx.m = dim, m.model_index * x.shape[dim], x.shape[dim], m
        return mesh._all_gather_cat(x, dim, m.model_group, m.n_model)

    @staticmethod
    def backward(ctx, grad):
        whole = mesh._all_reduce_sum(grad, ctx.m.model_group)
        return whole.narrow(ctx.dim, ctx.start, ctx.size), None, None


def tp_rank(data: dict) -> dict:
    """One rank of the 2 x 2 mesh: the round trip, the TP step, the step
    with a summed gather backward, the step without the input all-reduce,
    and a bf16 step, each from the same weights."""
    torch.set_num_threads(1)
    m = mesh.make_mesh_2d(TP_DATA, TP_MODEL)
    rows = mesh.rank_rows(data["batch"], m.data_index, TP_DATA, TP_B)
    full = m.data_index == 0  # ranks 0 and 1 return whole states, 2 and 3 their replicas
    out = {"mesh": (m.data_index, m.model_index)}

    def run(key, bf16=False):
        hps, model, disc = tp_state(data, bf16)
        mesh.tp_shard_generator(model, m)
        st = t_step.replicate_state(t_step.create_train_state(model, disc, hps, 100), hps)
        metrics = {k: v.item() for k, v in t_step.train_step(st, rows, hps,
                                                             noise=data["noise"]).items()}
        params = mesh.gather_state_dict(model, m)
        grads = _gathered_grads(model, m)
        replicated = {k: p.detach().numpy().copy() for k, p in model.named_parameters()
                      if getattr(p, "tp_dim", None) is None}
        out[key] = {"metrics": metrics, "replicated": replicated}
        if full:
            out[key]["model"] = {k: (params[k].numpy().copy(), grads[k]) for k in grads}
            out[key]["disc"] = named_arrays(disc.named_parameters())
            out[key]["split"] = {k: p.tp_dim for k, p in model.named_parameters()
                                 if getattr(p, "tp_dim", None) is not None}

    hps, model, _ = tp_state(data)
    mesh.tp_shard_generator(model, m)
    back = mesh.gather_state_dict(model, m)
    out["round_trip"] = (sorted(back) == sorted(data["g"]) and all(
        torch.equal(back[k], data["g"][k]) for k in back))
    out["split_shapes"] = {k: tuple(p.shape) for k, p in model.named_parameters()
                           if getattr(p, "tp_dim", None) is not None}

    run("tp")
    real_gather, real_copy = mesh.gather_from_model, mesh.copy_to_model
    try:
        mesh.gather_from_model = lambda x, dim, mm: _SummedGather.apply(x, dim, mm)
        run("summed_gather")
        mesh.gather_from_model = real_gather
        mesh.copy_to_model = lambda x, mm: x
        run("no_input_all_reduce")
    finally:
        mesh.gather_from_model, mesh.copy_to_model = real_gather, real_copy
    run("bf16", bf16=True)
    return out
