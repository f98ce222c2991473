"""Data-parallel training across processes (port of the data-parallel half
of ``vits_tpu/parallel/mesh.py``).

The JAX package shards the global batch over a ``jax.sharding.Mesh`` and XLA
inserts the gradient all-reduce. Here, as in the torch reference (train.py
with ``torch.distributed``), every card has its own process: ``torchrun``
starts them, ``init_distributed`` joins them into one process group, each
process loads its ``local_batch_rows`` of the global batch, and
``DistributedDataParallel`` (``wrap``) averages the gradients over NCCL.

Counterparts of the JAX names:
  * ``jax.distributed.initialize()``     -> ``init_distributed``
  * ``jax.process_index/process_count``  -> ``process_index/process_count``
  * ``local_batch_rows``                 -> the same, the same error
  * ``shard_batch``                      -> none: each process holds its own
    rows already (the sampler's ``ids[rank::num_replicas]`` stride)
  * ``replicate_state``                  -> ``wrap``: DDP broadcasts rank 0's
    parameters and buffers to every rank when it wraps a module
  * the step's global-batch draws        -> ``rank_rows``

Tensor parallelism, the tensor-parallel half of the JAX module:
  * ``make_mesh_2d(n_data, n_model)``    -> the same: the data and model
    process groups over the world, rank r at (r // n_model, r % n_model)
  * ``tp_shard_generator``               -> the same placement rule, as an
    explicit output-channel split: every conv under ``waveform_decoder``
    whose output channels divide by n_model becomes a ``ShardedConv``
    holding its 1/n_model slice of them; the rest stays replicated
  * XLA's all-gathers and reduce-scatters -> ``copy_to_model``,
    ``reduce_from_model`` and ``gather_from_model``, autograd functions over
    the model group, and ``gather_state_dict`` for the whole tensors
Under a 2-D mesh DDP runs over the data group alone, and ``data_index`` /
``data_count`` (not the global rank and world) place a rank's rows of the
global batch, so model peers see the same rows and the same noise.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import socket
import time
import traceback
from multiprocessing import connection as mp_connection, resource_tracker

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F
from torch.nn.parallel import DistributedDataParallel

from vits_torch.models.modules import _in_dtype_of
from vits_torch.models.synthesizer import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device=None, backend: str | None = None) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this process's device.

    Without ``device`` the device is ``cuda:{LOCAL_RANK}`` and the backend
    NCCL; it raises without a card, as ``resolve_device`` does. A named
    device is taken as given (``"cuda"`` means ``cuda:{LOCAL_RANK}``); the
    backend is gloo on the CPU and NCCL on a card unless ``backend`` names
    another (NCCL refuses two ranks on one card, gloo does not)."""
    dev = resolve_device(device)
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs the environment torchrun sets; {missing} are not set "
            "(start with: torchrun --nproc_per_node N -m vits_torch.training.train ...)"
        )
    local = int(os.environ["LOCAL_RANK"])
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
    )
    return dev


def destroy() -> None:
    """Leave the process group (``init_distributed``'s counterpart) and
    forget the 2-D mesh."""
    global _MESH
    _MESH = None
    if is_distributed():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_batch_rows(global_batch_size: int) -> int:
    """Rows THIS process must feed per step so the global batch has
    ``global_batch_size`` rows. With the ``ids[rank::num_replicas]`` sampler
    stride, every process contributes an equal share."""
    n_proc = process_count()
    if global_batch_size % n_proc != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"process count {n_proc}"
        )
    return global_batch_size // n_proc


def rank_rows(noise: dict, rank: int, world: int, batch: int) -> dict:
    """This rank's rows of draws made for the global batch of ``batch``
    rows: rows ``[rank * b, (rank + 1) * b)``, ``b = batch // world``, of
    every ``[batch, ...]`` draw, and those rows of each half of a
    ``[2 * batch, ...]`` draw (PhaseAug's rotations of the doubled batch,
    real rows then generated ones). Tensors or numpy arrays."""
    b = batch // world
    lo, hi = rank * b, (rank + 1) * b
    out = {}
    for k, v in noise.items():
        n = v.shape[0]
        if n == batch:
            out[k] = v[lo:hi]
        elif n == 2 * batch:
            halves = (v[lo:hi], v[batch + lo : batch + hi])
            out[k] = torch.cat(halves) if isinstance(v, torch.Tensor) else np.concatenate(halves)
        else:
            raise ValueError(f"noise[{k!r}] has {n} rows; the global batch has {batch}")
    return out


def all_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the data ranks (every rank, or the data group
    of a 2-D mesh, whose model peers hold equal values), a new tensor
    (``t`` itself outside a process group). Sum, then divide: gloo has no
    average."""
    if not is_distributed():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_MESH.data_group if _MESH else None)
    return t / data_count()


def wrap(module: torch.nn.Module, device=None) -> DistributedDataParallel:
    """``module`` (already on ``device``) under DDP over the data ranks: its
    parameters and buffers are broadcast from the group's first rank now,
    its gradients averaged over the group in every backward. Buffers are
    constants here (windows, filter banks), so they are not broadcast again
    before each forward."""
    dev = torch.device(device) if device is not None else next(module.parameters()).device
    return DistributedDataParallel(
        module,
        device_ids=[dev.index if dev.index is not None else torch.cuda.current_device()]
        if dev.type == "cuda" else None,
        broadcast_buffers=False,
        process_group=_MESH.data_group if _MESH else None,
    )


# -- the 2-D (data, model) mesh and tensor parallelism ------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place on the (data, model) mesh and its two process
    groups: the ranks with its model index (DDP's) and those with its data
    index (the tensor-parallel peers)."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup


_MESH: Mesh2D | None = None


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D:
    """The 2-D mesh over the initialised world of ``n_data * n_model``
    ranks: rank r sits at (r // n_model, r % n_model), as JAX's
    ``devices.reshape(n_data, n_model)`` places device r. Every rank must
    call it (each creates every group, in one order)."""
    world = process_count()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes; "
                         f"the group has {world}")
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(process_index(), n_model)
    global _MESH
    _MESH = Mesh2D(n_data, n_model, d, m, data_groups[m], model_groups[d])
    return _MESH


def data_index() -> int:
    """This rank's row of the mesh (its rank without a 2-D mesh)."""
    return _MESH.data_index if _MESH else process_index()


def data_count() -> int:
    """The mesh's rows, the data-parallel world (the world without one)."""
    return _MESH.n_data if _MESH else process_count()


def _for_backend(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` that ``group``'s backend takes: for gloo
    on the CPU and of f32 or wider (gloo's gathers take no CUDA tensor, and
    not every build reduces bf16), for NCCL as it is."""
    if dist.get_backend(group) == "gloo":
        return t.detach().to("cpu", torch.promote_types(t.dtype, torch.float32)).contiguous()
    return t.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    buf = _for_backend(t, group)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device, t.dtype)


def _all_gather_cat(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    buf = _for_backend(t, group)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(t.device, t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the model
    group: each rank's slice of a conv reaches its whole input, so each
    holds only its channels' share of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; identity backward: the sum feeds
    every rank's replicated value, whose gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's slices concatenated on ``dim`` forward; backward,
    this rank's slice of the gradient. Every model rank computes the same
    loss from the gathered tensor, so the gradient arriving here is whole
    and the same on each: summing it over the ranks (what
    ``torch.distributed.nn.functional.all_gather``'s backward does) would
    give n_model times the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, index, n):
        ctx.dim, ctx.start, ctx.size = dim, index * x.shape[dim], x.shape[dim]
        return _all_gather_cat(x, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.size), None, None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Mesh2D) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim, mesh.model_group, mesh.model_index, mesh.n_model)


def _slice(t: torch.Tensor, dim: int, mesh: Mesh2D) -> torch.nn.Parameter:
    size = t.shape[dim] // mesh.n_model
    p = torch.nn.Parameter(t.detach().narrow(dim, mesh.model_index * size, size).clone())
    p.tp_dim = dim  # read by gather_state_dict and grad_norm
    return p


class ShardedConv(torch.nn.Module):
    """One rank's slice of the output channels of a (weight-normed)
    ``Conv1d`` or ``ConvTranspose1d``, under the conv's own parameter names
    (``weight`` or ``weight_v`` / ``weight_g``, ``bias``): the rank computes
    its channels from the whole input (``copy_to_model``), and the model
    group gathers them before the next layer (``gather_from_model``).

    A conv's weight-norm scale ``g`` is per output channel and is split with
    them. A transposed conv's is per *input* channel, and its norm runs over
    the output channels that the ranks split: the squared norm is summed
    over the model group and ``g`` stays whole on every rank (its gradient
    summed there). JAX's rule puts that ``g`` on ``'model'`` along its input
    channels, which XLA can compute and an explicit split cannot."""

    def __init__(self, conv: torch.nn.Module, mesh: Mesh2D):
        super().__init__()
        if conv.groups != 1 or conv.padding_mode != "zeros":
            raise ValueError("ShardedConv splits plain convs only")
        self.mesh = mesh
        self.transposed = isinstance(conv, torch.nn.ConvTranspose1d)
        out_dim = 1 if self.transposed else 0  # [in, out, k] / [out, in, k]
        self.args = ((conv.stride, conv.padding, conv.output_padding, 1, conv.dilation)
                     if self.transposed else (conv.stride, conv.padding, conv.dilation))
        self.weight_norm = hasattr(conv, "weight_v")
        if self.weight_norm:
            self.weight_v = _slice(conv.weight_v, out_dim, mesh)
            self.weight_g = (torch.nn.Parameter(conv.weight_g.detach().clone())
                             if self.transposed else _slice(conv.weight_g, 0, mesh))
        else:
            self.weight = _slice(conv.weight, out_dim, mesh)
        self.bias = _slice(conv.bias, 0, mesh) if conv.bias is not None else None

    def _weight(self) -> torch.Tensor:
        if not self.weight_norm:
            return self.weight
        if not self.transposed:  # legacy weight_norm's own computation
            return torch._weight_norm(self.weight_v, self.weight_g, 0)
        v = self.weight_v
        sq = reduce_from_model(v.pow(2).sum((1, 2), keepdim=True), self.mesh)
        return v * copy_to_model(self.weight_g / sq.sqrt(), self.mesh)

    def _conv(self, x, w, b):
        fn = F.conv_transpose1d if self.transposed else F.conv1d
        return fn(x, w, b, *self.args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.mesh)
        y = _in_dtype_of(x, self._weight(), self.bias, self._conv)
        return gather_from_model(y, 1, self.mesh)


def tp_shard_generator(model: torch.nn.Module, mesh: Mesh2D | None = None) -> torch.nn.Module:
    """JAX's tensor-parallel placement of the generator, in place: under
    ``waveform_decoder`` every conv whose output channels divide by
    ``mesh.n_model`` becomes its ``ShardedConv``; the rest (``conv_posts``,
    with one output channel, and every module outside the decoder) stays
    replicated. Call it in every rank of the mesh (default: the one
    ``make_mesh_2d`` made) before the optimizer is built and before
    ``wrap``. A pitchless model has no tensor-parallel step and raises."""
    if not getattr(model, "has_pitch", True):
        raise ValueError("tp_shard_generator: a pitchless model (pitch: none) trains in one "
                         "process; its step has no tensor-parallel form")
    mesh = mesh or _MESH
    decoder = model.waveform_decoder
    for name, module in list(decoder.named_modules()):
        if (isinstance(module, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))
                and module.out_channels % mesh.n_model == 0):
            parent, _, attr = name.rpartition(".")
            setattr(decoder.get_submodule(parent), attr, ShardedConv(module, mesh))
    return model


def gather_state_dict(module: torch.nn.Module, mesh: Mesh2D | None = None) -> dict:
    """``module.state_dict()`` with every tensor-parallel slice gathered
    whole: the state dict of the unsharded module, which loads strictly into
    it (checkpoints, ``evaluate``, serving). A collective: every rank of the
    model group calls it."""
    mesh = mesh or _MESH
    sd = module.state_dict()
    for name, p in module.named_parameters():
        dim = getattr(p, "tp_dim", None)
        if dim is not None:
            sd[name] = _all_gather_cat(p.detach(), dim, mesh.model_group, mesh.n_model)
    return sd


def grad_norm(params: list) -> torch.Tensor:
    """The global L2 norm of ``params``' gradients (``optax.global_norm``):
    a tensor-parallel slice's share summed over its model group."""
    sharded = [p.grad for p in params if getattr(p, "tp_dim", None) is not None]
    if not sharded:
        return torch.nn.utils.get_total_norm([p.grad for p in params])
    whole = [p.grad for p in params if getattr(p, "tp_dim", None) is None]
    sq = _all_reduce_sum(torch.nn.utils.get_total_norm(sharded) ** 2, _MESH.model_group)
    return (torch.nn.utils.get_total_norm(whole) ** 2 + sq).sqrt()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawned(fn, rank, world, port, device, backend, conn, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # the ranks are local: gloo connects them over the loopback device, not
    # over whatever address the host's name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if device.type == "cuda" and device.index is None:  # ranks share the cards
            device = torch.device("cuda", rank % torch.cuda.device_count())
        init_distributed(device, backend)
        conn.send((True, fn(*args)))
    except BaseException:
        conn.send((False, traceback.format_exc()))
    finally:
        destroy()
        conn.close()


def spawn(fn, world: int, *args, device=None, backend: str | None = None,
          timeout: float = 600.0) -> list:
    """``fn(*args)`` in ``world`` new processes (the ``spawn`` start method)
    joined into one process group on ``device`` (``cuda`` unless it names
    another; raises without a card, as ``resolve_device`` does). ``"cuda"``
    puts rank r on ``cuda:{r % device_count}``, so with more ranks than
    cards they share them and need ``backend="gloo"`` (NCCL refuses two ranks
    on one card); ``"cuda:0"`` puts every rank there; ``"cpu"`` is gloo on
    the CPU. Returns the ranks' return values in rank order (they must
    pickle: numbers, numpy arrays); raises with the traceback of a rank that
    failed. Every process is joined, or killed after ``timeout`` seconds, so
    nothing outlives the call."""
    device = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    # the spawn start method starts multiprocessing's resource tracker (a
    # process of its own) if it is not running yet; a tracker this call
    # started is stopped at its end, one that ran before is left alone
    tracker_was_running = resource_tracker._resource_tracker._fd is not None
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    procs = [ctx.Process(target=_spawned, args=(fn, r, world, port, device, backend,
                                                pipes[r][1], args))
             for r in range(world)]
    got, failures = {}, []
    try:
        for p, (_, send) in zip(procs, pipes):
            p.start()
            send.close()  # the child holds the only write end: its exit is EOF here
        waiting = {recv: r for r, (recv, _) in enumerate(pipes)}
        deadline = time.monotonic() + timeout
        while waiting and (left := deadline - time.monotonic()) > 0:
            for recv in mp_connection.wait(list(waiting), timeout=left):
                rank = waiting.pop(recv)
                try:
                    ok, value = recv.recv()
                except EOFError:
                    ok, value = False, "exited without a result"
                if ok:
                    got[rank] = value
                else:
                    failures.append(f"rank {rank}:\n{value}")
        if waiting:
            failures.append(f"no result from ranks {sorted(waiting.values())} in {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not failures else 5)
            if p.is_alive():
                p.kill()
                p.join()
        for recv, _ in pipes:
            recv.close()
        if not tracker_was_running:
            resource_tracker._resource_tracker._stop()
    if failures:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(failures))
    return [got[r] for r in range(world)]
