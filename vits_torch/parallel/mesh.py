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

Tensor parallelism (``make_mesh_2d``, ``tp_shard_generator``) is not ported.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import time
import traceback
from multiprocessing import connection as mp_connection, resource_tracker

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

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
    """Leave the process group (``init_distributed``'s counterpart)."""
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
    """The mean of ``t`` over the ranks, a new tensor (``t`` itself outside a
    process group). Sum, then divide: gloo has no average."""
    if not is_distributed():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / process_count()


def wrap(module: torch.nn.Module, device=None) -> DistributedDataParallel:
    """``module`` (already on ``device``) under DDP: its parameters and
    buffers are broadcast from rank 0 now, its gradients averaged over the
    ranks in every backward. Buffers are constants here (windows, filter
    banks), so they are not broadcast again before each forward."""
    dev = torch.device(device) if device is not None else next(module.parameters()).device
    return DistributedDataParallel(
        module,
        device_ids=[dev.index if dev.index is not None else torch.cuda.current_device()]
        if dev.type == "cuda" else None,
        broadcast_buffers=False,
    )


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
