"""Process groups for data-parallel training (port of ``parallel/mesh.py``).

JAX runs one program over a 1-D ``data`` mesh of devices and lets XLA insert
the collectives.  The port runs one process a card (a rank), joined by
``torch.distributed``: NCCL on the card, gloo on the CPU (or, asked for,
gloo with CUDA tensors, which lets two ranks share one card).  A
:class:`Mesh` is one rank's view: its rank, the world size, its device
``cuda:{local_rank}`` and the backend.  :func:`make_mesh` sets up the
process group; :func:`destroy_mesh` tears it down.  The BatchNorm sites
read torch.distributed's own state (:func:`data_parallel`); the steps take
the mesh as an argument and refuse to run without it while a group of more
than one rank is up (:func:`check_step_mesh`), so the two never disagree.

The counterparts of JAX's shardings: :func:`data_sharding` takes a rank's
rows of a global batch (``P("data")``), :func:`replicated` broadcasts
tensors from rank 0 (``P()``).

What crosses ranks in a train step, and nothing else:
- :func:`global_sums`: the per-channel sums of a train-mode BatchNorm
  (Σx, Σx² and the element count, one all-reduce a layer, its backward one
  all-reduce of the cotangents), so that every rank normalises with the
  statistics of the global batch, as JAX's single program does.  At world
  size 1 it launches nothing;
- :func:`mean_over_ranks`: the gradients and the losses after the
  backward, one all-reduce, the counterpart of XLA's ``psum``.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """One rank of the data-parallel group."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and scalars."""
        return self.rank == 0


def free_port() -> int:
    """A TCP port on localhost that is free now, for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world: int, *args, deadline: Optional[float] = None) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes of this host, rendezvous at a free localhost port, and wait
    for all.  A rank that raises ends the others and raises here; past
    ``deadline`` seconds every rank is killed and TimeoutError raised."""
    import time

    import torch.multiprocessing as mp

    init = f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(fn, args=(world, init, *args), nprocs=world, join=False,
                             start_method="spawn")
    end = None if deadline is None else time.monotonic() + deadline
    while not ctx.join(timeout=None if end is None else max(end - time.monotonic(), 0.1)):
        if end is not None and time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish within {deadline} s")


def make_mesh(rank: int, world: int, init_method: str, device="cuda",
              backend: Optional[str] = None, local_rank: Optional[int] = None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Join the process group as ``rank`` of ``world``.  ``init_method``: the rendezvous, ``tcp://localhost:<port>``.
    ``device`` "cuda" is the rank's card ``cuda:{local_rank}`` (``local_rank``
    defaults to ``rank``: one host), an indexed card is taken as it is, and
    "cpu" runs on the CPU.  ``backend`` defaults to NCCL on the card and
    gloo on the CPU.  A rank that finds no card raises."""
    if dist.is_initialized():
        raise RuntimeError("a process group is set up already: destroy_mesh() first")
    dev = resolve_device(device, rank if local_rank is None else local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return Mesh(rank, world, dev, backend)


def destroy_mesh() -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def data_parallel() -> bool:
    """A process group of more than one rank is set up: a train-mode
    BatchNorm's statistics cross ranks."""
    return dist.is_initialized() and dist.get_world_size() > 1


def check_step_mesh(mesh: Optional[Mesh]) -> None:
    """Raise where a step is called without its mesh inside a group of more
    than one rank: its BatchNorms would cross ranks, its gradients would
    not."""
    if mesh is None and data_parallel():
        raise RuntimeError("a process group of more than one rank is set up: give the step "
                           "its mesh (parallel/train_parallel.py::make_parallel_steps)")


def data_sharding(mesh: Optional[Mesh], batch: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a global batch: rows ``[rank * n, (rank + 1) * n)``
    with ``n = len(batch) // world`` (JAX ``P("data")``)."""
    if mesh is None:
        return batch
    n = batch.shape[0] // mesh.world
    return batch[mesh.rank * n:(mesh.rank + 1) * n]


def _collective_by_dtype(tensors, run, device=None, extras=()) -> list:
    """Group ``tensors`` by dtype; for each group concatenate them (through
    ``device`` where given), ``extras`` (scalars) riding after the first
    group, ``run`` the collective on the flat buffer in place and copy each
    slice back, in place.  Returns the extras after the collective, each in
    its own dtype."""
    tensors, extras = list(tensors), list(extras)
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    if not groups and extras:
        groups[extras[0].dtype] = []
    out = []
    with torch.no_grad():
        for i, (dtype, ts) in enumerate(groups.items()):
            rides = extras if i == 0 else []
            flat = torch.cat([t.reshape(-1).to(device or t.device) for t in ts]
                             + [e.detach().reshape(1).to(dtype) for e in rides])
            run(flat)
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            out += [flat[offset + j].to(e.dtype) for j, e in enumerate(rides)]
    return out


def replicated(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Give every rank rank 0's values of ``tensors``, in place (JAX
    ``P()``): one broadcast a dtype.  Tensors off the mesh's device (Adam's
    step counts lie on the CPU) travel through it."""
    _collective_by_dtype(tensors, lambda flat: dist.broadcast(flat, 0), mesh.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its backward sums the cotangents over ranks (every
    rank's loss reads the global sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def global_sums(s1: torch.Tensor, s2: torch.Tensor, count: int):
    """(Σx, Σx², n) of a train-mode BatchNorm over every rank's rows: one
    all-reduce of ``[s1, s2, count]`` in the sums' dtype (float32 or
    wider), differentiable.  Without a mesh, or at world size 1, the
    arguments come back as they are and nothing is launched."""
    if not data_parallel():
        return s1, s2, count
    c = s1.shape[0]
    buf = torch.cat([s1, s2, s1.new_full((1,), count)])
    buf = _AllReduceSum.apply(buf)
    return buf[:c], buf[c:2 * c], buf[2 * c]


def mean_over_ranks(mesh: Mesh, tensors, extras=()):
    """Replace each of ``tensors`` by its mean over ranks, in place, and
    return the means of the scalars ``extras``: one all-reduce (a sum, then
    a division by the world size) a dtype, the extras riding with the
    first.  Every rank gets the same bits."""
    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(mesh.world)

    return _collective_by_dtype(tensors, mean, extras=extras)
