"""Process groups and meshes on ``torch.distributed``.

Counterpart of ``small_gicp_tpu/parallel/multihost.py``. A mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` named ("data",) whose ranks
each drive one device: the card of their ``LOCAL_RANK`` over NCCL, or the
CPU over gloo. Every sharded function of ``parallel/`` (``align_batch``,
``align_point_sharded``, the map-block search, ``align_fleet_sharded``,
``BatchOdometry(mesh=)``) is SPMD as ``shard_map`` is: every rank calls it
with the same global inputs, works on its contiguous block and returns the
same global result, through ``all_reduce`` and ``all_gather`` only.

Usage, one process per card (NCCL):

    torchrun --nproc-per-node=N script.py
        from small_gicp_tpu_torch.parallel import multihost, sharding
        multihost.initialize()          # from torchrun's environment
        mesh = multihost.global_mesh("data")
        sharding.align_batch(targets, sources, init_Ts, mesh=mesh)

On the CPU, ``initialize(..., device="cpu")`` brings up gloo. Several ranks
may share one card over gloo, whose collectives take CUDA tensors through the
host (``local_device_ids=[0]``); NCCL refuses two ranks on one card.

Collectives per call: batch, fleet and odometry gather their results once;
the point-sharded LM iteration all-reduces 44 float64 sums (H, b, a zero,
the inlier count) and the K+1 trial errors; the map-block search two [Q]
``MIN`` reductions and one [Q,12] ``SUM``. NCCL collectives are ordered on
the stream and add no host read.

The JAX package's TPU pod markers (``_pod_environment``: auto-discovery
of the coordinator on a pod) have no counterpart: a process group is
brought up from torchrun's environment or from explicit arguments only.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from small_gicp_tpu_torch.point_cloud import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *, device=None,
               backend: Optional[str] = None) -> None:
    """Bring up ``torch.distributed`` for a multi-process run.

    Without arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``), and in a
    single process with none of it set it does nothing. Explicit arguments
    (``coordinator_address`` "host:port" or an init URL such as
    "file:///path", ``num_processes``, ``process_id``) take precedence, and a
    failure with them raises. ``device``: the card by default (NCCL, the
    card of ``local_device_ids[0]`` or ``LOCAL_RANK``), "cpu" for gloo;
    ``backend`` overrides the backend (gloo for ranks sharing one card).
    Calling it again once the group is up does nothing.
    """
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and "WORLD_SIZE" not in os.environ:
        return  # a single process: nothing to bring up
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("explicit initialization needs coordinator_address, "
                             "num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    else:
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        local = (local_device_ids[0] if local_device_ids
                 else int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)


def process_info() -> Tuple[int, int, int]:
    """(rank, world size, devices this process drives): (0, 1, 1) when no
    group is up. A rank drives one device, where a JAX process addresses all
    of its host's."""
    if not dist.is_initialized():
        return 0, 1, 1
    return dist.get_rank(), dist.get_world_size(), 1


def _require_group() -> int:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "multihost.initialize() (or pass mesh=None to run unsharded)")
    return dist.get_world_size()


def global_mesh(axis_name: str = "data", *, device=None) -> DeviceMesh:
    """1-D mesh over every rank of the group, on the card (or ``device``)."""
    world = _require_group()
    return DeviceMesh(resolve_device(device).type, list(range(world)),
                      mesh_dim_names=(axis_name,))


def global_mesh_2d(axis_names: Sequence[str] = ("host", "chip"), *,
                   device=None) -> DeviceMesh:
    """(host, local rank) mesh: the outer axis crosses hosts, the inner one
    stays within a host (torchrun's ``LOCAL_WORLD_SIZE`` ranks a host; one
    host when it is not set)."""
    world = _require_group()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    ranks = torch.arange(world).reshape(world // local, local)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=tuple(axis_names))


def mesh_group(mesh) -> Tuple[dist.ProcessGroup, int, int]:
    """(process group, this rank's index in it, its size) of a 1-D
    ``DeviceMesh`` or a process group."""
    if isinstance(mesh, DeviceMesh):
        if mesh.ndim != 1:
            raise ValueError(f"a 1-D mesh is needed, got {mesh.ndim} dimensions")
        return mesh.get_group(0), mesh.get_local_rank(0), mesh.size()
    if isinstance(mesh, dist.ProcessGroup):
        return mesh, dist.get_rank(mesh), dist.get_world_size(mesh)
    raise TypeError(f"mesh must be a 1-D DeviceMesh or a process group, got "
                    f"{type(mesh).__name__}")


def block(n: int, rank: int, size: int) -> slice:
    """This rank's contiguous block of ``n`` rows (a multiple of ``size``),
    as a ``PartitionSpec`` splits an axis."""
    rows = n // size
    return slice(rank * rows, (rank + 1) * rows)


def all_gather_rows(t: torch.Tensor, group: dist.ProcessGroup, size: int) -> torch.Tensor:
    """Every rank's equal block of rows, concatenated in rank order."""
    x = t.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_gather_fields(result, group: dist.ProcessGroup, size: int):
    """A dataclass of tensors with a leading block axis (a
    ``RegistrationResult``) gathered over the ranks in one all-gather: the
    fields travel as the columns of one float64 [rows, width] tensor, which
    holds float32, float64, int32 and bool values exactly."""
    fields = [getattr(result, f.name) for f in dataclasses.fields(result)]
    rows = fields[0].shape[0]
    flat = torch.cat([t.reshape(rows, -1).to(torch.float64) for t in fields], dim=1)
    full = all_gather_rows(flat, group, size)
    out, off = {}, 0
    for f, t in zip(dataclasses.fields(result), fields):
        width = t[0].numel()
        out[f.name] = full[:, off:off + width].reshape((-1,) + t.shape[1:]).to(t.dtype)
        off += width
    return dataclasses.replace(result, **out)


def run_ranks(argv_of: Callable[[int], List[str]], world: int, timeout: float,
              env: Optional[dict] = None) -> List[Tuple[int, str]]:
    """Run ``world`` processes on this host, ``argv_of(rank)`` each, and wait
    for all of them: [(exit code, output)] in rank order. Each writes to a
    file of its own (a rank blocked on a full pipe would stall the others in
    a collective). Past ``timeout`` seconds in all, every process still
    running is killed and its exit code is the kill's."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(argv_of(r), stdout=logs[r],
                                              stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            for p in procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]
