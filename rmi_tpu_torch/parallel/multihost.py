"""Process set-up for the data-parallel build and sharded serving
(counterpart of rmi_tpu/parallel/multihost.py).

One process per rank, each on its own card, joined by
``torch.distributed``:

    from rmi_tpu_torch.parallel import multihost, dp_trainer
    multihost.initialize()                 # torchrun's environment; False alone
    keys_local, n = dp_trainer.local_shard(data.keys, data.key_type)
    top, leaf, errs, metrics = dp_trainer.dp_train_two_layer(
        keys_local, n, data.key_type, "cubic", "linear", 262144)

    torchrun --nproc-per-node 4 script.py  # one rank a card, NCCL

``initialize`` is safe to call unconditionally: without explicit
arguments or torchrun's variables it starts nothing and returns False.
The backend is NCCL, each rank on ``cuda:LOCAL_RANK``; gloo is used only
when the caller names it, as the CPU tests do (``device="cpu"``) and as
ranks that share one card must (NCCL refuses two ranks on one card, and
so does ``initialize``, before it starts anything).  ``run_ranks`` starts
a world of ranks from one process, the way the tests and chip_smoke.py
do.

Meshes: ``global_mesh`` is the 1-D mesh over every rank and
``hybrid_mesh`` the 2-D (nodes, ranks per node) one, ranks per node from
``LOCAL_WORLD_SIZE``: shard keys over its "data" axis and independent
work over "config", so collectives stay inside a node.
"""

from __future__ import annotations

import os
import queue
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from rmi_tpu_torch import config
from rmi_tpu_torch.train.api import to_host


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def check_nccl(ranks_on_host: int, cards: int) -> None:
    """NCCL needs a card of its own for each rank: raise ValueError when
    ``ranks_on_host`` ranks would share ``cards`` cards."""
    if ranks_on_host > cards:
        raise ValueError(
            f"NCCL needs one CUDA card per rank: {ranks_on_host} ranks on this host, "
            f"{cards} cards; ask for backend='gloo' to let ranks share a card")


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: Optional[str] = None,
               device=None) -> bool:
    """Start this process's rank of a ``torch.distributed`` group; the
    counterpart of ``jax.distributed.initialize``.

    Returns True if a group is up (already, or now), False where no
    group is asked for.  The group comes from the explicit arguments
    (``coordinator`` an init_method URL such as ``tcp://host:port`` or
    ``file:///path``; a world of one is started too when asked for this
    way), else from torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` > 1, ``RANK``).  The rank runs on
    ``device``: by default the card ``cuda:LOCAL_RANK`` (an error without
    one), made the current device; the CPU only when asked for.
    ``backend`` is NCCL unless the caller names another, gloo for a rank
    on the CPU or ranks sharing a card."""
    if dist.is_initialized():
        return True
    explicit = coordinator is not None and num_processes is not None
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 0)
    rank = process_id if process_id is not None else _env_int("RANK", -1)
    if coordinator is None or rank < 0 or world < (1 if explicit else 2):
        return False
    local_rank = _env_int("LOCAL_RANK", rank)
    dev = torch.device(device) if device is not None else torch.device("cuda", local_rank)
    backend = backend or "nccl"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend needs each rank on a CUDA card")
        check_nccl(_env_int("LOCAL_WORLD_SIZE", world), torch.cuda.device_count())
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            config.require_cuda()
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=coordinator, world_size=world,
                            rank=rank, device_id=dev if backend == "nccl" else None)
    return True


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(axis: str = "data"):
    """1-D DeviceMesh over every rank of the default group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def hybrid_mesh(ici_axis: str = "data", dcn_axis: str = "config"):
    """2-D (nodes, ranks per node) DeviceMesh: node granularity on
    ``dcn_axis``, the ranks of a node (``LOCAL_WORLD_SIZE``, else all of
    them) on ``ici_axis``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    per_node = _env_int("LOCAL_WORLD_SIZE", world)
    if world % per_node:
        raise ValueError(f"{world} ranks do not split into nodes of {per_node}")
    return init_device_mesh(_mesh_device_type(), (world // per_node, per_node),
                            mesh_dim_names=(dcn_axis, ici_axis))


# how long run_ranks waits between looks at its ranks
_POLL_S = 1.0


def _rank_entry(rank, world, init_method, backend, device, fn, args, results):
    try:
        initialize(init_method, world, rank, backend=backend, device=device)
        try:
            out = to_host(fn(rank, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, init_method: str, *, backend: str, device, args=(),
              timeout: Optional[float] = None) -> list:
    """``fn(rank, *args)`` in each of ``world`` spawned processes, each one
    rank of a group started by ``initialize(init_method, world, rank,
    backend=backend, device=device)`` and destroyed after ``fn``; returns
    their results in rank order, every tensor in them a numpy array
    (train.api.to_host).  ``fn`` and ``args`` are pickled (``fn`` by its
    import path) and so is each result.  Raises RuntimeError with
    the rank's traceback when a rank fails, or when one exits without a
    result or the run outlasts ``timeout`` seconds; every process is
    stopped before it returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world, init_method, backend, device, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, failed = {}, []
    waited = 0.0
    try:
        while len(got) + len(failed) < world:
            try:
                rank, ok, out = results.get(timeout=_POLL_S)
            except queue.Empty:
                waited += _POLL_S
                gone = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if gone and results.empty():
                    raise RuntimeError(f"ranks {gone} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in gone]})")
                if timeout is not None and waited > timeout:
                    raise RuntimeError(f"ranks did not finish in {timeout} s")
                continue
            if ok:
                got[rank] = out
            else:
                failed.append(f"rank {rank}:\n{out}")
                break
        if failed:
            raise RuntimeError("a rank failed: " + "\n".join(failed))
    finally:
        for p in procs:
            p.join(timeout=10 if not failed else 0.1)
            if p.is_alive():
                p.terminate()
                p.join()
    return [got[r] for r in range(world)]
