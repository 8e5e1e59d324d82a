"""Sharded serving: query batches split over ranks or devices, the index
replicated (counterpart of rmi_tpu/parallel/serve.py).

An index (its keys, leaf rows, errors and top) is small enough to hold
whole on every card, so serving shards the QUERIES and answers every
shard with the single-device ``search`` on its own card, with no
collective on the way:

  * across the ranks of a torch.distributed group: ``replicate_rmi``
    broadcasts rank 0's index to every rank, ``shard_queries`` gives each
    rank its slice of a batch, each rank calls ``search`` on it, and
    ``unshard`` all_gathers the answers back into the batch;
  * across the devices of one process: ``replicate_rmi_per_device``
    copies the index to each device and ``search_sharded`` dispatches
    every device's slice before it fetches any answer.

Serving state (plans, lookup tables) is built per copy on first use, so
each copy serves on its own card: a slice past search's density gate
(lookup.search_route) through its own sort and K5, a smaller one through
its own plan.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from rmi_tpu_torch import config
from rmi_tpu_torch.lookup import search
from rmi_tpu_torch.models.base import params_to
from rmi_tpu_torch.parallel import multihost
from rmi_tpu_torch.train.api import TrainedRMI

QUERY_AXIS = "q"
# the serving tensors a replica receives; the rest of a TrainedRMI is
# host data, sent pickled
SERVING = ("keys", "leaf_errors", "device_top_params", "device_leaf_params")
_HOST_ONLY = ("raw_inputs", "host_cache")


def serving_mesh():
    """The 1-D DeviceMesh over every rank, its axis named "q"."""
    return multihost.global_mesh(QUERY_AXIS)


def _spec(v):
    if v is None:
        return None
    if isinstance(v, dict):
        return {k: _spec(x) for k, x in v.items()}
    return (tuple(v.shape), v.dtype)


def _broadcast(v, spec, src, group, device):
    """``v`` (on ``src``) or a tensor of ``spec`` filled from it (elsewhere)."""
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {k: _broadcast(None if v is None else v[k], s, src, group, device)
                for k, s in spec.items()}
    t = v.contiguous() if v is not None else torch.empty(spec[0], dtype=spec[1],
                                                         device=device)
    dist.broadcast(t, src=src, group=group)
    return t


def replicate_rmi(rmi: Optional[TrainedRMI], group=None, device=None) -> TrainedRMI:
    """The index of ``group``'s rank 0 on every rank of ``group``, called
    on every rank (``rmi`` is read on rank 0 only; the others may pass
    None): its serving tensors broadcast onto this rank's ``device`` (the
    current card when None; rank 0 keeps its own), the rest of it
    pickled.  Serving caches are rebuilt per copy; the raw-parameter
    inputs stay with rank 0's index."""
    root = dist.get_rank(group) == 0
    src = dist.get_global_rank(group, 0) if group is not None else 0
    if root:
        device = rmi.keys.device
        meta = {f.name: getattr(rmi, f.name) for f in dataclasses.fields(rmi)
                if f.init and f.name not in SERVING + _HOST_ONLY}
        obj = [meta, {name: _spec(getattr(rmi, name)) for name in SERVING}]
    else:
        device = config.require_cuda() if device is None else torch.device(device)
        obj = [None, None]
    dist.broadcast_object_list(obj, src=src, group=group)
    meta, specs = obj
    tensors = {name: _broadcast(getattr(rmi, name) if root else None, spec, src,
                                group, device) for name, spec in specs.items()}
    return TrainedRMI(**meta, **tensors)


def shard_queries(queries: torch.Tensor, group=None):
    """(this rank's slice of ``queries``, m): the batch padded with its
    last query to a multiple of the world size, cut into one slice a rank
    in rank order; m = len(queries), for ``unshard``."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    m = queries.shape[0]
    per = -(-m // world)
    part = queries[min(rank * per, m):min((rank + 1) * per, m)]
    pad = per - part.shape[0]
    if pad:
        part = torch.cat([part, queries[-1:].expand(pad)])
    return part, m


def unshard(part: torch.Tensor, m: int, group=None) -> torch.Tensor:
    """The answers to the whole batch, on every rank: each rank's answers
    to its slice (shard_queries) all_gathered, the padding dropped."""
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, part.contiguous(), group=group)
    return torch.cat(parts)[:m]


def replicate_rmi_per_device(rmi: TrainedRMI, devices: Optional[Sequence] = None
                             ) -> List[TrainedRMI]:
    """One copy of the index per device of ``devices`` (every card when
    None and the index is on a card; its own device otherwise), each
    serving on its own device with its own caches."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if rmi.keys.is_cuda else [rmi.keys.device])
    out = []
    for d in map(torch.device, devices):
        out.append(dataclasses.replace(
            rmi, keys=rmi.keys.to(d), leaf_errors=rmi.leaf_errors.to(d),
            device_top_params=params_to(rmi.device_top_params, d),
            device_leaf_params=params_to(rmi.device_leaf_params, d)))
    return out


def search_sharded(rmis: Sequence[TrainedRMI], queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of ``queries`` over per-device copies
    (replicate_rmi_per_device): the batch cut into one slice a copy, every
    slice's ``search`` dispatched before any answer is fetched, the
    answers joined on the first copy's device."""
    nd = len(rmis)
    m = queries.shape[0]
    per = -(-m // nd)
    pad = per * nd - m
    if pad:
        queries = torch.cat([queries, queries[-1:].expand(pad)])
    parts = [search(r, queries[i * per:(i + 1) * per].to(r.keys.device))
             for i, r in enumerate(rmis)]
    home = rmis[0].keys.device
    return torch.cat([p.to(home) for p in parts])[:m]
