"""Configurations spread over a pool of devices (counterpart of
rmi_tpu/parallel/sweep.py).

The reference fans RMI configurations across rayon threads
(optimizer.rs:220-231, main.rs:241-248); here each configuration is one
build on one device of the pool.  The keys are copied once to each
device, with their shared inputs (two_layer.shared_inputs: FixDups and
the normalization); configurations go out round-robin, every build is
dispatched (``train_async``) before the host waits, and one
``fetch_host`` brings every build's metrics back, in configuration
order.  With one device this is dispatch-all-then-fetch on it.  The
optimizer (optimizer.py) turns the metrics into its statistics.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rmi_tpu_torch.data import RMIDataset
from rmi_tpu_torch.train import api, two_layer


def default_devices(data: RMIDataset) -> List[torch.device]:
    """Every CUDA card for keys on a card; the keys' own device otherwise
    (keys on the CPU are the caller asking for the CPU)."""
    if data.keys.device.type != "cuda":
        return [data.keys.device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_pool(data: RMIDataset, devices: Optional[Sequence] = None
                ) -> List[Tuple[RMIDataset, dict]]:
    """``data`` on each device of ``devices`` (default_devices when None),
    each with its shared inputs: a sweep's builds read these and make no
    copy of their own."""
    pool = []
    for d in (default_devices(data) if devices is None else devices):
        keys = data.keys.to(torch.device(d))
        pool.append((RMIDataset(keys=keys, key_type=data.key_type,
                                source_path=data.source_path),
                     two_layer.shared_inputs(keys, data.key_type)))
    return pool


def _dispatch(configs, pool):
    """A PendingRMI per configuration, dispatched round-robin over the
    pool as the caller takes it."""
    for i, (models, bf) in enumerate(configs):
        ds, shared = pool[i % len(pool)]
        yield api.train_async(ds, models, bf, shared=shared)


def parallel_train_grid(data: RMIDataset, configs: Sequence[Tuple[str, int]],
                        devices: Optional[Sequence] = None, progress=None):
    """A TrainedRMI per (models, branching_factor), every build in flight
    before the one fetch of their metrics (main.rs:241-248's par_iter over
    --param-grid); each index lies on the device that built it."""
    pending = list(_dispatch(configs, device_pool(data, devices)))
    fetched = api.fetch_host([p.metrics for p in pending])
    out = []
    for p, vals in zip(pending, fetched):
        out.append(p.result(prefetched=vals))
        if progress is not None:
            progress(out[-1])
    return out


def parallel_measure_rmis(pool: List[Tuple[RMIDataset, dict]],
                          configs: Sequence[Tuple[str, int]]) -> list:
    """measure_rmis (optimizer.rs:220-231) over ``pool`` (device_pool):
    each configuration's error_metrics, host copies of the [6] values in
    two_layer.METRIC_NAMES' order, in configuration order.  Only each
    build's metrics are kept: its parameters go as soon as its work is
    queued."""
    return api.fetch_host([p.metrics for p in _dispatch(configs, pool)])
