"""The Pareto optimizer behind ``--optimize`` and ``--max-size``
(counterpart of rmi_tpu/optimizer.py; the reference's optimizer.rs).

A two-phase grid search over (top model, leaf model, branching factor):
phase 1 measures every model pair at every 5th branching factor of the
profile; phase 2 measures the rest of the branching factors for the
pairs on phase 1's Pareto front.  Dominance is on (size,
average log2 error) with the reference's exact tie rules
(optimizer.rs:173-187); ``narrow_front`` keeps ``desired_size``
configurations by dropping, again and again, the less accurate of the
two closest in size (optimizer.rs:74-108).  The profile comes from
RMI_OPTIMIZER_PROFILE: unset, ``fast``, ``memory`` or ``disk``
(optimizer.rs:15-57).

Every grid point is one ``train`` on the card.  A phase dispatches all
its builds (``train_async``) round-robin over the device pool
(parallel/sweep.py: every CUDA card, the keys copied once to each, one
FixDups and one normalization per device) before one transfer brings
every build's metrics to the host; a configuration's size is
``serialize.predicted_rmi_size``, which equals the build's ``rmi_size``
for every model of the grid.

Not ported, because each works around the TPU: rmi_tpu's compile-once
B-generic grid (``bucket_for``, ``grid_measure_rmis``,
``RMI_OPT_BUCKETED``: torch compiles nothing per branching factor), its
compile-thread pool (``RMI_OPT_COMPILE_THREADS``), and its 16 GB HBM
guard with the host-RAM fallback (``RMI_GRID_HBM_GB``,
``host_measure.py``: the disk profile's 2^27 leaves at 200M keys fit the
card's 80 GB).  Their effect stays: every grid point is measured, and
the front is the per-build front.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional, Sequence, Tuple

from rmi_tpu_torch.parallel import sweep
from rmi_tpu_torch.serialize import predicted_rmi_size
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import profiling


def _profile() -> Optional[str]:
    p = os.environ.get("RMI_OPTIMIZER_PROFILE")
    if p is not None and p not in ("fast", "memory", "disk"):
        raise ValueError(f"Invalid optimizer profile {p}")
    return p


def top_only_layers() -> List[str]:
    return {
        None: ["radix", "radix18", "radix22", "robust_linear"],
        "fast": ["robust_linear"],
        "memory": ["radix", "radix18", "radix22", "robust_linear"],
        "disk": ["radix", "radix18", "radix22", "robust_linear",
                 "normal", "lognormal", "loglinear"],
    }[_profile()]


def anywhere_layers() -> List[str]:
    return {
        None: ["linear", "cubic", "linear_spline"],
        "fast": ["linear", "cubic"],
        "memory": ["linear", "cubic", "linear_spline"],
        "disk": ["linear", "cubic", "linear_spline"],
    }[_profile()]


def branching_factors() -> List[int]:
    rng = {
        None: range(6, 25, 1),
        "fast": range(6, 25, 2),
        "memory": range(6, 25, 1),
        "disk": range(6, 28, 1),
    }[_profile()]
    return [2 ** i for i in rng]


@dataclasses.dataclass(frozen=True)
class RMIStatistics:
    """One measured configuration (optimizer.rs:153-160)."""
    models: str
    branching_factor: int
    average_log2_error: float
    max_log2_error: float
    size: int

    def dominated_by(self, other: "RMIStatistics") -> bool:
        # optimizer.rs:173-187
        if self.size < other.size:
            return False
        if self.average_log2_error < other.average_log2_error:
            return False
        if (self.size == other.size
                and self.average_log2_error <= other.average_log2_error):
            return False
        log2_diff = abs(self.average_log2_error - other.average_log2_error)
        if self.size <= other.size and log2_diff < sys.float_info.epsilon:
            return False
        return True

    def to_grid_spec(self, namespace: str) -> dict:
        # optimizer.rs:208-217
        return {
            "layers": self.models,
            "branching factor": self.branching_factor,
            "namespace": namespace,
            "size": self.size,
            "average log2 error": self.average_log2_error,
            "binary": True,
        }


def pareto_front(results: Sequence[RMIStatistics]) -> List[RMIStatistics]:
    return [r for r in results
            if not any(r.dominated_by(v) for v in results)]


def narrow_front(results: Sequence[RMIStatistics],
                 desired_size: int) -> List[RMIStatistics]:
    assert desired_size >= 2
    if len(results) <= desired_size:
        return list(results)
    tmp = sorted(results, key=lambda r: r.size)
    best = tmp.pop(0)
    while len(tmp) > desired_size - 1:
        gaps = [(i, i + 1, tmp[i + 1].size / tmp[i].size)
                for i in range(len(tmp) - 1)]
        i1, i2, _ = min(gaps, key=lambda g: g[2])
        if tmp[i1].average_log2_error > tmp[i2].average_log2_error:
            tmp.pop(i1)
        else:
            tmp.pop(i2)
    tmp.insert(0, best)
    return tmp


def first_phase_configs() -> List[Tuple[str, int]]:
    # optimizer.rs:110-125: every 5th branching factor
    out = []
    tops = top_only_layers() + anywhere_layers()
    for top in tops:
        for bottom in anywhere_layers():
            for bf in branching_factors()[::5]:
                out.append((f"{top},{bottom}", bf))
    return out


def second_phase_configs(first_phase: Sequence[RMIStatistics]
                         ) -> List[Tuple[str, int]]:
    qualifying = sorted({r.models for r in pareto_front(first_phase)})
    out = []
    for models in qualifying:
        for bf in branching_factors():
            if any(r.models == models and r.branching_factor == bf
                   for r in first_phase):
                continue
            out.append((models, bf))
    return out


def statistics(configs: Sequence[Tuple[str, int]], fetched,
               progress=None) -> List[RMIStatistics]:
    """RMIStatistics of each configuration from the host copy of its
    build's error_metrics, in order, each passed to ``progress``."""
    out = []
    for (models, bf), vals in zip(configs, fetched):
        m = two_layer.metrics_dict(vals)
        out.append(RMIStatistics(
            models=models, branching_factor=int(bf),
            average_log2_error=m["model_avg_log2_error"],
            max_log2_error=m["model_max_log2_error"],
            size=predicted_rmi_size(models, bf)))
        if progress is not None:
            progress(out[-1])
    return out


def measure_pool(pool, configs: Sequence[Tuple[str, int]],
                 progress=None) -> List[RMIStatistics]:
    """Build and measure each configuration on ``pool`` (parallel/sweep.py's
    device_pool): every build in flight before the one transfer of their
    metrics."""
    return statistics(configs, sweep.parallel_measure_rmis(pool, configs), progress)


def measure_rmis(data, configs: Sequence[Tuple[str, int]],
                 progress=None) -> List[RMIStatistics]:
    """Build and measure each configuration (optimizer.rs:220-231) on the
    device pool of ``data``: every CUDA card, or the keys' own device."""
    return measure_pool(sweep.device_pool(data), configs, progress)


def find_pareto_efficient_configs(data, restrict: int = 10, progress=None,
                                  reuse_phase1: bool = False
                                  ) -> List[RMIStatistics]:
    """The two-phase sweep (optimizer.rs:233-249), its front sorted by
    average log2 error.

    ``reuse_phase1=False`` is the reference: the front is made from phase
    2's measurements only, so a qualifying pair's phase-1 points (which
    second_phase_configs skips, optimizer.rs:141-143) never reach it.
    ``reuse_phase1=True`` adds them to the pool: the same builds, never a
    worse front.  The keys' copies and their shared inputs are made once
    for both phases.  Each phase is timed (utils/profiling.py: ``phase1``
    and ``phase2`` in last_phase_times and last_phase_builds, and logged).
    """
    pool = sweep.device_pool(data)
    configs = first_phase_configs()
    with profiling.phase("phase1", builds=len(configs)):
        phase1 = measure_pool(pool, configs, progress)
    configs = second_phase_configs(phase1)
    with profiling.phase("phase2", builds=len(configs)):
        phase2 = measure_pool(pool, configs, progress)
    del pool
    found = list(phase2)
    if reuse_phase1:
        qualifying = {r.models for r in pareto_front(phase1)}
        found.extend(r for r in phase1 if r.models in qualifying)
    front = narrow_front(pareto_front(found), restrict)
    front.sort(key=lambda r: r.average_log2_error)
    return front


def display_table(items: Sequence[RMIStatistics]) -> str:
    """The optimizer's result table (optimizer.rs:193-206)."""
    lines = [f"{'Models':<28} {'Branch':>10} {'AvgLg2':>12} "
             f"{'MaxLg2':>12} {'Size (b)':>14}"]
    for it in items:
        lines.append(
            f"{it.models:<28} {it.branching_factor:>10} "
            f"{it.average_log2_error:>12.5f} {it.max_log2_error:>12.5f} "
            f"{it.size:>14}")
    return "\n".join(lines)
