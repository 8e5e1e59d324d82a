"""The build-phase timer (counterpart of rmi_tpu/utils/profiling.py).

``RMI_PROFILE_BUILD=1`` times the three stages of a build (assign, fit,
sweep; train/two_layer.py) on the host clock, each ending with a
synchronize of the keys' device so that its time covers the device's
work, logs them and keeps them in ``last_phase_times`` for tests and
tools.  Off by default: a normal build makes no synchronize for it.  The
``rmi.build.*`` ``record_function`` ranges name the same stages in a
``torch.profiler`` trace whether the timer is on or not.

The optimizer times its two phases with the same ``phase`` (always on:
a phase ends with its one fetch, so the timer adds no synchronize),
counting their builds; on the card each build's dispatch is bracketed by
CUDA events (``build_span``), read after that fetch into
``last_phase_builds``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional

import torch

log = logging.getLogger("rmi_tpu_torch.profile")

# phase -> seconds of the most recent profiled build stage or optimizer phase
last_phase_times: Dict[str, float] = {}
# optimizer phase -> {"builds": its builds, "device_ms": each build's
# device milliseconds, CUDA events around its dispatch (empty off the card)}
last_phase_builds: Dict[str, dict] = {}

# the event pairs of the open phase that counts builds, else None
_spans: Optional[List] = None


def requested() -> bool:
    """Whether RMI_PROFILE_BUILD asks for the phase times."""
    return os.environ.get("RMI_PROFILE_BUILD") == "1"


@contextlib.contextmanager
def phase(name: str, enabled: bool = True, device: Optional[torch.device] = None,
          builds: Optional[int] = None):
    """Time one phase when ``enabled``: host clock from entry until
    ``device`` (a CUDA device) has finished the phase's work.  ``builds``
    is the count of builds an optimizer phase dispatches: their spans on
    the card are kept in last_phase_builds[name]."""
    global _spans
    if not enabled:
        yield
        return
    saved = _spans
    if builds is not None:
        _spans = []
    spans = _spans
    t0 = time.perf_counter()
    try:
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        _spans = saved
    dt = time.perf_counter() - t0
    last_phase_times[name] = dt
    if builds is None:
        log.info("build phase %-8s: %8.1f ms", name, dt * 1e3)
        return
    for _, end in spans:
        end.synchronize()
    ms = [begin.elapsed_time(end) for begin, end in spans]
    last_phase_builds[name] = {"builds": builds, "device_ms": ms}
    spread = (f"device ms a build (CUDA events around each dispatch) median "
              f"{sorted(ms)[len(ms) // 2]:.3f}" if ms else "no device spans off the card")
    log.info("optimizer %s: %d builds in %.3f s, %.4f s a build; %s", name, builds, dt,
             dt / max(builds, 1), spread)


@contextlib.contextmanager
def build_span(device: torch.device):
    """Inside a phase that counts builds, CUDA events on ``device``'s
    current stream around one build's dispatch; nothing otherwise."""
    spans = _spans
    if spans is None or device.type != "cuda":
        yield
        return
    stream = torch.cuda.current_stream(device)
    begin = torch.cuda.Event(enable_timing=True)
    begin.record(stream)
    yield
    end = torch.cuda.Event(enable_timing=True)
    end.record(stream)
    spans.append((begin, end))
