"""Host cost of a kernel launch, and the nine card probes' times, for one
checkout of rmi_tpu_torch on one CUDA card.

    python3 tools/time_torch_launch.py [--root DIR] [--calls 10000]

1. Host microseconds per call: time.perf_counter around CALLS calls,
   with no synchronization between them, of probe A's wrapper
   (probe_kernels.scale2 on its [8, 128] f32 tile), of its C entry
   through _build.launch alone (the output made once), and of torch.mul,
   one PyTorch call of the same function.
2. Each probe on its probe's inputs (D at widths 128 and 2048, one
   block) and its library call where one exists (as chip_smoke.py
   chooses them): ms per call with CUDA events, for a call under 0.1 ms
   the median of 5 runs of at least 5 ms of calls, with the runs' spread
   (at these sizes what the host takes to launch a call); and the device
   time per call, the kernels' own, from a torch.profiler trace of
   DEVICE_CALLS calls.

--root DIR imports rmi_tpu_torch from DIR, a checkout of another commit:
run both in one command, in turns, to compare them on one card.  Prints
the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CALLS = 200


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def row_ms(fn, iters=20):
    """[median, least, most] ms per call over 5 runs of at least 5 ms of
    calls, or one run of ``iters`` calls for a call of 0.1 ms or more."""
    ms = cuda_ms(fn, iters)
    if ms >= 0.1:
        return [ms, ms, ms]
    reps = max(iters, math.ceil(5.0 / max(ms, 1e-4)))
    runs = sorted(cuda_ms(fn, reps) for _ in range(5))
    return [runs[2], runs[0], runs[-1]]


def device_us(fn, calls=DEVICE_CALLS):
    """Device microseconds per call of ``fn``: the CUDA kernels' time in
    a profiler trace of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA"):
            total += (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0.0))
    return total / calls


def host_us(fn, calls):
    """Host microseconds per call of ``fn``, unsynchronized, after a
    warm-up of 100 calls; the card is drained before and after."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--calls", type=int, default=10_000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from rmi_tpu_torch import config
    from rmi_tpu_torch.ops import _build, probe_kernels as pk

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    _build.library()
    probe_a = next(p for p in pk.PROBES if p.key == "A")
    (x,) = pk.probe_inputs(probe_a, dev)
    out = torch.empty_like(x)
    host = {"wrapper": host_us(lambda: pk.scale2(x), args.calls),
            "launch": host_us(lambda: _build.launch("rmi_probe_scale2", x, out, x.numel()),
                              args.calls),
            "torch.mul": host_us(lambda: torch.mul(x, 2.0), args.calls)}

    probes = {}
    for probe in pk.PROBES:
        for width in ((128, 2048) if probe.inputs is None else (None,)):
            a = pk.probe_inputs(probe, dev, width=width or 128)
            idx = [t.long() for t in a if t.dtype == torch.int32]
            lib = {"A": lambda: torch.mul(a[0], 2.0),
                   "B1": lambda: torch.lt(a[0], a[1]),
                   "C1": lambda: torch.index_select(a[0], 0, idx[0]),
                   "C2": lambda: torch.take(a[0], idx[0]),
                   "C3": lambda: torch.gather(a[0], 1, idx[0]),
                   "E": lambda: torch.index_select(a[1], 0, idx[0])}.get(probe.key)
            if not torch.equal(probe.wrapper(*a), probe.plain(*a)):
                raise RuntimeError(f"probe {probe.key}: kernel disagrees with its plain version")
            key = probe.key + (f" width {width}" if width else "")
            probes[key] = {"entry": probe.entry,
                           "ms": row_ms(lambda: probe.wrapper(*a)),
                           "library_ms": None if lib is None else row_ms(lib),
                           "device_us": device_us(lambda: probe.wrapper(*a)),
                           "library_device_us": None if lib is None else device_us(lib)}
    print(json.dumps({"root": os.path.abspath(args.root), "calls": args.calls,
                      "device": torch.cuda.get_device_name(0), "host_us": host,
                      "probes": probes}), flush=True)


if __name__ == "__main__":
    main()
