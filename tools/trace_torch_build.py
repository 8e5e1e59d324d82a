"""Where the time goes in one rmi_tpu_torch build and search on a CUDA card.

    python3 tools/trace_torch_build.py [--n 200000000] [--spec cubic,linear]
                                       [--B 262144] [--trace build_trace.json]

Makes books-like keys on the card (as chip_smoke.py does), runs one
untraced build and search to warm up, then traces with torch.profiler a
warm build of ``--spec`` with ``--B`` leaves (chip_smoke.py's first path
by default; its others are ``--spec robust_linear,cubic``,
``--spec cubic,loglinear`` and ``--spec cubic,normal``, each with
``--B 65536``), and
apart from it SEARCH_BATCHES search batches of 2^22 random queries
(sort -> K5 -> unsort).  For each
trace it prints the device time of the rmi.* ranges (the build stages of
train/two_layer.py), the kernels by device time, the device's busy
share of the traced wall time, and any scatter operation it saw (the
build takes its per-leaf maxima inside kernels and should show none).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rmi_tpu_torch  # noqa: E402
from rmi_tpu_torch import config, data as rdata  # noqa: E402
from rmi_tpu_torch.keys import KeyType  # noqa: E402

QUERIES = 1 << 22
SEARCH_BATCHES = 5


def _dev_us(evt, self_only=False):
    name = "self_device_time_total" if self_only else "device_time_total"
    return getattr(evt, name, None) or getattr(
        evt, name.replace("device", "cuda"), 0.0)


def _on_device(evt):
    """A kernel or copy that ran on the card (not a host-side aten op)."""
    return getattr(evt.device_type, "name", str(evt.device_type)).endswith("CUDA")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--spec", default="cubic,linear")
    ap.add_argument("--B", type=int, default=262144)
    ap.add_argument("--trace", default=None, help="chrome trace output path")
    args = ap.parse_args()

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    keys = rdata.books_like_on_device(args.n, args.seed, dev)
    data = rdata.RMIDataset(keys, KeyType.U64)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    q = torch.randint(int(keys[0]), int(keys[-1]), (QUERIES,),
                      generator=gen, device=dev)
    rmi = rmi_tpu_torch.train(data, args.spec, args.B)   # warm-up
    rmi_tpu_torch.search(rmi, q)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        rmi = rmi_tpu_torch.train(data, args.spec, args.B)
        torch.cuda.synchronize()
        build_wall = time.perf_counter() - t0
    _report(prof, build_wall, f"n={args.n} {args.spec} B={args.B}: build", 25)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    rmi_tpu_torch.search(rmi, q)          # the plan is made on first use
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(SEARCH_BATCHES):
            with record_function("rmi.search"):
                rmi_tpu_torch.search(rmi, q)
        torch.cuda.synchronize()
        search_wall = time.perf_counter() - t0
    _report(prof, search_wall,
            f"search, {SEARCH_BATCHES} batches of {QUERIES} queries", 15)


def _report(prof, wall_s, label, top):
    evts = prof.key_averages()
    print(f"{label}: wall {wall_s * 1e3:.3f} ms")
    # a range appears twice: its host span and its span on the device
    for key in sorted({e.key for e in evts if e.key.startswith("rmi.")}):
        same = [e for e in evts if e.key == key]
        print(f"  range {key:18s} host {max(e.cpu_time_total for e in same) / 1e3:9.3f} ms"
              f"  device {max(_dev_us(e) for e in same) / 1e3:9.3f} ms")
    kernels = [e for e in evts if _on_device(e) and not e.key.startswith("rmi.")]
    busy = sum(_dev_us(e, True) for e in kernels) / 1e3
    wall = wall_s * 1e3
    print(f"  device busy {busy:.3f} ms of {wall:.3f} ms traced wall "
          f"(idle share {1 - busy / wall:.3f})")
    scatters = sorted({e.key for e in evts if "scatter" in e.key.lower()})
    print(f"  scatter operations traced: {scatters or 'none'}")
    for e in sorted(kernels, key=lambda e: -_dev_us(e, True))[:top]:
        print(f"  {_dev_us(e, True) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")


if __name__ == "__main__":
    main()
