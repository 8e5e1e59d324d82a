"""Where the time goes in one rmi_tpu_torch build and search on a CUDA card.

    python3 tools/trace_torch_build.py [--n 200000000] [--trace build_trace.json]

Makes books-like keys on the card (as chip_smoke.py does), runs one
untraced build to warm up, then traces a warm ``cubic,linear 262144``
build and one search batch of 2^22 queries with torch.profiler.  Prints the device time of each
build stage (the rmi.build.* ranges of train/two_layer.py), the kernels
by device time, and the device's busy share of the traced wall time.
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

B = 262144
QUERIES = 1 << 22


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
    rmi = rmi_tpu_torch.train(data, "cubic,linear", B)   # warm-up
    rmi_tpu_torch.search(rmi, q)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        rmi = rmi_tpu_torch.train(data, "cubic,linear", B)
        torch.cuda.synchronize()
        build_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        with record_function("rmi.search"):
            rmi_tpu_torch.search(rmi, q)
        torch.cuda.synchronize()
        search_wall = time.perf_counter() - t0

    evts = prof.key_averages()
    print(f"n={args.n} B={B}: build wall {build_wall * 1e3:.3f} ms, "
          f"search wall {search_wall * 1e3:.3f} ms for {QUERIES} queries")
    # a range appears twice: its host span and its span on the device
    for key in sorted({e.key for e in evts if e.key.startswith("rmi.")}):
        same = [e for e in evts if e.key == key]
        print(f"  range {key:18s} host {max(e.cpu_time_total for e in same) / 1e3:9.3f} ms"
              f"  device {max(_dev_us(e) for e in same) / 1e3:9.3f} ms")
    kernels = [e for e in evts if _on_device(e) and not e.key.startswith("rmi.")]
    busy = sum(_dev_us(e, True) for e in kernels) / 1e3
    wall = (build_wall + search_wall) * 1e3
    print(f"device busy {busy:.3f} ms of {wall:.3f} ms traced wall "
          f"(idle share {1 - busy / wall:.3f})")
    for e in sorted(kernels, key=lambda e: -_dev_us(e, True))[:25]:
        print(f"  {_dev_us(e, True) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
