"""Warm build times of chip_smoke.py's paths 1-5 and 8, many builds each,
for one checkout of rmi_tpu_torch on one CUDA card.

    python3 tools/time_torch_builds.py [--root DIR] [--n 200000000] [--reps 15]

Makes books-like keys on the card (as chip_smoke.py does; path 8's are
the same keys shifted right by 30, u32, chip_smoke.typed_keys, with path
8's B = 100), then for each path builds once to warm up and REPS times
more, each build timed by the
host clock around ``train`` and a synchronize.  Prints per path the
median, quartiles, least and most seconds, the kernel calls a build
makes through the binding (``_build.launches``) and the peak device
memory of its builds (``torch.cuda.max_memory_allocated``, the keys
included).  chip_smoke times one
warm build a path; this gives the spread that one build hides.

--root DIR imports rmi_tpu_torch from DIR, a checkout of another commit:
run both in one command, in turns, to compare them on one card.  Prints
the card's name and power limit first, then a line per path and one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (spec, B, key kind): chip_smoke.py's paths 1-5 and 8
PATHS = (("cubic,linear", 262144, "u64"), ("robust_linear,cubic", 65536, "u64"),
         ("cubic,loglinear", 65536, "u64"), ("cubic,normal", 65536, "u64"),
         ("radix18,linear", 65536, "u64"), ("linear,linear", 100, "u32"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--n", type=int, default=200_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import rmi_tpu_torch
    from rmi_tpu_torch import config, data as rdata
    from rmi_tpu_torch import keys as keymod
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.ops import _build

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    u = rdata.books_like_on_device(args.n, args.seed, dev)
    typed = {"u64": rdata.RMIDataset(u, KeyType.U64),
             "u32": rdata.RMIDataset((keymod.u64_bits(u) >> 30).add_(keymod.IMAGE_MIN),
                                     KeyType.U32)}
    out = {}
    for spec, B, kind in PATHS:
        data = typed[kind]
        rmi_tpu_torch.train(data, spec, B)          # warm-up, kernels built
        torch.cuda.synchronize()
        before = sum(_build.launches.values())
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            rmi_tpu_torch.train(data, spec, B)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        calls = (sum(_build.launches.values()) - before) / args.reps
        peak = torch.cuda.max_memory_allocated() / 2**30
        times.sort()
        q = [times[int(f * (len(times) - 1))] for f in (0.25, 0.5, 0.75)]
        out[f"{spec} {kind}"] = {"median_s": q[1], "quartiles_s": [q[0], q[2]], "least_s": times[0],
                     "most_s": times[-1], "binding_calls": calls, "peak_gib": peak}
        print(f"{spec} {B}: warm build median {q[1]:.4f} s (quartiles {q[0]:.4f}-{q[2]:.4f}, "
              f"{times[0]:.4f}-{times[-1]:.4f}, {args.reps} builds), {calls:g} kernel calls "
              f"through the binding a build, peak device memory {peak:.2f} GiB", flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "reps": args.reps, "paths": out}),
          flush=True)


if __name__ == "__main__":
    main()
