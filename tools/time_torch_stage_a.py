"""Stage A's kernels (csrc/top.cu, csrc/top_fit.cu) on one CUDA card, on
the paths' inputs at 200M keys, beside their bounds and their plain
versions.

    python3 tools/time_torch_stage_a.py [--root DIR] [--n 200000000] [--reps 5]
                                        [--split] [--only NAME,...]

Makes books-like keys on the card (as chip_smoke.py does), stage A's
inputs as the build makes them (the normalized keys, FixDups, the cubic
top's candidates of ``cubic,linear 262144`` and its fitted row), then
times with CUDA events rmi_key_normalize, rmi_top_cubic_candidates,
rmi_top_l1_cubic, rmi_top_moments (the robust_linear top of path 2, the
linear top of path 8 and a normal top, each at B = 65536),
rmi_top_table_fit (path 5's radix18 top, and the zoo's radix22 top) and
rmi_top_assign (cubic top) and their plain versions (the eager torch
they replaced): each the median of --reps runs of 10 calls, with the
runs' spread.  The bound is the bytes a call must move at 3.35 TB/s
(chip_smoke.py's HBM_BYTES_PER_S), each input read once: 16, 12 and 12
bytes a key for the normalization, the L1 sums and the assignment, 12
(linear tops) and 8 (normal) for the moments, whose two passes read them
twice; the candidates' 2 (log2 n + 1) + 10 sectors of 32 bytes and the
table fit's two sectors a slot.

--split traces one more call of each entry with torch.profiler and
prints the device kernels it launched, by name, with their device ms:
the parts of an entry that launches more than one kernel.  --only times
the named entries alone (the names as printed, e.g. ``rmi_top_moments
linear``).  --root DIR imports rmi_tpu_torch from DIR, a checkout of
another commit: run both in one command, in turns, to compare them on
one card.  Prints the card's name and power limit first, then ptxas's
registers, shared memory and spills of csrc/top_fit.cu's kernels from
the build log, a line per entry and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
B = 262144
CALLS = 10


def _ms(fn, reps):
    """(median, least, most) ms a call over reps runs of CALLS calls."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(CALLS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / CALLS)
    runs.sort()
    return runs[len(runs) // 2], runs[0], runs[-1]


def _split(fn):
    """{device kernel name: device ms} of one call of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
            out[e.key[:90]] = out.get(e.key[:90], 0.0) + us / 1e3
    return out


def _ptxas(log, source="top_fit_cu"):
    """ptxas's lines for the kernels of ``source`` in the build log."""
    lines, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif source in entry and ("registers" in line or "spill" in line):
            lines.append(f"ptxas {entry[:90]}: " + line.split("ptxas info    :")[-1].strip())
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--n", type=int, default=200_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--split", action="store_true", help="each entry's kernels by name")
    ap.add_argument("--only", default="", help="comma-separated entry names to time")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from rmi_tpu_torch import config, data as rdata
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.models.base import model_float_input
    from rmi_tpu_torch.ops import _build, top_kernel
    from rmi_tpu_torch.train import two_layer

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    print(f"rmi_tpu_torch from {os.path.abspath(args.root)}", flush=True)
    _build.library()
    for line in _ptxas(_build.build_info.get("log", "")):
        print(line, flush=True)
    keys = rdata.books_like_on_device(args.n, args.seed, dev)
    n = keys.shape[0]
    kminf, s = two_layer.norm_constants(keys)
    x = model_float_input(get_model("cubic"), keys, kminf, s)
    yfix = two_layer.fixdups_i32(keys)
    sf = B / n
    ep = (two_layer._scale(0.0, sf), two_layer._scale(float(n - 1), sf))
    cand = top_kernel.top_cubic_candidates_plain(x, yfix, sf, ep, keys)
    top_w, _, _ = two_layer._assign_body(x, yfix, top_type="cubic", B=B, keys=keys)
    sf_paths = 65536 / n
    sectors = 2 * (math.ceil(math.log2(n + 1)) + 1) + 10
    calls = {
        "rmi_key_normalize": (16 * n, lambda: top_kernel.key_normalize(keys, kminf, s),
                              lambda: top_kernel.key_normalize_plain(keys, kminf, s)),
        "rmi_top_cubic_candidates": (
            32 * sectors, lambda: top_kernel.top_cubic_candidates(x, yfix, sf, ep, keys),
            lambda: top_kernel.top_cubic_candidates_plain(x, yfix, sf, ep, keys)),
        "rmi_top_l1_cubic": (12 * n, lambda: top_kernel.top_l1_cubic(x, yfix, sf, cand),
                             lambda: top_kernel.top_l1_cubic_plain(x, yfix, sf, cand)),
        **{f"rmi_top_moments {top}": (
            per_key * n, lambda top=top: top_kernel.top_moments(top, x, yfix, sf_paths),
            lambda top=top: top_kernel.top_moments_plain(top, x, yfix, sf_paths))
           for top, per_key in (("robust_linear", 12), ("linear", 12), ("normal", 8))},
        **{f"rmi_top_table_fit radix{bits}": (
            (64 + 4) << bits, lambda bits=bits: top_kernel.top_table_fit(keys, yfix, sf_paths,
                                                                         bits),
            lambda bits=bits: top_kernel.top_table_fit_plain(keys, yfix, sf_paths, bits))
           for bits in (18, 22)},
        "rmi_top_assign": (12 * n, lambda: top_kernel.top_assign("cubic", top_w, x, B),
                           lambda: top_kernel.top_assign_plain("cubic", top_w, x, B)),
    }
    only = [name for name in args.only.split(",") if name]
    out = {}
    for entry, (nbytes, kernel, plain) in calls.items():
        if only and entry not in only:
            continue
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        k, p = _ms(kernel, args.reps), _ms(plain, max(1, args.reps // 2))
        out[entry] = {"ms": k[0], "spread": [k[1], k[2]], "plain_ms": p[0], "bound_ms": bound,
                      "share": bound / k[0]}
        print(f"{entry} at {n} keys: {k[0]:.4f} ms ({k[1]:.4f}-{k[2]:.4f}), bound {bound:.4f} "
              f"ms, share {bound / k[0]:.3f}; plain {p[0]:.4f} ms", flush=True)
        if args.split:
            out[entry]["kernels_ms"] = _split(kernel)
            for name, ms in out[entry]["kernels_ms"].items():
                print(f"    {ms:.4f} ms  {name}", flush=True)
    print(json.dumps({"n": n, "root": os.path.abspath(args.root), "kernels": out}), flush=True)


if __name__ == "__main__":
    main()
