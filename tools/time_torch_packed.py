"""The packed plan's search and K5's window bounds on one CUDA card:
chip_smoke.py's paths 1 (``cubic,linear 262144``) and 5 (``radix18,linear
65536``) on its 200M books-like keys and queries.

    python3 tools/time_torch_packed.py [--root DIR] [--n 200000000] [--runs 5]

For each path and batch of 2^14 ... 2^22 queries (chip_smoke.CURVE), the
median of RUNS timings with CUDA events (each of at least 5 ms of calls,
chip_smoke.row_ms) of: rmi_packed_search (packed_kernel.packed_search),
its plain version (the eager route it replaced), sort -> K5 -> unsort
(lookup_fast.serve_via_sort) and torch.searchsorted; every answer checked
against torch.searchsorted.  At 2^22 sorted queries rmi_sorted_bounds
against its plain version, and search's device time a batch split by a
profiler trace into the sort, the bounds, K5's scatter entry and the
rest.  Then each of chip_smoke's zoo rows that takes a packed plan
(chip_smoke.ZOO: packed_wide under radix, bradix, a histogram's block
route, the lognormal top's torch leaf ids) at 2^22 queries: the kernel
(with the lognormal top's torch step, as packed_search runs it) and
torch.searchsorted.  --root DIR imports rmi_tpu_torch and chip_smoke from
DIR, a checkout of another version (one with the packed kernels): run
both in one command, in turns, to compare them on one card, e.g.

    for r in p c c p; do if [ $r = p ]; then python3 tools/time_torch_packed.py \
        --root .chip_checkout/parent; else python3 tools/time_torch_packed.py; fi; done

Prints the card's name and power limit, ptxas's registers of the packed
kernels, one line a point, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_ms(cs, fn, runs):
    return sorted(cs.row_ms(fn, 3)[0] for _ in range(runs))[runs // 2]


def search_split(cs, rmi, q, batches=5):
    """search's device ms a batch by part (a profiler trace)."""
    from rmi_tpu_torch.lookup import search
    search(rmi, q)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(batches):
            search(rmi, q)
        torch.cuda.synchronize()
    parts = dict.fromkeys(("sort", "bounds", "k5_scatter", "other"), 0.0)
    for e in prof.key_averages():
        name = e.key.lower()
        part = ("k5_scatter" if "serve_sorted" in name else "bounds" if "rmi_sorted_bounds"
                in name or "packed" in name else "sort" if "sort" in name else "other")
        parts[part] += cs._device_us(e) / 1e3 / batches
    return parts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--n", type=int, default=200_000_000, help="keys")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    import rmi_tpu_torch
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch import lookup_fast
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.ops import _build
    from rmi_tpu_torch.ops import packed_kernel as pk

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    _build.library()
    entry = ""
    for line in _build.build_info["log"].splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "registers" in line and "packed" in entry:
            print("ptxas " + entry.split("'")[1][:60] + ": "
                  + line.split("ptxas info    :")[-1].strip(), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    keys = rdata.books_like_on_device(args.n, args.seed, dev)
    data = rdata.RMIDataset(keys, KeyType.U64)
    out = {}
    for spec, B in (cs.PATH1[:2], cs.PATH5[:2]):
        rmi = rmi_tpu_torch.train(data, spec, B)
        plan = lookup_fast.get_plan(rmi)
        rows = []
        for nq in cs.CURVE:
            q = cs.make_queries(keys, nq, gen)
            routes = {"kernel": lambda: pk.packed_search(rmi, plan, q),
                      "plain": lambda: pk.packed_search_plain(rmi, plan, q),
                      "sort_k5": lambda: lookup_fast.serve_via_sort(rmi, plan, q),
                      "searchsorted": lambda: torch.searchsorted(keys, q)}
            row = {"nq": nq}
            for name, fn in routes.items():
                if cs.mismatches(keys, q, fn()):
                    raise RuntimeError(f"{spec}: {name} wrong at {nq} queries")
                row[name] = median_ms(cs, fn, args.runs)
            rows.append(row)
            print(f"{spec} nq={nq}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()
                                                  if k != "nq"), flush=True)
        qs = torch.sort(q).values
        lo, hi = pk.sorted_bounds(rmi, plan, qs)
        want = pk.sorted_bounds_plain(rmi, plan, qs)
        if not (torch.equal(lo, want[0]) and torch.equal(hi, want[1])):
            raise RuntimeError(f"{spec}: rmi_sorted_bounds disagrees with its plain version")
        bounds = {"kernel": median_ms(cs, lambda: pk.sorted_bounds(rmi, plan, qs), args.runs),
                  "plain": median_ms(cs, lambda: pk.sorted_bounds_plain(rmi, plan, qs),
                                     args.runs)}
        split = search_split(cs, rmi, q)
        print(f"{spec} bounds at {qs.shape[0]}: " + json.dumps(bounds)
              + "; search's device ms a batch: " + json.dumps(split), flush=True)
        out[spec] = {"plan": [plan.kind, plan.S, plan.F], "curve": rows, "bounds": bounds,
                     "search_split": split}
        del rmi, plan
        torch.cuda.empty_cache()
    q = cs.make_queries(keys, cs.CURVE[-1], gen)
    want = torch.searchsorted(keys, q)
    out["zoo"] = {}
    for spec, B, _ in cs.ZOO:
        rmi = rmi_tpu_torch.train(data, spec, B)
        plan = lookup_fast.get_plan(rmi)
        if plan.kind in pk.PACKED_KINDS:
            if not torch.equal(pk.packed_search(rmi, plan, q), want):
                raise RuntimeError(f"zoo {spec}: the packed search is wrong")
            row = {"plan": [plan.kind, plan.S, plan.F],
                   "kernel": median_ms(cs, lambda: pk.packed_search(rmi, plan, q), args.runs),
                   "searchsorted": median_ms(cs, lambda: torch.searchsorted(keys, q),
                                             args.runs)}
            out["zoo"][spec] = row
            print(f"zoo {spec} {B} at {q.shape[0]}: " + json.dumps(row), flush=True)
        del rmi, plan
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
