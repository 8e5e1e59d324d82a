"""The hierarchical plan's serving on one CUDA card, for one checkout of
rmi_tpu_torch: chip_smoke.py's path 8 (``linear,linear 100`` on 200M u32
keys, path 1's books-like keys shifted right by 30; K = 3) and its 2^22
queries.

    python3 tools/time_torch_hier.py [--root DIR] [--n 200000000] [--runs 7]

Times, each the median of RUNS single calls with CUDA events after one
untimed call: rmi_hier_resolve (hier_kernel.resolve, from the batch's
guess and err), the hier search (lookup_fast.fast_search: one fused
lookup and one resolve), bounded_search and torch.searchsorted on the
same batch; each answer is checked against torch.searchsorted.  As
yardsticks of what one random read a query costs: torch.index_select of
each query's answer from the keys (level 0, 1.6 GB) and of answer // 64
from level 1 (25 MB).

--root DIR imports rmi_tpu_torch and chip_smoke from DIR, a checkout of
another version: run both in one command, in turns, to compare them on
one card.  A version whose plan keeps no packed levels (before the
resolve kernel: its resolve is torch over the levels' [m, 128] counts)
times its hier search and the yardsticks, not the resolve alone.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--n", type=int, default=200_000_000, help="keys")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    import rmi_tpu_torch
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch import lookup_fast
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.lookup import bounded_search, lookup
    from rmi_tpu_torch.ops import _build

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    _build.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    keys = cs.typed_keys(rdata.books_like_on_device(args.n, args.seed, dev), KeyType.U32)
    B = max(2, 100 * args.n // 200_000_000)
    rmi = rmi_tpu_torch.train(rdata.RMIDataset(keys, KeyType.U32), "linear,linear", B)
    plan = lookup_fast.get_plan(rmi)
    if plan.kind != "hier":
        raise RuntimeError(f"plan {plan.kind}, not the hierarchical plan")
    q = cs.make_queries(keys, min(1 << 22, args.n), gen, KeyType.U32)
    guess, err = lookup(rmi, q)
    want = torch.searchsorted(keys, q)

    calls = {"hier_search": lambda: lookup_fast.fast_search(rmi, q),
             "bounded_search": lambda: bounded_search(rmi, q),
             "searchsorted": lambda: torch.searchsorted(keys, q)}
    if getattr(plan, "packed", None) is not None:
        calls["resolve"] = lambda: lookup_fast.resolve(plan.levels, q, guess, err, K=plan.K,
                                                       n=plan.n, packed=plan.packed)
    out = {"root": os.path.abspath(args.root), "n": args.n, "nq": q.shape[0], "K": plan.K,
           "max_err": rmi.model_max_error}
    for name, fn in calls.items():
        mism = int((fn() != want).sum())
        med, runs = cs.median_ms(fn, args.runs)
        out[f"{name}_ms"], out[f"{name}_runs"], out[f"{name}_mismatches"] = med, runs, mism
    at = want.clamp(max=keys.shape[0] - 1)
    for name, level, idx in (("gather_level0", keys, at),
                             ("gather_level1", plan.levels[1], at // 64)):
        out[f"{name}_ms"] = cs.median_ms(lambda: torch.index_select(level, 0, idx),
                                         args.runs)[0]
    print(json.dumps(out), flush=True)
    if any(out[f"{name}_mismatches"] for name in calls):
        raise RuntimeError("an answer differs from torch.searchsorted")


if __name__ == "__main__":
    main()
