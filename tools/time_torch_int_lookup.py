"""The fused lookup under every integer top that chip_smoke.py drives, on
one CUDA card, for one checkout of rmi_tpu_torch: lookups of 2^22 keys
sampled from 200M books-like keys (chip_smoke's keys, seed 42) under
path 5's ``radix18,linear 65536``, the zoo's ``histogram,linear 4096``,
``radix22,cubic 65536``, ``radix,linear 1024`` and ``bradix,linear 1024``,
the zoo's f64 row (``radix18,linear 65536`` on path 7's f64 keys), and
path 1's affine ``cubic,linear 262144`` beside them.

    python3 tools/time_torch_int_lookup.py [--root DIR] [--n 200000000] [--runs 7]
    python3 tools/time_torch_int_lookup.py --routes

Each time is the median of RUNS runs, each run the mean of back-to-back
``lookup`` calls over at least 5 ms (CUDA events), so that the launch
gaps of a ~0.05 ms call are not what is timed; every answer is checked
against the plain version (eval_kernel.lookup_clamped_plain) on the card.

--root DIR imports rmi_tpu_torch and chip_smoke from DIR, a checkout of
another version: run both in one command, in turns (parent, this tree,
this tree, parent), to compare them on one card.

--routes (this tree's kernel only) times each integer top's lookup under
every route rmi_lookup_* takes, launched directly: a hint table in place
with 16-bit and with 32-bit entries (B given as 2^16 + 1, the clamped
entries unchanged) and folded into the rows; a histogram in place and in
one block.  A route the card refuses is logged as refused.  Every
route's answers must equal the plain version's.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, spec, B, key type): chip_smoke's rows
ROWS = [("path5", "radix18,linear", 65536, "u64"),
        ("histogram", "histogram,linear", 4096, "u64"),
        ("radix22", "radix22,cubic", 65536, "u64"),
        ("radix", "radix,linear", 1024, "u64"),
        ("bradix", "bradix,linear", 1024, "u64"),
        ("f64_radix18", "radix18,linear", 65536, "f64"),
        ("path1", "cubic,linear", 262144, "u64")]
RUN_MS = 5.0


def run_ms(fn, runs):
    """(median, every run): each run the mean of back-to-back calls of fn
    over at least RUN_MS, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    reps = max(10, math.ceil(RUN_MS / max(start.elapsed_time(stop), 1e-3)))
    t = []
    for _ in range(runs):
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        t.append(start.elapsed_time(stop) / reps)
    return sorted(t)[runs // 2], t


def route_variants(eval_kernel, rmi, B):
    """(name, top_args, rows, B) of each route rmi_lookup_* takes for an
    integer top: the default (lookup's own), then each route."""
    top, top_p, leaf = rmi.top_type, rmi.device_top_params, rmi.leaf_type
    ops = eval_kernel.top_operands(top, top_p, rmi.leaf_errors.device, B, leaf)
    rows = eval_kernel.lookup_table(rmi.device_leaf_params, rmi.leaf_errors)
    out = [("default", rmi.lookup_top_cache, rmi.lookup_table_cache, B)]
    kind = eval_kernel.TOP_KINDS[eval_kernel.top_kind(top)]
    if kind == "table":
        wide = eval_kernel.unpack_table(ops[2], B).to(torch.int32)
        out.append(("l2_16", (*ops[:5], eval_kernel.IN_PLACE), rows, B))
        out.append(("l2_32", (*ops[:2], wide, *ops[3:5], eval_kernel.IN_PLACE), rows,
                    max(B, (1 << 16) + 1)))
        folded = rows[eval_kernel.unpack_table(ops[2], B)]
        out.append(("folded", (*ops[:5], eval_kernel.FOLDED), folded, B))
    elif kind == "histogram":
        out += [(name, (*ops[:5], r), rows, B)
                for name, r in (("l2", eval_kernel.IN_PLACE), ("block", eval_kernel.BLOCK))]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--n", type=int, default=200_000_000, help="keys")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--routes", action="store_true",
                    help="time every route of each integer top (this tree only)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    import rmi_tpu_torch
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.lookup import lookup
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.ops import _build, eval_kernel

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    _build.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    u = rdata.books_like_on_device(args.n, args.seed, dev)
    data = {"u64": rdata.RMIDataset(u, KeyType.U64),
            "f64": rdata.RMIDataset(cs.typed_keys(u, KeyType.F64), KeyType.F64)}
    nq = min(1 << 22, args.n)
    out = {"root": os.path.abspath(args.root), "n": args.n, "nq": nq}
    bad = []
    for label, spec, B, kt in ROWS:
        d = data[kt]
        rmi = rmi_tpu_torch.train(d, spec, B)
        sample = d.keys[torch.randint(0, args.n, (nq,), generator=gen, device=dev)]
        want = eval_kernel.lookup_clamped_plain(
            sample, rmi.device_top_params, rmi.device_leaf_params, rmi.leaf_errors,
            rmi.num_rmi_rows, rmi.norm_offset, rmi.norm_scale, top_type=rmi.top_type,
            leaf_type=rmi.leaf_type, key_type=rmi.key_type)
        got = lookup(rmi, sample)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        med, runs = run_ms(lambda: lookup(rmi, sample), args.runs)
        out[label] = {"spec": spec, "B": B, "keys": kt, "ms": med, "runs": runs,
                      "plain_equal": same}
        if len(rmi.lookup_top_cache or ()) > 5:
            out[label]["route"] = eval_kernel.route_name(rmi.top_type,
                                                         rmi.lookup_top_cache[5])
        print(f"{label} {spec} {B} ({kt}): {med:.4f} ms ({min(runs):.4f}-{max(runs):.4f}), "
              f"route {out[label].get('route')}, equal to the plain version {same}",
              flush=True)
        if not same:
            bad.append(label)
        if args.routes and get_model(rmi.top_type).output_int:
            kernel = get_model(rmi.leaf_type).leaf_kernel
            key_kind = eval_kernel.key_kind(rmi.key_type)
            times = {}
            for name, ops, rows, b in route_variants(eval_kernel, rmi, B):
                def call(ops=ops, rows=rows, b=b):
                    return _build.launch(
                        f"rmi_lookup_{kernel}", sample, key_kind, ops[0],
                        eval_kernel.top_kind(rmi.top_type), *ops[1:], rows, (nq,), (nq,),
                        nq, b, rmi.num_rmi_rows, float(rmi.norm_offset),
                        float(rmi.norm_scale))
                try:
                    g, e = call()
                except RuntimeError as exc:
                    times[name] = f"refused: {exc}"
                    print(f"  {label} route {name}: refused ({exc})", flush=True)
                    continue
                ok = torch.equal(g, want[0]) and torch.equal(e, want[1])
                med, runs = run_ms(call, args.runs)
                times[name] = {"ms": med, "runs": runs, "plain_equal": ok}
                print(f"  {label} route {name}: {med:.4f} ms ({min(runs):.4f}-"
                      f"{max(runs):.4f}), equal {ok}", flush=True)
                if not ok:
                    bad.append(f"{label}:{name}")
            out[label]["routes"] = times
        del rmi, sample, want, got
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    if bad:
        raise RuntimeError(f"answers differ from the plain version: {bad}")


if __name__ == "__main__":
    main()
