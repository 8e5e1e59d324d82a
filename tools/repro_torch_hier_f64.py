"""Exact search through the hier plan on f64 keys, for one checkout of
rmi_tpu_torch on one CUDA card: chip_smoke.py's zoo f64 row.

    python3 tools/repro_torch_hier_f64.py [--root DIR] [--n 4000000] [--cpu]
                                          [--save FILE]

Makes books-like keys on the card (as chip_smoke.py does), casts them to
f64 and scales them by 2^-32 (chip_smoke.typed_keys), builds
``radix18,linear 65536`` on them (an integer top on f64 keys: the hier
plan) and searches 2^22 random images over the keys' range, each key's
image minus 1 and each key's image plus 1, against torch.searchsorted.
Prints the card's name and power limit, the plan and the build's
max_err and avg_log2, the last keys, the mismatches of each query set
and, for up to ten of them, the query, its lower bound, the answer and
lookup's guess and err.  At 4M keys the last key is the double below
2^30 and the image just above it truncates to 2^30, a bit no key has:
the radix18 top sends it to leaf 0, whose window does not hold n, so a
checkout whose resolve does not answer a query past the last key by the
key count answers it wrong.  --cpu also
builds the same keys on the machine's CPU (the plain route) and
searches the same queries there; --save FILE writes the keys' images
(.npy); --root DIR imports rmi_tpu_torch from DIR, a checkout of another
commit.
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
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cpu", action="store_true",
                    help="also build on the machine's CPU from the same keys and compare")
    ap.add_argument("--save", default=None, help="write the keys' images here (.npy)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import rmi_tpu_torch
    from rmi_tpu_torch import config, data as rdata, keys as keymod, lookup_fast
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.lookup import lookup, search

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    u = rdata.books_like_on_device(args.n, args.seed, dev)
    keys = keymod.f64_image(keymod.as_float(u).mul_(2.0 ** -32))
    del u
    rmi = rmi_tpu_torch.train(rdata.RMIDataset(keys, KeyType.F64), "radix18,linear", 65536)
    plan = lookup_fast.get_plan(rmi)
    print(f"rmi_tpu_torch from {os.path.abspath(args.root)}: plan {plan.kind} K={plan.K}, "
          f"max_err {rmi.model_max_error}, avg_log2 {rmi.model_avg_log2_error!r}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    sets = {"random": torch.randint(int(keys[0]), int(keys[-1]), (1 << 22,), generator=gen,
                                    device=dev),
            "key - 1": keys - 1, "key + 1": keys + 1}
    if args.save:
        import numpy as np
        np.save(args.save, keys.cpu().numpy())
    cpu = None
    if args.cpu:
        cpu = rmi_tpu_torch.train(rdata.RMIDataset(keys.cpu(), KeyType.F64), "radix18,linear",
                                  65536)
        top_c = {k: bool(torch.equal(v.cpu(), cpu.device_top_params[k]))
                 for k, v in rmi.device_top_params.items()}
        print(json.dumps({"cpu max_err": cpu.model_max_error,
                          "top equal": top_c,
                          "leaf rows equal": bool(torch.equal(rmi.device_leaf_params.cpu(),
                                                              cpu.device_leaf_params)),
                          "leaf errors differ": int((rmi.leaf_errors.cpu()
                                                     != cpu.leaf_errors).sum())}), flush=True)
    last = keys[-3:]
    print(json.dumps({"last images": last.tolist(),
                      "last values": keymod.as_float(last, KeyType.F64).tolist(),
                      "first image": int(keys[0])}), flush=True)
    total = 0
    for label, q in sets.items():
        got = search(rmi, q)
        lb = torch.searchsorted(keys, q, side="left")
        bad = (got != lb).nonzero().flatten()
        total += bad.numel()
        print(f"{label}: {q.shape[0]} queries, {bad.numel()} mismatches", flush=True)
        if cpu is not None:
            bad_c = (search(cpu, q.cpu()) != lb.cpu()).nonzero().flatten()
            print(f"{label} on the CPU: {bad_c.numel()} mismatches {bad_c[:10].tolist()}",
                  flush=True)
        if bad.numel():
            guess, err = lookup(rmi, q[bad[:10]])
            for j, b in enumerate(bad[:10].tolist()):
                print(json.dumps({"query": int(q[b]), "lower_bound": int(lb[b]),
                                  "answer": int(got[b]), "guess": int(guess[j]),
                                  "err": int(err[j])}), flush=True)
            if cpu is not None:
                qc = q[bad[:10]].cpu()
                gc, ec = lookup(cpu, qc)
                print(json.dumps({"cpu search": search(cpu, qc).tolist(),
                                  "cpu guess": gc.tolist(), "cpu err": ec.tolist()}),
                      flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "n": args.n, "mismatches": total}),
          flush=True)


if __name__ == "__main__":
    main()
