"""The cachefix serving path's two kernels on one CUDA card, for one
checkout of rmi_tpu_torch, at chip_smoke.py's shapes and 2^22 queries:

  rmi_cachefix_interp      path 11's cache_fix_osm (``cubic,linear 786432
                           --bounded 8``, 24.9M knots) and cache_fix_wiki
                           (``linear_spline,linear 4194304 --bounded 8``)
                           on SOSD_SYNTH.json's 200M osm and wiki keys
                           (seed 7), and path 6b's (the same spec on path
                           1's books-like keys): the kernel alone (from the
                           batch's RMI guess and error) and the cachefix
                           lookup (one fused lookup and the kernel), of
                           keys drawn at random;
  rmi_bounded_lower_bound  path 8 (``linear,linear 100`` on path 1's keys >>
                           30): the kernel alone and bounded_search; the
                           cachefix search of cache_fix_wiki with the
                           original keys (exact mode: the kernel alone and
                           search), of queries uniform over the keys, and
                           of a batch made only of queries whose window
                           misses (after a run of equal keys).
  control                  path 8's hier search (one fused lookup and
                           rmi_hier_resolve), which shares no code with
                           them.

    python3 tools/time_torch_cachefix.py [--root DIR] [--n 200000000] [--runs 7]
        [--data .data/cachefix] [--strides 8,16,32,64,128]

Each time is the median of RUNS single calls with CUDA events after one
untimed call; every answer is checked against the plain versions
(cachefix_interp_plain, bounded_lower_bound_plain on the card) and the
searches against torch.searchsorted.  The three cachefix indexes (their
host spline takes 20-30 s each) and their query keys are made on the
first run into --data and loaded by later runs, so that a parent and
this tree run in turns on the same inputs.  --root DIR imports
rmi_tpu_torch and chip_smoke from DIR, a checkout of another version:
run both in one command, in turns, to compare them on one card.
--strides also times rmi_cachefix_interp on cache_fix_osm with the knots'
sample at those strides (the C entry's sample_stride; the wrapper's is
KNOT_STRIDE), a checkout whose entry takes a sample only.  Prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = {"osm": ("osm", "cubic,linear", 786432),
         "wiki": ("wiki", "linear_spline,linear", 4194304),
         "6b": ("books", "linear_spline,linear", 4194304)}
LINE = 8
SEED = 7          # SOSD_SYNTH.json's keys (chip_smoke.WIKI_SEED)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--n", type=int, default=200_000_000, help="keys")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--data", default=os.path.join(REPO, ".data", "cachefix"),
                    help="directory of the indexes made on the first run")
    ap.add_argument("--strides", default="",
                    help="knot sample strides to time cache_fix_osm's interpolation at")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    import rmi_tpu_torch as rt
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch import lookup_fast
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.lookup import _rmi_lookup, bounded_search, err_iters, lookup, search
    from rmi_tpu_torch.ops import _build, cachefix_kernel

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    _build.library()
    nq = min(1 << 22, args.n)
    out = {"root": os.path.abspath(args.root), "n": args.n, "nq": nq}
    checks = {}

    def timed(name, fn, want):
        got = fn()
        checks[name] = int((got != want).sum())
        out[f"{name}_ms"], out[f"{name}_runs"] = cs.median_ms(fn, args.runs)

    # the cachefix indexes, made once into --data
    os.makedirs(args.data, exist_ok=True)
    wiki_keys = None
    for label, (kind, spec, B) in SPECS.items():
        meta = os.path.join(args.data, f"{label}_{args.n}.json")
        keys_file = os.path.join(args.data, f"{label}_{args.n}_keys.npy")
        sample_file = os.path.join(args.data, f"{label}_{args.n}_sample.npy")
        if not os.path.exists(meta):
            t0 = time.perf_counter()
            if kind == "books":
                keys = rdata.books_like_on_device(args.n, 42, dev)
            else:
                keys = rt.RMIDataset.from_numpy(
                    rdata.synthetic_dataset(kind, args.n, KeyType.U64, seed=SEED), device=dev).keys
            index = rt.train_bounded(rdata.RMIDataset(keys, KeyType.U64), spec, B, LINE)
            rt.save_artifact(index, os.path.splitext(os.path.basename(meta))[0], args.data)
            g = torch.Generator(device=dev)
            g.manual_seed(SEED + 1)
            np.save(sample_file, keys[torch.randint(0, args.n, (nq,), generator=g,
                                                    device=dev)].cpu().numpy())
            if label == "wiki":
                np.save(keys_file, keys.cpu().numpy())
            print(f"{label}: index made and saved in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            del keys, index
            torch.cuda.empty_cache()
        index = rt.load_artifact(meta)
        k = torch.from_numpy(np.load(sample_file)).to(dev)
        guess, err = _rmi_lookup(index, k)
        lookup(index, k)                   # the index's cached operands, made once
        kw = {}
        if "sample" in inspect.signature(cachefix_kernel.cachefix_interp).parameters:
            kw["sample"] = index.knot_sample_cache
        want = cachefix_kernel.cachefix_interp_plain(index.keys, index.spline_vals_cache, k,
                                                     guess, err, LINE, index.num_data_rows)
        timed(f"{label}_interp", lambda: cachefix_kernel.cachefix_interp(
            index.keys, index.spline_vals_cache, k, guess, err, LINE, index.num_data_rows,
            **kw), want)
        timed(f"{label}_lookup", lambda: lookup(index, k)[0], want)
        out[f"{label}_knots"] = index.keys.shape[0]
        for stride in (int(x) for x in args.strides.split(",") if x and label == "osm"):
            knots, total = index.keys, index.num_data_rows
            sample = knots[::stride].contiguous()
            timed(f"osm_interp_stride{stride}", lambda: _build.launch(
                "rmi_cachefix_interp", knots, index.spline_vals_cache, knots.shape[0], sample,
                sample.shape[0], stride, k, guess, err, k.shape[0], k.shape[0], LINE, total,
                cachefix_kernel.interp_eps(total), cachefix_kernel.interp_iters(knots.shape[0])),
                want)
        if label == "wiki":
            wiki_keys = torch.from_numpy(np.load(keys_file)).to(dev)
            wiki = index
        else:
            del index
        del k, guess, err, want
        torch.cuda.empty_cache()

    # the cachefix search with the original keys: random queries, then
    # only queries whose window misses
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    n = wiki_keys.shape[0]
    iters = max(1, int(np.ceil(np.log2(2 * LINE + 2))) + 2)      # lookup.search's
    batches = {"wiki_search": cs.make_queries(wiki_keys, nq, g)}
    ends = torch.nonzero((wiki_keys[1:-1] == wiki_keys[:-2])
                         & (wiki_keys[2:] > wiki_keys[1:-1] + 1)).flatten()
    qm = wiki_keys[ends + 1] + 1
    pos, perr = lookup(wiki, qm)
    lb = torch.searchsorted(wiki_keys, qm)
    batches["wiki_missed"] = qm[(lb < pos - perr - 1) | (lb > pos + perr + 2)][:nq]
    out["wiki_missed_queries"] = batches["wiki_missed"].shape[0]
    for name, q in batches.items():
        want = torch.searchsorted(wiki_keys, q)
        pos, perr = lookup(wiki, q)
        timed(f"{name}_kernel", lambda: cachefix_kernel.bounded_lower_bound(
            wiki_keys, q, pos, perr + 1, n, iters, True), want)
        timed(f"{name}", lambda: search(wiki, q, keys=wiki_keys), want)
    del wiki, wiki_keys, batches, qm, pos, perr, lb, ends, want
    torch.cuda.empty_cache()

    # path 8: bounded_search over 200M u32 keys, and the hier search as a control
    keys = cs.typed_keys(rdata.books_like_on_device(args.n, 42, dev), KeyType.U32)
    B = max(2, 100 * args.n // 200_000_000)
    rmi = rt.train(rdata.RMIDataset(keys, KeyType.U32), "linear,linear", B)
    g.manual_seed(43)
    q = cs.make_queries(keys, nq, g, KeyType.U32)
    guess, err = lookup(rmi, q)
    want = torch.searchsorted(keys, q)
    iters = err_iters(rmi.model_max_error)
    inside = cachefix_kernel.bounded_lower_bound_plain(keys, q, guess, err, keys.shape[0], iters)
    timed("path8_kernel", lambda: cachefix_kernel.bounded_lower_bound(
        keys, q, guess, err, keys.shape[0], iters), inside)
    timed("path8_bounded_search", lambda: bounded_search(rmi, q), want)
    timed("path8_hier_search", lambda: lookup_fast.fast_search(rmi, q), want)
    out["path8_max_err"] = rmi.model_max_error
    out["mismatches"] = checks
    print(json.dumps(out), flush=True)
    if any(checks.values()):
        raise RuntimeError(f"an answer differs from the plain version: {checks}")


if __name__ == "__main__":
    main()
