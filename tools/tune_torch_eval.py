"""K4 (csrc/eval.cu) at lookup's shape on one CUDA card: what bounds it.

    python3 tools/tune_torch_eval.py [--m 4194304] [--B 65536] [--root DIR]
                                     [--sass FILE]

On random key images over B synthetic leaves it times, for each leaf
kernel:

  lookup      rmi_lookup_<leaf> on the keys over the lookup table, once
              for each top kind (the four leaf kernels, which the affine
              tops share; each top's row spreads the keys over the leaves);
  random      rmi_leaf_eval_<leaf> on lookup's own x and leaf ids under
              the cubic top;
  sorted      the same pairs sorted by leaf id, so that the rows are
              read in order;
  one_row     every leaf id 0.

Each time is the median of 5 runs of at least 5 ms of calls (CUDA
events), with their spread, after a second of launches that brings the
card to its clocks.  Beside it: the bound (bytes of the inputs and
outputs at 3.35 TB/s, the rows and errors once) and the bytes the
32-byte sectors of L2 move for the call (the streamed inputs and
outputs, and the sectors of each gathered row), with the rate each time
implies.  Every output is checked bit for bit against the plain version.

--root DIR imports rmi_tpu_torch from DIR, a checkout of another commit,
to compare two versions in one command.  --sass FILE writes the SASS of
the library's K4 kernels (cuobjdump) to FILE and prints, per kernel, its
registers and its count of each global load and store, shuffle and call.
Prints the card's name and power limit, then one JSON line per leaf
kernel.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
SECTOR = 32


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


def warm_up(fn, seconds=1.0):
    """Keep the card busy with ``fn`` for ``seconds``: the first kernel
    timed after an idle spell otherwise runs at lower clocks."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        cuda_ms(fn, 50)


def runs_ms(fn):
    """[median, least, most] of 5 runs of at least 5 ms of calls."""
    ms = cuda_ms(fn, 10)
    reps = max(10, math.ceil(5.0 / max(ms, 1e-4)))
    runs = sorted(cuda_ms(fn, reps) for _ in range(5))
    return [runs[2], runs[0], runs[-1]]


def top_row(kind, B):
    """A top row of kernel ``kind`` that maps normalized keys in [0, 1]
    over the B leaves."""
    return {"linear": [0.0, float(B)], "cubic": [0.0, 0.0, float(B), 0.0],
            "loglinear": [0.0, math.log(B)], "normal": [0.5, 0.25, float(B)]}[kind]


def leaf_rows(kernel, B, n, rng):
    """[B, ppm] rows that map leaf j's keys near positions j n / B."""
    ids = np.arange(B)
    if kernel == "cubic":
        return np.stack([np.zeros(B), np.zeros(B), np.full(B, float(n)), np.zeros(B)], 1)
    if kernel == "normal":
        return np.stack([(ids + 0.5) / B, np.full(B, 0.3 / B), (ids + 1.0) * (n / B)], 1)
    if kernel == "loglinear":
        return np.stack([np.log1p(ids * (n / B)), rng.normal(1.0, 0.1, B)], 1)
    return np.stack([np.zeros(B), np.full(B, float(n))], 1)


def row_sectors(width, ids):
    """32-byte sectors that rows of ``width`` bytes at ``ids`` span, each
    access apart."""
    first = ids * width
    return int(((first + width - 1) // SECTOR - first // SECTOR + 1).sum())


def kernel_of(mangled):
    """'lookup<L>' or 'leaf_eval<L>' of a mangled K4 kernel name, else None."""
    m = re.search(r"(lookup|leaf_eval)I?L?\w*?RmiLeaf(\d)", mangled)
    if not m or not ("6lookup" in mangled or "9leaf_eval" in mangled):
        return None
    return f"{m.group(1)}{m.group(2)}"


def registers(log):
    """{kernel: registers} from ptxas's -v output in the build log."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_of(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def sass_summary(lib_path, out_file, nvcc):
    """Write the K4 kernels' SASS to ``out_file``; {kernel: {op: count}}
    of their global loads and stores, shuffles, calls and local memory."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, keep, name = {}, [], None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_of(m.group(1))
            if name:
                counts[name] = collections.Counter()
        if name is None:
            continue
        keep.append(line)
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9]+)*)", line)
        if op and op.group(1).split(".")[0] in ("LDG", "STG", "SHFL", "CALL", "LDL", "STL"):
            counts[name][op.group(1)] += 1
    with open(out_file, "w") as f:
        f.write("\n".join(keep) + "\n")
    return {k: dict(v) for k, v in counts.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=1 << 22)
    ap.add_argument("--B", type=int, default=65536)
    ap.add_argument("--n", type=int, default=200_000_000, help="keys the index holds")
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--sass", help="file for the K4 kernels' SASS")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from rmi_tpu_torch import config
    from rmi_tpu_torch.models.base import (get_model, kernel_input, model_float_input,
                                           predict_top_assignment)
    from rmi_tpu_torch.ops import _build, eval_kernel

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    _build.library()
    info = {"root": os.path.abspath(args.root),
            "registers": registers(_build.build_info["log"])}
    if args.sass:
        info["sass"] = sass_summary(_build.build_info["path"], args.sass, config.nvcc_path())
    print(json.dumps(info), flush=True)

    m, B, n = args.m, args.B, args.n
    rng = np.random.default_rng(0)
    lo, hi = -(1 << 62), 1 << 62
    q = torch.from_numpy(rng.integers(lo, hi, m, dtype=np.int64)).to(dev)
    kminf = float(np.float64(np.uint64(lo + (1 << 63))))
    s = 1.0 / (float(np.float64(np.uint64(hi + (1 << 63)))) - kminf)
    errors = torch.from_numpy(rng.integers(0, 1000, B, dtype=np.int64)).to(dev)
    tops = {k: torch.tensor([top_row(k, B)], dtype=torch.float64, device=dev)
            for k in eval_kernel.LEAF_KERNELS}
    warmed = False
    for kernel in eval_kernel.LEAF_KERNELS:
        mleaf = get_model(kernel)
        w = torch.from_numpy(leaf_rows(kernel, B, n, rng)).to(dev)
        table = eval_kernel.lookup_table(w, errors)
        row_b, table_b = w.shape[1] * 8, table.shape[1] * 8
        res, l2, bound = {}, {}, {}
        for top, top_w in tops.items():
            kw = {"top_type": top, "leaf_type": kernel}

            def run_lookup(top_w=top_w, kw=kw):
                return eval_kernel.lookup_clamped(q, top_w, w, errors, n, kminf, s, **kw,
                                                  table=table)
            if not warmed:
                warm_up(run_lookup)
                warmed = True
            case = f"lookup_{top}_top"
            res[case] = runs_ms(run_lookup)
            want = eval_kernel.lookup_clamped_plain(q, top_w, w, errors, n, kminf, s, **kw)
            got = run_lookup()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"rmi_lookup_{kernel}, {top} top: differs from plain")
            ids = predict_top_assignment(get_model(top), top_w,
                                         model_float_input(get_model(top), q, kminf, s),
                                         B - 1)
            l2[case] = m * 24 + row_sectors(table_b, ids.cpu().numpy()) * SECTOR
            bound[case] = (m * 24 + (row_b + 8) * B) / HBM_BYTES_PER_S * 1e3
        x = kernel_input(mleaf, model_float_input(mleaf, q, kminf, s))
        ids = predict_top_assignment(get_model("cubic"), tops["cubic"],
                                     model_float_input(get_model("cubic"), q, kminf, s),
                                     B - 1)
        order = torch.argsort(ids)
        cases = {"random": (x, ids), "sorted": (x[order].contiguous(), ids[order].contiguous()),
                 "one_row": (x, torch.zeros_like(ids))}
        for c, (cx, cids) in cases.items():
            res[c] = runs_ms(lambda cx=cx, cids=cids: eval_kernel.leaf_eval_clamped(
                cx, w, cids, n - 1, leaf_type=kernel))
            want = eval_kernel.leaf_eval_clamped_plain(cx, w, cids, n - 1, leaf_type=kernel)
            if not torch.equal(eval_kernel.leaf_eval_clamped(cx, w, cids, n - 1,
                                                             leaf_type=kernel), want):
                raise RuntimeError(f"rmi_leaf_eval_{kernel} {c}: differs from plain")
            rows = {"random": row_sectors(row_b, cids.cpu().numpy()) * SECTOR,
                    "sorted": row_b * B, "one_row": 0}[c]
            l2[c] = m * 20 + rows
            bound[c] = (m * 20 + (row_b * B if c != "one_row" else 0)) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "leaf": kernel, "m": m, "B": B, "ms": res, "bound_ms": bound,
            "l2_sector_bytes": l2,
            "l2_TB_per_s": {c: l2[c] / (res[c][0] * 1e-3) / 1e12 for c in res}}), flush=True)


if __name__ == "__main__":
    main()
