"""The build's FixDups and leaf fits on one CUDA card at 200M keys, for one
checkout of rmi_tpu_torch: chip_smoke.py's paths 1, 3, 4, 5 and 8.

    python3 tools/time_torch_fit.py [--root DIR] [--n 200000000] [--reps 5] [--errors DIR]
                                    [--sass FILE] [--paths "path 3,path 4"]

Makes books-like keys on the card (as chip_smoke.py does; path 8's are
the same keys shifted right by 30, u32, chip_smoke.typed_keys), then per
path: one warm build traced with torch.profiler, the device ms of its
rmi.build.assign and rmi.build.fit ranges; and with CUDA events (the
median of --reps runs of CALLS calls, with the runs' spread) FixDups
(two_layer.fixdups_i32 on the path's keys) and the leaf fit alone (the
model's fit_leaves on the build's own input, FixDups and spans).  Where
the checkout has them (select_kernel.aug_fit_moments,
scan_kernel.fixdups), it also times the two entries alone on the same
inputs, beside their bounds (bytes at 3.35 TB/s: 12 B a key for FixDups
and the linear form, 8 for the xx form) and K2 (rmi_aug_moments or
rmi_aug_moments_xx) on the same spans and means; path 3's loglinear leaves
likewise through select_kernel.aug_fit_log_moments (12 B a key) where the
checkout has it, beside K2 weighted (rmi_aug_moments_weighted) on ln y,
its weights and the fit's means.

--sass FILE writes the SASS of moments.cu's fit kernels (cuobjdump, beside
nvcc) to FILE and prints, per kernel, its f64 instructions by opcode (a
static count: every path of the code once), with ptxas's lines for
moments.cu (registers, spills); --paths keeps the named paths alone.

--root DIR imports rmi_tpu_torch from DIR, a checkout of another commit:
run both in one command, in turns, to compare them on one card.  With
--errors DIR each path's warm build also saves its leaf errors and
metrics under DIR/<checkout's name>/, and is held to those of every other
checkout already saved there: how many leaf errors differ, and both
max_err and avg_log2.  Prints the card's name and power limit first, a
line per measurement and one JSON line last.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
CALLS = 10
# chip_smoke.py's paths 1, 3, 4, 5 and 8 (path 8's B at 200M keys)
PATHS = (("path 1", "cubic,linear", 262144, "u64"), ("path 3", "cubic,loglinear", 65536, "u64"),
         ("path 4", "cubic,normal", 65536, "u64"), ("path 5", "radix18,linear", 65536, "u64"),
         ("path 8", "linear,linear", 100, "u32"))


def _sass(lib_path, nvcc, out_file, build_log):
    """Write the SASS of moments.cu's fit kernels to ``out_file``; print
    each one's f64 instructions by opcode and ptxas's lines for them."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, keep, name = {}, [], None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "fit_" in m.group(1) else None
            if name:
                counts[name] = collections.Counter()
        if name is None:
            continue
        keep.append(line)
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9]+)*)", line)
        if op and (op.group(1)[0] == "D" or op.group(1).startswith("MUFU")):
            counts[name][op.group(1)] += 1
    with open(out_file, "w") as f:
        f.write("\n".join(keep) + "\n")
    for name, c in counts.items():
        print(f"sass {name}: {sum(c.values())} f64 instructions {dict(sorted(c.items()))}",
              flush=True)
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "fit_" in line and "Compiling entry function" in line:
            print("ptxas " + " | ".join(lines[i:i + 4]), flush=True)


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


def _ranges(rmi_tpu_torch, data, spec, B):
    """(device ms of the rmi.build.* ranges of one traced warm build, the
    build)."""
    rmi_tpu_torch.train(data, spec, B)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        rmi = rmi_tpu_torch.train(data, spec, B)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():       # a range's host span and its device span
        if e.key.startswith("rmi.build."):
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            out[e.key] = max(out.get(e.key, 0.0), us / 1e3)
    return out, rmi


def _errors(rmi, errors_dir, root, label):
    """Save the build's leaf errors and metrics under errors_dir/<root's
    name>/ and compare them with each other checkout's saved there."""
    mine = os.path.basename(os.path.abspath(root))
    path = os.path.join(errors_dir, mine)
    os.makedirs(path, exist_ok=True)
    errs = rmi.leaf_errors.cpu().numpy()
    metrics = [rmi.model_max_error, rmi.model_max_error_idx, rmi.model_avg_log2_error]
    np.save(os.path.join(path, f"{label.replace(' ', '_')}.npy"), errs)
    with open(os.path.join(path, f"{label.replace(' ', '_')}.json"), "w") as f:
        json.dump(metrics, f)
    out = {"max_err": metrics[0], "max_err_leaf": metrics[1], "avg_log2": metrics[2]}
    for other in sorted(os.listdir(errors_dir)):
        theirs = os.path.join(errors_dir, other, f"{label.replace(' ', '_')}.npy")
        if other == mine or not os.path.exists(theirs):
            continue
        e = np.load(theirs)
        with open(theirs[:-4] + ".json") as f:
            m = json.load(f)
        out[f"against {other}"] = {
            "leaf_errors_differing": int((e != errs).sum()),
            "max_abs_diff": int(np.abs(e - errs).max()), "max_err": m[0],
            "max_err_leaf": m[1], "avg_log2": m[2]}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--n", type=int, default=200_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--errors", default=None, help="directory to save and compare leaf errors in")
    ap.add_argument("--sass", default=None, help="file for the fit kernels' SASS")
    ap.add_argument("--paths", default=None, help="comma-separated labels of PATHS to run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import rmi_tpu_torch
    from rmi_tpu_torch import config, data as rdata
    from rmi_tpu_torch import keys as keymod
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.models.base import model_float_input
    from rmi_tpu_torch.models.linear import log_targets
    from rmi_tpu_torch.ops import _build, scan_kernel, select_kernel
    from rmi_tpu_torch.train import two_layer
    from rmi_tpu_torch.utils import segments as seg

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    print(f"rmi_tpu_torch from {os.path.abspath(args.root)}", flush=True)
    if args.sass:
        _build.library()
        _sass(_build.build_info["path"], config.nvcc_path(), args.sass,
              _build.build_info.get("log", ""))
    u = rdata.books_like_on_device(args.n, args.seed, dev)
    typed = {"u64": (u, KeyType.U64),
             "u32": ((keymod.u64_bits(u) >> 30).add_(keymod.IMAGE_MIN), KeyType.U32)}
    has_entries = hasattr(select_kernel, "aug_fit_moments")
    has_log = hasattr(select_kernel, "aug_fit_log_moments")
    out = {"root": os.path.abspath(args.root), "n": args.n, "paths": {}}
    wanted = None if args.paths is None else set(args.paths.split(","))
    for label, spec, B, kind in PATHS:
        if wanted is not None and label not in wanted:
            continue
        keys, key_type = typed[kind]
        n = keys.shape[0]
        B = B if kind == "u64" else max(2, B * n // 200_000_000)
        data = rdata.RMIDataset(keys, key_type)
        ranges, rmi = _ranges(rmi_tpu_torch, data, spec, B)
        row = {"spec": spec, "B": B, "ranges_ms": ranges}
        if args.errors:
            row["errors"] = _errors(rmi, args.errors, args.root, label)
            print(f"{label} leaf errors: {json.dumps(row['errors'])}", flush=True)
        del rmi
        top, leaf = (get_model(m) for m in spec.split(","))
        kminf, s = two_layer.norm_constants(keys, key_type)
        yfix = two_layer.fixdups_i32(keys)
        top_in = model_float_input(top, keys, kminf, s, key_type)
        _, t, _ = two_layer._assign_body(top_in, yfix, top_type=top.name, B=B, keys=keys,
                                         key_type=key_type)
        del top_in
        leaf_in = model_float_input(leaf, keys, kminf, s, key_type)
        spans = seg.make_spans(t, B)
        del t
        row["fixdups_ms"] = _ms(lambda: two_layer.fixdups_i32(keys), args.reps)
        row["fit_leaves_ms"] = _ms(lambda: leaf.fit_leaves(leaf_in, yfix, spans), args.reps)
        lo, hi = spans.aug_starts, spans.aug_ends
        if has_entries and leaf.name in ("linear", "normal"):
            y = yfix if leaf.name == "linear" else None
            per_key = 12 if y is not None else 8
            means = select_kernel.aug_fit_moments(leaf_in, y, lo, hi)
            row["aug_fit_moments_ms"] = _ms(
                lambda: select_kernel.aug_fit_moments(leaf_in, y, lo, hi), args.reps)
            row["aug_fit_moments_bound_ms"] = per_key * n / HBM_BYTES_PER_S * 1e3
            if y is None:
                row["k2_ms"] = _ms(lambda: select_kernel.aug_centered_xx(
                    leaf_in, means[0], lo, hi), args.reps)
            else:
                yf = yfix.double()
                row["k2_ms"] = _ms(lambda: select_kernel.aug_centered_moments(
                    leaf_in, yf, means[0], means[1], lo, hi), args.reps)
                del yf
        if leaf.name == "loglinear":
            if has_log:
                _, mx, my, _, _ = select_kernel.aug_fit_log_moments(leaf_in, yfix, lo, hi)
                row["aug_fit_log_moments_ms"] = _ms(
                    lambda: select_kernel.aug_fit_log_moments(leaf_in, yfix, lo, hi), args.reps)
                row["aug_fit_log_moments_bound_ms"] = 12 * n / HBM_BYTES_PER_S * 1e3
            ln, w = log_targets(yfix.double())
            if not has_log:          # the fit's means as the checkout's chain takes them
                cnt, sx, sy = seg.aug_masked_stats(spans, w, leaf_in, ln)
                mx, my = sx / cnt.clamp(min=1.0), sy / cnt.clamp(min=1.0)
            row["k2_ms"] = _ms(lambda: select_kernel.aug_centered_moments(
                leaf_in, ln, mx, my, lo, hi, weights=w), args.reps)
            del ln, w
        if has_entries and hasattr(scan_kernel, "fixdups"):
            row["rmi_fixdups_bound_ms"] = 12 * n / HBM_BYTES_PER_S * 1e3
        out["paths"][label] = row
        rng = ", ".join(f"{k} {v:.3f}" for k, v in sorted(row["ranges_ms"].items()))
        line = (f"{label} {spec} {B} ({kind}): device ms {rng}; FixDups "
                f"{row['fixdups_ms'][0]:.4f} ms ({row['fixdups_ms'][1]:.4f}-"
                f"{row['fixdups_ms'][2]:.4f}); fit_leaves {row['fit_leaves_ms'][0]:.4f} ms "
                f"({row['fit_leaves_ms'][1]:.4f}-{row['fit_leaves_ms'][2]:.4f})")
        for entry in ("aug_fit_moments", "aug_fit_log_moments"):
            if f"{entry}_ms" in row:
                f, bound = row[f"{entry}_ms"], row[f"{entry}_bound_ms"]
                line += (f"; rmi_{entry} {f[0]:.4f} ms ({f[1]:.4f}-{f[2]:.4f}), bound "
                         f"{bound:.4f}, share {bound / f[0]:.3f}")
        if "k2_ms" in row:
            k2 = row["k2_ms"]
            line += f"; K2 on the same spans {k2[0]:.4f} ({k2[1]:.4f}-{k2[2]:.4f})"
        print(line, flush=True)
        del data, yfix, leaf_in, spans
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
