"""Where the time goes in one rmi_tpu_torch build and search on a CUDA card.

    python3 tools/trace_torch_build.py [--n 200000000] [--spec cubic,linear]
                                       [--B 262144] [--trace build_trace.json]
    python3 tools/trace_torch_build.py --paths [--root DIR]
    python3 tools/trace_torch_build.py --dp [--spec cubic,linear] [--B 262144]
                                       [--n 200000000] [--root DIR]

Makes books-like keys on the card (as chip_smoke.py does), runs one
untraced build and search to warm up, then traces with torch.profiler a
warm build of ``--spec`` with ``--B`` leaves (chip_smoke.py's first path
by default; its others are ``--spec robust_linear,cubic``,
``--spec cubic,loglinear``, ``--spec cubic,normal`` and
``--spec radix18,linear``, each with ``--B 65536``), and
apart from it SEARCH_BATCHES search batches of 2^22 random queries
(sort -> K5 -> unsort).  For each
trace it prints the device time of the rmi.* ranges (the build stages of
train/two_layer.py), the kernels by device time, the device's busy
share of the traced wall time, the warm build's peak device memory, and
any scatter operation it saw (the build takes its per-leaf maxima inside
kernels and should show none, but for hint-table leaves, which are swept
in torch).

--paths traces the warm builds of chip_smoke.py's paths 1-5 and 8
(PATHS; path 8 on the keys shifted right by 30, u32, as chip_smoke's
typed_keys makes them) in turn, in one process, and no search, and after
each build its stage A alone (two_layer's rmi.build.assign: the norm
constants, the top's input, FixDups, _assign_body), with the device
launches it makes in all and by kernel, then its stage B leaf fit alone
(the leaf model's fit_leaves on that stage A's FixDups and spans), its
device kernels by name and its peak device memory above what it was
given; --root DIR imports rmi_tpu_torch
from DIR, a checkout of another commit, so that two commits' stage
splits are taken with one tool on one card.

--dp traces the data-parallel build (parallel/dp_trainer.py) of --spec
with --B leaves by one NCCL rank on card 0 (multihost.run_ranks), its
shard all --n keys: a cold build and DP_WARM warm ones (their median),
then one warm build traced
(its device ms, the idle share of its wall time, the kernels by device
time, the peak device memory of the warm builds) and one more under
OpCensus, which lists each torch operator that read or wrote m = --n
elements or more (by name, with its count), and under torch.profiler
with the inputs' shapes, which counts the device operations launched by
a torch operator given m elements or more (device_ops_over): in this
tree the build's passes over the keys are the port's kernels, whose
launches the binding makes without a torch operator, so both are empty.  The census and
its rule (m_sized) are this file's, so --root times another checkout's
dp build with the same census.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = 1 << 22
DP_WARM = 5               # warm dp builds timed (--dp); the median is reported
SEARCH_BATCHES = 5
# chip_smoke.py's build paths 1-5 and 8: (spec, B, key kind)
PATHS = (("cubic,linear", 262144, "u64"), ("robust_linear,cubic", 65536, "u64"),
         ("cubic,loglinear", 65536, "u64"), ("cubic,normal", 65536, "u64"),
         ("radix18,linear", 65536, "u64"), ("linear,linear", 100, "u32"))


# torch operators that read a few elements of a large input (a binary
# search, a gather by a short index): what they read is what they write
READS_FEW = ("aten::searchsorted", "aten::index", "aten::index_select", "aten::gather",
             "aten::take", "aten::_local_scalar_dense")


class OpCensus(TorchDispatchMode):
    """Every torch operator dispatched while it is on: (name, elements of
    the largest tensor it reads, of the largest it writes, whether it is a
    view).  A kernel of the port, launched by its binding, dispatches no
    operator and is not seen."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func._schema.name
        # a view returns an alias of an input and writes none (its schema's
        # Tensor(a), where an in-place op's is Tensor(a!))
        aliases = [r.alias_info for r in func._schema.returns]
        view = bool(aliases) and all(a is not None and not a.is_write for a in aliases)
        self.ops.append((name, max((t.numel() for t in ins), default=0),
                         max((t.numel() for t in outs), default=0), view))
        return out


def m_sized(ops, m: int) -> dict:
    """{operator name: count} of the census' operators over m elements:
    those that wrote m or more, or read m or more (READS_FEW: as many as
    they wrote); views, which move no element, are not counted."""
    found = {}
    for name, read, wrote, view in ops:
        if view:
            continue
        if max(wrote if name in READS_FEW else read, wrote) >= m:
            found[name] = found.get(name, 0) + 1
    return found


def _numel(shape):
    """Elements of a profiler-recorded input shape ([] for a non-tensor;
    a list of shapes, a tensor list, counted by its largest)."""
    if not shape:
        return 0
    if isinstance(shape[0], (list, tuple)):
        return max((_numel(s) for s in shape), default=0)
    out = 1
    for d in shape:
        out *= int(d)
    return out


def device_ops_over(prof, m: int) -> dict:
    """{operator name: device launches} from a torch.profiler trace taken
    with record_shapes: the device operations launched by a torch
    operator that was given an input of m elements or more (READS_FEW
    excepted: they read a few of them)."""
    found = {}
    for e in prof.events():
        if not e.name.startswith("aten::") or e.name in READS_FEW:
            continue
        launched = len(getattr(e, "kernels", []) or [])
        if launched and max((_numel(sh) for sh in (e.input_shapes or [])), default=0) >= m:
            found[e.name] = found.get(e.name, 0) + launched
    return found


def _dp_rank(rank, root, n, seed, spec, B):
    """The --dp trace, on the one rank: its report as a list of lines."""
    sys.path.insert(0, os.path.abspath(root))
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.parallel import dp_trainer
    dev = torch.device("cuda", torch.cuda.current_device())
    keys = rdata.books_like_on_device(n, seed, dev)
    keys_local, n = dp_trainer.local_shard(keys, KeyType.U64)
    del keys
    top, leaf = spec.split(",")

    def build():
        out = dp_trainer.dp_train_two_layer(keys_local, n, KeyType.U64, top, leaf, B)
        torch.cuda.synchronize()
        return out
    build()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(DP_WARM):
        t0 = time.perf_counter()
        build()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        build()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    census = OpCensus()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as shapes, census:
        build()
    lines = [f"dp build {spec} B={B} n={n}, one NCCL rank: warm median "
             f"{walls[DP_WARM // 2] * 1e3:.3f} ms of {DP_WARM} "
             f"({', '.join(f'{w * 1e3:.3f}' for w in walls)}), peak device memory {peak:.2f} GiB"]
    lines += _report_lines(prof, wall, f"dp build {spec} B={B} n={n} (traced)", 25)
    big = m_sized(census.ops, keys_local.shape[0])
    lines.append(f"  torch operators over m = {keys_local.shape[0]} elements: "
                 + (", ".join(f"{k} x{c}" for k, c in sorted(big.items())) or "none")
                 + f" (of {len(census.ops)} operators)")
    over = device_ops_over(shapes, keys_local.shape[0])
    lines.append("  device operations of torch operators given m elements or more "
                 "(profiler): " + (", ".join(f"{k} x{c}" for k, c in sorted(over.items()))
                                   or "none"))
    return lines


def dp_main(args):
    """--dp: one NCCL rank on card 0 traces the dp build (_dp_rank)."""
    import tempfile
    sys.path.insert(0, os.path.abspath(args.root))
    from rmi_tpu_torch.ops import _build
    from rmi_tpu_torch.parallel import multihost
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"rmi_tpu_torch from {os.path.abspath(args.root)}")
    _build.library()            # built here once; the rank loads it
    with tempfile.TemporaryDirectory() as tmp:
        (lines,) = multihost.run_ranks(
            _dp_rank, 1, f"file://{tmp}/rdv", backend="nccl", device="cuda:0",
            args=(args.root, args.n, args.seed, args.spec, args.B), timeout=1800)
    print("\n".join(lines))


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
    ap.add_argument("--spec", default="cubic,linear")
    ap.add_argument("--B", type=int, default=262144)
    ap.add_argument("--trace", default=None, help="chrome trace output path")
    ap.add_argument("--paths", action="store_true", help="trace paths 1-5 (PATHS)")
    ap.add_argument("--root", default=REPO, help="checkout to import rmi_tpu_torch from")
    ap.add_argument("--dp", action="store_true",
                    help="trace the dp build by one NCCL rank")
    args = ap.parse_args()
    if args.dp:
        return dp_main(args)
    sys.path.insert(0, os.path.abspath(args.root))
    import rmi_tpu_torch
    from rmi_tpu_torch import config, data as rdata
    from rmi_tpu_torch import keys as keymod
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.models.base import model_float_input
    from rmi_tpu_torch.train import two_layer
    from rmi_tpu_torch.utils import segments as seg

    dev = config.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    keys = rdata.books_like_on_device(args.n, args.seed, dev)
    typed = {"u64": rdata.RMIDataset(keys, KeyType.U64),
             "u32": rdata.RMIDataset((keymod.u64_bits(keys) >> 30).add_(keymod.IMAGE_MIN),
                                     KeyType.U32)}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    q = torch.randint(int(keys[0]), int(keys[-1]), (QUERIES,),
                      generator=gen, device=dev)
    print(f"rmi_tpu_torch from {os.path.abspath(args.root)}")
    for spec, B, kind in PATHS if args.paths else ((args.spec, args.B, "u64"),):
        data = typed[kind]
        rmi = rmi_tpu_torch.train(data, spec, B)   # warm-up
        del rmi
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            rmi = rmi_tpu_torch.train(data, spec, B)
            torch.cuda.synchronize()
            build_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        _report(prof, build_wall, f"n={args.n} {spec} B={B}: build", 25)
        print(f"  peak device memory {peak / 2**30:.2f} GiB")
        if args.trace:
            os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
            prof.export_chrome_trace(args.trace)
        if args.paths:
            del rmi
            top = get_model(spec.split(",")[0])

            def stage_a():
                kminf, s = two_layer.norm_constants(data.keys, data.key_type)
                top_in = model_float_input(top, data.keys, kminf, s, data.key_type)
                yfix = two_layer.fixdups_i32(data.keys)
                _, t, _ = two_layer._assign_body(top_in, yfix, top_type=top.name, B=B,
                                                 keys=data.keys, key_type=data.key_type)
                return kminf, s, yfix, t
            stage_a()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                kminf, s, yfix, t = stage_a()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = sum(e.count for e in prof.key_averages()
                           if _on_device(e) and not e.key.startswith("rmi."))
            print(f"  stage A alone: {launches} device launches")
            _report(prof, wall, f"n={args.n} {spec} B={B}: stage A alone", 12)
            leaf = get_model(spec.split(",")[1])
            leaf_in = model_float_input(leaf, data.keys, kminf, s, data.key_type)
            spans = seg.make_spans(t, B)
            del t
            leaf.fit_leaves(leaf_in, yfix, spans)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                leaf.fit_leaves(leaf_in, yfix, spans)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = sum(e.count for e in prof.key_averages()
                           if _on_device(e) and not e.key.startswith("rmi."))
            print(f"  stage B's leaf fit alone: {launches} device launches, peak device "
                  f"memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
                  f"above its inputs")
            _report(prof, wall, f"n={args.n} {spec} B={B}: stage B's leaf fit alone", 12)
            del leaf_in, yfix, spans
    if args.paths:
        return
    data = typed["u64"]
    rmi_tpu_torch.search(rmi, q)          # the plan is made on first use
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(SEARCH_BATCHES):
            with record_function("rmi.search"):
                rmi_tpu_torch.search(rmi, q)
        torch.cuda.synchronize()
        search_wall = time.perf_counter() - t0
    _report(prof, search_wall,
            f"search, {SEARCH_BATCHES} batches of {QUERIES} queries", 15)


def _report(prof, wall_s, label, top):
    print("\n".join(_report_lines(prof, wall_s, label, top)))


def _report_lines(prof, wall_s, label, top):
    evts = prof.key_averages()
    lines = [f"{label}: wall {wall_s * 1e3:.3f} ms"]
    # a range appears twice: its host span and its span on the device
    for key in sorted({e.key for e in evts if e.key.startswith("rmi.")}):
        same = [e for e in evts if e.key == key]
        lines.append(f"  range {key:18s} host "
                     f"{max(e.cpu_time_total for e in same) / 1e3:9.3f} ms  device "
                     f"{max(_dev_us(e) for e in same) / 1e3:9.3f} ms")
    kernels = [e for e in evts if _on_device(e) and not e.key.startswith("rmi.")]
    busy = sum(_dev_us(e, True) for e in kernels) / 1e3
    wall = wall_s * 1e3
    lines.append(f"  device busy {busy:.3f} ms of {wall:.3f} ms traced wall "
                 f"(idle share {1 - busy / wall:.3f}), {sum(e.count for e in kernels)} "
                 f"device launches")
    scatters = sorted({e.key for e in evts if "scatter" in e.key.lower()})
    lines.append(f"  scatter operations traced: {scatters or 'none'}")
    for e in sorted(kernels, key=lambda e: -_dev_us(e, True))[:top]:
        lines.append(f"  {_dev_us(e, True) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    return lines


if __name__ == "__main__":
    main()
