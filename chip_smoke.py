"""Drive rmi_tpu_torch once on one CUDA card and check every kernel.

    python3 chip_smoke.py              # 200M keys, all four paths
    python3 chip_smoke.py --n 2000000  # a shorter run

Phases (any failure raises and exits non-zero):
  1. the card: name and power limit as nvidia-smi reports them;
  2. the kernels: built from csrc/ with nvcc, build time printed;
  3. path 1 on books-like u64 keys made on the card from a seed:
     ``train(data, "cubic,linear", 262144)`` cold and warm, then lookup,
     search of 2^22 random queries (torch.sort, then K5's scatter entry,
     at the default size) and search_sorted of the same queries sorted
     (K5); every kernel of the path must have launched in that run, and
     the keys made twice and the two builds must be bit-equal;
  4. the bound |guess - lower_bound| <= err on sampled keys, whose
     lookup must launch K4's fused entry (rmi_lookup_<leaf>) and nothing
     else; lookup of the random queries too, both replayed in phase 7;
  5. exact search against torch.searchsorted: search and search_sorted
     of the path, then search, search_sorted and fast_search on 2^16
     queries (the packed plan); the search rate;
  5b. K5 on that batch (k5_phase): the share of blocks whose window
     exceeds the shared-memory stage, search's device time split into
     the sort and K5 with its scatter, and K5 at sample levels 8 and 16
     timed in turns, both checked against torch.searchsorted;
  6. the serving curve: lookups/s at 2^14 ... 2^22 queries for the
     bounded path, the packed plan, sort -> K5 -> unsort without the
     density gate, and search_sorted on sorted batches;
  7. each kernel of the path replayed on the inputs the path gave it,
     against its plain PyTorch version: K1, K2, the run-length pass, K5,
     K5's scatter entry and K4's fused lookup entry on the card (guess and
     err bit-equal; lookup also timed against the two-step route it
     replaced), K3 (the per-leaf maxima, which must be equal) and K4's
     per-element entry on CPU copies (CPU torch.addcmul is an exact FMA),
     the latter also on lookup's own x and leaf ids at 2^22 queries,
     where it is timed;
  8. a build on the card against the plain build on the CPU;
  9. path 2 on the same keys, once path 1's index is freed:
     ``train(data, "robust_linear,cubic", 65536)`` cold and warm (bit-
     equal), its max_err and its index, phases 3-5 for it, then K3 and K4
     for cubic leaves (on CPU copies) and K6 (on the card) replayed
     against their plain versions, and its card-vs-CPU cross-check;
 10. path 3, ``train(data, "cubic,loglinear", 65536)``, the same way,
     replaying K2's weighted variant on the card and K3 and K4 for
     loglinear leaves on CPU copies;
 11. path 4, ``train(data, "cubic,normal", 65536)``, the same way,
     replaying K2's variance-only variant and K3 and K4 for normal leaves;
 12. a ``cubic,lognormal`` build on the card against the CPU build, at
     the paths' keys per leaf and at 64 keys per leaf, its normal-leaf K3
     and K4 calls (on max(ln x, 0), computed outside the kernels)
     replayed against their plain versions;
 13. the nine card probes (rmi_tpu_torch/ops/probe_kernels.py, the
     kernels of tools/probe_torch_kernels.py), each run once on its
     probe's inputs (D at widths 128 and 2048) with the launches counted
     from 0, its output held equal to its plain version's on the card;
     each probe's device time per call (a profiler trace of 200 calls)
     logged beside its library call's.
Each row of the kernels line carries the kernel's time on its path's
largest call (a call under 0.1 ms: the median of five runs of at least
5 ms of calls, logged with their spread) beside the plain version's and,
where one PyTorch call
computes the same function, that call's (library_ms), and the least time
the card could take for the call (bound_ms): the bytes its tensors hold,
each input read once and each output written once (K5: the queries, the
answers, and the 32-byte sectors of keys that decide each answer and
each block's binary search over its stripes; the scatter entry adds its
order), at 3.35 TB/s, or its operations at the
peak rate of their type, whichever is larger.
The last line is the device JSON; the line before it lists the kernels,
one row per C entry point.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

import rmi_tpu_torch
from rmi_tpu_torch import config, lookup_fast
from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch import data as rdata
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.lookup import bounded_search, lookup, search, search_sorted
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.base import kernel_input, model_float_input, predict_top_assignment
from rmi_tpu_torch.ops import (_build, cubic_l1_kernel, eval_kernel, probe_kernels,
                               scan_kernel, select_kernel, sorted_serve_kernel,
                               sweep_kernel)
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

K2_RTOL = 1e-9            # summation order
METRIC_RTOL = 1e-7
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 bandwidth
F64_OPS_PER_S = 34e12         # NVIDIA's data sheet, f64 outside the tensor cores
F32_OPS_PER_S = 67e12         # the same data sheet, f32 outside the tensor cores
INT_OPS_PER_S = 33.5e12       # int32 lanes: half the H100 SXM's 67 TFLOP/s of f32 lanes
SECTOR_BYTES = 32             # the least a load moves from device memory

# one row per C entry point: (entry, module, wrapper name, plain version
# name, device the plain version is compared on (None: the card), source,
# TPU kernel replaced); first the kernels of the build and serving paths
PATH_KERNELS = [
    ("rmi_scan_i32", scan_kernel, "scan_i32", "scan_i32_plain", None,
     "rmi_tpu_torch/csrc/scan.cu", "rmi_tpu/ops/scan_kernel.py:35"),
    ("rmi_aug_moments", select_kernel, "aug_centered_moments",
     "aug_centered_moments_plain", None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    ("rmi_aug_moments_weighted", select_kernel, "aug_centered_moments",
     "aug_centered_moments_plain", None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    ("rmi_aug_moments_xx", select_kernel, "aug_centered_xx", "aug_centered_xx_plain",
     None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    ("rmi_sweep_max_linear", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    ("rmi_sweep_max_cubic", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    ("rmi_sweep_max_loglinear", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    ("rmi_sweep_max_normal", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    # the reverse running min of _run_lengths_i32 and the max over it
    ("rmi_span_run_max", sweep_kernel, "span_run_max", "span_run_max_plain", None,
     "rmi_tpu_torch/csrc/run_max.cu", "rmi_tpu/ops/scan_kernel.py:35"),
    ("rmi_leaf_eval_linear", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    ("rmi_leaf_eval_cubic", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    ("rmi_leaf_eval_loglinear", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    ("rmi_leaf_eval_normal", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    # lookup whole in one launch, held to its plain route on the card
    *[(f"rmi_lookup_{k}", eval_kernel, "lookup_clamped", "lookup_clamped_plain", None,
       "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39")
      for k in eval_kernel.LEAF_KERNELS],
    ("rmi_serve_sorted", sorted_serve_kernel, "serve_sorted", "serve_sorted_plain",
     None, "rmi_tpu_torch/csrc/sorted_serve.cu",
     "rmi_tpu/ops/sorted_serve_kernel.py:88"),
    ("rmi_serve_sorted_scatter", sorted_serve_kernel, "serve_sorted_scatter",
     "serve_sorted_scatter_plain", None, "rmi_tpu_torch/csrc/sorted_serve.cu",
     "rmi_tpu/ops/sorted_serve_kernel.py:88"),
    ("rmi_cubic_l1", cubic_l1_kernel, "cubic_l1_sums", "cubic_l1_sums_plain", None,
     "rmi_tpu_torch/csrc/cubic_l1.cu", "rmi_tpu/ops/select_kernel.py:30"),
]
# then the card probes, driven by their own phase
PROBE_KERNELS = [
    (p.entry, probe_kernels, p.wrapper.__name__, p.plain.__name__, None,
     "rmi_tpu_torch/csrc/probes.cu", p.replaces) for p in probe_kernels.PROBES]
KERNELS = PATH_KERNELS + PROBE_KERNELS
# (spec, B, the C entry points the path launches, those it replays)
# search launches K5's scatter entry, search_sorted K5 itself
K5 = ("rmi_serve_sorted", "rmi_serve_sorted_scatter")
RUN_MAX = "rmi_span_run_max"
# K4: the build's epsilon probes launch the per-element entry, lookup the fused one
PATH1 = ("cubic,linear", 262144,
         ("rmi_scan_i32", "rmi_aug_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5),
         ("rmi_scan_i32", "rmi_aug_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5))
PATH2 = ("robust_linear,cubic", 65536,
         ("rmi_scan_i32", "rmi_sweep_max_cubic", RUN_MAX, "rmi_leaf_eval_cubic",
          "rmi_lookup_cubic", *K5, "rmi_cubic_l1"),
         ("rmi_sweep_max_cubic", RUN_MAX, "rmi_leaf_eval_cubic", "rmi_lookup_cubic",
          "rmi_cubic_l1"))
PATH3 = ("cubic,loglinear", 65536,
         ("rmi_scan_i32", "rmi_aug_moments_weighted", "rmi_sweep_max_loglinear", RUN_MAX,
          "rmi_leaf_eval_loglinear", "rmi_lookup_loglinear", *K5),
         ("rmi_aug_moments_weighted", "rmi_sweep_max_loglinear", RUN_MAX,
          "rmi_leaf_eval_loglinear", "rmi_lookup_loglinear"))
PATH4 = ("cubic,normal", 65536,
         ("rmi_scan_i32", "rmi_aug_moments_xx", "rmi_sweep_max_normal", RUN_MAX,
          "rmi_leaf_eval_normal", "rmi_lookup_normal", *K5),
         ("rmi_aug_moments_xx", "rmi_sweep_max_normal", RUN_MAX, "rmi_leaf_eval_normal",
          "rmi_lookup_normal"))
# the lognormal cross-check's build, and the entries replayed from it
LOGNORMAL = ("cubic,lognormal", 65536, (),
             ("rmi_sweep_max_normal", RUN_MAX, "rmi_leaf_eval_normal"))
CURVE = [1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22]   # serving curve batch sizes
SEARCH_TRACED = 5         # search batches the K5 phase traces


def log(*a):
    print(*a, flush=True)


class Recorder:
    """Keeps the arguments of every call of the kernel wrappers while
    installed, so each kernel can be replayed on a path's inputs."""

    def __init__(self):
        self.wrappers = {(mod, name) for _, mod, name, *_ in PATH_KERNELS}
        self.calls = {name: [] for _, name in self.wrappers}
        self._saved = []

    def __enter__(self):
        self._saved = []
        for mod, name in self.wrappers:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def rec(*args, _fn=fn, _name=name, **kw):
                self.calls[_name].append((args, kw))
                return _fn(*args, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def calls_of(self, entry, name):
        """The recorded calls of wrapper ``name`` that launch ``entry``:
        K2 launches one entry point per variant, K3 and K4 one per leaf
        kernel."""
        return [(a, kw) for a, kw in self.calls[name]
                if entry_of(name, kw) in (None, entry)]


def entry_of(name, kw):
    """The C entry point a call of wrapper ``name`` with keywords ``kw``
    launches, where the wrapper has more than one."""
    if name == "aug_centered_moments":
        return "rmi_aug_moments" if kw.get("weights") is None else "rmi_aug_moments_weighted"
    if name == "lookup_clamped":       # a lognormal top or leaf: the two-step route
        kernel = get_model(kw["leaf_type"]).leaf_kernel
        return (f"rmi_lookup_{kernel}" if eval_kernel.fused_lookup(kw["top_type"],
                                                                    kw["leaf_type"])
                else f"rmi_leaf_eval_{kernel}")
    if "leaf_type" in kw:
        prefix = {"sweep_leaf_max": "rmi_sweep_max_",
                  "leaf_eval_clamped": "rmi_leaf_eval_"}
        return prefix[name] + get_model(kw["leaf_type"]).leaf_kernel
    return None


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


SHORT_MS = 0.1            # calls shorter than this are timed in runs of RUN_MS
RUN_MS = 5.0
RUNS = 5


def row_ms(fn, iters):
    """(ms per call, (least, most)): over ``iters`` calls, or for a call
    under SHORT_MS the median of RUNS runs of at least RUN_MS of calls
    each, with the runs' spread."""
    ms = cuda_ms(fn, iters)
    if ms >= SHORT_MS:
        return ms, (ms, ms)
    reps = max(iters, math.ceil(RUN_MS / max(ms, 1e-4)))
    runs = sorted(cuda_ms(fn, reps) for _ in range(RUNS))
    return runs[RUNS // 2], (runs[0], runs[-1])


def spread(t):
    return f"{t[0]:.4f} ms ({t[1][0]:.4f}-{t[1][1]:.4f})"


def plain_args(name, args, kw, where):
    """Arguments of the plain version on ``where`` (None: where they
    are); K1's plain version takes no fill, lookup's none of the kernel's
    lookup table."""
    def move(a):
        return a.to(where or a.device) if torch.is_tensor(a) else a
    args = [move(a) for a in args]
    kw = {k: move(v) for k, v in kw.items()
          if (name, k) not in (("scan_i32", "fill"), ("lookup_clamped", "table"))}
    return args, kw


def compare(name, got, want, args, kw):
    """(max abs error, ok) of a kernel output against its plain version."""
    if name == "aug_centered_moments":
        x, y, mean_x, mean_y, lo, hi = [a.cpu() for a in args]
        w = kw.get("weights")
        (m2, c), (wm2, wc) = [[t.cpu() for t in r] for r in (got, want)]
        syy = select_kernel.aug_centered_moments_plain(
            y, y, mean_y, mean_y, lo, hi, weights=None if w is None else w.cpu())[0]
        tol_m2 = K2_RTOL * wm2.abs()
        tol_c = K2_RTOL * wc.abs() + 1e-12 * torch.sqrt(wm2.clamp(min=0) * syy)
        err = max(float((m2 - wm2).abs().max()), float((c - wc).abs().max()))
        ok = bool(((m2 - wm2).abs() <= tol_m2).all() and ((c - wc).abs() <= tol_c).all())
        return err, ok
    if name == "aug_centered_xx":
        m2, wm2 = got.cpu(), want.cpu()
        return (float((m2 - wm2).abs().max()),
                bool(((m2 - wm2).abs() <= K2_RTOL * wm2.abs()).all()))
    if name == "cubic_l1_sums":
        return compare_l1(got, want)
    if name == "lookup_clamped":      # (guess, err), both bit-equal
        diffs = [compare(None, g, w, args, kw) for g, w in zip(got, want)]
        return max(d[0] for d in diffs), all(d[1] for d in diffs)
    got, want = got.cpu().long(), want.cpu().long()
    err = int((got - want).abs().max()) if got.numel() else 0
    return err, bool(torch.equal(got, want))


def compare_l1(got, want):
    """K6: both sums within cubic_l1_kernel.sum_tolerance, and the choice
    l_err < c_err the same wherever the two sums are not a near tie, that
    is closer than their two tolerances."""
    (c, l), (wc, wl) = [[t.cpu() for t in r] for r in (got, want)]
    tc, tl = cubic_l1_kernel.sum_tolerance(wc), cubic_l1_kernel.sum_tolerance(wl)
    err = max(float((c - wc).abs().max()), float((l - wl).abs().max()))
    near_tie = (wl - wc).abs() <= tc + tl
    same_choice = ((l < c) == (wl < wc)) | near_tie
    log(f"  K6: {int(near_tie.sum())} near-tie leaves of {c.shape[0]}, "
        f"{int(((l < c) != (wl < wc)).sum())} choices differ")
    return err, bool(((c - wc).abs() <= tc).all() and ((l - wl).abs() <= tl).all()
                     and same_choice.all())


def check_kernels(rec, launches, entries):
    """Replay each of ``entries`` on its recorded calls against its plain
    version, and time its largest call (K4's per-element entries: on
    lookup's own inputs) beside the plain version."""
    rows = {}
    for entry, mod, name, plain_name, where, source, replaces in PATH_KERNELS:
        if entry not in entries:
            continue
        wrapper, plain = getattr(mod, name), getattr(mod, plain_name)
        calls = rec.calls_of(entry, name)
        if not calls:
            raise RuntimeError(f"{entry}: no call recorded on the path")
        worst = 0
        for args, kw in calls:
            worst = max(worst, replay(entry, name, wrapper, plain, where, args, kw))
        # time the largest call: kernel, plain version and library call
        # on the card, and its bound
        args, kw = max(calls, key=lambda c: c[0][0].shape[0])
        if name == "leaf_eval_clamped":
            lookups = [c for c in rec.calls["lookup_clamped"]
                       if get_model(c[1]["leaf_type"]).leaf_kernel
                       == get_model(kw["leaf_type"]).leaf_kernel]
            if lookups:
                out = wrapper(*args, **kw)
                log(f"kernel {entry} at {list(args[0].shape)} (the build's epsilon "
                    f"probes): {spread(row_ms(lambda: wrapper(*args, **kw), 10))}")
                del out
                args, kw = lookup_leaf_call(*max(lookups, key=lambda c: c[0][0].shape[0]))
                worst = max(worst, replay(entry, name, wrapper, plain, where, args, kw))
        pa, pk = plain_args(name, args, kw, args[0].device)
        out = wrapper(*args, **kw)
        ms = row_ms(lambda: wrapper(*args, **kw), 10)
        plain_ms = row_ms(lambda: plain(*pa, **pk), 3)
        lib = library_call(name, args, kw)
        library_ms = None if lib is None else row_ms(lib, 10)
        nbytes, ops, peak = work(name, args, kw, out)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
        del out
        rows[entry] = {"name": entry, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[entry],
                       "max_abs_err": worst, "ms": ms[0], "plain_ms": plain_ms[0],
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None if library_ms is None else library_ms[0]}
        log(f"kernel {entry}: {len(calls)} calls on the path match the plain "
            f"version (max abs err {worst}); {spread(ms)} vs plain {spread(plain_ms)}, "
            f"library {library_ms and spread(library_ms)}, bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes / 1e9:.4f} GB, {ops:.4g} ops) at {list(args[0].shape)}")
        if name == "lookup_clamped":
            steps = row_ms(lambda: eval_kernel.lookup_steps(
                *args, kw["top_type"], kw["leaf_type"], eval_kernel.leaf_eval_clamped), 10)
            log(f"lookup {kw['top_type']},{kw['leaf_type']} at {list(args[0].shape)}: "
                f"fused {spread(ms)}, two steps (torch top eval, then "
                f"rmi_leaf_eval_*: the route before the fused entry) {spread(steps)}, "
                f"plain {spread(plain_ms)}; bound {bound_ms:.4f} ms")
    return rows


def replay(entry, name, wrapper, plain, where, args, kw):
    """A wrapper call against its plain version; its max abs error."""
    got = wrapper(*args, **kw)
    pa, pk = plain_args(name, args, kw, where)
    want = plain(*pa, **pk)
    err, ok = compare(name, got, want, args, kw)
    if not ok:
        raise RuntimeError(f"{entry}: kernel disagrees with its plain version "
                           f"(max abs err {err})")
    return err


def lookup_leaf_call(args, kw):
    """The per-element K4 call a lookup's leaf step makes: lookup's kernel
    input and leaf ids, bound n - 1 (eval_kernel.lookup_steps)."""
    queries, top_w, leaf_w, _, n, kminf, s = args
    mtop, mleaf = get_model(kw["top_type"]), get_model(kw["leaf_type"])
    x = kernel_input(mleaf, model_float_input(mleaf, queries, kminf, s))
    ids = predict_top_assignment(mtop, top_w, model_float_input(mtop, queries, kminf, s),
                                 leaf_w.shape[0] - 1)
    return (x, leaf_w, ids, n - 1), {"leaf_type": kw["leaf_type"]}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


# f64 operations per element of each leaf kernel (a division counted as one)
LEAF_OPS = {"linear": 2, "cubic": 6, "loglinear": 10, "normal": 14}


def work(name, args, kw, out):
    """(bytes, operations, peak operations/s) of one wrapper call: each
    input tensor read once and each output written once, and the
    arithmetic its elements need."""
    outs = list(out) if isinstance(out, tuple) else [out]
    if name == "scan_i32":
        n = args[0].shape[0]
        return _nbytes(args[0], *outs), n, INT_OPS_PER_S
    if name in ("aug_centered_moments", "aug_centered_xx"):
        lo, hi = args[-2:]
        per = 3 if name == "aug_centered_xx" else 6
        per += 0 if kw.get("weights") is None else 2
        return (_nbytes(*args, kw.get("weights"), *outs), int((hi - lo).sum()) * per,
                F64_OPS_PER_S)
    if name == "lookup_clamped":
        # the keys, the top row, each leaf's row and error read once (not
        # the lookup table's padding: what the function needs, not what
        # the kernel reads), guess and err written once; per query the
        # key's conversion and normalization (5), both models and their
        # floors and clamps (8)
        q, top_w, leaf_w, leaf_errors = args[:4]
        per = 13 + sum(LEAF_OPS[get_model(kw[k]).leaf_kernel]
                       for k in ("top_type", "leaf_type"))
        return (_nbytes(q, top_w, leaf_w, leaf_errors, *outs), q.shape[0] * per,
                F64_OPS_PER_S)
    if name in ("sweep_leaf_max", "leaf_eval_clamped"):
        per = LEAF_OPS[get_model(kw["leaf_type"]).leaf_kernel] + 4   # floor, clamps
        # K3: xn, yfix, the span bounds and the rows; K4: x, the rows, the leaf ids
        return (_nbytes(*(a for a in args if torch.is_tensor(a)), *outs),
                args[0].shape[0] * per, F64_OPS_PER_S)
    if name == "span_run_max":       # a compare, a subtraction and a max per key
        return _nbytes(*args, *outs), args[0].shape[0] * 3, INT_OPS_PER_S
    if name == "cubic_l1_sums":
        x, y, cubic_w, lin_w, spans = args
        elems = int((spans.aug_ends - spans.aug_starts).sum())
        return (_nbytes(x, y, cubic_w, lin_w, spans.aug_starts, spans.aug_ends, *outs),
                elems * 12, F64_OPS_PER_S)
    if name in ("serve_sorted", "serve_sorted_scatter"):
        # what the answers need, not what K5 reads: each query, window
        # bound and answer once (and the scatter's order); per answer lb
        # the sectors that hold keys[lb - 1] and keys[lb], each sector
        # once; per block a binary search of its window of stripe-first
        # keys (keys[::64], between its bounds), a sector per probe
        q, *rest = args
        order = rest.pop(0) if name == "serve_sorted_scatter" else None
        _, keys, lo, hi = rest
        n = keys.shape[0]
        near = torch.cat([(out - 1).clamp(0, n - 1), out.clamp(0, n - 1)])
        sectors = torch.unique(near // (SECTOR_BYTES // keys.element_size())).numel()
        window = (hi - lo + 1).clamp(min=1).double()
        probes = int(torch.log2(window).ceil().sum())
        nbytes = _nbytes(q, order, lo, hi, out) + SECTOR_BYTES * (sectors + probes)
        steps = math.log2(max(2.0, float(window.mean()))) + math.log2(sorted_serve_kernel.STRIPE)
        return nbytes, q.shape[0] * steps * 3, INT_OPS_PER_S      # int64 compare ~ 3 ops
    raise KeyError(name)


def library_call(name, args, kw):
    """One PyTorch call that computes the same function as the kernel,
    timed as a yardstick and used nowhere in the port, or None."""
    if name == "scan_i32":
        return (lambda: torch.cummax(args[0], 0)) if kw["is_max"] else \
            (lambda: torch.cummin(args[0], 0))
    if name == "serve_sorted":
        return lambda: torch.searchsorted(args[2], args[0])
    return None         # the scatter entry: no one call both searches and scatters


def bound_violations(rmi, keys, sample, gen):
    idx = torch.randint(0, keys.shape[0], (sample,), generator=gen, device=keys.device)
    q = keys[idx]
    guess, err = lookup(rmi, q)
    lb = torch.searchsorted(keys, q, side="left")
    return int(((guess - lb).abs() > err).sum())


def make_queries(keys, nq, gen):
    """Random images over the key range, plus out-of-range and existing
    (duplicate) keys."""
    dev = keys.device
    lo, hi = int(keys[0]), int(keys[-1])
    q = torch.randint(lo, hi, (nq,), generator=gen, device=dev, dtype=torch.int64)
    k = nq // 16
    q[:k] = keys[torch.randint(0, keys.shape[0], (k,), generator=gen, device=dev)]
    q[k:k + 8] = torch.tensor([-(1 << 63), max(lo - 1, -(1 << 63)), lo, hi,
                               min(hi + 1, (1 << 63) - 1), (1 << 63) - 1,
                               (1 << 63) - 2, 0], device=dev)
    return q


def mismatches(keys, q, got):
    return int((got != torch.searchsorted(keys, q, side="left")).sum())


def check_search(rmi, keys, gen):
    """search, search_sorted and fast_search on 2^16 queries (the packed
    plan; search_sorted runs K5) against torch.searchsorted."""
    q = make_queries(keys, min(1 << 16, keys.shape[0]), gen)
    qs = torch.sort(q).values
    res = {"search": mismatches(keys, q, search(rmi, q)),
           "search_sorted": mismatches(keys, qs, search_sorted(rmi, qs)),
           "fast_search": mismatches(keys, q, lookup_fast.fast_search(rmi, q))}
    log(f"search check, {q.shape[0]} queries: mismatches {json.dumps(res)}")
    if any(res.values()):
        raise RuntimeError("search disagrees with torch.searchsorted")


def serving_curve(rmi, keys, gen):
    """lookups/s per path and batch size over the main path's keys, each
    path's answers checked against torch.searchsorted once."""
    plan = lookup_fast.get_plan(rmi)
    paths = {
        "bounded": lambda q: bounded_search(rmi, q),
        "packed": lambda q: lookup_fast.fast_search(rmi, q),
        "sort_k5": lambda q: lookup_fast.serve_via_sort(rmi, plan, q),
        "sorted_k5": lambda q: search_sorted(rmi, q),
    }
    rows = []
    for nq in CURVE:
        q = make_queries(keys, nq, gen)
        qs = torch.sort(q).values
        row = {"nq": nq}
        for name, fn in paths.items():
            x = qs if name == "sorted_k5" else q
            if mismatches(keys, x, fn(x)):
                raise RuntimeError(f"serving curve: {name} wrong at {nq} queries")
            ms = cuda_ms(lambda: fn(x), 20 if nq <= 1 << 18 else 5)
            row[name] = nq / (ms / 1e3)
        rows.append(row)
        log(f"serving curve nq={nq}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in row.items() if k != "nq") + " lookups/s")
    over = [r["nq"] for r in rows if r["sort_k5"] > r["packed"]]
    log(f"serving curve (plan {plan.kind}, S={plan.S}, F={plan.F}): sort -> K5 "
        f"-> unsort beats the packed plan at nq in {over}")
    log("serving curve " + json.dumps(rows))


def _device_us(evt):
    """Self device time of a profiler event, 0 for a host-side op."""
    if not getattr(evt.device_type, "name", str(evt.device_type)).endswith("CUDA"):
        return 0.0
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0.0))


def k5_phase(rmi, keys, queries):
    """K5 on the main path's batch: the share of blocks whose window
    exceeds the shared-memory stage; search's device time per batch split
    into the sort, K5 with its scatter and the rest (a profiler trace of
    SEARCH_TRACED batches) beside each part timed alone; K5 at the sample
    levels 8 and 16 in turns (8, 16, 16, 8), both exact."""
    ssk = sorted_serve_kernel
    plan = lookup_fast.get_plan(rmi)
    n, nq = keys.shape[0], queries.shape[0]
    qs, order = torch.sort(queries)
    lo, hi = lookup_fast.sorted_bounds(rmi, plan, qs)
    glo, ghi = ssk.group_bounds(lo, hi, n)
    staged = ghi - (glo & ~1)
    over = int((staged > ssk.WINDOW_CAP).sum())
    log(f"K5 windows, {nq} queries over {n} keys: {over} of {lo.shape[0]} blocks "
        f"over the stage cap of {ssk.WINDOW_CAP} group-first keys (share "
        f"{over / lo.shape[0]!r}); staged keys per block mean "
        f"{float(staged.double().mean())!r}, max {int(staged.max())}")

    search(rmi, queries)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(SEARCH_TRACED):
            search(rmi, queries)
        torch.cuda.synchronize()
    parts = dict.fromkeys(("sort", "k5_scatter", "other"), 0.0)
    for e in prof.key_averages():
        name = e.key.lower()
        part = ("k5_scatter" if "serve_sorted" in name
                else "sort" if "sort" in name else "other")
        parts[part] += _device_us(e) / 1e3 / SEARCH_TRACED
    alone = {"sort": cuda_ms(lambda: torch.sort(queries), 10),
             "bounds": cuda_ms(lambda: lookup_fast.sorted_bounds(rmi, plan, qs), 10),
             "k5_scatter": cuda_ms(lambda: ssk.serve_sorted_scatter(
                 qs, order, plan.group_first, keys, lo, hi), 10),
             "search": cuda_ms(lambda: search(rmi, queries), 10)}
    log(f"search device time per batch of {nq} (profiler, {SEARCH_TRACED} batches): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + f", busy {sum(parts.values()):.4f} ms; timed alone (CUDA events): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in alone.items()))

    want = torch.searchsorted(keys, qs)
    firsts = {g: keys[::g].contiguous() for g in ssk.LEVELS}
    for g, gf in firsts.items():
        if not torch.equal(ssk.serve_sorted_level(qs, gf, keys, lo, hi, g), want):
            raise RuntimeError(f"K5 at sample level {g} disagrees with torch.searchsorted")
    times = {g: [] for g in ssk.LEVELS}
    for g in (8, 16, 16, 8):
        times[g].append(cuda_ms(lambda: ssk.serve_sorted_level(
            qs, firsts[g], keys, lo, hi, g), 10))
    library = cuda_ms(lambda: torch.searchsorted(keys, qs), 10)
    log(f"K5 sample levels, {nq} sorted queries over {n} keys, in turns 8, 16, 16, 8: "
        + ", ".join(f"level {g}: {t[0]:.4f}, {t[1]:.4f} ms" for g, t in times.items())
        + f"; torch.searchsorted {library:.4f} ms; serving uses level {ssk.GROUP}")


def same_build(a, b):
    """Two TrainedRMIs with bit-equal parameters, errors and metrics."""
    return (torch.equal(a.device_top_params, b.device_top_params)
            and torch.equal(a.device_leaf_params, b.device_leaf_params)
            and torch.equal(a.leaf_errors, b.leaf_errors)
            and (a.model_avg_log2_error, a.model_avg_error, a.model_max_error)
            == (b.model_avg_log2_error, b.model_avg_error, b.model_max_error))


def log_readers(keys, t, B):
    """(keys whose ln differs between the card and the CPU, [B] mask of
    the leaves that read such a value: a key of their augmented range,
    which the fit and the sweep read, or one of their two probes).
    torch's log on the card is CUDA's, on the CPU glibc's; either may
    round the last bit otherwise."""
    n, dev = keys.shape[0], keys.device
    t = t.long()

    def differs(x):
        return torch.log(x.to(dev)).cpu() != torch.log(x.cpu())

    idx = differs(keymod.as_float(keys)).nonzero().flatten()
    spans = seg.make_spans(t.to(torch.int32), B)
    direct = torch.zeros(B, dtype=torch.bool)
    # its own leaf, and the leaf before or after it where it is an edge key
    for nb in ((idx - 1).clamp(min=0), idx, (idx + 1).clamp(max=n - 1)):
        direct[t[nb]] = True
    _, next_key, prev_key = two_layer.lower_bound_fills(spans, keys.cpu(), KeyType.U64)
    probes = torch.cat([keymod.minus_epsilon(next_key, KeyType.U64),
                        keymod.plus_epsilon(prev_key, KeyType.U64)])
    direct |= differs(keymod.as_float(probes)).view(2, B).any(0)
    return int(idx.numel()), direct


def cross_check(spec, n, B, seed, dev, rec=None):
    """A build on the card against the plain build on the CPU, same keys;
    the card build's kernel calls are recorded into ``rec`` if given.
    Leaf errors may differ by 1 from the order of sums in a few leaves.
    A lognormal leaf fits and predicts on ln x, so a leaf that reads a
    value whose log the card rounds otherwise may differ too
    (log_readers); and its mean is a difference of prefix sums of ln x
    (~43 per key), good to ~1e-10 against a stdev of ~1e-5 at 64 keys
    per leaf, so a leaf whose row the card's sums round otherwise may
    differ by 1 however few they are.  Such leaves are counted apart."""
    keys = rdata.books_like_on_device(n, seed, dev)
    if rec is None:
        card = rmi_tpu_torch.train(rdata.RMIDataset(keys, KeyType.U64), spec, B)
    else:
        with rec:
            card = rmi_tpu_torch.train(rdata.RMIDataset(keys, KeyType.U64), spec, B)
    cpu = rmi_tpu_torch.train(rdata.RMIDataset(keys.cpu(), KeyType.U64), spec, B)

    def ids_counts(r, k):
        t = two_layer.top_assignment(get_model(r.top_type), r.device_top_params, k,
                                     r.norm_offset, r.norm_scale, B - 1)
        spans = seg.make_spans(t.to(torch.int32), B)
        return t.cpu(), (spans.ends - spans.starts).cpu()

    t_card, cnt_card = ids_counts(card, keys)
    t_cpu, cnt_cpu = ids_counts(cpu, keys.cpu())
    e_card, e_cpu = card.leaf_errors.cpu(), cpu.leaf_errors.cpu()
    id_diff = (t_card - t_cpu).abs()
    err_diff = (e_card - e_cpu).abs()
    leaves = (err_diff > 0) | (cnt_card != cnt_cpu)
    reading = torch.zeros(B, dtype=torch.bool)

    def contrib(cnt, e):
        return cnt.double() * torch.log2(2.0 * e.double() + 2.0)
    explained = float((contrib(cnt_card, e_card) - contrib(cnt_cpu, e_cpu))[leaves]
                      .abs().sum()) / n
    d_log2 = abs(card.model_avg_log2_error - cpu.model_avg_log2_error)
    res = {"spec": spec, "n": n, "B": B, "max_err_card": card.model_max_error,
           "max_err_cpu": cpu.model_max_error,
           "avg_log2_card": card.model_avg_log2_error,
           "avg_log2_cpu": cpu.model_avg_log2_error,
           "avg_log2_abs_diff": d_log2, "explained_by_differing_leaves": explained,
           "leaf_ids_differing": int((id_diff > 0).sum()),
           "leaf_ids_max_diff": int(id_diff.max()),
           "leaf_errors_differing": int((err_diff > 0).sum()),
           "leaf_errors_max_diff": int(err_diff.max()),
           "top_params_equal": bool(torch.equal(card.device_top_params.cpu(),
                                                cpu.device_top_params))}
    if get_model(cpu.leaf_type).input_domain == "raw":
        res["keys_log_differs"], direct = log_readers(keys, t_cpu, B)
        a, b = card.device_leaf_params.cpu(), cpu.device_leaf_params
        refit = ~((a == b) | (a.isnan() & b.isnan())).all(1) & ~direct
        reading = direct | refit
        res["leaves_reading_them"] = int(direct.sum())
        res["leaf_rows_differing_otherwise"] = int(refit.sum())
        res["differing_leaves_reading_them"] = int((direct & (err_diff > 0)).sum())
        res["differing_leaves_rows_differing"] = int((refit & (err_diff > 0)).sum())
    res["leaf_errors_differing_otherwise"] = int(((err_diff > 0) & ~reading).sum())
    few = max(8, B // 256)
    log("cross-check " + json.dumps(res))
    ok = (res["max_err_card"] == res["max_err_cpu"]
          and d_log2 <= METRIC_RTOL * abs(cpu.model_avg_log2_error) + explained
          and res["leaf_ids_max_diff"] <= 1 and res["leaf_errors_max_diff"] <= 1
          and res["leaf_ids_differing"] <= few
          and res["leaf_errors_differing_otherwise"] <= few)
    if not ok:
        raise RuntimeError(f"{spec}: card build and CPU build disagree beyond tolerance")


def drive(path, data, queries, gen):
    """Phases 3-5 of one path: cold and warm builds with the launches
    counted from 0 and every call of a kernel wrapper recorded, the bound
    check, search and search_sorted; returns (index, recorder, launches)."""
    spec, B, entries, _ = path
    keys = data.keys
    nq = queries.shape[0]
    queries_sorted = torch.sort(queries).values
    for entry in _build.launches:
        _build.launches[entry] = 0
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        t0 = time.perf_counter()
        rmi = rmi_tpu_torch.train(data, spec, B)
        cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    warm_rmi = rmi_tpu_torch.train(data, spec, B)
    warm = time.perf_counter() - t0
    with rec:
        before = dict(_build.launches)
        viol = bound_violations(rmi, keys, nq, gen)
        by_lookup = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
        lookup(rmi, queries)         # replayed with the sampled keys' lookup
        idx = search(rmi, queries)
        idx_sorted = search_sorted(rmi, queries_sorted)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    fused = f"rmi_lookup_{get_model(rmi.leaf_type).leaf_kernel}"
    log(f"{spec} lookup launches: {json.dumps(by_lookup)}")
    if by_lookup != {fused: 1}:
        raise RuntimeError(f"{spec}: lookup launched {by_lookup}, not {fused} alone")
    log(f"build {spec} {B}: cold {cold:.4f} s, warm {warm:.4f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB; model_max_error {rmi.model_max_error} "
        f"at leaf {rmi.model_max_error_idx}, "
        f"model_avg_log2_error {rmi.model_avg_log2_error!r}, "
        f"model_avg_error {rmi.model_avg_error!r}")
    log(f"{spec} launches: {json.dumps(launches)}")
    missing = [e for e in entries if launches[e] <= 0]
    if missing:
        raise RuntimeError(f"{spec}: kernels not launched on the path: {missing}")
    if not math.isfinite(rmi.model_avg_log2_error) or rmi.leaf_errors.shape != (B,):
        raise RuntimeError(f"{spec}: build produced malformed metrics")
    builds_again = same_build(rmi, warm_rmi)
    log(f"{spec} reproducible: cold and warm builds bit-equal {builds_again}")
    if not builds_again:
        raise RuntimeError(f"{spec}: the same keys gave different builds")
    del warm_rmi

    log(f"{spec} bound check: {viol} violations on {nq} sampled keys")
    if viol:
        raise RuntimeError("bound |guess - lb| <= err violated")
    plan = lookup_fast.get_plan(rmi)
    mism = mismatches(keys, queries, idx)
    mism_sorted = mismatches(keys, queries_sorted, idx_sorted)
    log(f"{spec} search check: {mism} mismatches on {nq} queries, search_sorted "
        f"{mism_sorted}; plan {plan.kind} S={plan.S} F={plan.F}")
    if mism or mism_sorted:
        raise RuntimeError("search disagrees with torch.searchsorted")
    check_search(rmi, keys, gen)
    ms = cuda_ms(lambda: search(rmi, queries), 5)
    log(f"{spec} search: {nq / (ms / 1e3):.6g} lookups/s ({ms:.4f} ms per batch "
        f"of {nq})")
    return rmi, rec, launches


# D runs at its narrowest and widest rows only: the rate table over all
# widths is tools/probe_torch_kernels.py's
PROBE_RING_WIDTHS = (128, 2048)
PROBE_TRACED = 200        # calls per probe in its device-time trace


def device_us(fn, calls=PROBE_TRACED):
    """Device microseconds per call of ``fn``: its CUDA kernels' time in
    a profiler trace of ``calls`` calls, as tools/time_torch_launch.py
    measures it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()) / calls


def probe_phase(dev):
    """The card probes' own path: every probe run once on its probe's
    inputs (D once per width of PROBE_RING_WIDTHS) with the launches
    counted from 0; then each output held equal to its plain version's on
    the card, and the kernel timed beside it.  Returns the kernels rows."""
    probes = probe_kernels.PROBES
    cases = [(p, w) for p in probes
             for w in (PROBE_RING_WIDTHS if p.inputs is None else (None,))]
    inputs = [probe_kernels.probe_inputs(p, dev, width=w or 128) for p, w in cases]
    for entry in _build.launches:
        _build.launches[entry] = 0
    outputs = [p.wrapper(*args) for (p, _), args in zip(cases, inputs)]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    missing = [p.entry for p in probes if launches[p.entry] <= 0]
    if missing:
        raise RuntimeError(f"probes not launched: {missing}")

    rows = {}
    for (probe, width), args, got in zip(cases, inputs, outputs):
        want = probe.plain(*args)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"probe {probe.key} ({probe.entry}): kernel disagrees "
                               f"with its plain version")
        if probe.inputs is None:       # D also on the table that shows a stale slot
            marked = probe_kernels.ring_table(width, dev, marked=True)
            if not torch.equal(probe.wrapper(marked), probe.plain(marked)):
                raise RuntimeError(f"probe D, width {width}: wrong sum on the marked table")
            del marked
        idx = [a.long() for a in args if a.dtype == torch.int32]
        # one PyTorch call that computes the same, where there is one: the
        # pair compare and the copy ring have none, and torch 2.11 has no
        # uint64 compare on the card ("compare_cuda" not implemented)
        lib = {"A": lambda: torch.mul(args[0], 2.0),
               "B1": lambda: torch.lt(args[0], args[1]),
               "C1": lambda: torch.index_select(args[0], 0, idx[0]),
               "C2": lambda: torch.take(args[0], idx[0]),
               "C3": lambda: torch.gather(args[0], 1, idx[0]),
               "E": lambda: torch.index_select(args[1], 0, idx[0])}.get(probe.key)
        ms = row_ms(lambda: probe.wrapper(*args), 20)
        plain_ms = row_ms(lambda: probe.plain(*args), 20)
        library_ms = None if lib is None else row_ms(lib, 20)
        if probe.inputs is None:       # the rows D fetches, not its whole table
            nbytes = probe_kernels.RING_ITERS * width * 4 + _nbytes(got)
            elems = probe_kernels.RING_ITERS
        else:
            nbytes, elems = _nbytes(*args, got), got.numel()
        peak = INT_OPS_PER_S if got.dtype == torch.int32 else F32_OPS_PER_S
        bound_ms = max(nbytes / HBM_BYTES_PER_S, elems / peak) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= elems / peak else "operations"
        name = f"probe {probe.key} {probe.entry}" + (f" width {width}" if width else "")
        log(f"{name}: equal to its plain version; {spread(ms)} vs plain {spread(plain_ms)}, "
            f"library {library_ms and spread(library_ms)}, bound {bound_ms:.6f} ms "
            f"({bound_by}: {nbytes} B)")
        lib_us = None if lib is None else f"{device_us(lib):.4f} us"
        log(f"{name}: device time per call (profiler, {PROBE_TRACED} calls) "
            f"{device_us(lambda: probe.wrapper(*args)):.4f} us vs library {lib_us}")
        # one row per entry: D's is its widest call, the last of its cases
        rows[probe.entry] = {
            "name": probe.entry, "route": "cuda",
            "source": "rmi_tpu_torch/csrc/probes.cu", "replaces": probe.replaces,
            "launches": launches[probe.entry], "max_abs_err": 0, "ms": ms[0],
            "plain_ms": plain_ms[0], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library_ms is None else library_ms[0]}
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000_000, help="keys")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    n = args.n
    nq = min(1 << 22, n)          # search queries, and keys of the bound check
    cross_n = min(1 << 20, n)

    # 1. the card
    dev = config.require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. the kernels
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall, nvcc "
        f"{_build.build_info['seconds']:.2f} s ({_build.build_info['path']})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas " + line.split("ptxas info    :")[-1].strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    keys = rdata.books_like_on_device(n, args.seed, dev)
    data = rdata.RMIDataset(keys, KeyType.U64)
    torch.cuda.synchronize()
    log(f"keys: n={n} made on the card in {time.perf_counter() - t0:.2f} s")
    keys_again = torch.equal(keys, rdata.books_like_on_device(n, args.seed, dev))
    log(f"reproducible: keys made twice equal {keys_again}")
    if not keys_again:
        raise RuntimeError("the same seed gave different keys")
    queries = make_queries(keys, nq, gen)
    rows, launches = {}, dict.fromkeys(_build.launches, 0)

    # 3-8. path 1
    spec, B, _, replayed = PATH1
    rmi, rec, counts = drive(PATH1, data, queries, gen)
    k5_phase(rmi, keys, queries)
    serving_curve(rmi, keys, gen)
    del rmi
    rows.update(check_kernels(rec, counts, replayed))
    launches = {e: launches[e] + counts[e] for e in launches}
    del rec
    torch.cuda.empty_cache()
    cross_check(spec, cross_n, max(64, (B * cross_n) // n), args.seed + 2, dev)

    # 9-11. paths 2, 3 and 4
    for seed, path in enumerate((PATH2, PATH3, PATH4), args.seed + 3):
        spec, B, _, replayed = path
        rmi, rec, counts = drive(path, data, queries, gen)
        del rmi
        rows.update(check_kernels(rec, counts, replayed))
        launches = {e: launches[e] + counts[e] for e in launches}
        del rec
        torch.cuda.empty_cache()
        cross_check(spec, cross_n, max(64, (B * cross_n) // n), seed, dev)

    # 12. lognormal leaves: the card against the CPU, and their K3 and K4
    # calls replayed; these launches are not the main path's
    spec, B, _, replayed = LOGNORMAL
    rec = Recorder()
    for b in (max(64, (B * cross_n) // n), cross_n // 64):
        cross_check(spec, cross_n, b, args.seed + 6, dev, rec)
    for entry, row in check_kernels(rec, dict.fromkeys(_build.launches, 0),
                                    replayed).items():
        log(f"lognormal replay {entry}: max abs err {row['max_abs_err']}")
    del rec

    for entry, row in rows.items():
        row["launches"] = launches[entry]
    # 13. the card probes
    rows.update(probe_phase(dev))
    print(json.dumps({"kernels": [rows[entry] for entry, *_ in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
