"""Drive rmi_tpu_torch once on one CUDA card and check every kernel.

    python3 chip_smoke.py              # 200M keys, cubic,linear 262144
    python3 chip_smoke.py --n 2000000  # a shorter run

Phases (any failure raises and exits non-zero):
  1. the card: name and power limit as nvidia-smi reports them;
  2. the kernels: built from csrc/ with nvcc, build time printed;
  3. the main path: books-like u64 keys made on the card from a seed,
     ``train(data, "cubic,linear", 262144)`` cold and warm, then lookup
     and search; every kernel must have launched in that run, and the
     keys made twice and the two builds must be bit-equal;
  4. the bound |guess - lower_bound| <= err on sampled keys;
  5. exact search against torch.searchsorted, and its rate;
  6. each kernel replayed on the inputs the main path gave it, against
     its plain PyTorch version: K1 and K2 on the card, K3 and K4 on CPU
     copies (CPU torch.addcmul is an exact FMA);
  7. a build on the card against the plain build on the CPU.
The last line is the device JSON; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

import rmi_tpu_torch
from rmi_tpu_torch import config
from rmi_tpu_torch import data as rdata
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.lookup import lookup, search
from rmi_tpu_torch.ops import _build, eval_kernel, scan_kernel, select_kernel, sweep_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

SPEC = "cubic,linear"
B = 262144
K2_RTOL = 1e-9            # summation order
METRIC_RTOL = 1e-7

# (module, wrapper name, plain version name, C entry point, device the
#  plain version is compared on (None: the card), source, TPU kernel replaced)
KERNELS = [
    (scan_kernel, "scan_i32", "scan_i32_plain", "rmi_scan_i32", None,
     "rmi_tpu_torch/csrc/scan.cu", "rmi_tpu/ops/scan_kernel.py:35"),
    (select_kernel, "aug_centered_moments", "aug_centered_moments_plain",
     "rmi_aug_moments", None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    (sweep_kernel, "sweep_errors", "sweep_errors_plain", "rmi_sweep_linear", "cpu",
     "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    (eval_kernel, "leaf_eval_clamped", "leaf_eval_clamped_plain",
     "rmi_leaf_eval_linear", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
]


def log(*a):
    print(*a, flush=True)


class Recorder:
    """Keeps the arguments of every call of the kernel wrappers while
    installed, so each kernel can be replayed on main-path inputs."""

    def __init__(self):
        self.calls = {name: [] for _, name, *_ in KERNELS}
        self._saved = []

    def __enter__(self):
        self._saved = []
        for mod, name, *_ in KERNELS:
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


def plain_args(name, args, kw, where):
    """Arguments of the plain version on ``where`` (None: where they
    are); K1's plain version takes no fill."""
    args = [a.to(where or a.device) if torch.is_tensor(a) else a for a in args]
    kw = {k: v for k, v in kw.items() if not (name == "scan_i32" and k == "fill")}
    return args, kw


def compare(name, got, want, args):
    """(max abs error, ok) of a kernel output against its plain version."""
    if name == "aug_centered_moments":
        x, y, mean_x, mean_y, lo, hi = [a.cpu() for a in args]
        syy = select_kernel.aug_centered_moments_plain(y, y, mean_y, mean_y, lo, hi)[0]
        (m2, c), (wm2, wc) = [[t.cpu() for t in r] for r in (got, want)]
        tol_m2 = K2_RTOL * wm2.abs()
        tol_c = K2_RTOL * wc.abs() + 1e-12 * torch.sqrt(wm2.clamp(min=0) * syy)
        err = max(float((m2 - wm2).abs().max()), float((c - wc).abs().max()))
        ok = bool(((m2 - wm2).abs() <= tol_m2).all() and ((c - wc).abs() <= tol_c).all())
        return err, ok
    got, want = got.cpu().long(), want.cpu().long()
    err = int((got - want).abs().max()) if got.numel() else 0
    return err, bool(torch.equal(got, want))


def check_kernels(rec, launches):
    rows = []
    for mod, name, plain_name, entry, where, source, replaces in KERNELS:
        wrapper, plain = getattr(mod, name), getattr(mod, plain_name)
        calls = rec.calls[name]
        if not calls:
            raise RuntimeError(f"{name}: no main-path call recorded")
        worst = 0
        for args, kw in calls:
            got = wrapper(*args, **kw)
            pa, pk = plain_args(name, args, kw, where)
            want = plain(*pa, **pk)
            err, ok = compare(name, got, want, args)
            if not ok:
                raise RuntimeError(f"{name}: kernel disagrees with its plain "
                                   f"version (max abs err {err})")
            worst = max(worst, err)
        # time the largest main-path call, kernel and plain version on the card
        args, kw = max(calls, key=lambda c: c[0][0].shape[0])
        pa, pk = plain_args(name, args, kw, args[0].device)
        ms = cuda_ms(lambda: wrapper(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: plain(*pa, **pk), 3)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[entry],
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms})
        log(f"kernel {name}: {len(calls)} main-path calls match the plain "
            f"version (max abs err {worst}); {ms:.4f} ms vs plain {plain_ms:.4f} ms "
            f"at {list(args[0].shape)}")
    return rows


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


def same_build(a, b):
    """Two TrainedRMIs with bit-equal parameters, errors and metrics."""
    return (torch.equal(a.device_top_params, b.device_top_params)
            and torch.equal(a.device_leaf_params, b.device_leaf_params)
            and torch.equal(a.leaf_errors, b.leaf_errors)
            and (a.model_avg_log2_error, a.model_avg_error, a.model_max_error)
            == (b.model_avg_log2_error, b.model_avg_error, b.model_max_error))


def cross_check(n, B, seed, dev):
    """A build on the card against the plain build on the CPU, same keys."""
    keys = rdata.books_like_on_device(n, seed, dev)
    card = rmi_tpu_torch.train(rdata.RMIDataset(keys, KeyType.U64), SPEC, B)
    cpu = rmi_tpu_torch.train(rdata.RMIDataset(keys.cpu(), KeyType.U64), SPEC, B)

    def ids_counts(r, k):
        xn = two_layer.normalize(k, r.norm_offset, r.norm_scale)
        t = two_layer.predict_top_assignment(
            rmi_tpu_torch.models.get_model("cubic"), r.device_top_params, xn, B - 1)
        spans = seg.make_spans(t.to(torch.int32), B)
        return t.cpu(), (spans.ends - spans.starts).cpu()

    t_card, cnt_card = ids_counts(card, keys)
    t_cpu, cnt_cpu = ids_counts(cpu, keys.cpu())
    e_card, e_cpu = card.leaf_errors.cpu(), cpu.leaf_errors.cpu()
    id_diff = (t_card - t_cpu).abs()
    err_diff = (e_card - e_cpu).abs()
    leaves = (err_diff > 0) | (cnt_card != cnt_cpu)

    def contrib(cnt, e):
        return cnt.double() * torch.log2(2.0 * e.double() + 2.0)
    explained = float((contrib(cnt_card, e_card) - contrib(cnt_cpu, e_cpu))[leaves]
                      .abs().sum()) / n
    d_log2 = abs(card.model_avg_log2_error - cpu.model_avg_log2_error)
    res = {"n": n, "B": B, "max_err_card": card.model_max_error,
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
    log("cross-check " + json.dumps(res))
    few = max(8, B // 256)
    ok = (res["max_err_card"] == res["max_err_cpu"]
          and d_log2 <= METRIC_RTOL * abs(cpu.model_avg_log2_error) + explained
          and res["leaf_ids_max_diff"] <= 1 and res["leaf_errors_max_diff"] <= 1
          and res["leaf_ids_differing"] <= few and res["leaf_errors_differing"] <= few)
    if not ok:
        raise RuntimeError("card build and CPU build disagree beyond tolerance")


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

    # 3. the main path
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    keys = rdata.books_like_on_device(n, args.seed, dev)
    data = rdata.RMIDataset(keys, KeyType.U64)
    torch.cuda.synchronize()
    log(f"keys: n={n} made on the card in {time.perf_counter() - t0:.2f} s")
    queries = make_queries(keys, nq, gen)

    for entry in _build.launches:
        _build.launches[entry] = 0
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        t0 = time.perf_counter()
        rmi = rmi_tpu_torch.train(data, SPEC, B)
        cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    warm_rmi = rmi_tpu_torch.train(data, SPEC, B)
    warm = time.perf_counter() - t0
    with rec:
        viol = bound_violations(rmi, keys, nq, gen)
        idx = search(rmi, queries)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"build {SPEC} {B}: cold {cold:.4f} s, warm {warm:.4f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB; model_max_error {rmi.model_max_error}, "
        f"model_avg_log2_error {rmi.model_avg_log2_error!r}, "
        f"model_avg_error {rmi.model_avg_error!r}")
    log(f"main-path launches: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    if not math.isfinite(rmi.model_avg_log2_error) or rmi.leaf_errors.shape != (B,):
        raise RuntimeError("build produced malformed metrics")
    keys_again = torch.equal(keys, rdata.books_like_on_device(n, args.seed, dev))
    builds_again = same_build(rmi, warm_rmi)
    log(f"reproducible: keys made twice equal {keys_again}, cold and warm "
        f"builds bit-equal {builds_again}")
    if not (keys_again and builds_again):
        raise RuntimeError("the same seed gave different keys or builds")
    del warm_rmi

    # 4. the bound contract
    log(f"bound check: {viol} violations on {nq} sampled keys")
    if viol:
        raise RuntimeError("bound |guess - lb| <= err violated")

    # 5. exact search
    want = torch.searchsorted(keys, queries, side="left")
    mism = int((idx != want).sum())
    log(f"search check: {mism} mismatches on {queries.shape[0]} queries")
    if mism:
        raise RuntimeError("search disagrees with torch.searchsorted")
    ms = cuda_ms(lambda: search(rmi, queries), 5)
    log(f"search: {queries.shape[0] / (ms / 1e3):.6g} lookups/s "
        f"({ms:.4f} ms per batch of {queries.shape[0]})")
    del idx, want

    # 6. kernels against their plain versions, on main-path inputs
    del rmi
    rows = check_kernels(rec, launches)
    del rec
    torch.cuda.empty_cache()

    # 7. card against CPU
    cross_check(cross_n, max(64, (B * cross_n) // n), args.seed + 2, dev)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
