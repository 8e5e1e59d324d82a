"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a CUDA device: a CUDA kernel has no
CPU mode (on the CPU each wrapper runs its plain version, which
tests/test_torch_kernels_ref.py holds to rmi_tpu).  Needs no JAX, so it
runs on a machine without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: K1, K3 and K4 (linear, cubic, loglinear and normal leaves,
lognormal through the normal kernel; lookup's fused entry for every
affine and integer top and leaf kernel, against its plain version on the
card and on the CPU, on test_torch_lookup_kernel.py's inputs) and the
hierarchical resolve bit-equal (max/min never round; K3,
the per-leaf maximum of the sweep, and K4 are compared with the plain
version on CPU copies, where torch.addcmul is an exact FMA); the
run-length pass and the nine card probes equal to their plain versions
(C1 and C2 also bit-equal to tbl[idx] on tables beyond a block's shared
memory, odd widths and offset views; D also with 1 and 16 issuing warps
a block and in its whole-card form); every C entry's wrapper counts
exactly one launch through the compiled binding, which refuses tensors
off the card, non-contiguous or of the wrong type;
K2 and its weighted and variance-only
variants within rtol 1e-9 (summation order) plus 1e-12 of the
Cauchy-Schwarz bound sqrt(m2 * sum (y-my)^2) for c; the integer models'
builds on the card against the CPU build (hint tables bit-equal) with the
kernels they launched replayed as above; K5 and its scatter
entry, at both sample levels, bit-equal to their plain versions on the
card and to np.searchsorted (int64 compares never round), on f64 key
images too; lookup's fused entry with the f64 key kind bit-equal to its
plain version for every top and leaf kernel, an unknown key kind
refused; an f64 and a u32 build on the card against the CPU build; K6 within
cubic_l1_kernel.sum_tolerance (summation order) and bit-equal to itself
when run again; the cachefix path's bounded lower bound and
interpolation bit-equal to their plain versions at their edges
(test_torch_lookup_kernel.py's cachefix_edge_case and bounded_edge_case),
over windows of 2^16 and 2^21 keys (wide_window_case), on keys, knots and
samples one entry off a 16-byte boundary, and at 2^22 queries, and a
train_bounded index's lookup and search on the card equal to the CPU
index's, through those kernels, its knot sample made per index;
rmi_fixdups bit-equal to its plain version (test_torch_fit_kernels.py's
edge cases and runs of a million keys), and rmi_aug_fit_moments, both
forms, and rmi_aug_fit_log_moments within select_kernel.fit_tolerance of
their plain versions on those edge cases, on leaves of hundreds of chunks
and on path 3's ~3050-key leaves, each the same bits when run again and,
the fits, with a full schedule of long-leaf chunks; the log form's ln y
within one ulp of torch.log's for every y in [1, 2^28) (the count that
differs printed); the build's FixDups and linear, normal and loglinear
leaf fits one launch each, the fit allocating nothing of the keys' size;
rmi_top_cubic_candidates bit-equal on runs of up to 2^20 + 1 equal keys
at both ends and on f64 keys led by NaN, -inf or +inf; the data-parallel
build's per-shard forms (rmi_fixdups_carry, rmi_span_run_max_carry,
rmi_aug_fit_sums, K2 on the int32 targets, rmi_top_l1_partial) against
their plain versions on tests/test_torch_dp_kernels.py's edge shards and
on one 200M-key shard (integers equal, sums within fit_sums_tolerance,
centered_tolerance and sum_tolerance), the same bits when run again, and
one NCCL rank's dp build at 2^22 keys with no torch operator over its m
keys (tools/trace_torch_build.py's census).
"""

import dataclasses

import numpy as np
import pytest
import torch

import rmi_tpu_torch as rt
from rmi_tpu_torch import data as rdata
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import cubic, get_model
from rmi_tpu_torch.models.base import (REGISTRY, kernel_input, model_float_input,
                                       params_equal, params_to, predict_top_assignment)
from rmi_tpu_torch.models.linear import log_targets
from rmi_tpu_torch.lookup import bounded_search
from rmi_tpu_torch.parallel import dp_trainer
from rmi_tpu_torch.ops import (_build, cachefix_kernel, cubic_l1_kernel, eval_kernel,
                               hier_kernel, packed_kernel, probe_kernels, scan_kernel,
                               select_kernel, sorted_serve_kernel as ssk, sweep_kernel,
                               top_kernel)
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg
from test_torch_dp_kernels import (EDGE_CASES, _clip, _groups, _leaves, _shards, _trace_tool,
                                   _x_y)
from test_torch_fit_kernels import (FIT_EDGES, FIXDUPS_EDGES, TABLE_EDGES, TOP_FIT_EDGES,
                                    _fixdups_np, fit_case, fixdups_case, leaf_arrays,
                                    table_edge_case, top_fit_case)
from test_torch_lookup_kernel import (BOUNDED_EDGES, CACHEFIX_EDGES, INT_TOPS, KEY_SETS,
                                      LEAVES, PACKED_EDGE_BS, PACKED_EDGES, RESOLVE_EDGES,
                                      WIDE_WINDOWS, bounded_edge_case, cachefix_edge_case,
                                      int_keys, int_queries, int_top_case, leaf_table,
                                      lookup_case, model_inputs, packed_edge_case, resolve_case,
                                      resolve_edge_case, top_rows, wide_window_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _leaf_inputs(n, B, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.exponential(size=n) * (rng.random(n) > 0.05))
    x = (x - x[0]) / (x[-1] - x[0])
    first = np.concatenate([[True], x[1:] != x[:-1]])
    y = np.maximum.accumulate(np.where(first, np.arange(n), 0)).astype(np.int32)
    t = np.clip(np.floor(x * B), 0, B - 1).astype(np.int32)
    beta = rng.normal(n, n / 100, B)
    alpha = np.bincount(t, y - beta[t] * x, B) / np.maximum(np.bincount(t, None, B), 1)
    w = np.stack([alpha, beta], axis=1)
    return (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t),
            torch.from_numpy(w))


@pytest.mark.parametrize("is_max,reverse", [(True, False), (True, True),
                                            (False, False), (False, True)])
@pytest.mark.parametrize("n", [1, 4095, 4097, 1_000_003])
def test_k1_scan(dev, is_max, reverse, n):
    v = torch.randint(-(1 << 30), 1 << 30, (n,), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(n))
    fill = seg.INT32_MIN if is_max else seg.INT32_MAX
    before = _build.launches["rmi_scan_i32"]
    got = scan_kernel.scan_i32(v.to(dev), is_max=is_max, fill=fill, reverse=reverse)
    torch.cuda.synchronize()
    assert _build.launches["rmi_scan_i32"] == before + 1
    want = scan_kernel.scan_i32_plain(v, is_max=is_max, reverse=reverse)
    assert torch.equal(got.cpu(), want)


def test_k2_moments(dev):
    x, y, t, _ = _leaf_inputs(300_001, 4096, 1)
    spans = seg.make_spans(t, 4096)
    cnt = seg.aug_count(spans).clamp(min=1)
    yf = y.double()
    mx = seg.range_sum(x, spans.aug_starts, spans.aug_ends) / cnt
    my = seg.range_sum(yf, spans.aug_starts, spans.aug_ends) / cnt
    args = (x, yf, mx, my, spans.aug_starts, spans.aug_ends)
    m2, c = select_kernel.aug_centered_moments(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    wm2, wc = select_kernel.aug_centered_moments_plain(*args)
    syy = select_kernel.aug_centered_moments_plain(yf, yf, my, my, *args[4:])[0]
    assert ((m2.cpu() - wm2).abs() <= 1e-9 * wm2.abs()).all()
    assert ((c.cpu() - wc).abs()
            <= 1e-9 * wc.abs() + 1e-12 * torch.sqrt(wm2 * syy)).all()


def _k2_close(got, want, syy):
    (m2, c), (wm2, wc) = [[t.cpu() for t in r] for r in (got, want)]
    assert ((m2 - wm2).abs() <= 1e-9 * wm2.abs()).all()
    assert ((c - wc).abs() <= 1e-9 * wc.abs() + 1e-12 * torch.sqrt(wm2 * syy)).all()


def test_k2_moments_weighted(dev):
    """Loglinear's inputs: ln of FixDups positions, weight 0 where the
    log is -inf (the first duplicate run, a whole leaf)."""
    x, y, t, _ = _leaf_inputs(300_001, 4096, 7)
    y[:2000] = 0
    ln, w = log_targets(y.double())
    spans = seg.make_spans(t, 4096)
    cnt, sx, sy = seg.aug_masked_stats(spans, w, x, ln)
    assert float(cnt[0]) == 0.0
    mx, my = sx / cnt.clamp(min=1), sy / cnt.clamp(min=1)
    args = (x, ln, mx, my, spans.aug_starts, spans.aug_ends)
    before = _build.launches["rmi_aug_moments_weighted"]
    got = select_kernel.aug_centered_moments(*[a.to(dev) for a in args], weights=w.to(dev))
    torch.cuda.synchronize()
    assert _build.launches["rmi_aug_moments_weighted"] == before + 1
    want = select_kernel.aug_centered_moments_plain(*args, weights=w)
    syy = select_kernel.aug_centered_moments_plain(ln, ln, my, my, *args[4:], weights=w)[0]
    _k2_close(got, want, syy)


def test_k2_moments_xx(dev):
    x, _, t, _ = _leaf_inputs(300_001, 4096, 8)
    spans = seg.make_spans(t, 4096)
    mx = seg.aug_sum(spans, x) / seg.aug_count(spans).clamp(min=1)
    before = _build.launches["rmi_aug_moments_xx"]
    got = select_kernel.aug_centered_xx(x.to(dev), mx.to(dev), spans.aug_starts.to(dev),
                                        spans.aug_ends.to(dev))
    torch.cuda.synchronize()
    assert _build.launches["rmi_aug_moments_xx"] == before + 1
    want = select_kernel.aug_centered_xx_plain(x, mx, spans.aug_starts, spans.aug_ends)
    assert ((got.cpu() - want).abs() <= 1e-9 * want.abs()).all()


def _zoo_rows(leaf, n, B, seed):
    """(kernel input, y, t, rows) with rows from the port's fit of leaf
    model ``leaf`` on the CPU; lognormal's model input is raw key values."""
    x, y, t, _ = _leaf_inputs(n, B, seed)
    mdef = get_model(leaf)
    if mdef.input_domain == "raw":
        x = x * 2.0 ** 50 + 1.0
    w = mdef.fit_leaves(x, y, seg.make_spans(t, B))
    return kernel_input(mdef, x), y, t, w


def _leaf_max_on_card(dev, x, y, t, w, leaf, B):
    """K3 on the card for the spans of leaf ids ``t``, counted as one
    launch of its entry; (per-leaf maxima on the CPU, per-key plain errors)."""
    n = x.shape[0]
    spans = seg.make_spans(t, B)
    entry = f"rmi_sweep_max_{get_model(leaf).leaf_kernel}"
    before = _build.launches[entry]
    got = sweep_kernel.sweep_leaf_max(x.to(dev), y.to(dev), spans.starts.to(dev),
                                      spans.ends.to(dev), w.to(dev), n, leaf_type=leaf)
    torch.cuda.synchronize()
    assert _build.launches[entry] == before + 1
    want = sweep_kernel.sweep_leaf_max_plain(x, y, spans.starts, spans.ends, w, n,
                                             leaf_type=leaf)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    err = sweep_kernel.sweep_errors_plain(x, y, t, w, n, leaf_type=leaf)
    assert torch.equal(want, seg.range_max(err, spans.starts, spans.ends, 0))
    return want, err


@pytest.mark.parametrize("leaf", ["loglinear", "normal", "lognormal"])
def test_k3_sweep_zoo(dev, leaf):
    x, y, t, w = _zoo_rows(leaf, 500_009, 2048, 9)
    _, err = _leaf_max_on_card(dev, x, y, t, w, leaf, 2048)
    assert int((err > 0).sum()) > x.shape[0] // 10


@pytest.mark.parametrize("leaf", ["loglinear", "normal", "lognormal"])
@pytest.mark.parametrize("bound", [0, 499_999])
def test_k4_leaf_eval_zoo(dev, leaf, bound):
    x, _, t, w = _zoo_rows(leaf, 500_009, 2048, 10)
    x = torch.cat([x, torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0])])
    w[5] = torch.tensor([0.0, float("nan"), -float("inf")])[:w.shape[1]]  # an empty leaf
    leaf_ids = torch.cat([t, t[:4]]).long()
    got = eval_kernel.leaf_eval_clamped(x.to(dev), w.to(dev), leaf_ids.to(dev), bound,
                                        leaf_type=leaf)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), eval_kernel.leaf_eval_clamped_plain(
        x, w, leaf_ids, bound, leaf_type=leaf))


def test_entry_points_default_to_the_card(dev, tmp_path):
    keys = np.sort(np.random.default_rng(3).integers(0, 2 ** 50, 5000, dtype=np.uint64))
    assert rt.RMIDataset.from_numpy(keys).keys.device.type == "cuda"
    path = str(tmp_path / "keys_uint64")
    rt.write_sosd_file(path, keys)
    assert rt.load_data(path).keys.device.type == "cuda"
    cpu = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), "linear,linear", 16)
    rc = rt.trained_from_numpy("linear,linear", 16, KeyType.U64, keys,
                               cpu.device_top_params.numpy(),
                               cpu.device_leaf_params.numpy(),
                               cpu.leaf_errors.numpy(), cpu.norm_offset, cpu.norm_scale)
    assert rc.keys.device.type == rc.device_leaf_params.device.type == "cuda"


@pytest.mark.parametrize("spec", ["cubic,loglinear", "cubic,normal", "cubic,lognormal",
                                  "lognormal,linear"])
def test_card_build_zoo_matches_cpu_build(dev, spec):
    keys = rdata.books_like_on_device(1 << 18, 8, dev)
    card = rt.train(rdata.RMIDataset(keys, KeyType.U64), spec, 256)
    cpu = rt.train(rdata.RMIDataset(keys.cpu(), KeyType.U64), spec, 256)
    assert card.model_max_error == cpu.model_max_error
    diff = (card.leaf_errors.cpu() - cpu.leaf_errors).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 8
    lb = torch.searchsorted(keys, keys, side="left")
    g, e = rt.lookup(card, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    assert torch.equal(rt.search(card, keys), lb)


def test_k3_sweep(dev):
    x, y, t, w = _leaf_inputs(500_009, 2048, 2)
    _leaf_max_on_card(dev, x, y, t, w, "linear", 2048)


@pytest.mark.parametrize("bound", [0, 1000, 499_999])
def test_k4_leaf_eval(dev, bound):
    x, _, t, w = _leaf_inputs(500_009, 2048, 3)
    x = torch.cat([x, torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0])])
    leaf = torch.cat([t, t[:4]]).long()
    got = eval_kernel.leaf_eval_clamped(x.to(dev), w.to(dev), leaf.to(dev), bound,
                                        leaf_type="linear")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), eval_kernel.leaf_eval_clamped_plain(
        x, w, leaf, bound, leaf_type="linear"))


def _cubic_rows(B, seed):
    """[B, 4] cubic rows with random coefficients of the sizes leaf fits
    give; callers set c = n, so that the rows follow y ~ n x."""
    rng = np.random.default_rng(seed)
    c = rng.normal(1000.0, 10.0, B)
    a = rng.normal(0.0, 1e3, B)
    b = rng.normal(0.0, 1e2, B)
    d = rng.normal(0.0, 5.0, B)
    return torch.from_numpy(np.stack([a, b, c, d], axis=1))


def test_k3_sweep_cubic(dev):
    x, y, t, _ = _leaf_inputs(500_009, 2048, 4)
    w = _cubic_rows(2048, 4)
    w[:, 2] = float(x.shape[0])            # rows that track y ~ n x
    _, err = _leaf_max_on_card(dev, x, y, t, w, "cubic", 2048)
    assert int((err > 0).sum()) > x.shape[0] // 2


def _span_case(case):
    """(x f64, int64 keys, yfix, starts, ends, w) of one span shape for K3
    and the run-length pass; every span boundary is the first key of a
    duplicate run, as leaf ids computed from the keys give."""
    n = {"huge": (1 << 22) + (1 << 18), "one_nonempty": 300_007, "B1": 70_001,
         "n0": 0}[case]
    B = {"huge": 2048, "one_nonempty": 262144, "B1": 1, "n0": 16}[case]
    x, y, _, w = _leaf_inputs(max(n, 2), 512, len(case))
    x, y = x[:n], y[:n]
    keys = (x * 2.0 ** 50).long()
    assert n == 0 or bool(((keys[1:] == keys[:-1]) == (x[1:] == x[:-1])).all())
    if case == "huge":       # 1000 small leaves, one of ~2^22 keys, 1047 small ones
        cuts = np.concatenate([np.linspace(0, 1 << 17, 1001)[:-1],
                               [1 << 17], np.linspace((1 << 17) + (1 << 22), n, 1048)[:-1]])
        starts = y[torch.from_numpy(cuts.astype(np.int64))].long()
    elif case == "one_nonempty":
        starts = torch.zeros(B, dtype=torch.int64)
        starts[77_778:] = n
    else:
        starts = torch.zeros(B, dtype=torch.int64)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    return x, keys, y, starts, ends, w[torch.arange(B) % w.shape[0]].contiguous()


@pytest.mark.parametrize("case", ["huge", "one_nonempty", "B1", "n0"])
def test_k3_and_run_max_span_shapes(dev, case):
    """One leaf of 2^22 keys among small ones, every leaf empty but one
    (262143 empty leaves), B = 1 and n = 0: both per-leaf maxima equal
    their plain versions on CPU copies."""
    x, keys, y, starts, ends, w = _span_case(case)
    n = x.shape[0]
    d = [a.to(dev) for a in (x, keys, y, starts, ends, w)]
    got = sweep_kernel.sweep_leaf_max(d[0], d[2], d[3], d[4], d[5], n, leaf_type="linear")
    want = sweep_kernel.sweep_leaf_max_plain(x, y, starts, ends, w, n, leaf_type="linear")
    assert torch.equal(got.cpu(), want)
    before = _build.launches["rmi_span_run_max"]
    runs = sweep_kernel.span_run_max(d[1], d[2], d[3], d[4])
    torch.cuda.synchronize()
    assert _build.launches["rmi_span_run_max"] == before + 1
    want_runs = sweep_kernel.span_run_max_plain(keys, y, starts, ends)
    assert runs.dtype == torch.int32 and torch.equal(runs.cpu(), want_runs)
    if case in ("huge", "one_nonempty"):
        assert int((ends - starts).max()) >= 300_007 and int(want_runs.max()) >= 2
        assert int((want > 0).sum()) >= 1


def _events_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def test_k3_huge_leaf_is_not_one_warps_work(dev):
    """The same keys as one leaf of ~2^22 among small ones and as 2048
    even leaves: a long span is cut into chunks, so its keys cost about
    what the even leaves' keys cost (printed; run pytest with -rP)."""
    x, keys, y, starts, ends, w = _span_case("huge")
    n = x.shape[0]
    even = torch.from_numpy(np.linspace(0, n, 2049)[:-1].astype(np.int64))
    even = y[even].long()
    even_ends = torch.cat([even[1:], even.new_full((1,), n)])
    d = [a.to(dev) for a in (x, keys, y, starts, ends, w, even, even_ends)]
    times = {}
    for name, s, e in (("huge", d[3], d[4]), ("even", d[6], d[7])):
        times[name] = (
            _events_ms(lambda: sweep_kernel.sweep_leaf_max(d[0], d[2], s, e, d[5], n,
                                                           leaf_type="linear")),
            _events_ms(lambda: sweep_kernel.span_run_max(d[1], d[2], s, e)))
    for name, (k3, run) in times.items():
        print(f"span maxima over n={n} keys, {name} leaves: K3 {k3:.4f} ms "
              f"({k3 * 1e6 / n:.4f} ns/key), run max {run:.4f} ms "
              f"({run * 1e6 / n:.4f} ns/key)")
    assert times["huge"][0] <= 3 * times["even"][0] + 0.05
    assert times["huge"][1] <= 3 * times["even"][1] + 0.05


@pytest.mark.parametrize("bound", [0, 499_999])
def test_k4_leaf_eval_cubic(dev, bound):
    x, _, t, _ = _leaf_inputs(500_009, 2048, 5)
    w = _cubic_rows(2048, 5)
    w[:, 2] = float(x.shape[0])
    x = torch.cat([x, torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0])])
    leaf = torch.cat([t, t[:4]]).long()
    got = eval_kernel.leaf_eval_clamped(x.to(dev), w.to(dev), leaf.to(dev), bound,
                                        leaf_type="cubic")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), eval_kernel.leaf_eval_clamped_plain(
        x, w, leaf, bound, leaf_type="cubic"))


def test_k6_cubic_l1(dev):
    """K6 against its plain version on CPU copies: empty leaves, one-key
    leaves and one leaf of 10^5 keys, with the leaf fit's own candidates."""
    n, B = 1_000_003, 4096
    x, y, t, _ = _leaf_inputs(n, B, 6)
    t = t.numpy().astype(np.int64)
    t[t >= 1000] += 5                        # leaves 1000-1004 empty
    lo = n // 2                              # leaf t[lo] + 1 holds 10^5 keys
    t[lo:lo + 100_000] = t[lo - 1] + 1
    t[lo + 100_000:] = np.maximum(t[lo + 100_000:], t[lo] + 1)
    k = n // 5                               # a one-key leaf
    t[k] = t[k - 1] + 1
    t[k + 1:] = np.maximum(t[k + 1:], t[k] + 1)
    t = torch.from_numpy(np.minimum(t, B - 1).astype(np.int32))
    spans = seg.make_spans(t, B)
    assert int((spans.ends - spans.starts).max()) >= 100_000
    cubic_w, lin_w, _ = cubic._candidates(x, y, spans)
    before = _build.launches["rmi_cubic_l1"]
    dspans = seg.make_spans(t.to(dev), B)
    got = cubic_l1_kernel.cubic_l1_sums(x.to(dev), y.to(dev), cubic_w.to(dev),
                                        lin_w.to(dev), dspans)
    torch.cuda.synchronize()
    assert _build.launches["rmi_cubic_l1"] == before + 1
    want = cubic_l1_kernel.cubic_l1_sums_plain(x, y, cubic_w, lin_w, spans)
    for g, w in zip(got, want):
        assert ((g.cpu() - w).abs() <= cubic_l1_kernel.sum_tolerance(w)).all()
    again = cubic_l1_kernel.cubic_l1_sums(x.to(dev), y.to(dev), cubic_w.to(dev),
                                          lin_w.to(dev), dspans)
    assert all(torch.equal(a, g) for a, g in zip(again, got))   # a fixed order


def test_card_build_cubic_leaves_matches_cpu_build(dev):
    keys = rdata.books_like_on_device(1 << 18, 7, dev)
    card = rt.train(rdata.RMIDataset(keys, KeyType.U64), "robust_linear,cubic", 256)
    cpu = rt.train(rdata.RMIDataset(keys.cpu(), KeyType.U64), "robust_linear,cubic", 256)
    assert card.model_max_error == cpu.model_max_error
    diff = (card.leaf_errors.cpu() - cpu.leaf_errors).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 8
    lb = torch.searchsorted(keys, keys, side="left")
    g, e = rt.lookup(card, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    assert torch.equal(rt.search(card, keys), lb)


# batch sizes of the K4 tail tests: none, a lone head, ends on both sides
LOOKUP_SIZES = [0, 1, 5, (1 << 16) + 3]


def _lookup_on_card(dev, case, top, leaf, sliced=False, key_type=KeyType.U64):
    """K4's fused entry on ``case`` (images of ``key_type`` keys) against
    its plain version on the card and on the CPU, counted as one launch of
    rmi_lookup_<leaf kernel> and none of the per-element entries;
    ``sliced`` serves the queries from one past a 16-byte boundary."""
    q, *rest = case
    qd = q.to(dev)
    if sliced:
        qd, q = qd[1:], q[1:]
        assert qd.data_ptr() % 16 == 8
    card = [qd] + [a.to(dev) if torch.is_tensor(a) else
                   params_to(a, dev) if isinstance(a, dict) else a for a in rest]
    kw = {"top_type": top, "leaf_type": leaf, "key_type": key_type}
    entry = f"rmi_lookup_{get_model(leaf).leaf_kernel}"
    before = dict(_build.launches)
    g, e = eval_kernel.lookup_clamped(*card, **kw)
    torch.cuda.synchronize()
    assert _build.launches[entry] == before[entry] + 1
    assert all(_build.launches[k] == before[k] for k in before if k.startswith("rmi_leaf_eval"))
    B = card[3].shape[0]
    ops = eval_kernel.top_operands(top, card[1], dev, B, leaf)
    table = eval_kernel.lookup_rows(card[2], card[3], ops, B)     # as lookup keeps them
    g2, e2 = eval_kernel.lookup_clamped(*card, **kw, table=table, top_args=ops)
    assert torch.equal(g2, g) and torch.equal(e2, e)
    pg, pe = eval_kernel.lookup_clamped_plain(*card, **kw)
    cg, ce = eval_kernel.lookup_clamped_plain(q, *rest, **kw)
    assert g.dtype == e.dtype == torch.int64 and g.shape == e.shape == q.shape
    assert torch.equal(g, pg) and torch.equal(e, pe)
    assert torch.equal(g.cpu(), cg) and torch.equal(e.cpu(), ce)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("top", LEAVES)
def test_k4_lookup_fused(dev, top, leaf):
    """Each top kind (the four leaf kernels, which the six affine tops
    share) with each leaf kernel, at the tail sizes."""
    for m in LOOKUP_SIZES:
        _lookup_on_card(dev, lookup_case(top, leaf, m, 20 + m), top, leaf)


@pytest.mark.parametrize("leaf", LEAVES)
def test_k4_lookup_misaligned_keys(dev, leaf):
    for m in (2, 6, (1 << 16) + 4):
        _lookup_on_card(dev, lookup_case("cubic", leaf, m, 30 + m), "cubic", leaf,
                        sliced=True)


@pytest.mark.parametrize("leaf", ["linear", "cubic", "loglinear", "normal", "lognormal"])
def test_k4_leaf_eval_tails(dev, leaf):
    """The per-element entries on lookup's x and leaf ids at the tail
    sizes: both from a 16-byte boundary, both one past it, and on two
    phases (the wrapper copies them onto one)."""
    mleaf = get_model(leaf)
    for m in LOOKUP_SIZES:
        q, top_w, leaf_w, _, n, kminf, s = lookup_case("cubic", leaf, m, 40 + m)
        x = kernel_input(mleaf, model_float_input(mleaf, q, kminf, s))
        ids = predict_top_assignment(get_model("cubic"), top_w, model_float_input(
            get_model("cubic"), q, kminf, s), leaf_w.shape[0] - 1)
        xd, idd, wd = x.to(dev), ids.to(dev), leaf_w.to(dev)
        for xs, ls, cx, cl in ((xd, idd, x, ids), (xd[1:], idd[1:], x[1:], ids[1:]),
                               (xd[1:], idd[:-1], x[1:], ids[:-1])):
            got = eval_kernel.leaf_eval_clamped(xs, wd, ls, n - 1, leaf_type=leaf)
            torch.cuda.synchronize()
            want = eval_kernel.leaf_eval_clamped_plain(cx, leaf_w, cl, n - 1, leaf_type=leaf)
            assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
            assert torch.equal(got, eval_kernel.leaf_eval_clamped_plain(
                xs, wd, ls, n - 1, leaf_type=leaf))


@pytest.mark.parametrize("spec", ["cubic,linear", "cubic,lognormal"])
def test_lookup_table_only_for_the_fused_route(dev, spec):
    """An index keeps a lookup table only where lookup reads one; its
    guesses hold the bound on every key either way."""
    keys = rdata.books_like_on_device(1 << 16, 6, dev)
    rmi = rt.train(rdata.RMIDataset(keys, KeyType.U64), spec, 256)
    guess, err = rt.lookup(rmi, keys)
    assert (rmi.lookup_table_cache is not None) == eval_kernel.fused_lookup(*spec.split(","))
    lb = torch.searchsorted(keys, keys)
    assert bool(((guess - lb).abs() <= err).all())


def test_k4_lookup_refuses_bad_inputs(dev):
    q, top_w, leaf_w, errs, n, kminf, s = [a.to(dev) if torch.is_tensor(a) else a
                                           for a in lookup_case("cubic", "normal", 64, 3)]
    kw = {"top_type": "cubic", "leaf_type": "normal"}
    with pytest.raises(ValueError):
        eval_kernel.lookup_clamped(q.int(), top_w, leaf_w, errs, n, kminf, s, **kw)
    with pytest.raises(ValueError):
        eval_kernel.lookup_clamped(q, top_w, leaf_w, errs[1:], n, kminf, s, **kw)
    table = eval_kernel.lookup_table(leaf_w, errs)
    with pytest.raises(ValueError):                      # a table of other rows
        eval_kernel.lookup_clamped(q, top_w, leaf_w, errs, n, kminf, s, **kw,
                                   table=table[:, :3].contiguous())
    B = leaf_w.shape[0] - 1
    with pytest.raises(ValueError, match="16-byte"):     # 8 bytes off
        eval_kernel.lookup_clamped(q, top_w, leaf_w[1:], errs[1:], n, kminf, s, **kw,
                                   table=table.view(-1)[1:1 + 4 * B].view(B, 4))


def test_wrappers_refuse_bad_inputs(dev):
    v = torch.zeros(10, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        scan_kernel.scan_i32(v, is_max=True, fill=0)
    x = torch.zeros(10, dtype=torch.float64, device=dev)
    w = torch.zeros(4, 2, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        eval_kernel.leaf_eval_clamped(x, w, torch.zeros(10, dtype=torch.int64), 5,
                                      leaf_type="linear")


# the kernel wrappers a build calls, with their plain versions
BUILD_WRAPPERS = [(scan_kernel, "fixdups"), (select_kernel, "aug_fit_moments"),
                  (select_kernel, "aug_centered_moments"),
                  (sweep_kernel, "sweep_leaf_max"), (sweep_kernel, "span_run_max"),
                  (eval_kernel, "leaf_eval_clamped"), (cubic_l1_kernel, "cubic_l1_sums")]


def _record_build(monkeypatch, fn):
    """fn()'s result, and the (wrapper name, args, kwargs) of every kernel
    wrapper call it made."""
    calls = []
    for mod, name in BUILD_WRAPPERS:
        def rec(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls.append((_name, a, kw))
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    out = fn()
    monkeypatch.undo()
    return out, calls


def _replay_on_plain(name, args, kw):
    """A recorded wrapper call against its plain version: K2, K6 and the
    leaf fit's moments on the card within their tolerances, the others
    bit-equal (K3 and K4 on CPU copies, where torch.addcmul is an exact
    FMA)."""
    mod = dict((n, m) for m, n in BUILD_WRAPPERS)[name]
    got = getattr(mod, name)(*args, **kw)
    if name in ("sweep_leaf_max", "leaf_eval_clamped"):
        args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    want = getattr(mod, name + "_plain")(*args, **kw)
    if name == "aug_fit_moments":
        tol = select_kernel.fit_tolerance(*args, want)
        assert all(bool(((g - w).abs() <= t).all()) for g, w, t in zip(got, want, tol))
    elif name == "aug_centered_moments":
        x, y, mean_x, mean_y, lo, hi = args
        syy = select_kernel.aug_centered_moments_plain(y, y, mean_y, mean_y, lo, hi)[0]
        _k2_close(got, want, syy.cpu())
    elif name == "cubic_l1_sums":
        for g, w in zip(got, want):
            assert ((g.cpu() - w.cpu()).abs() <= cubic_l1_kernel.sum_tolerance(w.cpu())).all()
    else:
        assert torch.equal(got.cpu().long(), want.cpu().long()), name


@pytest.mark.parametrize("spec", ["radix18,linear", "cubic,radix8"])
def test_card_build_integer_models_matches_cpu_build(dev, spec, monkeypatch):
    """A hint-table top (radix18) and hint-table leaves (radix8) built on
    the card at n = 2^16 against the CPU build: max_err equal, leaf errors
    within 1 in at most 8 leaves (the linear leaves' sums), and where the
    tops agree the hint tables and their leaf errors bit-equal; the
    kernels the card build launched replayed against their plain
    versions."""
    keys = rdata.books_like_on_device(1 << 16, 9, dev)
    B = 256
    card, calls = _record_build(monkeypatch, lambda: rt.train(
        rdata.RMIDataset(keys, KeyType.U64), spec, B))
    cpu = rt.train(rdata.RMIDataset(keys.cpu(), KeyType.U64), spec, B)
    assert card.model_max_error == cpu.model_max_error
    diff = (card.leaf_errors.cpu() - cpu.leaf_errors).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 8
    top_int = get_model(card.top_type).output_int
    same_top = params_equal(params_to(card.device_top_params, "cpu"), cpu.device_top_params)
    assert same_top or not top_int
    if same_top and get_model(card.leaf_type).output_int:
        assert params_equal(params_to(card.device_leaf_params, "cpu"), cpu.device_leaf_params)
        assert torch.equal(card.leaf_errors.cpu(), cpu.leaf_errors)
    names = {name for name, _, _ in calls}
    assert {"fixdups", "span_run_max"} <= names
    assert ("sweep_leaf_max" in names) == (not get_model(card.leaf_type).output_int)
    for name, args, kw in calls:
        _replay_on_plain(name, args, kw)
    lb = torch.searchsorted(keys, keys, side="left")
    g, e = rt.lookup(card, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    assert torch.equal(rt.search(card, keys), lb)


@pytest.mark.parametrize("spec,B", [
    ("radix,linear", 1024), ("bradix,linear", 1024), ("histogram,linear", 1024),
    *[(f"radix{b},linear", 1024) for b in (8, 18, 22, 26, 28)],
    ("linear,radix8", 1024), ("linear,radix18", 64), ("linear,radix22", 16)])
def test_card_trains_every_integer_model(dev, spec, B):
    """Every integer model as a top, and each hint table as a leaf layer
    within its cap, trains on the card (radix26 and radix28 tops: 256 MB
    and 1 GB tables) with the bound holding and search exact."""
    keys = rdata.books_like_on_device(1 << 16, 10, dev)
    rmi = rt.train(rdata.RMIDataset(keys, KeyType.U64), spec, B)
    lb = torch.searchsorted(keys, keys, side="left")
    g, e = rt.lookup(rmi, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    assert torch.equal(rt.search(rmi, keys), lb)


def test_card_build_matches_cpu_build(dev):
    keys = rdata.books_like_on_device(1 << 18, 5, dev)
    card = rt.train(rdata.RMIDataset(keys, KeyType.U64), "cubic,linear", 1024)
    cpu = rt.train(rdata.RMIDataset(keys.cpu(), KeyType.U64), "cubic,linear", 1024)
    assert card.model_max_error == cpu.model_max_error
    diff = (card.leaf_errors.cpu() - cpu.leaf_errors).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 4
    lb = torch.searchsorted(keys, keys, side="left")
    g, e = rt.lookup(card, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    assert torch.equal(rt.search(card, keys), lb)


def _k5_case(case):
    """(sorted int64 keys, sorted int64 queries) of one K5 case."""
    rng = np.random.default_rng(len(case))
    if case == "duplicates":           # runs longer than a stripe
        keys = np.repeat(rng.integers(-(1 << 40), 1 << 40, 3000), rng.integers(1, 300, 3000))
        keys.sort()
        q = np.concatenate([keys[rng.integers(0, keys.size, 1 << 16)],
                            rng.integers(-(1 << 41), 1 << 41, 1 << 14)])
        return keys, np.sort(q)
    if case == "straddle":             # blocks ~100 stripes wide (bounds widened later)
        keys = np.sort(rng.integers(-(1 << 62), 1 << 62, 1 << 20))
        nq = 12 * ssk.KQ + 77
        q = np.sort(rng.integers(keys[64 * 2000], keys[64 * 3300], nq))
        return keys, q
    n = {"dense": 1 << 20, "sparse": 1 << 22, "extremes": 1 << 16,
         "ragged": 1 << 18}[case]
    keys = np.sort(rng.integers(-(1 << 62), 1 << 62, n))
    nq = {"dense": 1 << 20, "sparse": 2048, "extremes": 1 << 14,
          "ragged": 3 * ssk.KQ + 17}[case]
    q = rng.integers(-(1 << 62), 1 << 62, nq)
    if case == "extremes":
        keys[:5] = tkeys.IMAGE_MIN
        keys[-70:] = KeyType.U64.max_image
        q[:300] = tkeys.IMAGE_MIN
        q[300:600] = KeyType.U64.max_image
        q[600:700] = KeyType.U64.max_image - 1
    return np.sort(keys), np.sort(q)


def _tight_bounds(stripe_first, q):
    """Per-block [lo, hi]: min of max(lb1 - 1, 0) and max of lb1."""
    lb1 = np.searchsorted(stripe_first, q)
    nb = -(-q.size // ssk.KQ)
    pad = np.full(nb * ssk.KQ - q.size, lb1[-1])
    blocks = np.concatenate([lb1, pad]).reshape(nb, ssk.KQ)
    return np.maximum(blocks.min(1) - 1, 0), blocks.max(1)


def _staged(lo, hi, n):
    """Group-first keys each block stages: from its 16-byte aligned start."""
    glo, ghi = ssk.group_bounds(torch.from_numpy(lo), torch.from_numpy(hi), n)
    return (ghi - (glo & ~1)).numpy()


# window widths hi - lo of the straddle case, cycled over its blocks: a
# window of w + 1 stripes stages 8 (w + 1) group-first keys, so w = 767
# stages exactly the cap of 6144
STRADDLE_WIDTHS = [150, 766, 767, 768, 3000, 767]


@pytest.mark.parametrize("case", ["dense", "sparse", "duplicates", "extremes", "ragged",
                                  "straddle"])
def test_k5_serve_sorted(dev, case):
    keys, q = _k5_case(case)
    sf = keys[::64]
    lo, hi = _tight_bounds(sf, q)
    if case == "straddle":   # widen each window to its width, lb1 still inside
        w = np.resize(STRADDLE_WIDTHS, lo.size)
        assert np.all(hi - lo <= w.min())
        lo = lo - 10
        hi = lo + w
        assert lo.min() >= 1 and hi.max() <= sf.size
        staged = _staged(lo, hi, keys.size)
        cap = ssk.WINDOW_CAP
        assert (staged > cap).any() and (staged < cap).any() and (staged == cap).any()
    if case == "sparse":     # every block's window exceeds the shared-memory stage
        assert _staged(lo, hi, keys.size).min() > ssk.WINDOW_CAP
    want = np.searchsorted(keys, q, side="left")
    for g in ssk.LEVELS:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (q, keys[::g], keys, lo, hi)]
        before = _build.launches["rmi_serve_sorted"]
        got = (ssk.serve_sorted(*args) if g == ssk.GROUP
               else ssk.serve_sorted_level(*args, g))
        torch.cuda.synchronize()
        assert _build.launches["rmi_serve_sorted"] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        plain = ssk.serve_sorted_plain(*args, g)
        assert torch.equal(got, plain)
    # the whole key range as every block's window: still exact
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (q, keys[::ssk.GROUP], keys, np.zeros_like(lo), np.full_like(hi, sf.size))]
    np.testing.assert_array_equal(ssk.serve_sorted(*args).cpu().numpy(), want)


@pytest.mark.parametrize("case", ["dense", "sparse", "duplicates", "extremes", "ragged"])
def test_k5_serve_sorted_scatter(dev, case):
    """The scatter entry writes the answer of sorted query i to
    out[order[i]]: bit-equal to its plain version and to np.searchsorted
    of the batch in its own order."""
    keys, q = _k5_case(case)
    lo, hi = _tight_bounds(keys[::64], q)
    order = np.random.default_rng(3).permutation(q.size)
    unsorted = np.empty_like(q)
    unsorted[order] = q
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (q, order, keys[::ssk.GROUP], keys, lo, hi)]
    before = _build.launches["rmi_serve_sorted_scatter"]
    got = ssk.serve_sorted_scatter(*args)
    torch.cuda.synchronize()
    assert _build.launches["rmi_serve_sorted_scatter"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.searchsorted(keys, unsorted, side="left"))
    assert torch.equal(got, ssk.serve_sorted_scatter_plain(*args))


def test_k5_window_off_lb1_disagrees(dev):
    keys, q = _k5_case("dense")
    sf = keys[::64]
    lo, hi = _tight_bounds(sf, q)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (q, keys[::ssk.GROUP], keys, lo + 2, hi)]
    got = ssk.serve_sorted(*args)
    assert torch.equal(got, ssk.serve_sorted_plain(*args))
    assert int((got.cpu().numpy() != np.searchsorted(keys, q)).sum()) > 0


def test_k5_refuses_bad_inputs(dev):
    keys = torch.arange(10_000, dtype=torch.int64, device=dev)
    gf = keys[::ssk.GROUP].contiguous()
    q = torch.arange(0, 1000, 2, dtype=torch.int64, device=dev)
    b = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):                  # a bound on the CPU
        ssk.serve_sorted(q, gf, keys, b.cpu(), b)
    with pytest.raises(ValueError):                  # non-contiguous queries
        ssk.serve_sorted(torch.arange(0, 2000, 2, dtype=torch.int64, device=dev)[::2],
                         gf, keys, b, b)
    with pytest.raises(ValueError):                  # one bound per block
        ssk.serve_sorted(q, gf, keys, torch.cat([b, b]), b)
    with pytest.raises(ValueError):                  # int64 only
        ssk.serve_sorted(q.int(), gf, keys, b, b)
    with pytest.raises(ValueError, match="16-byte"):  # keys 8 bytes off
        ssk.serve_sorted(q, keys[1:][::ssk.GROUP].contiguous(), keys[1:], b, b)


def test_card_serving_routes(dev):
    """search (2^20 random queries: sort, then K5's scatter entry),
    search_sorted (K5) and fast_search (the packed plan) on the card, all
    exact."""
    keys = rdata.books_like_on_device(1 << 20, 6, dev)
    rmi = rt.train(rdata.RMIDataset(keys, KeyType.U64), "cubic,linear", 1374)
    assert lookup_fast.get_plan(rmi).kind == "packed"
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randint(int(keys[0]) - 1000, int(keys[-1]) + 1000, (1 << 20,),
                      generator=gen, device=dev)
    q[:1000] = keys[:1000]
    want = torch.searchsorted(keys, q)
    before = dict(_build.launches)
    assert torch.equal(rt.search(rmi, q), want)
    qs = torch.sort(q).values
    assert torch.equal(rt.search_sorted(rmi, qs), torch.searchsorted(keys, qs))
    torch.cuda.synchronize()
    assert _build.launches["rmi_serve_sorted_scatter"] == before["rmi_serve_sorted_scatter"] + 1
    assert _build.launches["rmi_serve_sorted"] == before["rmi_serve_sorted"] + 1
    assert torch.equal(lookup_fast.fast_search(rmi, q), want)


@pytest.mark.parametrize("key", [p.key for p in probe_kernels.PROBES])
def test_probe_kernel(dev, key):
    """Each card probe on probes/probe_pallas.py's inputs (D at width 128
    and 2048, one block and 132): equal to its plain version."""
    probe = next(p for p in probe_kernels.PROBES if p.key == key)
    for width, blocks in ((128, 1), (2048, 132)) if key == "D" else ((128, None),):
        args = probe_kernels.probe_inputs(probe, dev, width=width)
        kw = {} if blocks is None else {"blocks": blocks}
        before = _build.launches[probe.entry]
        got = probe.wrapper(*args, **kw)
        torch.cuda.synchronize()
        assert _build.launches[probe.entry] == before + 1
        want = probe.plain(*args, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(got.cpu(), probe.plain(*[a.cpu() for a in args], **kw))
        if key == "D":
            assert bool((got == 4096.0).all())


@pytest.mark.parametrize("width", [128, 1024])
@pytest.mark.parametrize("iters,slots", [(4096, 16), (37, 16), (5, 16), (4096, 3)])
def test_probe_ring_marked_table(dev, width, iters, slots):
    """D on a table whose rows differ (x[r, 0] = r mod 251): a copy that
    lands in the wrong slot, or a slot read before its copy or after the
    next one, cannot give the plain version's sums."""
    tbl = probe_kernels.ring_table(width, dev, marked=True)
    got = probe_kernels.row_ring(tbl, iters=iters, slots=slots, blocks=7)
    torch.cuda.synchronize()
    want = probe_kernels.row_ring_plain(tbl, iters=iters, blocks=7)
    assert torch.equal(got, want) and len(set(want.tolist())) > 1


def test_probe_compares_on_random_bits(dev):
    """B2 and B3 on 2^20 random 64-bit patterns: equal to numpy's uint64 <."""
    rng = np.random.default_rng(11)
    x, q = (rng.integers(0, 2**64, 1 << 20, dtype=np.uint64) for _ in range(2))
    q[:1000] = x[:1000]
    q[1000:2000] = x[1000:2000] ^ np.uint64(1 << 63)
    want = torch.from_numpy((x < q).astype(np.int32))
    tx, tq = (torch.from_numpy(a.view(np.int64)).to(dev) for a in (x, q))
    assert torch.equal(probe_kernels.less_than_u64(tx, tq).cpu(), want)
    halves = [torch.from_numpy((a >> np.uint64(s)).astype(np.uint32).view(np.int32)).to(dev)
              for a in (x, q) for s in (32, 0)]
    assert torch.equal(probe_kernels.less_than_u32pair(*halves).cpu(), want)


@pytest.mark.parametrize("width", [4, 128, 2048])
def test_probe_row_copy_spread(dev, width):
    """E over the card: nq from none to 70000 rows (above the ~57K one
    block held), rows of 16 B to 8 KB, indices repeated, equal to x[idx]."""
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.normal(size=(4099, width)).astype(np.float32)).to(dev)
    for nq in (0, 1, 2, 257, 70_000):
        idx = rng.integers(0, 4099, nq, dtype=np.int32)
        idx[: nq // 3] = idx[nq // 2] if nq else 0
        idx_d = torch.from_numpy(idx).to(dev)
        before = _build.launches["rmi_probe_row_copy"]
        got = probe_kernels.row_copy(idx_d, x)
        torch.cuda.synchronize()
        assert _build.launches["rmi_probe_row_copy"] == before + 1
        assert got.shape == (nq, width) and torch.equal(got, x[idx_d.long()])


GATHER_NQS = [0, 1, 2, 257, 70_000]
# C1's tables: odd and narrow widths take the 4-byte path, a row of 2048
# loops within its warp, and 70000 rows of 36 are more than a block's
# shared memory held before C1 read rows through L2
GATHER_TABLES = [(4099, 1), (4099, 3), (4099, 4), (4099, 128), (4099, 2048), (70_000, 36)]
TAKE_TABLES = [4096, 1 << 22]          # 16 KB, and 16 MB


def _gather_indices(rng, rows, nq):
    """nq int32 indices in [0, rows), the first third one repeated row."""
    idx = rng.integers(0, rows, nq, dtype=np.int32)
    idx[: nq // 3] = idx[nq // 2] if nq else 0
    return idx


def _offset_view(a, dev, offset):
    """``a`` on the card starting ``offset`` elements past an allocation,
    so off a 16-byte boundary for offset 1-3 of 4-byte elements."""
    buf = torch.empty(a.size + offset, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
    view = buf[offset:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


def _check_gather(fn, entry, tbl, idx):
    """One wrapper call: one launch counted, bit-equal to tbl[idx]."""
    before = _build.launches[entry]
    got = fn(tbl, idx)
    torch.cuda.synchronize()
    assert _build.launches[entry] == before + 1
    want = tbl[idx.long()]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("nq", GATHER_NQS)
@pytest.mark.parametrize("rows,width", GATHER_TABLES)
def test_probe_gather_rows_direct(dev, rows, width, nq):
    """C1 read through L2: any table, any nq, bit-equal to tbl[idx]."""
    rng = np.random.default_rng(rows + width + nq)
    tbl = torch.from_numpy(rng.normal(size=(rows, width)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(_gather_indices(rng, rows, nq)).to(dev)
    _check_gather(probe_kernels.gather_rows, "rmi_probe_gather_rows", tbl, idx)


@pytest.mark.parametrize("rows,width", GATHER_TABLES)
def test_probe_gather_rows_offset_views(dev, rows, width):
    """C1 on views of idx and tbl one element past a 16-byte boundary:
    the table's rows take the 4-byte path."""
    rng = np.random.default_rng(width)
    tbl = _offset_view(rng.normal(size=(rows, width)).astype(np.float32), dev, 1)
    idx = _offset_view(_gather_indices(rng, rows, 257), dev, 1)
    assert tbl.data_ptr() % 16 and idx.data_ptr() % 16
    _check_gather(probe_kernels.gather_rows, "rmi_probe_gather_rows", tbl, idx)


@pytest.mark.parametrize("nq", GATHER_NQS)
@pytest.mark.parametrize("ntbl", TAKE_TABLES)
def test_probe_take_direct(dev, ntbl, nq):
    """C2 read through L2: a table of 16 KB or 16 MB, any nq, bit-equal
    to tbl[idx]."""
    rng = np.random.default_rng(ntbl + nq)
    tbl = torch.from_numpy(rng.normal(size=ntbl).astype(np.float32)).to(dev)
    idx = torch.from_numpy(_gather_indices(rng, ntbl, nq)).to(dev)
    _check_gather(probe_kernels.take, "rmi_probe_take", tbl, idx)


@pytest.mark.parametrize("ntbl", TAKE_TABLES)
def test_probe_take_offset_views(dev, ntbl):
    """C2 on views of idx and tbl one element past a 16-byte boundary,
    nq from 1 to 70000."""
    rng = np.random.default_rng(ntbl)
    tbl = _offset_view(rng.normal(size=ntbl).astype(np.float32), dev, 1)
    for nq in (1, 2, 3, 257, 70_000):
        idx = _offset_view(_gather_indices(rng, ntbl, nq), dev, 1)
        assert tbl.data_ptr() % 16 and idx.data_ptr() % 16
        _check_gather(probe_kernels.take, "rmi_probe_take", tbl, idx)


@pytest.mark.parametrize("width", [128, 512, 2048])
@pytest.mark.parametrize("warps", [1, 16])
def test_probe_ring_warps_and_card_form(dev, width, warps):
    """D with ``warps`` issuing warps a block, each its own stream and
    ring, on the marked table: one block (the probe's 4096 copies per
    warp; 37 copies through 3 slots, a ring that wraps), five blocks, and
    the whole-card form, each equal to its plain version; the whole-card
    form's partial sums add up to the TPU probe's own sum of its walk."""
    tbl = probe_kernels.ring_table(width, dev, marked=True)
    for kw in ({}, {"iters": 37, "slots": 3}, {"iters": 300, "slots": 3, "blocks": 5}):
        before = _build.launches["rmi_probe_row_ring"]
        got = probe_kernels.row_ring(tbl, warps=warps, **kw)
        torch.cuda.synchronize()
        assert _build.launches["rmi_probe_row_ring"] == before + 1
        want = probe_kernels.row_ring_plain(tbl, warps=warps, **{
            k: v for k, v in kw.items() if k != "slots"})
        assert got.shape == (kw.get("blocks", 1) * warps,) and torch.equal(got, want)
    got = probe_kernels.row_ring_card(tbl, warps=warps)
    torch.cuda.synchronize()
    assert torch.equal(got, probe_kernels.row_ring_card_plain(tbl, warps=warps))
    j = np.arange(probe_kernels.RING_ITERS)
    assert float(got.double().sum()) == float(((j * 7919) % (1 << 17) % 251).sum())


def _entry_calls(dev):
    """C entry -> one call of the wrapper that launches it, on small
    inputs (whose values do not matter here)."""
    n, B = 5000, 64
    x, y, t, _ = (a.to(dev) for a in _leaf_inputs(n, B, 12))
    spans = seg.make_spans(t, B)
    yf = y.double()
    mx = torch.zeros(B, dtype=torch.float64, device=dev)
    keys = torch.arange(0, 2 * n, 2, dtype=torch.int64, device=dev)
    q = torch.arange(0, 1000, 2, dtype=torch.int64, device=dev)
    lo = torch.zeros(1, dtype=torch.int64, device=dev)
    hi = torch.full((1,), -(-n // 64), dtype=torch.int64, device=dev)
    gf = keys[::ssk.GROUP].contiguous()
    rmi = rt.train(rdata.RMIDataset(keys, KeyType.U64), "linear,linear", 4)
    plan = lookup_fast.get_plan(rmi)
    plan.top_args = packed_kernel.top_operands(rmi)
    zeros = torch.zeros(B, 4, dtype=torch.float64, device=dev)
    levels, packed = hier_kernel.hier_levels(keys, 1)
    calls = {
        "rmi_scan_i32": lambda: scan_kernel.scan_i32(y, is_max=True, fill=seg.INT32_MIN),
        "rmi_aug_moments": lambda: select_kernel.aug_centered_moments(
            x, yf, mx, mx, spans.aug_starts, spans.aug_ends),
        "rmi_aug_moments_weighted": lambda: select_kernel.aug_centered_moments(
            x, yf, mx, mx, spans.aug_starts, spans.aug_ends, weights=torch.ones_like(x)),
        "rmi_aug_moments_xx": lambda: select_kernel.aug_centered_xx(
            x, mx, spans.aug_starts, spans.aug_ends),
        "rmi_span_run_max": lambda: sweep_kernel.span_run_max(
            keys, torch.arange(n, dtype=torch.int32, device=dev), spans.starts, spans.ends),
        "rmi_cubic_l1": lambda: cubic_l1_kernel.cubic_l1_sums(
            x, y, zeros, zeros[:, :2].contiguous(), spans),
        "rmi_serve_sorted": lambda: ssk.serve_sorted(q, gf, keys, lo, hi),
        "rmi_serve_sorted_scatter": lambda: ssk.serve_sorted_scatter(
            q, torch.arange(q.shape[0], device=dev), gf, keys, lo, hi),
        "rmi_hier_resolve": lambda: hier_kernel.resolve(
            levels, q, q // 2, torch.full_like(q, 40), K=1, n=n, packed=packed),
        "rmi_bounded_lower_bound": lambda: cachefix_kernel.bounded_lower_bound(
            keys, q, q // 2, torch.full_like(q, 40), n, 8),
        "rmi_cachefix_interp": lambda: cachefix_kernel.cachefix_interp(
            keys, keys * 3, q, q // 2, torch.full_like(q, 40), 8, 3 * n),
        "rmi_packed_search": lambda: packed_kernel.packed_search(rmi, plan, q),
        "rmi_sorted_bounds": lambda: packed_kernel.sorted_bounds(rmi, plan, q),
        "rmi_key_normalize": lambda: top_kernel.key_normalize(keys, 0.0, 1.0),
        "rmi_top_cubic_candidates": lambda: top_kernel.top_cubic_candidates(x, y, 0.5),
        "rmi_top_l1_cubic": lambda: top_kernel.top_l1_cubic(x, y, 0.5, zeros[0].repeat(4)),
        "rmi_top_moments": lambda: top_kernel.top_moments("linear", x, y, 0.5),
        "rmi_top_table_fit": lambda: top_kernel.top_table_fit(keys, y[:n], 0.5, 8),
        "rmi_top_assign": lambda: top_kernel.top_assign(
            "linear", zeros[:1, :2].contiguous(), x, B),
        "rmi_fixdups": lambda: scan_kernel.fixdups(keys),
        "rmi_aug_fit_moments": lambda: select_kernel.aug_fit_moments(
            x, y, spans.aug_starts, spans.aug_ends),
        "rmi_aug_fit_log_moments": lambda: select_kernel.aug_fit_log_moments(
            x, y, spans.aug_starts, spans.aug_ends),
        "rmi_fixdups_carry": lambda: scan_kernel.fixdups_carry(
            keys, 7, torch.ones(1, dtype=torch.bool, device=dev),
            torch.full((), 3, dtype=torch.int32, device=dev)),
        "rmi_aug_fit_sums": lambda: select_kernel.aug_fit_sums(
            x, y, spans.aug_starts, spans.aug_ends),
        "rmi_span_run_max_carry": lambda: sweep_kernel.span_run_max_carry(
            keys, torch.arange(n, dtype=torch.int32, device=dev), spans.starts, spans.ends,
            0, n, torch.zeros(1, dtype=torch.bool, device=dev),
            torch.full((), n - 1, dtype=torch.int32, device=dev)),
        "rmi_top_l1_partial": lambda: top_kernel.top_l1_partial(
            x, y, 0.5, zeros[0].repeat(4), n - 3),
    }
    for leaf in LEAVES:
        kernel = get_model(leaf).leaf_kernel
        w = torch.zeros(B, get_model(leaf).ppm, dtype=torch.float64, device=dev)
        case = [a.to(dev) if torch.is_tensor(a) else a for a in lookup_case(leaf, leaf, 100, 3)]
        calls[f"rmi_sweep_max_{kernel}"] = lambda w=w, leaf=leaf: sweep_kernel.sweep_leaf_max(
            x, y, spans.starts, spans.ends, w, n, leaf_type=leaf)
        calls[f"rmi_leaf_eval_{kernel}"] = lambda w=w, leaf=leaf: (
            eval_kernel.leaf_eval_clamped(x, w, t.long(), n - 1, leaf_type=leaf))
        calls[f"rmi_lookup_{kernel}"] = lambda case=case, leaf=leaf: (
            eval_kernel.lookup_clamped(*case, top_type=leaf, leaf_type=leaf))
    for probe in probe_kernels.PROBES:
        args = probe_kernels.probe_inputs(probe, dev)
        calls[probe.entry] = lambda probe=probe, args=args: probe.wrapper(*args)
    return calls


@pytest.mark.parametrize("entry", list(_build.SIGNATURES))
def test_every_wrapper_counts_one_launch(dev, entry):
    """Each C entry's wrapper, called once through the compiled binding,
    adds one to its entry's count and nothing to any other."""
    call = _entry_calls(dev)[entry]
    before = dict(_build.launches)
    call()
    torch.cuda.synchronize()
    moved = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
    assert moved == {entry: 1}


@pytest.mark.parametrize("scatter", [False, True])
def test_k5_empty_batch_counts_no_launch(dev, scatter):
    """K5's wrappers on an empty batch return an empty answer without a
    launch and count none, and still refuse a tensor off the queries'
    card or a non-contiguous one."""
    q = torch.empty(0, dtype=torch.int64, device=dev)

    def serve(keys, lo):
        gf = keys[::ssk.GROUP].contiguous()
        if scatter:
            return ssk.serve_sorted_scatter(q, q, gf, keys, lo, q)
        return ssk.serve_sorted(q, gf, keys, lo, q)
    keys = torch.arange(0, 20_000, 2, dtype=torch.int64, device=dev)
    before = dict(_build.launches)
    out = serve(keys, q)
    torch.cuda.synchronize()
    assert out.shape == (0,) and out.dtype == torch.int64 and out.is_cuda
    assert _build.launches == before
    with pytest.raises(ValueError, match="contiguous"):       # a bound on the CPU
        serve(keys, q.cpu())
    with pytest.raises(ValueError, match="contiguous"):       # non-contiguous keys
        serve(keys[::2], q)


def test_binding_refuses_bad_tensors(dev):
    """The compiled binding raises, launches nothing and counts nothing
    for a tensor off the card or on another card, a non-contiguous
    tensor, a tensor of the wrong type, a wrong argument count and an
    unknown entry; a tensor given for an output is written in place."""
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).view(8, 128)
    before = dict(_build.launches)
    bad = [((x.cpu(), x.shape, x.numel()), ValueError, "not on a CUDA device"),
           ((x, x.cpu(), x.numel()), ValueError, "not on a CUDA device"),
           ((x.t(), (128, 8), x.numel()), ValueError, "non-contiguous"),
           ((x, torch.empty(128, 8, device=dev).t(), x.numel()), ValueError,
            "non-contiguous"),
           ((x.double(), x.shape, x.numel()), ValueError, "want"),
           ((x, x.shape), TypeError, "takes 3 arguments"),
           ((x, x.shape, 1.5), TypeError, "want an int")]
    if torch.cuda.device_count() > 1:
        bad.append(((x, torch.empty_like(x, device="cuda:1"), x.numel()), ValueError,
                    "tensors on"))
    for args, err, match in bad:
        with pytest.raises(err, match=match):
            _build.launch("rmi_probe_scale2", *args)
    with pytest.raises(ValueError, match="non-contiguous"):
        probe_kernels.scale2(x.t())
    i32 = torch.zeros(8, 128, dtype=torch.int32, device=dev)
    for call in (lambda: probe_kernels.scale2(x.double()),           # the wrappers' types,
                 lambda: probe_kernels.less_than_i64(i32, i32),       # checked on the card
                 lambda: probe_kernels.take_lanes(x, i32.long()),     # by the binding
                 lambda: probe_kernels.gather_rows(x, i32[0].long())):
        with pytest.raises(ValueError, match="want"):
            call()
    with pytest.raises(ValueError, match="unknown C entry point"):
        _build.launch("rmi_no_such_entry", x)
    assert _build.launches == before
    out = torch.empty_like(x)
    assert _build.launch("rmi_probe_scale2", x, out, x.numel()) is None
    torch.cuda.synchronize()
    assert torch.equal(out, 2 * x) and _build.launches["rmi_probe_scale2"] == before[
        "rmi_probe_scale2"] + 1


# --------------------------------------------------------------------------
# the compile path on the card: artifacts, cachefix, the CLI
# --------------------------------------------------------------------------

def _compile_keys(n=1 << 14, seed=12):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(10, 2 ** 40, n, dtype=np.uint64))
    keys[500:540] = keys[500]
    return keys


@pytest.mark.parametrize("spec,B", [("cubic,linear", 256), ("radix18,linear", 64),
                                    ("linear,cubic", 128), ("histogram,linear", 32)])
def test_load_artifact_onto_the_card(dev, tmp_path, spec, B):
    """An artifact written from a CPU build loads onto the card (the
    default device) and serves as it serves loaded on the CPU."""
    from rmi_tpu_torch import native
    keys = _compile_keys()
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    meta = rt.output_rmi("c", rp, data_dir=str(tmp_path), emit_cpp=False)
    on_cpu = rt.load_artifact(meta, keys=rp.keys, device="cpu")
    on_card = rt.load_artifact(meta, keys=rp.keys.to(dev))
    assert on_card.keys.is_cuda and on_card.device_leaf_params.is_cuda
    q = np.concatenate([keys[::3], np.random.default_rng(1).integers(
        0, 2 ** 40, 5000, dtype=np.uint64)])
    qi = tkeys.to_image(q)
    g, e = rt.lookup(on_card, qi.to(dev))
    gc, ec = rt.lookup(on_cpu, qi)
    assert torch.equal(g.cpu(), gc) and torch.equal(e.cpu(), ec)
    lb = np.searchsorted(keys, q)
    np.testing.assert_array_equal(rt.search(on_card, qi.to(dev)).cpu().numpy(), lb)
    with native.NativeRMI(meta) as srv:
        np.testing.assert_array_equal(srv.search(q, keys), lb)


def test_train_bounded_on_the_card(dev):
    keys = _compile_keys()
    cpu = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"),
                           "linear_spline,linear", 256, 8)
    card = rt.train_bounded(rt.RMIDataset.from_numpy(keys), "linear_spline,linear", 256, 8)
    assert card.keys.is_cuda
    np.testing.assert_array_equal(card.cache_fix[1], cpu.cache_fix[1])
    np.testing.assert_array_equal(card.cache_fix[2], cpu.cache_fix[2])
    img = tkeys.to_image(keys)
    pos, err = rt.lookup(card, img.to(dev))
    lb = np.searchsorted(keys, keys)
    assert (np.abs(pos.cpu().numpy() - lb) <= 8).all() and (err.cpu() == 8).all()
    np.testing.assert_array_equal(
        rt.search(card, img.to(dev), keys=img.to(dev)).cpu().numpy(), lb)
    assert rt.rmi_size(card) == rt.rmi_size(cpu)


def test_cli_on_the_card_writes_the_cpu_files(dev, tmp_path, monkeypatch):
    """cli.main trains on the card by default; a sum-free configuration
    builds bit-equal there and on the CPU, so the files are the same."""
    import filecmp
    import os
    from rmi_tpu_torch import cli
    keys = _compile_keys()
    path = str(tmp_path / "keys_uint64")
    rt.write_sosd_file(path, keys)
    outs = []
    for name, device in (("card", None), ("cpu", "cpu")):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert cli.main([path, "ns", "linear_spline,linear_spline", "128",
                         "--zero-build-time"], device=device) == 0
        outs.append(d)
    for f in ("ns.h", "ns.cpp", "ns_data.h", "rmi_data/ns_L1_PARAMETERS"):
        assert filecmp.cmp(outs[0] / f, outs[1] / f, shallow=False), f
    assert os.path.exists(outs[0] / "rmi_data" / "ns.json")


# ---------------------------------------------------------------------------
# f64 keys: K4's fused entry with the f64 key kind, K5 and the run-length
# pass on f64 images, and card builds of f64 and u32 keys
# ---------------------------------------------------------------------------

def f64_lookup_case(top, leaf, m, seed, *, B=512, n=1 << 20):
    """lookup_case's inputs for f64 keys: an index over [1e6, 2e9], the
    queries f64 images of values below, inside and above it, negative
    ones, subnormals, +-0.0, +-inf and NaN."""
    rng = np.random.default_rng(seed)
    lo, hi = 1e6, 2e9
    v = np.concatenate([rng.uniform(lo - (hi - lo) / 4, hi + (hi - lo) / 4, m),
                        -rng.uniform(0.0, 1e300, m // 8 + 1),
                        rng.integers(1, 2 ** 52, m // 8 + 1) * 5e-324,
                        [0.0, -0.0, np.inf, -np.inf, np.nan, lo, hi, 1.7e308]])
    v = v[rng.permutation(v.size)[:m]]
    v[:min(m, 5)] = [np.nan, -0.0, np.inf, -np.inf, lo][:min(m, 5)]
    top_w = top_rows(top, seed)[0]
    leaf_w = leaf_table(get_model(leaf).leaf_kernel, B, n, seed + 1)
    errors = torch.from_numpy(rng.integers(0, 1000, B, dtype=np.int64))
    return tkeys.to_image(v), top_w, leaf_w, errors, n, lo, 1.0 / (hi - lo)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("top", LEAVES)
def test_k4_lookup_fused_f64(dev, top, leaf):
    """The f64 key kind for each top kind and leaf kernel, at the tail
    sizes: guess and err bit-equal to the plain version, which decodes
    the images (keys.f64_of_image)."""
    for m in LOOKUP_SIZES:
        _lookup_on_card(dev, f64_lookup_case(top, leaf, m, 50 + m), top, leaf,
                        key_type=KeyType.F64)


@pytest.mark.parametrize("leaf", LEAVES)
def test_k4_lookup_f64_misaligned_keys(dev, leaf):
    for m in (2, 6, (1 << 16) + 4):
        _lookup_on_card(dev, f64_lookup_case("cubic", leaf, m, 60 + m), "cubic", leaf,
                        sliced=True, key_type=KeyType.F64)


@pytest.mark.parametrize("kind", [-1, 2, 7])
def test_k4_lookup_refuses_an_unknown_key_kind(dev, kind):
    q, top_w, leaf_w, errs, n, kminf, s = [a.to(dev) if torch.is_tensor(a) else a
                                           for a in f64_lookup_case("cubic", "linear", 64, 3)]
    table = eval_kernel.lookup_table(leaf_w, errs)
    guess, err = torch.empty_like(q), torch.empty_like(q)
    before = _build.launches["rmi_lookup_linear"]
    with pytest.raises(RuntimeError):
        ops = eval_kernel.top_operands("cubic", top_w, dev, leaf_w.shape[0], "linear")
        _build.launch("rmi_lookup_linear", q, kind, ops[0], 1, *ops[1:], table, guess, err,
                      q.shape[0], leaf_w.shape[0], n, kminf, s)
    assert _build.launches["rmi_lookup_linear"] == before


def _f64_keys_and_queries(n, nq, seed):
    """Sorted f64 keys with duplicate runs (-0.0 among the zeros) and a
    sorted batch of queries with -0.0, +-inf, NaN and the keys' ends, as
    int64 images."""
    rng = np.random.default_rng(seed)
    v = np.repeat(rng.uniform(-1e9, 1e9, n // 4), rng.integers(1, 8, n // 4))[:n]
    v[:40] = -0.0
    v[40:80] = 0.0
    keys = np.sort(tkeys.to_image(v).numpy())
    q = np.concatenate([rng.uniform(-2e9, 2e9, nq - 8),
                        [np.nan, -0.0, 0.0, np.inf, -np.inf, -1e9, 1e9, 5e-324]])
    return keys, np.sort(tkeys.to_image(q).numpy())


@pytest.mark.parametrize("scatter", [False, True])
def test_k5_on_f64_images(dev, scatter):
    keys, q = _f64_keys_and_queries(1 << 18, 1 << 16, 8)
    lo, hi = _tight_bounds(keys[::64], q)
    want = np.searchsorted(keys, q, side="left")
    if scatter:
        order = np.random.default_rng(9).permutation(q.size)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (q, order, keys[::ssk.GROUP], keys, lo, hi)]
        got = ssk.serve_sorted_scatter(*args)
        unsorted = np.empty_like(q)
        unsorted[order] = q
        want = np.searchsorted(keys, unsorted, side="left")
        assert torch.equal(got, ssk.serve_sorted_scatter_plain(*args))
    else:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (q, keys[::ssk.GROUP], keys, lo, hi)]
        got = ssk.serve_sorted(*args)
        assert torch.equal(got, ssk.serve_sorted_plain(*args))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_run_max_on_f64_images(dev):
    """The run-length pass compares images for equality: -0.0 and +0.0 are
    one run, as the reference's f64 compare makes them."""
    keys, _ = _f64_keys_and_queries(1 << 18, 16, 10)
    k = torch.from_numpy(keys)
    yfix = two_layer.fixdups_i32(k)
    # leaf ids from the keys' values, so that no leaf boundary splits a run
    x = tkeys.as_float(k, KeyType.F64)
    t = ((x - x[0]) / (x[-1] - x[0]) * 1023).floor().to(torch.int32)
    spans = seg.make_spans(t, 1024)
    d = [a.to(dev) for a in (k, yfix, spans.starts, spans.ends)]
    got = sweep_kernel.span_run_max(*d)
    want = sweep_kernel.span_run_max_plain(k, yfix, spans.starts, spans.ends)
    assert torch.equal(got.cpu(), want)
    assert int(want.max()) >= 80


@pytest.mark.parametrize("key_type,spec,B", [(KeyType.F64, "cubic,linear", 1024),
                                             (KeyType.F64, "radix,linear", 256),
                                             (KeyType.U32, "linear,linear", 100)])
def test_card_build_of_other_key_types(dev, key_type, spec, B):
    """An f64 (path 7's keys, scaled) and a u32 (path 8's) build on the
    card against the CPU build; bound on every key and exact search through
    the plan both packages pick (hier for radix on f64 keys)."""
    u = rdata.books_like_on_device(1 << 18, 11, dev)
    if key_type is KeyType.F64:
        keys = tkeys.f64_image(tkeys.as_float(u) * 2.0 ** -32)
    else:
        keys = (tkeys.u64_bits(u) >> 30) ^ tkeys.IMAGE_MIN
    card = rt.train(rdata.RMIDataset(keys, key_type), spec, B)
    cpu = rt.train(rdata.RMIDataset(keys.cpu(), key_type), spec, B)
    assert card.model_max_error == cpu.model_max_error
    diff = (card.leaf_errors.cpu() - cpu.leaf_errors).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 4
    lb = torch.searchsorted(keys, keys, side="left")
    g, e = rt.lookup(card, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    q = torch.cat([keys[::7], torch.randint(int(keys[0]), int(keys[-1]), (1 << 15,),
                                            device=dev)])
    assert torch.equal(rt.search(card, q), torch.searchsorted(keys, q))
    assert lookup_fast.get_plan(card).kind == lookup_fast.get_plan(cpu).kind


def _same_build(a, b):
    return (params_equal(a.device_top_params, b.device_top_params)
            and params_equal(a.device_leaf_params, b.device_leaf_params)
            and torch.equal(a.leaf_errors, b.leaf_errors)
            and all(getattr(a, k) == getattr(b, k) for k in two_layer.METRIC_NAMES))


@pytest.mark.parametrize("spec,B", [("cubic,linear", 1024), ("robust_linear,cubic", 512),
                                    ("radix18,linear", 256), ("linear,linear_spline", 64)])
def test_train_async_on_the_card(dev, monkeypatch, spec, B):
    """train_async with the shared inputs, two builds in flight and one
    fetch, is train bit for bit; so is a build under RMI_PROFILE_BUILD=1,
    which times its three stages."""
    from rmi_tpu_torch.train import api
    from rmi_tpu_torch.utils import profiling
    keys = rdata.books_like_on_device(1 << 18, 12, dev)
    data = rdata.RMIDataset(keys, KeyType.U64)
    shared = two_layer.shared_inputs(keys, KeyType.U64)
    pend = [api.train_async(data, spec, B, shared=shared) for _ in range(2)]
    assert pend[0].metrics.device == keys.device
    host = api.fetch_host([p.metrics for p in pend])
    plain = rt.train(data, spec, B)
    assert all(_same_build(p.result(prefetched=h), plain) for p, h in zip(pend, host))
    monkeypatch.setenv("RMI_PROFILE_BUILD", "1")
    profiling.last_phase_times.clear()
    assert _same_build(rt.train(data, spec, B), plain)
    assert set(profiling.last_phase_times) == {"assign", "fit", "sweep"}


def test_optimizer_on_the_card_against_the_cpu(dev, monkeypatch):
    """The fast profile over 2^6 ... 2^14 on 2^16 books-like keys: the
    card's front is the CPU's, as chip_smoke's cross-check holds builds:
    equal (models, branching factor, size), equal max errors, the average
    log2 error within 1e-7 relative or, where the order of sums moves a
    few leaf errors by 1, by no more than those leaves explain.  Each
    phase keeps its builds' device spans.  A pool of the card twice
    measures as the card once."""
    from rmi_tpu_torch import optimizer as t_opt
    from rmi_tpu_torch.parallel import sweep
    from rmi_tpu_torch.utils import profiling
    monkeypatch.setenv("RMI_OPTIMIZER_PROFILE", "fast")
    monkeypatch.setattr(t_opt, "branching_factors", lambda: [2 ** i for i in range(6, 15, 2)])
    keys = rdata.books_like_on_device(1 << 16, 13, dev)
    card_data = rdata.RMIDataset(keys, KeyType.U64)
    cpu_data = rdata.RMIDataset(keys.cpu(), KeyType.U64)
    card = t_opt.find_pareto_efficient_configs(card_data)
    for name in ("phase1", "phase2"):     # each build's span on the card
        spans = profiling.last_phase_builds[name]
        assert len(spans["device_ms"]) == spans["builds"] > 0
        assert all(ms > 0 for ms in spans["device_ms"])
    cpu = t_opt.find_pareto_efficient_configs(cpu_data)
    assert len(cpu) >= 3
    assert [(s.models, s.branching_factor, s.size) for s in card] == \
        [(s.models, s.branching_factor, s.size) for s in cpu]
    n = keys.shape[0]
    for a, b in zip(card, cpu):
        assert round(2 ** a.max_log2_error) == round(2 ** b.max_log2_error)
        if a.average_log2_error == pytest.approx(b.average_log2_error, rel=1e-7, abs=0):
            continue
        rc = rt.train(card_data, a.models, a.branching_factor)
        rp = rt.train(cpu_data, a.models, a.branching_factor)
        counts = []
        for r, k in ((rc, keys), (rp, keys.cpu())):
            t = two_layer.top_assignment(get_model(r.top_type), r.device_top_params, k,
                                         r.norm_offset, r.norm_scale,
                                         r.branching_factor - 1, KeyType.U64)
            s = seg.make_spans(t.to(torch.int32), r.branching_factor)
            counts.append((s.ends - s.starts).cpu().double())
        ec, ep = rc.leaf_errors.cpu(), rp.leaf_errors
        assert torch.equal(counts[0], counts[1])
        assert int((ec - ep).abs().max()) <= 1 and int((ec != ep).sum()) <= 8
        explained = float((counts[0] * (torch.log2(2.0 * ec + 2.0)
                                        - torch.log2(2.0 * ep + 2.0))).abs().sum()) / n
        assert abs(a.average_log2_error - b.average_log2_error) <= \
            1e-7 * abs(b.average_log2_error) + explained
    configs = [(s.models, s.branching_factor) for s in cpu]
    assert t_opt.statistics(configs, sweep.parallel_measure_rmis(
        sweep.device_pool(card_data, [dev, dev]), configs)) == \
        t_opt.measure_rmis(card_data, configs)


def _dp_rank_build(rank, keys, spec, B, device):
    """One rank of a dp build over ``keys`` (numpy) on ``device``: its
    outputs and the launches it counted."""
    from rmi_tpu_torch.parallel import dp_trainer
    data = rt.RMIDataset.from_numpy(keys, device=device)
    keys_local, n = dp_trainer.local_shard(data.keys, data.key_type)
    for entry in _build.launches:
        _build.launches[entry] = 0
    out = dp_trainer.dp_train_two_layer(keys_local, n, data.key_type, *spec.split(","), B)
    return out, dict(_build.launches)


def test_dp_build_of_two_gloo_ranks_sharing_the_card(dev, tmp_path):
    """dp_train_two_layer of cubic,linear by two gloo ranks that share the
    card, at 2^20 keys, against the same build by two gloo ranks on the
    CPU: both ranks return the same bits, the card's ranks launch K1, K2,
    K3 and K4, and card and CPU agree within rmi_tpu's dp tolerance
    (tests/test_parallel.py:52-63: leaf errors within 1 on at most B/20
    leaves, leaf rows within rtol 1e-6 and atol 1e-8, avg_log2 within
    1e-6 relative)."""
    from rmi_tpu_torch.parallel import multihost
    _build.library()                   # built here once; the ranks load it
    spec, B = "cubic,linear", 1024
    keys = rdata.books_like_on_device(1 << 20, 14, dev).cpu()
    keys = tkeys.from_image(keys)
    runs = {}
    for device in ("cuda:0", "cpu"):
        runs[device] = multihost.run_ranks(
            _dp_rank_build, 2, f"file://{tmp_path}/{device.replace(':', '')}",
            backend="gloo", device=device, args=(keys, spec, B, device), timeout=600)
    for ranks in runs.values():
        (a, _), (b, _) = ranks
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]
    launched = {e for rank in runs["cuda:0"] for e, c in rank[1].items() if c}
    assert {"rmi_scan_i32", "rmi_aug_moments", "rmi_sweep_max_linear",
            "rmi_leaf_eval_linear"} <= launched
    (card, _), (cpu, _) = runs["cuda:0"][0], runs["cpu"][0]
    e1, e2 = card[2].astype(np.int64), cpu[2].astype(np.int64)
    assert np.abs(e1 - e2).max() <= 1
    assert (e1 != e2).sum() <= max(1, B // 20)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-6, atol=1e-8)
    assert card[3]["model_avg_log2_error"] == pytest.approx(
        cpu[3]["model_avg_log2_error"], rel=1e-6)


def test_dp_build_of_one_nccl_rank(dev, tmp_path):
    """The same build by one NCCL rank on the card, within rmi_tpu's dp
    tolerance of train on the card."""
    from rmi_tpu_torch.parallel import multihost
    _build.library()
    spec, B = "cubic,linear", 1024
    keys_img = rdata.books_like_on_device(1 << 20, 14, dev)
    (out, launches), = multihost.run_ranks(
        _dp_rank_build, 1, f"file://{tmp_path}/nccl", backend="nccl", device="cuda:0",
        args=(tkeys.from_image(keys_img), spec, B, "cuda:0"), timeout=600)
    assert launches["rmi_aug_moments"] > 0
    single = rt.train(rdata.RMIDataset(keys_img, KeyType.U64), spec, B)
    e1, e2 = single.leaf_errors.cpu().numpy(), out[2].astype(np.int64)
    assert np.abs(e1 - e2).max() <= 1
    assert (e1 != e2).sum() <= max(1, B // 20)
    np.testing.assert_allclose(out[1], single.device_leaf_params.cpu().numpy(),
                               rtol=1e-6, atol=1e-8)
    assert out[3]["model_avg_log2_error"] == pytest.approx(single.model_avg_log2_error,
                                                           rel=1e-6)


# ---------------------------------------------------------------------------
# integer tops in K4's fused entry, and the hierarchical resolve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("top", INT_TOPS)
@pytest.mark.parametrize("kind", KEY_SETS)
def test_k4_lookup_fused_integer_top(dev, kind, top, leaf):
    """Each integer top with each leaf kernel on test_torch_int_lookup.py's
    matrix (u64, u32 and f64 keys, one distinct key, a 53-bit prefix):
    one launch of rmi_lookup_<leaf kernel>, guess and err bit-equal to the
    plain version on the card and on the CPU, from a 16-byte boundary and
    one past it."""
    case, key_type = int_top_case(top, leaf, kind, 3000, 11)
    _lookup_on_card(dev, case, top, leaf, key_type=key_type)
    _lookup_on_card(dev, case, top, leaf, sliced=True, key_type=key_type)


@pytest.mark.parametrize("top", ["radix26", "radix28"])
@pytest.mark.parametrize("kind", ["u64", "narrow"])
def test_k4_lookup_fused_large_tables(dev, top, kind):
    """The 256 MB and 1 GB hint tables, fitted on the card, read through
    64-bit indices."""
    case, key_type = int_top_case(top, "linear", kind, 1 << 16, 13, device=dev)
    _lookup_on_card(dev, case, top, "linear", key_type=key_type)


def test_k4_lookup_refuses_integer_tops_without_operands(dev):
    (q, top_p, leaf_w, errs, n, kminf, s), _ = int_top_case("radix18", "linear", "u64",
                                                              64, 3)
    q, leaf_w, errs = q.to(dev), leaf_w.to(dev), errs.to(dev)
    top_p = params_to(top_p, dev)
    kw = {"top_type": "radix18", "leaf_type": "linear"}
    ops = eval_kernel.top_operands("radix18", top_p, dev, leaf_w.shape[0], "linear")
    with pytest.raises(ValueError):                      # a table of other bits
        eval_kernel.lookup_clamped(q, top_p, leaf_w, errs, n, kminf, s, **kw,
                                   top_args=(*ops[:2], ops[2][:512], ops[3], 1024, 1))
    with pytest.raises(ValueError):                      # bradix's four parameters
        eval_kernel.lookup_clamped(q, top_p, leaf_w, errs, n, kminf, s,
                                   top_type="bradix", leaf_type="linear", top_args=ops)
    table = eval_kernel.lookup_table(leaf_w, errs)
    guess, err = torch.empty_like(q), torch.empty_like(q)
    before = _build.launches["rmi_lookup_linear"]
    for kind, operands in ((6, (ops[1], ops[2][:0], ops[3], 0, 0)),   # no table
                           (8, ops[1:])):                           # no such top
        with pytest.raises(RuntimeError):
            _build.launch("rmi_lookup_linear", q, 0, ops[0], kind, *operands, table, guess,
                          err, q.shape[0], leaf_w.shape[0], n, kminf, s)
    assert _build.launches["rmi_lookup_linear"] == before


# the integer-top kernel's routes (eval_kernel.top_route): each at its
# edges, bit-equal to lookup_steps with K4's plain version

def _route_of(case, top, leaf="linear"):
    B = case[3].shape[0]
    return eval_kernel.top_operands(top, case[1], "cpu", B, leaf)[5]


def _histogram_case(B, kind, n, seed, m=3000):
    """A histogram top fitted over n keys under B leaves; for B = 1, which
    no fit gives, B = 2's one pivot with one leaf row."""
    case, key_type = int_top_case("histogram", "linear", kind, m, seed, B=max(B, 2), n=n)
    if B == 1:
        case = (*case[:2], case[2][:1], case[3][:1], *case[4:])
    return case, key_type


def _round_sizes(leaf, route):
    """Batch sizes at the grid's edges: none, a lone key, three (a head
    and a tail), pairs just past two blocks' round (the third block takes
    a partial round, the rest none), and a batch of several persistent
    rounds past a multiple of a round.  A block's round (csrc/eval.cu
    int_threads * int_pairs): in place 256 pairs; staged or folded 512
    threads of two pairs, one for cubic leaves."""
    per = 256 if route == eval_kernel.IN_PLACE else 512 * (
        1 if get_model(leaf).leaf_kernel == "cubic" else 2)
    return [0, 1, 3, 2 * (per * 2 + 3) + 1, 2 * (per * 2000 + per * 3 + 5) + 1]


@pytest.mark.parametrize("kind", ["u64", "f64"])
@pytest.mark.parametrize("B", [1 << 16, (1 << 16) + 1])
@pytest.mark.parametrize("top", ["radix8", "radix18", "radix22"])
def test_int_lookup_table_routes(dev, top, B, kind):
    """radix8 and radix18 tables folded into the rows, a radix22 table
    read in place (16-bit entries at B = 2^16, 32-bit at 2^16 + 1), from a
    16-byte boundary and one past it, u64 and f64 keys."""
    case, key_type = int_top_case(top, "linear", kind, 3000, 17, B=B)
    assert _route_of(case, top) == (eval_kernel.IN_PLACE if top == "radix22"
                                    else eval_kernel.FOLDED)
    _lookup_on_card(dev, case, top, "linear", key_type=key_type)
    _lookup_on_card(dev, case, top, "linear", sliced=True, key_type=key_type)


@pytest.mark.parametrize("B,n", [(1, 1 << 12), (2, 1 << 12), (4095, 1 << 14), (4096, 1 << 14),
                                 (4097, 1 << 14), (16384, 1 << 16), (16385, 1 << 16)])
def test_int_lookup_histogram_routes(dev, B, n):
    """Histograms of 1 (B = 1, 2), 4094, 4095, 4096 pivots and the largest
    tree one block stages (16383 pivots, 128 KB) in the block, and one
    pivot more in place; u64 keys, and f64 keys at 4095 pivots."""
    case, key_type = _histogram_case(B, "u64", n, 19)
    pivots = case[1]["pivots"].shape[0]
    assert _route_of(case, "histogram") == (eval_kernel.IN_PLACE if pivots > 16383
                                            else eval_kernel.BLOCK)
    _lookup_on_card(dev, case, "histogram", "linear", key_type=key_type)
    _lookup_on_card(dev, case, "histogram", "linear", sliced=True, key_type=key_type)
    if B == 4096:
        case, key_type = _histogram_case(B, "f64", n, 21)
        _lookup_on_card(dev, case, "histogram", "linear", key_type=key_type)


@pytest.mark.parametrize("top,leaf,B,route", [("radix18", "linear", 1 << 16, 2),
                                              ("radix18", "cubic", (1 << 16) + 1, 2),
                                              ("histogram", "linear", 4096, 1),
                                              ("radix22", "normal", 256, 0),
                                              ("bradix", "cubic", 256, 0)])
def test_int_lookup_round_edges(dev, top, leaf, B, route):
    """Each route at the persistent grid's edges (_round_sizes), the keys
    from a 16-byte boundary and one past it; radix18's cubic rows fold
    into exactly FOLD_BYTES."""
    case, key_type = int_top_case(top, leaf, "u64", 8, 23, B=B, n=1 << 14)
    assert _route_of(case, top, leaf) == route
    keys, _ = int_keys("u64", 29, 1 << 14)
    for m in _round_sizes(leaf, route):
        q = tkeys.to_image(keys[np.random.default_rng(m).integers(0, keys.size, m + 1)])
        _lookup_on_card(dev, (q[:m], *case[1:]), top, leaf, key_type=key_type)
        if m:
            _lookup_on_card(dev, (q, *case[1:]), top, leaf, sliced=True, key_type=key_type)


def test_int_lookup_refuses_routes_it_cannot_take(dev):
    """A route the top cannot take is refused (a table staged in a block,
    a histogram folded, radix staged, routes 3, 16 and -1), and so is a
    launch the card refuses: a 16384-pivot histogram's 256 KB tree in one
    block's shared memory.  No launch is counted."""
    (q, top_p, leaf_w, errs, n, kminf, s), _ = int_top_case("radix18", "linear", "u64", 64, 3,
                                                              B=1 << 16)
    q, leaf_w, errs = q.to(dev), leaf_w.to(dev), errs.to(dev)
    top_p = params_to(top_p, dev)
    ops = eval_kernel.top_operands("radix18", top_p, dev, leaf_w.shape[0], "linear")
    hist = int_top_case("histogram", "linear", "u64", 64, 3)[0][1]["pivots"].to(dev)
    wide = torch.arange(1 << 14, dtype=torch.int64, device=dev)
    table = eval_kernel.lookup_table(leaf_w, errs)
    guess, err = torch.empty_like(q), torch.empty_like(q)
    before = _build.launches["rmi_lookup_linear"]
    for kind, operands in [(6, (*ops[1:5], r)) for r in (1, 3, 16, -1)] + [
            (7, (ops[1], ops[2][:0], hist, hist.shape[0], 2)),
            (7, (ops[1], ops[2][:0], wide, wide.shape[0], 1)),
            (4, (top_p["w_int"], ops[2][:0], ops[3], 0, 1))]:
        with pytest.raises(RuntimeError):
            _build.launch("rmi_lookup_linear", q, 0, ops[0], kind, *operands, table, guess,
                          err, q.shape[0], leaf_w.shape[0], n, kminf, s)
    assert _build.launches["rmi_lookup_linear"] == before


@pytest.mark.parametrize("spec,key_type", [("radix,linear", KeyType.U64),
                                           ("histogram,cubic", KeyType.U64),
                                           ("radix18,linear", KeyType.F64),
                                           ("bradix,normal", KeyType.F64)])
def test_integer_top_index_serves_through_the_kernels(dev, spec, key_type):
    """An integer-top index on the card: lookup is one launch of the fused
    entry; on f64 keys the hier plan's search one fused lookup and one
    rmi_hier_resolve launch; the bound holds and search is exact."""
    u = rdata.books_like_on_device(1 << 18, 14, dev)
    keys = tkeys.f64_image(tkeys.as_float(u) * 2.0 ** -32) if key_type is KeyType.F64 else u
    rmi = rt.train(rdata.RMIDataset(keys, key_type), spec, 256)
    kernel = get_model(rmi.leaf_type).leaf_kernel
    before = dict(_build.launches)
    g, e = rt.lookup(rmi, keys)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in _build.launches.items() if c != before[k]}
    assert moved == {f"rmi_lookup_{kernel}": 1}
    lb = torch.searchsorted(keys, keys)
    assert int(((g - lb).abs() > e).sum()) == 0
    q = torch.cat([keys[::5], torch.randint(int(keys[0]), int(keys[-1]), (1 << 16,),
                                            device=dev)])
    plan = lookup_fast.get_plan(rmi)
    assert (plan.kind == "hier") == (key_type is KeyType.F64)
    before = dict(_build.launches)
    got = lookup_fast.fast_search(rmi, q)
    torch.cuda.synchronize()
    moved = {k: c - before[k] for k, c in _build.launches.items() if c != before[k]}
    if plan.kind == "hier":
        assert moved == {f"rmi_lookup_{kernel}": 1, "rmi_hier_resolve": 1}
    assert torch.equal(got, torch.searchsorted(keys, q))


@pytest.mark.parametrize("K", [0, 1, 2, 3])
def test_hier_resolve(dev, K):
    """rmi_hier_resolve against resolve_plain on the card and on the CPU,
    bit for bit, on test_torch_hier.py's cases (n not a multiple of 64,
    runs across a row's edge, guess - err < 0 and guess + err > n), with
    the plan's packed levels, on keys from a 16-byte boundary and one past
    it; one launch a call, none for an empty batch."""
    keys, q, guess, err = resolve_case(K, 70 + K, n=(1 << 16) + 37, m=(1 << 16) + 5)
    n = keys.shape[0]
    for kd in (keys.to(dev), torch.cat([keys[:1], keys]).to(dev)[1:]):
        levels, packed = hier_kernel.hier_levels(kd, K)
        cpu_levels = [lv.cpu() for lv in levels]
        want = hier_kernel.resolve_plain(cpu_levels, q, guess, err, K=K, n=n)
        qd, gd, ed = q.to(dev), guess.to(dev), err.to(dev)
        before = _build.launches["rmi_hier_resolve"]
        got = hier_kernel.resolve(levels, qd, gd, ed, K=K, n=n, packed=packed)
        torch.cuda.synchronize()
        assert _build.launches["rmi_hier_resolve"] == before + 1
        assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
        assert torch.equal(hier_kernel.resolve_plain(levels, qd, gd, ed, K=K, n=n).cpu(), want)
        for m in (0, 1, 33):
            before = _build.launches["rmi_hier_resolve"]
            got = hier_kernel.resolve(levels, qd[:m].clone(), gd[:m].clone(), ed[:m].clone(),
                                      K=K, n=n, packed=packed)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want[:m])
            assert _build.launches["rmi_hier_resolve"] == before + (m > 0)


@pytest.mark.parametrize("kind,K", RESOLVE_EDGES)
def test_hier_resolve_edges(dev, kind, K):
    """rmi_hier_resolve bit-equal to resolve_plain at the resolve's edges
    (test_torch_lookup_kernel.resolve_edge_case, which test_torch_hier.py
    holds to rmi_tpu on the CPU: counts on each window's edges at every
    level, guesses off by err + 1 and by whole rows, queries beyond the
    keys, duplicate runs across sectors and rows, last rows shorter than
    a sector, K = 4..10 over few keys), on keys from a 16-byte boundary
    (whole-sector reads) and one past it."""
    keys, q, guess, err = resolve_edge_case(kind, K, 90 + K)
    n = keys.shape[0]
    want = hier_kernel.resolve_plain(hier_kernel.hier_levels(keys, K)[0], q, guess, err,
                                     K=K, n=n)
    qd, gd, ed = q.to(dev), guess.to(dev), err.to(dev)
    for kd in (keys.to(dev), torch.cat([keys[:1], keys]).to(dev)[1:]):
        levels, packed = hier_kernel.hier_levels(kd, K)
        got = hier_kernel.resolve(levels, qd, gd, ed, K=K, n=n, packed=packed)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind,K", RESOLVE_EDGES)
def test_hier_resolve_ends(dev, kind, K):
    """rmi_hier_resolve bit-equal to resolve_plain at the resolve's edges
    with each guess at either end of the keys and err 0, and #(keys < q)
    on every query outside the keys' range, whatever its guess."""
    keys, q, guess, err = resolve_edge_case(kind, K, 90 + K)
    n = keys.shape[0]
    levels, packed = hier_kernel.hier_levels(keys.to(dev), K)
    cpu_levels = hier_kernel.hier_levels(keys, K)[0]
    out = (q <= keys[0]) | (q > keys[-1])
    zero = torch.zeros_like(err)
    for g in (zero, torch.full_like(guess, n)):
        want = hier_kernel.resolve_plain(cpu_levels, q, g, zero, K=K, n=n)
        got = hier_kernel.resolve(levels, q.to(dev), g.to(dev), zero.to(dev), K=K, n=n,
                                  packed=packed)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(want[out], torch.searchsorted(keys, q[out]))


def test_hier_search_past_the_f64_ends_4m(dev):
    """radix18,linear 65536 on 4M books-like keys made on the card, cast to
    f64 and scaled by 2^-32 (chip_smoke's zoo f64 row at --n 4000000): the
    last key is the double below 2^30, so the image just past it
    truncates to 2^30, a bit no key has, and its top routes it to leaf 0;
    search, search_sorted and fast_search answer it and the images just
    before the first key, past the last and at the ends exactly."""
    u = rdata.books_like_on_device(4_000_000, 42, dev)
    keys = tkeys.f64_image(tkeys.as_float(u).mul_(2.0 ** -32))
    rmi = rt.train(rdata.RMIDataset(keys, KeyType.F64), "radix18,linear", 65536)
    assert lookup_fast.get_plan(rmi).kind == "hier"
    q = torch.cat([keys[-1:] + 1, keys[-1:] + 2, keys[:1] - 1, keys[:1], keys[-1:],
                   torch.tensor([tkeys.IMAGE_MIN, tkeys.IMAGE_MAX], device=dev)])
    want = torch.searchsorted(keys, q)
    assert int(want[0]) == keys.shape[0]
    assert torch.equal(rt.search(rmi, q), want)
    assert torch.equal(lookup_fast.fast_search(rmi, q), want)
    qs, order = q.sort()
    assert torch.equal(rt.search_sorted(rmi, qs), want[order])


def _cachefix_on(dev, arrays):
    return [tkeys.to_image(a).to(dev) if a.dtype == np.uint64
            else torch.from_numpy(a.astype(np.int64)).to(dev) for a in arrays]


@pytest.mark.parametrize("total", [1000, 200_000_000])
@pytest.mark.parametrize("kind", CACHEFIX_EDGES)
def test_cachefix_interp(dev, kind, total):
    """rmi_cachefix_interp bit-equal to cachefix_interp_plain on the card
    and on the CPU at the edges that test_torch_cachefix.py holds to
    rmi_tpu (test_torch_lookup_kernel.cachefix_edge_case: err 0, windows
    clamped at both ends, queries past the last knot, equal knot keys,
    lerps within eps of a line boundary, one knot, the whole u64 range);
    one launch a call, none for an empty batch."""
    knots, vals, q, start, err, line = cachefix_edge_case(kind, seed=5)
    kd, vd, qd, sd, ed = _cachefix_on(dev, (knots, vals.astype(np.int64), q, start, err))
    want = cachefix_kernel.cachefix_interp_plain(kd.cpu(), vd.cpu(), qd.cpu(), sd.cpu(),
                                                 ed.cpu(), line, total)
    before = _build.launches["rmi_cachefix_interp"]
    got = cachefix_kernel.cachefix_interp(kd, vd, qd, sd, ed, line, total)
    torch.cuda.synchronize()
    assert _build.launches["rmi_cachefix_interp"] == before + 1
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    plain = cachefix_kernel.cachefix_interp_plain(kd, vd, qd, sd, ed, line, total)
    assert torch.equal(plain.cpu(), want)
    empty = qd[:0]
    got = cachefix_kernel.cachefix_interp(kd, vd, empty, empty, empty, line, total)
    assert got.shape == (0,) and _build.launches["rmi_cachefix_interp"] == before + 1


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("kind", BOUNDED_EDGES)
def test_bounded_lower_bound(dev, kind, exact):
    """rmi_bounded_lower_bound bit-equal to bounded_lower_bound_plain on
    the card and on the CPU at its edges (bounded_edge_case: err 0,
    windows clamped at 0 and n, queries past the last key, duplicate runs,
    n = 1, a trip count just covering the widest window and one too short
    for it, n below the keys' count), with and without ``exact`` (then
    the lower bound on every query), on keys from a 16-byte boundary and
    one past it; one launch a call."""
    keys, q, guess, err, n, iters = bounded_edge_case(kind, seed=6)
    kimg, qd, gd, ed = _cachefix_on(dev, (keys, q, guess, err))
    want = cachefix_kernel.bounded_lower_bound_plain(kimg.cpu(), qd.cpu(), gd.cpu(), ed.cpu(),
                                                     n, iters, exact)
    if exact:
        assert np.array_equal(want.numpy(), np.searchsorted(keys[:n], q, side="left"))
    for kd in (kimg, torch.cat([kimg[:1], kimg])[1:]):
        before = _build.launches["rmi_bounded_lower_bound"]
        got = cachefix_kernel.bounded_lower_bound(kd, qd, gd, ed, n, iters, exact)
        torch.cuda.synchronize()
        assert _build.launches["rmi_bounded_lower_bound"] == before + 1
        assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    plain = cachefix_kernel.bounded_lower_bound_plain(kimg, qd, gd, ed, n, iters, exact)
    assert torch.equal(plain.cpu(), want)


def test_cachefix_kernels_at_scale(dev):
    """Both kernels over 2^22 queries of 2^24 keys (the grid-stride loop
    past one grid), against their plain versions on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    n = 1 << 24
    keys = torch.sort(torch.randint(-(1 << 62), 1 << 62, (n,), generator=g, device=dev)).values
    q = torch.randint(-(1 << 62), 1 << 62, (1 << 22,), generator=g, device=dev)
    lb = torch.searchsorted(keys, q)
    err = torch.randint(0, 2000, q.shape, generator=g, device=dev)
    guess = (lb + torch.randint(-3000, 3000, q.shape, generator=g, device=dev)).clamp(0, n)
    for exact in (False, True):
        got = cachefix_kernel.bounded_lower_bound(keys, q, guess, err, n, 13, exact)
        assert torch.equal(got, cachefix_kernel.bounded_lower_bound_plain(keys, q, guess, err,
                                                                          n, 13, exact))
    assert torch.equal(got, lb)
    vals = torch.arange(n, device=dev) * 3
    got = cachefix_kernel.cachefix_interp(keys, vals, q, guess, err, 8, 3 * n)
    assert torch.equal(got, cachefix_kernel.cachefix_interp_plain(keys, vals, q, guess, err,
                                                                  8, 3 * n))


def test_cachefix_kernels_refuse_bad_inputs(dev):
    """A tensor on another device or of another dtype raises ValueError
    before any launch."""
    keys = torch.arange(100, dtype=torch.int64, device=dev)
    q, g, e = keys.clone(), keys.clone(), torch.ones_like(keys)
    before = dict(_build.launches)
    with pytest.raises(ValueError):
        cachefix_kernel.bounded_lower_bound(keys.cpu(), q, g, e, 100, 8)
    with pytest.raises(ValueError):
        cachefix_kernel.bounded_lower_bound(keys, q.int(), g, e, 100, 8)
    with pytest.raises(ValueError):
        cachefix_kernel.bounded_lower_bound(keys, q, g.double(), e, 100, 8)
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(keys, keys.cpu(), q, g, e, 8, 100)
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(keys, keys.double(), q, g, e, 8, 100)
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(keys, keys, q, g, e.cpu(), 8, 100)
    with pytest.raises(ValueError):       # the binding's own check
        _build.launch("rmi_bounded_lower_bound", keys, 100, q.cpu(), g, e, 100, 100, 100, 8, 0)
    assert _build.launches == before


def test_cachefix_lookup_and_search_on_the_card(dev):
    """A train_bounded index on the card: lookup is one fused K4 launch and
    one rmi_cachefix_interp, search with the original keys one more
    rmi_bounded_lower_bound (exact on every query, those between keys
    after a run of equal keys among them), bounded_search of a plain
    index one fused lookup and one rmi_bounded_lower_bound; each answer
    equal to the CPU index's."""
    rng = np.random.default_rng(12)
    keys = np.sort(rng.integers(10, 2 ** 40, 1 << 16, dtype=np.uint64))
    keys[100:160] = keys[100]
    q = tkeys.to_image(np.concatenate([keys, rng.integers(0, 2 ** 41, 4096,
                                                          dtype=np.uint64)]))
    img = tkeys.to_image(keys)
    card = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device=dev), "linear_spline,linear",
                            256, 8)
    cpu = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"), "linear_spline,linear",
                           256, 8)
    before = dict(_build.launches)
    pos, err = rt.lookup(card, q.to(dev))
    torch.cuda.synchronize()
    moved = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
    assert moved == {"rmi_lookup_linear": 1, "rmi_cachefix_interp": 1}
    assert torch.equal(pos.cpu(), rt.lookup(cpu, q)[0]) and bool((err == 8).all())
    before = dict(_build.launches)
    found = rt.search(card, q.to(dev), keys=img.to(dev))
    torch.cuda.synchronize()
    moved = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
    assert moved == {"rmi_lookup_linear": 1, "rmi_cachefix_interp": 1,
                     "rmi_bounded_lower_bound": 1}
    assert torch.equal(found.cpu(), torch.searchsorted(img, q))
    plain = rt.train(rt.RMIDataset.from_numpy(keys, device=dev), "cubic,linear", 256)
    before = dict(_build.launches)
    found = bounded_search(plain, q.to(dev))
    torch.cuda.synchronize()
    moved = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
    assert moved == {"rmi_lookup_linear": 1, "rmi_bounded_lower_bound": 1}
    assert torch.equal(found.cpu(), torch.searchsorted(img, q))


def _off_by_one(t):
    """A contiguous copy of t that starts one entry past its storage's
    start: 8 bytes off every 16- and 32-byte boundary."""
    return torch.cat([t[:1], t])[1:]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("kind", WIDE_WINDOWS)
def test_bounded_lower_bound_wide_windows(dev, kind, exact):
    """rmi_bounded_lower_bound bit-equal to bounded_lower_bound_plain over
    windows of up to 2^16 + 1 keys (wide_window_case: uniform, clustered,
    duplicate runs across sectors, u32 images, windows narrower than a
    sector, errors below 0, n below the keys' count with sorted keys
    beyond it), a seventh of the windows missing their lower bound, with
    and without ``exact``, on keys from a 16-byte boundary and one entry
    past it; one launch a call."""
    keys, q, guess, err, n, iters = wide_window_case(kind, seed=13)
    kimg, qd, gd, ed = _cachefix_on(dev, (keys, q, guess, err))
    want = cachefix_kernel.bounded_lower_bound_plain(kimg.cpu(), qd.cpu(), gd.cpu(), ed.cpu(),
                                                     n, iters, exact)
    for kd in (kimg, _off_by_one(kimg)):
        before = _build.launches["rmi_bounded_lower_bound"]
        got = cachefix_kernel.bounded_lower_bound(kd, qd, gd, ed, n, iters, exact)
        torch.cuda.synchronize()
        assert _build.launches["rmi_bounded_lower_bound"] == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", WIDE_WINDOWS)
def test_cachefix_interp_wide_windows(dev, kind):
    """rmi_cachefix_interp bit-equal to cachefix_interp_plain over windows
    of up to 2^16 + 1 knots (the knots' sample searched first), the knots
    and their sample each from a 16-byte boundary and one entry past it;
    one launch a call."""
    keys, q, start, err, n, _ = wide_window_case(kind, seed=14)
    vals = np.cumsum(np.random.default_rng(14).integers(0, 50, n)).astype(np.int64)
    kd, vd, qd, sd, ed = _cachefix_on(dev, (keys[:n], vals, q, start, err))
    want = cachefix_kernel.cachefix_interp_plain(kd.cpu(), vd.cpu(), qd.cpu(), sd.cpu(),
                                                 ed.cpu(), 8, 1 << 40)
    for knots in (kd, _off_by_one(kd)):
        sample = cachefix_kernel.knot_sample(knots)
        for smp in (sample, _off_by_one(sample)):
            before = _build.launches["rmi_cachefix_interp"]
            got = cachefix_kernel.cachefix_interp(knots, vd, qd, sd, ed, 8, 1 << 40, sample=smp)
            torch.cuda.synchronize()
            assert _build.launches["rmi_cachefix_interp"] == before + 1
            assert torch.equal(got.cpu(), want)


def test_cachefix_kernels_windows_of_2_21_keys(dev):
    """Both kernels over windows of 2^21 keys (errors up to 2^20) among 2^23
    sorted keys, 2^20 queries, a seventh of the windows missing: equal to
    the plain versions on the card, exact and not."""
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    n = 1 << 23
    keys = torch.sort(torch.randint(-(1 << 62), 1 << 62, (n,), generator=g, device=dev)).values
    q = torch.randint(-(1 << 62), 1 << 62, (1 << 20,), generator=g, device=dev)
    lb = torch.searchsorted(keys, q)
    err = torch.randint(0, 1 << 20, q.shape, generator=g, device=dev)
    guess = lb + ((torch.rand(q.shape, generator=g, device=dev) * 2 - 1) * err).long()
    guess[::7] = lb[::7] + err[::7] + 1
    guess = guess.clamp(0, n)
    iters = 23
    for exact in (False, True):
        got = cachefix_kernel.bounded_lower_bound(keys, q, guess, err, n, iters, exact)
        assert torch.equal(got, cachefix_kernel.bounded_lower_bound_plain(keys, q, guess, err,
                                                                          n, iters, exact))
    assert torch.equal(got, lb)
    vals = torch.arange(n, device=dev) * 5
    got = cachefix_kernel.cachefix_interp(keys, vals, q, guess, err, 8, 5 * n)
    assert torch.equal(got, cachefix_kernel.cachefix_interp_plain(keys, vals, q, guess, err,
                                                                  8, 5 * n))


def test_cachefix_sample_made_per_index(dev):
    """lookup makes a cachefix index's knot sample on its first call on the
    card and keeps it on the index; a second index, and a copy of the
    first, make their own; every lookup one fused lookup and one
    rmi_cachefix_interp, equal to the CPU index's."""
    rng = np.random.default_rng(16)
    for seed in (0, 1):
        keys = np.sort(np.random.default_rng(seed).integers(10, 2 ** 40, 1 << 17,
                                                            dtype=np.uint64))
        card = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device=dev),
                                "linear_spline,linear", 64, 8)
        cpu = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"),
                               "linear_spline,linear", 64, 8)
        q = tkeys.to_image(np.concatenate([keys[rng.integers(0, keys.size, 4096)],
                                           rng.integers(0, 2 ** 41, 4096, dtype=np.uint64)]))
        assert card.knot_sample_cache is None
        for index in (card, dataclasses.replace(card)):
            before = dict(_build.launches)
            pos = rt.lookup(index, q.to(dev))[0]
            torch.cuda.synchronize()
            moved = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
            assert moved == {"rmi_lookup_linear": 1, "rmi_cachefix_interp": 1}
            assert torch.equal(index.knot_sample_cache, cachefix_kernel.knot_sample(index.keys))
            assert torch.equal(pos.cpu(), rt.lookup(cpu, q)[0])


def test_cachefix_interp_refuses_a_wrong_sample(dev):
    """A sample that is not knot_sample of the knots' length, or lies on
    another device, raises ValueError before any launch."""
    knots = torch.arange(1000, dtype=torch.int64, device=dev)
    q = knots.clone()
    before = dict(_build.launches)
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(knots, knots, q, q, q, 8, 1000, sample=knots[:3])
    with pytest.raises(ValueError):
        cachefix_kernel.cachefix_interp(knots, knots, q, q, q, 8, 1000,
                                        sample=cachefix_kernel.knot_sample(knots).cpu())
    assert _build.launches == before


# ---------------------------------------------------------------------------
# the packed plan's search and K5's window bounds (csrc/packed.cu)
# ---------------------------------------------------------------------------

# (keys, spec, B): every top of the packed plan on test_torch_lookup_kernel's
# key sets (2^12 keys; "u32big" and "f64big" 2^16, for the wide plan) and on
# 2^20 books-like keys: both plan kinds, a histogram's pivots staged in a block
# (64 leaves) and read in place (32768), the 256 MB and 1 GB hint tables, and
# the lognormal top, whose leaf ids come from torch
PACKED_CASES = [("u64", "linear,linear", 4), ("u32", "robust_linear,linear", 64),
                ("f64", "linear_spline,linear", 16), ("u64", "cubic,linear", 64),
                ("single", "cubic,linear", 4), ("u64", "radix,linear", 64),
                ("narrow", "radix,linear", 16), ("narrow", "bradix,linear", 64),
                ("u64", "radix8,linear", 64), ("u32", "radix18,linear", 256),
                ("u64", "radix22,linear", 64), ("u64", "histogram,linear", 64),
                ("u32big", "cubic,linear", 2), ("f64big", "linear,linear", 2),
                ("books", "loglinear,linear", 64), ("books", "normal,linear", 8),
                ("books", "lognormal,linear", 64), ("books", "lognormal,linear", 4),
                ("books", "histogram,linear", 1 << 15), ("books", "radix26,linear", 4096),
                ("books", "radix28,linear", 4096), ("books", "cubic,linear", 1024)]


def _packed_index(dev, kind, spec, B):
    """(index built on the card, [m] query images on the card) of a case."""
    if kind == "books":
        keys = rdata.books_like_on_device(1 << 20, 15, dev)
        key_type = KeyType.U64
        gen = torch.Generator(device=dev).manual_seed(16)
        q = torch.cat([keys[torch.randint(0, keys.shape[0], (1 << 14,), generator=gen,
                                          device=dev)],
                       torch.randint(int(keys[0]) - (1 << 40), int(keys[-1]) + (1 << 40),
                                     (1 << 15,), generator=gen, device=dev),
                       torch.tensor([tkeys.IMAGE_MIN, tkeys.IMAGE_MAX, int(keys[0]),
                                     int(keys[-1])], device=dev)])
    else:
        u, key_type = int_keys(kind.replace("big", ""), 21,
                               1 << 16 if kind.endswith("big") else 1 << 12)
        keys = tkeys.to_image(u).to(dev)
        q = int_queries(u, key_type, 1 << 14, 22).to(dev)
    rmi = rt.train(rdata.RMIDataset(keys, key_type), spec, B)
    return rmi, q


def _moved(before):
    torch.cuda.synchronize()
    return {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}


@pytest.mark.parametrize("kind,spec,B", PACKED_CASES)
def test_packed_search_and_sorted_bounds(dev, kind, spec, B):
    """fast_search of a packed plan is one rmi_packed_search launch (a
    lognormal top: its torch top, then that launch), bit-equal to
    packed_search_plain on the card and to torch.searchsorted, also on a
    view one element past a 16-byte boundary; K5's bounds of the sorted
    batch (its last block short) one rmi_sorted_bounds launch, bit-equal
    to sorted_bounds_plain; search_sorted launches it, then K5."""
    rmi, q = _packed_index(dev, kind, spec, B)
    plan = lookup_fast.get_plan(rmi)
    assert plan.kind in packed_kernel.PACKED_KINDS
    want = torch.searchsorted(rmi.keys, q)
    before = dict(_build.launches)
    got = lookup_fast.fast_search(rmi, q)
    assert _moved(before) == {"rmi_packed_search": 1}
    assert torch.equal(got, want)
    assert torch.equal(got, packed_kernel.packed_search_plain(rmi, plan, q))
    assert torch.equal(packed_kernel.packed_search(rmi, plan, q[1:]), want[1:])
    qs = torch.sort(q[:(1 << 14) + 300]).values
    before = dict(_build.launches)
    lo, hi = packed_kernel.sorted_bounds(rmi, plan, qs)
    assert _moved(before) == {"rmi_sorted_bounds": 1}
    want_lo, want_hi = packed_kernel.sorted_bounds_plain(rmi, plan, qs)
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    before = dict(_build.launches)
    assert torch.equal(rt.search_sorted(rmi, qs), torch.searchsorted(rmi.keys, qs))
    assert _moved(before) == {"rmi_sorted_bounds": 1, "rmi_serve_sorted": 1}


def test_packed_kernels_at_scale(dev):
    """2^22 queries over 2^24 keys (the grid-stride loop past one grid),
    through a packed and a packed_wide plan, against the plain versions on
    the card and torch.searchsorted."""
    keys = rdata.books_like_on_device(1 << 24, 17, dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    q = torch.randint(int(keys[0]), int(keys[-1]), (1 << 22,), generator=gen, device=dev)
    q[: 1 << 18] = keys[torch.randint(0, keys.shape[0], (1 << 18,), generator=gen, device=dev)]
    qs = torch.sort(q).values
    for spec, B, kind in (("cubic,linear", 1 << 14, "packed"), ("linear,linear", 64,
                                                                "packed_wide")):
        rmi = rt.train(rdata.RMIDataset(keys, KeyType.U64), spec, B)
        plan = lookup_fast.get_plan(rmi)
        assert plan.kind == kind
        got = packed_kernel.packed_search(rmi, plan, q)
        assert torch.equal(got, packed_kernel.packed_search_plain(rmi, plan, q))
        assert torch.equal(got, torch.searchsorted(keys, q))
        for a, b in zip(packed_kernel.sorted_bounds(rmi, plan, qs),
                        packed_kernel.sorted_bounds_plain(rmi, plan, qs)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("B", PACKED_EDGE_BS)
@pytest.mark.parametrize("case", PACKED_EDGES)
def test_packed_search_edges(dev, case, B):
    """rmi_packed_search at its edges (test_torch_lookup_kernel.
    packed_edge_case: u32 keys; f64 keys with +-inf, NaN and -0.0
    queries; runs of equal keys longer than a stripe; queries equal to a
    stripe's first key; stripes whose keys jump, where the interpolation
    misses both blocks; n a multiple of neither 8 nor 64; queries outside
    [kmin, kmax]) under a linear top, packed and packed_wide, rows of 3
    to 108 samples: bit-equal to packed_search_plain on the card and to
    torch.searchsorted, also with the keys a view one element past a
    16-byte boundary; rmi_sorted_bounds bit-equal to sorted_bounds_plain."""
    keys, key_type, q = packed_edge_case(case, seed=23)
    rmi = rt.train(rdata.RMIDataset.from_numpy(keys, key_type, device=dev), "linear,linear", B)
    plan = lookup_fast.get_plan(rmi)
    assert plan.kind in packed_kernel.PACKED_KINDS
    q = q.to(dev)
    want = torch.searchsorted(rmi.keys, q)
    before = dict(_build.launches)
    got = packed_kernel.packed_search(rmi, plan, q)
    assert _moved(before) == {"rmi_packed_search": 1}
    assert torch.equal(got, want)
    assert torch.equal(got, packed_kernel.packed_search_plain(rmi, plan, q))
    off = torch.empty(rmi.keys.shape[0] + 1, dtype=torch.int64, device=dev)[1:]
    assert off.data_ptr() % 16 == 8
    shifted = dataclasses.replace(rmi, keys=off.copy_(rmi.keys))
    assert torch.equal(packed_kernel.packed_search(shifted, plan, q), want)
    qs = torch.sort(q).values
    for a, b in zip(packed_kernel.sorted_bounds(rmi, plan, qs),
                    packed_kernel.sorted_bounds_plain(rmi, plan, qs)):
        assert torch.equal(a, b)


def test_packed_kernels_refuse_bad_inputs(dev):
    """The wrappers refuse queries off the plan's device or of another
    dtype (ValueError) before any launch; each C entry refuses a plan or a
    top it cannot take (RuntimeError, nothing launched): S outside
    [1, 127], F not a power of two <= 64, an unknown key kind, the folded
    route, rows off a 16-byte boundary, B or n below 1, kmin above kmax,
    kq below 1."""
    rmi, q = _packed_index(dev, "u64", "radix18,linear", 256)
    plan = lookup_fast.get_plan(rmi)
    with pytest.raises(ValueError):
        packed_kernel.packed_search(rmi, plan, q.cpu())
    with pytest.raises(ValueError):
        packed_kernel.sorted_bounds(rmi, plan, q.int())
    args = list(packed_kernel._launch_args(rmi, plan, q))
    tail = [plan.stripe_first, rmi.keys, q.shape[0], q.shape[0],
            *packed_kernel._norm(rmi, plan)]
    # S, F, the key kind, the folded route, rows off a 16-byte boundary
    off = torch.empty(plan.rows.numel() + 1, dtype=torch.int64, device=dev)[1:]
    bad = [(12, 0), (12, 128), (13, 3), (13, 128), (1, 2), (8, 2),
           (10, off.copy_(plan.rows.view(-1)).view(plan.rows.shape))]
    for at, value in bad:
        a = list(args)
        a[at] = value
        before = dict(_build.launches)
        with pytest.raises(RuntimeError):
            _build.launch("rmi_packed_search", *a, *tail)
        assert _moved(before) == {}
    for fix in ({4: 0}, {5: 0}, {8: tail[9], 9: tail[8]}):    # B, n, kmin > kmax
        with pytest.raises(RuntimeError):
            _build.launch("rmi_packed_search", *args,
                          *[fix.get(i, v) for i, v in enumerate(tail)])
    nb = -(-q.shape[0] // ssk.KQ)
    with pytest.raises(RuntimeError):
        _build.launch("rmi_sorted_bounds", *args, nb, nb, q.shape[0], 0,
                      *packed_kernel._norm(rmi, plan))


# stage A of the build (csrc/top.cu, ops/top_kernel.py) -----------------------

STAGE_A_NS = (1, 2, 31, 32, 33, 1025, 2049, 1_000_003)     # 1025, 2049: ragged rounds
STAGE_A_TOPS = sorted(name for name, m in REGISTRY.items() if not m.output_int)


def _stage_a_keys(kind, n, seed=0):
    """Sorted images of n keys of ``kind`` with runs of equal keys (f64:
    across 0, with -0.0), and their key type."""
    rng = np.random.default_rng(seed)
    if kind == "f64":
        keys = np.sort(np.repeat(rng.normal(0.0, 1e6, n), rng.integers(1, 4, n))[:n])
        keys[: min(n, 3)] = -0.0
        return tkeys.to_image(np.sort(keys)), KeyType.F64
    if kind == "u32":
        keys = np.repeat(rng.integers(0, 2 ** 32, n, dtype=np.uint64), rng.integers(1, 4, n))[:n]
        return tkeys.to_image(np.sort(keys).astype(np.uint32)), KeyType.U32
    keys = np.repeat(rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64, endpoint=True),
                     rng.integers(1, 4, n))[:n]
    return tkeys.to_image(np.sort(keys)), KeyType.U64


def _bits_equal(a, b):
    """f64 tensors equal bit for bit, every NaN as a NaN."""
    a, b = a.cpu(), b.cpu()
    nan = b.isnan()
    return torch.equal(a.isnan(), nan) and torch.equal(a[~nan].view(torch.int64),
                                                       b[~nan].view(torch.int64))


@pytest.mark.parametrize("n", STAGE_A_NS)
@pytest.mark.parametrize("kind", ["u64", "u32", "f64"])
def test_key_normalize(dev, kind, n):
    """rmi_key_normalize bit-equal to normalize on the card and on the CPU,
    one launch, also on keys one element off a 16-byte boundary and on
    f64 keys with -0.0, +-inf and NaN."""
    img, key_type = _stage_a_keys(kind, n)
    kminf, s = two_layer.norm_constants(img, key_type)
    cases = [img]
    if kind == "f64":
        cases.append(torch.cat([img, tkeys.to_image(np.array(
            [-0.0, np.inf, -np.inf, np.nan, 5e-324, 1e300]))]))
    for keys in cases:
        d = keys.to(dev)
        for view in (d, torch.cat([d[:1], d])[1:]):     # the second off a 16-byte boundary
            before = _build.launches["rmi_key_normalize"]
            got = top_kernel.key_normalize(view, kminf, s, key_type)
            torch.cuda.synchronize()
            assert _build.launches["rmi_key_normalize"] == before + 1
            assert _bits_equal(got, two_layer.normalize(view, kminf, s, key_type))
            assert _bits_equal(got, two_layer.normalize(keys, kminf, s, key_type))


def _top_l1_inputs(n, B, seed):
    """Normalized books-like keys, FixDups with runs, sf and the cubic
    top's own candidates over them."""
    img, _ = _stage_a_keys("u64", n, seed)
    kminf, s = two_layer.norm_constants(img)
    x = two_layer.normalize(img, kminf, s)
    yfix = two_layer.fixdups_i32(img)
    sf = B / n
    ep = (two_layer._scale(0.0, sf), two_layer._scale(float(n - 1), sf))
    return x, yfix, sf, top_kernel.top_cubic_candidates_plain(x, yfix, sf, ep, img)


@pytest.mark.parametrize("n", STAGE_A_NS)
@pytest.mark.parametrize("B", [1, 262144, None])     # None: B = n, no scaling
def test_top_l1_cubic(dev, n, B):
    """rmi_top_l1_cubic within cubic_l1_kernel.sum_tolerance of its plain
    version, the choice l < c, and so the row and the case, the same
    unless the sums are closer than their tolerances, the same bits when
    run again, one launch; on views one element off a 16-byte boundary
    too."""
    x, yfix, sf, cand = _top_l1_inputs(n, B or n, n)
    want = top_kernel.top_l1_cubic_plain(x, yfix, sf, cand)
    tol = [cubic_l1_kernel.sum_tolerance(w) for w in want[0]]
    dx, dy = x.to(dev), yfix.to(dev)
    for vx, vy in ((dx, dy), (torch.cat([dx[:1], dx])[1:], torch.cat([dy[:1], dy])[1:])):
        before = _build.launches["rmi_top_l1_cubic"]
        got = top_kernel.top_l1_cubic(vx, vy, sf, cand.to(dev))
        torch.cuda.synchronize()
        assert _build.launches["rmi_top_l1_cubic"] == before + 1
        for g, w, t in zip(got[0].cpu(), want[0], tol):
            assert (g - w).abs() <= t
        c, l = want[0]
        if (l - c).abs() > tol[0] + tol[1]:              # no near tie: the same choice
            assert _bits_equal(got[1], want[1]) and torch.equal(got[2].cpu(), want[2])
        again = top_kernel.top_l1_cubic(vx, vy, sf, cand.to(dev))
        assert all(torch.equal(a, g) for a, g in zip(again, got))


# the top fits (csrc/top.cu's candidates, csrc/top_fit.cu) at their edges:
# n = 1, 2, 3 (robust_linear untrimmed: 2 bnd + 1 >= n), 31-33 around
# XLA's window, 1025 (level 1 past 32 windows), 32769 and 10^6 keys
TOP_FIT_NS = (1, 2, 3, 31, 32, 33, 1025, 32769, 1_000_003)
TOP_FIT_CASES = [("u64", n) for n in TOP_FIT_NS] + [(k, 4099) for k in TOP_FIT_EDGES[1:]]


def _top_fit_inputs(top, kind, n, B):
    """(images, key type, the top's input, FixDups, sf) of top_fit_case."""
    img, key_type = top_fit_case(kind, n)
    kminf, s = two_layer.norm_constants(img, key_type)
    top_in = model_float_input(get_model(top), img, kminf, s, key_type)
    return img, key_type, top_in, two_layer.fixdups_i32(img), B / n


def _same_fit(got, want):
    """A top fit's output (a tensor or an integer top's dict) the same bits."""
    if isinstance(want, dict):
        return want.keys() == got.keys() and all(
            torch.equal(got[k].cpu(), want[k].cpu()) and got[k].dtype == want[k].dtype
            for k in want)
    return got.shape == want.shape and _bits_equal(got, want)


# the cubic candidates' searches also at their edges: runs of 33, 1025 and
# 2^20 + 1 equal keys at both ends (past a round's 31 midpoints and past
# whole rounds), f64 keys led by NaN or -inf, all +inf, ending in +inf
CANDIDATE_CASES = TOP_FIT_CASES + [("end_runs", 3 * r) for r in (33, 1025, (1 << 20) + 1)] + [
    ("f64_nan_led", 4099), ("f64_ninf_led", 4099), ("f64_pinf", 33), ("f64_pinf_end", 4099)]


@pytest.mark.parametrize("B", [4096, None])          # None: B = n, no scaling
@pytest.mark.parametrize("kind,n", CANDIDATE_CASES)
def test_top_cubic_candidates(dev, kind, n, B):
    """rmi_top_cubic_candidates bit-equal to its plain version on the CPU
    and on the card, with the top's endpoint targets and the keys' raw
    ends and without them, one launch, the same bits when run again; its
    two warp searches aten's answers on every key set, n = 1, 2 and 33,
    all keys equal and x all NaN included."""
    img, kt, x, yfix, sf = _top_fit_inputs("cubic", kind, n, B or n)
    ep = (two_layer._scale(0.0, sf), two_layer._scale(float(n - 1), sf))
    dx, dy, dk = x.to(dev), yfix.to(dev), img.to(dev)
    for ep_y, keys, dkeys in ((ep, img, dk), (None, None, None)):
        want = top_kernel.top_cubic_candidates_plain(x, yfix, sf, ep_y, keys, kt)
        before = dict(_build.launches)
        got = top_kernel.top_cubic_candidates(dx, dy, sf, ep_y, dkeys, kt)
        assert _moved(before) == {"rmi_top_cubic_candidates": 1}
        assert _same_fit(got, want)
        assert _same_fit(got, top_kernel.top_cubic_candidates_plain(dx, dy, sf, ep_y, dkeys, kt))
        assert _same_fit(top_kernel.top_cubic_candidates(dx, dy, sf, ep_y, dkeys, kt), got)


@pytest.mark.parametrize("B", [4096, None])
@pytest.mark.parametrize("kind,n", TOP_FIT_CASES)
@pytest.mark.parametrize("top", sorted(top_kernel.MOMENT_TOPS))
def test_top_moments(dev, top, kind, n, B):
    """rmi_top_moments bit-equal to its plain version on the CPU, whose
    whole-array sums follow XLA's order, one launch, the same bits when
    run again; on inputs one element off a 16-byte boundary too."""
    _, _, x, yfix, sf = _top_fit_inputs(top, kind, n, B or n)
    want = top_kernel.top_moments_plain(top, x, yfix, sf)
    dx, dy = x.to(dev), yfix.to(dev)
    for vx, vy in ((dx, dy), (torch.cat([dx[:1], dx])[1:], torch.cat([dy[:1], dy])[1:])):
        before = dict(_build.launches)
        got = top_kernel.top_moments(top, vx, vy, sf)
        assert _moved(before) == {"rmi_top_moments": 1}
        assert _same_fit(got, want)
        assert _same_fit(top_kernel.top_moments(top, vx, vy, sf), got)


@pytest.mark.parametrize("B", [4096, None])
@pytest.mark.parametrize("kind,n", TOP_FIT_CASES)
@pytest.mark.parametrize("bits", [8, 18, 22])
def test_top_table_fit(dev, bits, kind, n, B):
    """rmi_top_table_fit bit-equal to its plain version on the CPU and on
    the card (empty slots between the clusters and past the last key's
    bucket, n equal keys: a prefix of 64), one launch, the same bits when
    run again."""
    _, _, top_in, yfix, sf = _top_fit_inputs(f"radix{bits}", kind, n, B or n)
    want = top_kernel.top_table_fit_plain(top_in, yfix, sf, bits)
    di, dy = top_in.to(dev), yfix.to(dev)
    before = dict(_build.launches)
    got = top_kernel.top_table_fit(di, dy, sf, bits)
    assert _moved(before) == {"rmi_top_table_fit": 1}
    assert _same_fit(got, want)
    assert _same_fit(got, top_kernel.top_table_fit_plain(di, dy, sf, bits))
    assert _same_fit(top_kernel.top_table_fit(di, dy, sf, bits), got)


# rmi_top_moments' walk at its own edges: n within one window (1, 32),
# level 1 at 32 windows and past (1024, 1025), level 2 at 32 windows and
# past (32768, 32769), below one grid wave of the walk (the resident warps
# take 1024 keys each: 500_000 leaves warps idle) and above it
# (3_000_017, ~3 waves on an H100), the last window of the keys partial
# and so the last stage of its warp's ring (1_000_003, 3_000_017); and
# robust_linear spans whose trimmed ends fall inside a window
MOMENT_WALK_NS = (1, 32, 33, 1024, 1025, 32768, 32769, 500_000, 1_000_003, 3_000_017)


@pytest.mark.parametrize("n", MOMENT_WALK_NS)
@pytest.mark.parametrize("top", sorted(top_kernel.MOMENT_TOPS))
def test_top_moments_walk_edges(dev, top, n):
    """rmi_top_moments bit-equal to its plain version on the CPU at the
    walk's and the tree's edges, one launch, the same bits when run
    again, also on inputs one element off a 16-byte boundary."""
    _, _, x, yfix, sf = _top_fit_inputs(top, "u64", n, 65536)
    lo, hi = top_kernel.top_span(top, n)
    if top == "robust_linear" and n >= 500_000:          # trimmed inside a window
        front = (-n % 32) // 2
        assert (lo + front) % 32 != 0 and (hi + front) % 32 != 0
    want = top_kernel.top_moments_plain(top, x, yfix, sf)
    dx, dy = x.to(dev), yfix.to(dev)
    for vx, vy in ((dx, dy), (torch.cat([dx[:1], dx])[1:], torch.cat([dy[:1], dy])[1:])):
        before = dict(_build.launches)
        got = top_kernel.top_moments(top, vx, vy, sf)
        assert _moved(before) == {"rmi_top_moments": 1}
        assert _same_fit(got, want)
        assert _same_fit(top_kernel.top_moments(top, vx, vy, sf), got)


@pytest.mark.parametrize("kind", TABLE_EDGES)
@pytest.mark.parametrize("bits", [8, 18, 22])
def test_top_table_fit_edges(dev, bits, kind):
    """rmi_top_table_fit bit-equal to its plain version on the CPU on
    table_edge_case's keys (books-like u64, u32 and f64 images at 2^22
    keys, one bucket, buckets that skip many slots, one key), one launch,
    the same bits when run again, also on images one element off a
    16-byte boundary (the 64-byte blocks fall elsewhere)."""
    images, yfix, sf = table_edge_case(kind)
    want = top_kernel.top_table_fit_plain(images, yfix, sf, bits)
    di, dy = images.to(dev), yfix.to(dev)
    for vi, vy in ((di, dy), (torch.cat([di[:1], di])[1:], torch.cat([dy[:1], dy])[1:])):
        before = dict(_build.launches)
        got = top_kernel.top_table_fit(vi, vy, sf, bits)
        assert _moved(before) == {"rmi_top_table_fit": 1}
        assert _same_fit(got, want)
        assert _same_fit(top_kernel.top_table_fit(vi, vy, sf, bits), got)


@pytest.mark.parametrize("B", [1, 16, 4096])
@pytest.mark.parametrize("top", STAGE_A_TOPS)
def test_top_assign_affine(dev, top, B):
    """rmi_top_assign under every affine top (lognormal: its plain version
    on the card, no launch) bit-equal to its plain version on the card and
    on the CPU, over top rows fitted, random and degenerate, and inputs
    with signed zeros, subnormals, infinities and NaN, predictions below
    0, past B and NaN; on inputs off a 16-byte boundary too."""
    x = model_inputs(4099, 3)
    launches = 0 if get_model(top).input_domain == "raw" else 1
    for w in top_rows(top, 5):
        want = top_kernel.top_assign_plain(top, w, x, B)
        d = x.to(dev)
        for view in (d, torch.cat([d[:1], d])[1:]):
            before = _build.launches["rmi_top_assign"]
            got = top_kernel.top_assign(top, w.to(dev), view, B)
            torch.cuda.synchronize()
            assert _build.launches["rmi_top_assign"] == before + launches
            assert got.dtype == torch.int32
            assert torch.equal(got.cpu(), want)
            assert torch.equal(got, top_kernel.top_assign_plain(top, w.to(dev), view, B))


@pytest.mark.parametrize("B", [16, 1024])
@pytest.mark.parametrize("kind", KEY_SETS)
@pytest.mark.parametrize("top", INT_TOPS)
def test_top_assign_int(dev, top, kind, B):
    """rmi_top_assign under every integer top, fitted as stage A fits it
    on each key set, bit-equal to its plain version on the CPU, over the
    keys and over queries past every edge; a hint table read as its
    fitted int32 entries whatever B."""
    keys, key_type = int_keys(kind, 11)
    img = tkeys.to_image(keys)
    top_in = model_float_input(get_model(top), img, 0.0, 1.0, key_type)
    top_p, _, _ = two_layer._assign_body(top_in, two_layer.fixdups_i32(img), top_type=top,
                                         B=B)
    q = model_float_input(get_model(top), int_queries(keys, key_type, 5000, 12), 0.0, 1.0,
                          key_type)
    for x in (top_in, q):
        want = top_kernel.top_assign_plain(top, top_p, x, B)
        before = _build.launches["rmi_top_assign"]
        got = top_kernel.top_assign(top, params_to(top_p, dev), x.to(dev), B)
        torch.cuda.synchronize()
        assert _build.launches["rmi_top_assign"] == before + 1
        assert torch.equal(got.cpu(), want)


def test_stage_a_entries_refuse_bad_inputs(dev):
    """An unknown key kind, an unknown top kind, a top without its
    operands, B below 1 or past 2^31, a scratch too small for the sums, no
    keys, an unknown moments model, a span past the keys, a table of 31
    bits: each refused, nothing counted."""
    img = torch.arange(64, dtype=torch.int64, device=dev)
    x = torch.linspace(0, 1, 64, dtype=torch.float64, device=dev)
    y = torch.arange(64, dtype=torch.int32, device=dev)
    w2 = torch.zeros(1, 2, dtype=torch.float64, device=dev)
    c16 = torch.zeros(top_kernel.CAND, dtype=torch.float64, device=dev)
    f64, i64, i32 = [torch.empty(0, dtype=t, device=dev)
                     for t in (torch.float64, torch.int64, torch.int32)]
    bad = [("rmi_key_normalize", (img, 2, 64, 64, 0.0, 1.0)),
           ("rmi_top_assign", (x, i64, w2, 9, i64, i32, i64, 0, 64, 64, 16)),
           ("rmi_top_assign", (x, i64, f64, 0, i64, i32, i64, 0, 64, 64, 16)),
           ("rmi_top_assign", (f64, img, f64, 6, i64, i32, i64, 0, 64, 64, 16)),
           ("rmi_top_assign", (x, i64, w2, 0, i64, i32, i64, 0, 64, 64, 0)),
           ("rmi_top_assign", (x, i64, w2, 0, i64, i32, i64, 0, 64, 64, 1 << 32)),
           ("rmi_top_l1_cubic", (x, y, 64, 1.0, 0, c16, 2, 0, 2, (1, 4), 1)),
           ("rmi_top_cubic_candidates", (x, y, i64, 2, 64, 1.0, 0, 0, 0.0, 0.0, 16)),
           ("rmi_top_cubic_candidates", (x, y, i64, 0, 0, 1.0, 0, 0, 0.0, 0.0, 16)),
           ("rmi_top_moments", (x, y, 64, 0, 64, 1.0, 0, 2, 1 << 12, 1 << 12, 2)),
           ("rmi_top_moments", (x, y, 64, 10, 65, 1.0, 0, 0, 1 << 12, 1 << 12, 2)),
           ("rmi_top_moments", (x, y, 64, 0, 64, 1.0, 0, 0, 8, 8, 2)),
           ("rmi_top_table_fit", (img, y, 64, 1.0, 0, 31, 2, 2)),
           ("rmi_top_table_fit", (img, y, 0, 1.0, 0, 8, 256, 2))]
    for entry, args in bad:
        before = dict(_build.launches)
        with pytest.raises(RuntimeError):
            _build.launch(entry, *args)
        assert _build.launches == before, entry
    with pytest.raises(ValueError):
        top_kernel.top_l1_cubic(x, y.long(), 1.0, c16)
    with pytest.raises(ValueError):
        top_kernel.top_moments("cubic", x, y, 1.0)


@pytest.mark.parametrize("top", ["cubic", "linear", "robust_linear", "normal", "radix18",
                                 "lognormal"])
def test_stage_a_on_card(dev, top):
    """_assign_body on the card: a cubic top normalizes, fits in its two
    entries and assigns, the linear-family and normal tops normalize, fit
    in rmi_top_moments and assign, radix18 fits in rmi_top_table_fit and
    assigns, the lognormal top launches none of them; the ids are the
    plain assignment's under the card's own top row, and but for the
    lognormal top (its fit's sums in torch's order) the top and the ids
    are the CPU build's (the cubic's L1 sums differ in order, but not its
    choice on these keys)."""
    keys = rdata.books_like_on_device(1 << 20, 9, dev)
    B, mtop = 4096, get_model(top)
    stage = {"rmi_key_normalize", "rmi_top_cubic_candidates", "rmi_top_l1_cubic",
             "rmi_top_moments", "rmi_top_table_fit", "rmi_top_assign"}
    moments = {"rmi_key_normalize", "rmi_top_moments", "rmi_top_assign"}
    want = {"cubic": stage - {"rmi_top_moments", "rmi_top_table_fit"},
            "radix18": {"rmi_top_table_fit", "rmi_top_assign"}, "lognormal": set()}.get(top, moments)
    kminf, s = two_layer.norm_constants(keys)
    before = dict(_build.launches)
    top_in = model_float_input(mtop, keys, kminf, s)
    top_w, t, _ = two_layer._assign_body(top_in, two_layer.fixdups_i32(keys), top_type=top,
                                         B=B, keys=keys)
    assert set(_moved(before)) & stage == want
    top_w = params_to(top_w, "cpu")
    assert torch.equal(t.cpu(), top_kernel.top_assign_plain(top, top_w, top_in.cpu(), B))
    if top != "lognormal":
        k = keys.cpu()
        hw, ht, _ = two_layer._assign_body(model_float_input(mtop, k, kminf, s),
                                           two_layer.fixdups_i32(k), top_type=top, B=B, keys=k)
        assert params_equal(top_w, hw) and torch.equal(t.cpu(), ht)


# the leaf fits' moments and FixDups (csrc/moments.cu, csrc/scan.cu) ----------

FIXDUPS_CARD = FIXDUPS_EDGES + ("dups_1m", "run_of_1m")


def _card_fixdups_keys(kind):
    """fixdups_case's keys, or at a million keys: runs of geometric
    lengths, one run of 10^6 keys."""
    rng = np.random.default_rng(len(kind))
    if kind == "dups_1m":
        return torch.from_numpy(np.sort(np.repeat(
            rng.integers(-(1 << 62), 1 << 62, 400_000), rng.geometric(0.4, 400_000)))[:1_000_003])
    if kind == "run_of_1m":
        return torch.from_numpy(np.concatenate([np.arange(50), np.full(1_000_017, 50),
                                                np.arange(51, 3000)]).astype(np.int64))
    return fixdups_case(kind)


@pytest.mark.parametrize("kind", FIXDUPS_CARD)
def test_fixdups(dev, kind):
    """rmi_fixdups bit-equal to its plain version on the CPU and on the
    card, one launch (none for no keys), the same bits when run again, on
    keys one element off a 16-byte boundary too."""
    keys = _card_fixdups_keys(kind)
    want = scan_kernel.fixdups_plain(keys)
    d = keys.to(dev)
    for view in (d, torch.cat([d[:1], d])[1:]):
        before = dict(_build.launches)
        got = scan_kernel.fixdups(view)
        assert _moved(before) == ({"rmi_fixdups": 1} if keys.shape[0] else {})
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got, scan_kernel.fixdups_plain(view))
        assert torch.equal(scan_kernel.fixdups(view), got)


FIT_CARD = FIT_EDGES + ("many_chunks", "path8_like", "path3_like")


def _card_fit_case(kind):
    """fit_case's (x, y, aug_starts, aug_ends), or on the card's scale: two
    leaves of 2^19 keys (128 chunks each, more than a warp's lanes), four
    of 2^20 (path 8's leaves are ~2M keys), 2^22 keys in 1376 leaves of
    ~3050 (path 3's), the first 5000 keys one run."""
    if kind not in ("many_chunks", "path8_like", "path3_like"):
        return fit_case(kind)
    n, B = {"many_chunks": ((1 << 20) + 333, 2), "path8_like": (1 << 22, 4),
            "path3_like": (1 << 22, 1376)}[kind]
    x, y, t = leaf_arrays(n, B, 90 + B)
    if kind == "path3_like":
        x[:5000] = x[0]
        y = _fixdups_np(x)
    spans = seg.make_spans(torch.from_numpy(t), B)
    return torch.from_numpy(x), torch.from_numpy(y), spans.aug_starts, spans.aug_ends


def _f64_bits(outs):
    return [o.contiguous().view(torch.int64) for o in outs]


@pytest.mark.parametrize("form", ["xy", "xx", "log"])
@pytest.mark.parametrize("kind", FIT_CARD)
def test_aug_fit_moments(dev, kind, form):
    """rmi_aug_fit_moments (the linear form, or the normal one, xx) and
    rmi_aug_fit_log_moments (log: loglinear leaves) within fit_tolerance
    of their plain versions on the CPU and on the card (the log form's
    count equal), one launch, the same bits when run again and when the
    schedule of long-leaf chunks has no slot or too few (those leaves
    then done by their own warps)."""
    x, y, lo, hi = _card_fit_case(kind)
    y = None if form == "xx" else y
    log = form == "log"
    wrapper, plain = ((select_kernel.aug_fit_log_moments, select_kernel.aug_fit_log_moments_plain)
                      if log else (select_kernel.aug_fit_moments,
                                   select_kernel.aug_fit_moments_plain))
    entry = "rmi_aug_fit_log_moments" if log else "rmi_aug_fit_moments"
    want = plain(x, y, lo, hi)
    tol = select_kernel.fit_tolerance(x, y, lo, hi, want, log_form=log)
    dx, dlo, dhi = x.to(dev), lo.to(dev), hi.to(dev)
    dy = None if y is None else y.to(dev)
    before = dict(_build.launches)
    got = wrapper(dx, dy, dlo, dhi)
    assert _moved(before) == {entry: 1}
    assert len(got) == len(want)
    plain_card = plain(dx, dy, dlo, dhi)
    for g, w, pc, t in zip(got, want, plain_card, tol):
        assert g.dtype == torch.float64 and g.shape == lo.shape
        assert ((g.cpu() - w).abs() <= t).all()
        assert ((pc.cpu() - w).abs() <= t).all()
    if log:
        assert torch.equal(got[0].cpu(), want[0])
    bits = _f64_bits(got)
    assert all(torch.equal(a, b) for a, b in zip(_f64_bits(wrapper(dx, dy, dlo, dhi)), bits))
    rows, B = len(got), lo.shape[0]
    ey = torch.empty(0, dtype=torch.int32, device=dev) if dy is None else dy
    for capacity in (0, 3):
        if log:
            out, _ = _build.launch(entry, dx, ey, dlo, dhi, dx.shape[0], (rows, B), B,
                                   1 + 7 * capacity, capacity)
        else:
            out, _ = _build.launch(entry, dx, ey, dlo, dhi, dx.shape[0], int(form == "xx"),
                                   (rows, B), B, 1 + 6 * capacity, capacity)
        assert all(torch.equal(a, b) for a, b in zip(_f64_bits(out.unbind(0)), bits))


def test_log_fit_ln_bits(dev):
    """rmi_aug_fit_log_moments' ln y against torch.log on the card for every
    y in [1, 2^28) (path 3's targets stay below 2 * 10^8): one key a leaf,
    whose mean_y is its ln y exactly (one term over a count of one).  The
    keys whose bits differ are counted and printed (PERF.md §6 holds the
    count); none differs by more than one ulp, which fit_tolerance's log
    form allows on every key."""
    top, chunk, differ = 1 << 28, 1 << 24, 0
    for start in range(1, top, chunk):
        y = torch.arange(start, min(start + chunk, top), dtype=torch.int32, device=dev)
        lo = torch.arange(y.shape[0], dtype=torch.int64, device=dev)
        x = torch.zeros(y.shape[0], dtype=torch.float64, device=dev)
        cnt, _, ln, m2, c = select_kernel.aug_fit_log_moments(x, y, lo, lo + 1)
        assert bool((cnt == 1).all()) and not m2.any() and not c.any()
        ulps = ln.view(torch.int64) - torch.log(y.double()).view(torch.int64)
        assert int(ulps.abs().max()) <= 1
        differ += int((ulps != 0).sum())
    print(f"ln y of rmi_aug_fit_log_moments against torch.log on the card: {differ} of "
          f"{top - 1} targets differ (by one ulp)")


def test_fit_entries_refuse_bad_inputs(dev):
    """A negative schedule capacity, keys past 2^31 for int32 indices, and
    wrong types: refused, nothing counted; no leaves or no keys: empty
    answers and no launch."""
    x, y, lo, hi = (a.to(dev) for a in fit_case("books"))
    B = lo.shape[0]
    before = dict(_build.launches)
    with pytest.raises(RuntimeError):
        _build.launch("rmi_aug_fit_moments", x, y, lo, hi, x.shape[0], 0, (4, B), B, 1, -1)
    with pytest.raises(RuntimeError):
        _build.launch("rmi_aug_fit_log_moments", x, y, lo, hi, x.shape[0], (5, B), B, 1, -1)
    with pytest.raises(ValueError):
        select_kernel.aug_fit_log_moments(x, y.long(), lo, hi)
    with pytest.raises(RuntimeError):
        _build.launch("rmi_fixdups", lo, (4,), (1 << 31) + 1)
    with pytest.raises(ValueError):
        select_kernel.aug_fit_moments(x, y.long(), lo, hi)
    with pytest.raises(ValueError):
        scan_kernel.fixdups(y)
    e = lo[:0]
    assert [o.shape for o in select_kernel.aug_fit_moments(x, y, e, e)] == [(0,)] * 4
    assert [o.shape for o in select_kernel.aug_fit_log_moments(x, y, e, e)] == [(0,)] * 5
    assert scan_kernel.fixdups(e).shape == (0,)
    assert _build.launches == before


@pytest.mark.parametrize("spec", ["cubic,linear", "robust_linear,linear", "linear,normal",
                                  "radix18,linear", "cubic,loglinear"])
def test_fit_and_fixdups_on_card(dev, spec):
    """A build on the card takes FixDups and its linear, normal or
    loglinear leaf fit in one launch each, and K1 and K2 not at all; the
    leaf fit allocates no tensor of the keys' size (its peak below n
    bytes, a quarter of an int32 [n] tensor)."""
    n, B = 1 << 22, 4096
    keys = rdata.books_like_on_device(n, 9, dev)
    data = rdata.RMIDataset(keys, KeyType.U64)
    rt.train(data, spec, B)
    before = dict(_build.launches)
    rt.train(data, spec, B)
    moved = _moved(before)
    fit = "rmi_aug_fit_log_moments" if spec.endswith("loglinear") else "rmi_aug_fit_moments"
    assert moved["rmi_fixdups"] == 1 and moved[fit] == 1
    assert not set(moved) & {"rmi_scan_i32", "rmi_aug_moments", "rmi_aug_moments_weighted",
                             "rmi_aug_moments_xx"}
    top, leaf = (get_model(m) for m in spec.split(","))
    kminf, s = two_layer.norm_constants(keys)
    yfix = two_layer.fixdups_i32(keys)
    top_in = model_float_input(top, keys, kminf, s)
    _, t, _ = two_layer._assign_body(top_in, yfix, top_type=top.name, B=B, keys=keys)
    leaf_in = model_float_input(leaf, keys, kminf, s)
    spans = seg.make_spans(t, B)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w = leaf.fit_leaves(leaf_in, yfix, spans)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < n
    assert w.shape == (B, leaf.ppm) and bool(torch.isfinite(w[spans.nonempty]).all())


# ---------------------------------------------------------------------------
# the data-parallel build's per-shard forms
# ---------------------------------------------------------------------------

def _dp_forms(k, x, y, lo, hi, starts, ends, off, n, carries, cand, sf, real, means):
    """Every dp form's wrapper on one shard: {name: output}."""
    mean_x, mean_y = means
    return {
        "fixdups_carry": scan_kernel.fixdups_carry(k, off, carries.continues_left,
                                                   carries.start),
        "span_run_max_carry": sweep_kernel.span_run_max_carry(
            k, y, starts, ends, off, n, carries.continues_right, carries.end),
        **{f"aug_fit_sums {form}": select_kernel.aug_fit_sums(
            x, None if form == "xx" else y, lo, hi, log=form == "log")
           for form in ("xy", "xx", "log")},
        **{f"aug_centered_moments log={log}": select_kernel.aug_centered_moments(
            x, y, mean_x, mean_y, lo, hi, log=log) for log in (False, True)},
        "top_l1_partial": top_kernel.top_l1_partial(x, y, sf, cand, real),
    }


def _check_dp_forms(got, want, x, y, lo, hi, means):
    """The card's dp forms against their plain versions: the integers
    equal, the sums within fit_sums_tolerance, the centered moments within
    centered_tolerance, the partial L1 sums within sum_tolerance."""
    for name, w in want.items():
        g = got[name]
        if name in ("fixdups_carry", "span_run_max_carry"):
            assert torch.equal(g.cpu(), w.cpu()), name
        elif name.startswith("aug_fit_sums"):
            form = name.split()[1]
            tol = select_kernel.fit_sums_tolerance(x, None if form == "xx" else y, lo, hi,
                                                   list(w), log=form == "log")
            for a, b, t in zip(g, w, tol):
                assert ((a.cpu() - b.cpu()).abs() <= t.cpu()).all(), name
        elif name.startswith("aug_centered_moments"):
            tol = select_kernel.centered_tolerance(x, y, *means, lo, hi, list(w),
                                                   log=name.endswith("True"))
            for a, b, t in zip(g, w, tol):
                assert ((a.cpu() - b.cpu()).abs() <= t.cpu()).all(), name
        else:
            assert ((g.cpu() - w.cpu()).abs()
                    <= cubic_l1_kernel.sum_tolerance(w.cpu())).all(), name


def _same_bits_again(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        if x.is_floating_point():
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_dp_forms_on_edge_shards(dev, case):
    """Each dp form on the card (rmi_fixdups_carry, rmi_span_run_max_carry,
    rmi_aug_fit_sums' three forms, K2 on the targets, rmi_top_l1_partial)
    against its plain version on the CPU, on tests/test_torch_dp_kernels'
    edge shards, every rank of each: integers equal, sums within their
    tolerances, the same bits when run again."""
    keys_np, world, B = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    _, spans = _leaves(keys_np, n, B)
    sf = float(B) / float(n)
    rng = np.random.default_rng(23)
    cand = torch.from_numpy(np.concatenate([rng.standard_normal(6) * [1, 1, n, 1, 1, n],
                                            np.zeros(top_kernel.CAND - 6)]))
    for r, comm in enumerate(_groups(shards)):
        k = shards[r]
        x, y = _x_y(shards, n, r)
        c = dp_trainer.dist_carries(k, n, comm)
        local = _clip(spans, m, r)
        lo, hi, starts, ends = local.aug_starts, local.aug_ends, local.starts, local.ends
        means = (torch.from_numpy(rng.random(B)), torch.from_numpy(rng.random(B) * n))
        real = max(0, min(m, n - r * m))
        cpu = (k, x, y, lo, hi, starts, ends, r * m, n, c, cand, sf, real, means)
        card = [a.to(dev) if torch.is_tensor(a) else a for a in cpu]
        card[9] = dp_trainer.Carries(*(t.to(dev) for t in c))
        card[13] = tuple(t.to(dev) for t in means)
        before = dict(_build.launches)
        got = _dp_forms(*card)
        moved = _moved(before)
        assert moved == {"rmi_fixdups_carry": 1, "rmi_span_run_max_carry": 1,
                         "rmi_aug_fit_sums": 3, "rmi_aug_moments": 1,
                         "rmi_aug_moments_weighted": 1, "rmi_top_l1_partial": 1}
        _check_dp_forms(got, _dp_forms(*cpu), x, y, lo, hi, means)
        again = _dp_forms(*card)
        for name in got:
            _same_bits_again(got[name], again[name])


def test_dp_forms_on_a_200m_key_shard(dev):
    """The dp forms on one shard of 200M books-like keys made on the card,
    as the middle rank of three (its first run carried in, its last run
    carried out), 262144 leaves: each against its plain version on the
    card, integers equal, sums within their tolerances."""
    m, B = 200_000_000, 262144
    k = rdata.books_like_on_device(m, 27, dev)
    off, n = m, 3 * m
    kminf, s = two_layer.norm_constants(k, KeyType.U64)
    x = top_kernel.key_normalize(k, kminf, s)
    y = (scan_kernel.fixdups(k) + off).to(torch.int32)
    t = top_kernel.top_assign("linear", torch.tensor([[0.0, B - 1.0]], device=dev,
                                                     dtype=torch.float64), x, B)
    spans = seg.make_spans(t, B)
    del t
    c = dp_trainer.Carries(torch.ones(1, dtype=torch.bool, device=dev),
                           torch.full((), off - 17, dtype=torch.int32, device=dev),
                           torch.ones(1, dtype=torch.bool, device=dev),
                           torch.full((), off + m + 5, dtype=torch.int32, device=dev))
    y[:int(torch.searchsorted(k, k[:1], right=True))] = off - 17   # the carried run
    sums = select_kernel.aug_fit_sums(x, y, spans.aug_starts, spans.aug_ends)
    safe = sums[0].clamp(min=1.0)
    means = (sums[1] / safe, sums[2] / safe)
    cand = torch.tensor([0.1, -0.2, 0.3 * B, 0.0, 0.0, float(B), *[0.0] * 10],
                        dtype=torch.float64, device=dev)
    args = (k, x, y, spans.aug_starts, spans.aug_ends, spans.starts, spans.ends, off, n, c,
            cand, float(B) / n, m, means)
    got = _dp_forms(*args)
    want = {}
    want["fixdups_carry"] = scan_kernel.fixdups_carry_plain(k, off, c.continues_left, c.start)
    want["span_run_max_carry"] = sweep_kernel.span_run_max_carry_plain(
        k, y, spans.starts, spans.ends, off, n, c.continues_right, c.end)
    for form in ("xy", "xx", "log"):
        want[f"aug_fit_sums {form}"] = select_kernel.aug_fit_sums_plain(
            x, None if form == "xx" else y, spans.aug_starts, spans.aug_ends,
            log=form == "log")
    for log in (False, True):
        want[f"aug_centered_moments log={log}"] = select_kernel.aug_centered_moments_plain(
            x, y, *means, spans.aug_starts, spans.aug_ends, log=log)
    want["top_l1_partial"] = top_kernel.top_l1_partial_plain(x, y, float(B) / n, cand, m)
    _check_dp_forms(got, want, x, y, spans.aug_starts, spans.aug_ends, means)
    assert torch.equal(got["fixdups_carry"].cpu(), y.cpu())


def _dp_rank_census(rank, n, spec, B):
    """One NCCL rank's warm dp build of ``spec`` over n books-like keys
    made on the card, under torch.profiler (the inputs' shapes recorded)
    and tools/trace_torch_build.py's OpCensus: the device operations
    launched by torch operators given m = n elements or more
    (device_ops_over), the torch operators over m elements (m_sized), and
    the device launches the profiler saw."""
    from torch.profiler import ProfilerActivity, profile
    tool = _trace_tool()
    keys = rdata.books_like_on_device(n, 31, torch.device("cuda", torch.cuda.current_device()))
    keys_local, n = dp_trainer.local_shard(keys, KeyType.U64)
    del keys

    def build():
        dp_trainer.dp_train_two_layer(keys_local, n, KeyType.U64, *spec.split(","), B)
        torch.cuda.synchronize()
    build()
    census = tool.OpCensus()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof, census:
        build()
    launches = sum(e.count for e in prof.key_averages() if tool._on_device(e))
    m = keys_local.shape[0]
    return tool.device_ops_over(prof, m), tool.m_sized(census.ops, m), launches


@pytest.mark.parametrize("spec,B", [("cubic,linear", 1024), ("cubic,normal", 256),
                                    ("cubic,loglinear", 256)])
def test_dp_build_of_one_nccl_rank_runs_no_m_sized_torch_op(dev, tmp_path, spec, B):
    """One NCCL rank's dp build at 2^22 keys: no device operation the
    profiler traced was launched by a torch operator given the shard's m
    keys, and no torch operator read or wrote m elements (the census of
    tools/trace_torch_build.py --dp): every pass over the shard is a
    kernel of the port; the profiler sees the build's device launches."""
    from rmi_tpu_torch.parallel import multihost
    _build.library()
    (over, big, launches), = multihost.run_ranks(
        _dp_rank_census, 1, f"file://{tmp_path}/nccl", backend="nccl", device="cuda:0",
        args=(1 << 22, spec, B), timeout=600)
    assert over == {} and big == {}
    assert launches > 0

