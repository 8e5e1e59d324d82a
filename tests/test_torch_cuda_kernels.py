"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a CUDA device: a CUDA kernel has no
CPU mode (on the CPU each wrapper runs its plain version, which
tests/test_torch_kernels_ref.py holds to rmi_tpu).  Needs no JAX, so it
runs on a machine without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: K1, K3 and K4 (linear, cubic, loglinear and normal leaves,
lognormal through the normal kernel; lookup's fused entry for every
affine top and leaf kernel, against its plain version on the card and on
the CPU, on test_torch_lookup_kernel.py's inputs) bit-equal (max/min never round; K3,
the per-leaf maximum of the sweep, and K4 are compared with the plain
version on CPU copies, where torch.addcmul is an exact FMA); the
run-length pass and the nine card probes equal to their plain versions
(C1 and C2 also bit-equal to tbl[idx] on tables beyond a block's shared
memory, odd widths and offset views);
K2 and its weighted and variance-only
variants within rtol 1e-9 (summation order) plus 1e-12 of the
Cauchy-Schwarz bound sqrt(m2 * sum (y-my)^2) for c; K5 and its scatter
entry, at both sample levels, bit-equal to their plain versions on the
card and to np.searchsorted (int64 compares never round); K6 within
cubic_l1_kernel.sum_tolerance (summation order) and bit-equal to itself
when run again.
"""

import numpy as np
import pytest
import torch

import rmi_tpu_torch as rt
from rmi_tpu_torch import data as rdata
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import cubic, get_model
from rmi_tpu_torch.models.base import kernel_input, model_float_input, predict_top_assignment
from rmi_tpu_torch.models.linear import log_targets
from rmi_tpu_torch.ops import (_build, cubic_l1_kernel, eval_kernel, probe_kernels,
                               scan_kernel, select_kernel, sorted_serve_kernel as ssk,
                               sweep_kernel)
from rmi_tpu_torch.utils import segments as seg
from test_torch_lookup_kernel import LEAVES, lookup_case

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


def _lookup_on_card(dev, case, top, leaf, sliced=False):
    """K4's fused entry on ``case`` against its plain version on the card
    and on the CPU, counted as one launch of rmi_lookup_<leaf kernel> and
    none of the per-element entries; ``sliced`` serves the queries from
    one past a 16-byte boundary."""
    q, *rest = case
    qd = q.to(dev)
    if sliced:
        qd, q = qd[1:], q[1:]
        assert qd.data_ptr() % 16 == 8
    card = [qd] + [a.to(dev) if torch.is_tensor(a) else a for a in rest]
    kw = {"top_type": top, "leaf_type": leaf}
    entry = f"rmi_lookup_{get_model(leaf).leaf_kernel}"
    before = dict(_build.launches)
    g, e = eval_kernel.lookup_clamped(*card, **kw)
    torch.cuda.synchronize()
    assert _build.launches[entry] == before[entry] + 1
    assert all(_build.launches[k] == before[k] for k in before if k.startswith("rmi_leaf_eval"))
    table = eval_kernel.lookup_table(card[2], card[3])       # as lookup keeps it
    g2, e2 = eval_kernel.lookup_clamped(*card, **kw, table=table)
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
