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
from rmi_tpu_torch.models.base import (kernel_input, model_float_input, params_equal,
                                       params_to, predict_top_assignment)
from rmi_tpu_torch.models.linear import log_targets
from rmi_tpu_torch.ops import (_build, cubic_l1_kernel, eval_kernel, probe_kernels,
                               scan_kernel, select_kernel, sorted_serve_kernel as ssk,
                               sweep_kernel)
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg
from test_torch_lookup_kernel import LEAVES, leaf_table, lookup_case, top_rows

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
    card = [qd] + [a.to(dev) if torch.is_tensor(a) else a for a in rest]
    kw = {"top_type": top, "leaf_type": leaf, "key_type": key_type}
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


# the kernel wrappers a build calls, with their plain versions
BUILD_WRAPPERS = [(scan_kernel, "scan_i32"), (select_kernel, "aug_centered_moments"),
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
    """A recorded wrapper call against its plain version: K2 and K6 on the
    card within their tolerances, the others bit-equal (K3 and K4 on CPU
    copies, where torch.addcmul is an exact FMA)."""
    mod = dict((n, m) for m, n in BUILD_WRAPPERS)[name]
    got = getattr(mod, name)(*args, **kw)
    if name in ("sweep_leaf_max", "leaf_eval_clamped"):
        args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    kw = {k: v for k, v in kw.items() if (name, k) != ("scan_i32", "fill")}
    want = getattr(mod, name + "_plain")(*args, **kw)
    if name == "aug_centered_moments":
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
    assert {"scan_i32", "span_run_max"} <= names
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
    zeros = torch.zeros(B, 4, dtype=torch.float64, device=dev)
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
        _build.launch("rmi_lookup_linear", q, kind, top_w, 1, table, guess, err,
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
