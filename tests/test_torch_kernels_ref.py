"""Plain versions of the port's kernels (K1-K4) against rmi_tpu.

On the CPU each rmi_tpu_torch wrapper runs its plain PyTorch version,
the definition its CUDA kernel is held to on the card
(tests/test_torch_cuda_kernels.py).  Here those plain versions meet the
JAX functions on the same numpy inputs:

  * K1 (scan) bit-equal to rmi_tpu.ops.scan_kernel.scan_i32 run in
    Pallas interpret mode: max and min never round.
  * K2 (moments) within rtol 1e-9 of segments.aug_centered_moments
    (prefix-sum differences vs per-leaf sums: summation order) and of
    aug_centered_moments_pallas (float-float products), plus an atol of
    1e-15 per summed term for leaves whose moments are near 0.
  * K3 (sweep) and K4 (leaf eval) bit-equal to JAX's jitted f64 path,
    which XLA computes as fma(beta, x, alpha); against the Pallas
    float-float kernels in interpret mode, integer outputs may differ by
    1 on at most 0.1% of elements.
  * K3 and K4 for loglinear, normal and lognormal rows (the port's own
    leaf fits of the same keys) bit-equal to rmi_tpu's jitted predict:
    exp1 of the FMA, and phi with the two FMAs XLA forms; lognormal
    through the lognormal input transform, applied before the kernel.
  * The per-leaf maxima of stage C, which the card takes inside K3 and
    the run-length pass: their plain versions equal rmi_tpu's
    seg.range_max over its per-key errors and over _run_lengths_i32
    (integer maxima, no tolerance), with empty leaves, B = 1, keys that
    end in a duplicate run and a leaf that holds only that run; the
    run-length kernel's own formula (a run's length read off its last
    key) equals them too, because a run never straddles two leaves
    under any ported top.
  * The leaf fits' statistics (select_kernel.aug_fit_moments, the plain
    version of rmi_aug_fit_moments) against rmi_tpu's _slr_ranges and
    _ncdf_ranges steps, xla (prefix-sum range sums, aug_centered_moments
    and aug_centered_dot) and the Pallas route (range_sum_blocked and
    aug_centered_moments_pallas in interpret mode), on
    test_torch_fit_kernels.py's edge cases (empty and one-key leaves,
    leaves across the kernel's chunks, robust_linear's trimmed spans):
    the means within select_kernel.fit_tolerance (both sides sum by
    prefix-sum differences or by blocks), the moments within it plus
    K2's 1e-9 relative and 1e-15 a key (float-float products on the
    Pallas route) and the rounding of rmi_tpu's range sums of the
    per-key terms (2^11 L u of their whole-array sum); the loglinear
    leaf rows (aug_fit_log_moments' plain version, then
    _slr_from_moments) against jax.jit of rmi_tpu's _loglinear_fit_leaves
    on the same edge cases, the first run's leaves among them: the count
    exact, the statistics within fit_tolerance's log form plus that
    rounding, each row within their first-order effect on beta = c / m2
    and alpha, leaves without variance or of one kept key bit for bit.
    FixDups (scan_kernel.fixdups, rmi_fixdups' plain
    version) bit-equal to rmi_tpu's _fixdups_i32 with its XLA scan and
    with the Pallas scan in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.models import linear as j_linear
from rmi_tpu.models.base import predict_clamped as j_predict_clamped
from rmi_tpu.models.linear import _linear_predict as j_linear_predict
from rmi_tpu.ops import eval_kernel as j_eval
from rmi_tpu.ops import scan_kernel as j_scan
from rmi_tpu.ops import sweep_kernel as j_sweep
from rmi_tpu.train import two_layer as j_two_layer
from rmi_tpu.utils import segments as j_seg
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.base import kernel_input
from rmi_tpu_torch.ops import eval_kernel, scan_kernel, select_kernel, sweep_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as t_seg
from test_torch_fit_kernels import FIT_EDGES, FIXDUPS_EDGES, fit_arrays, fit_case, fixdups_case

N = (1 << 15) + 517          # not a multiple of any kernel block
B = 1024


def _inputs(seed=0):
    """Normalized keys with duplicate runs, FixDups targets, monotone
    leaf ids and per-leaf least-squares rows, all numpy."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(size=N) * (rng.random(N) > 0.05)   # ~5% duplicates
    x = np.cumsum(gaps)
    x = (x - x[0]) / (x[-1] - x[0])
    first = np.concatenate([[True], x[1:] != x[:-1]])
    y = np.maximum.accumulate(np.where(first, np.arange(N), 0)).astype(np.int32)
    t = np.clip(np.floor(x * B), 0, B - 1).astype(np.int32)
    cnt = np.bincount(t, minlength=B).astype(np.float64)
    mx = np.bincount(t, x, B) / np.maximum(cnt, 1)
    my = np.bincount(t, y, B) / np.maximum(cnt, 1)
    dx = x - mx[t]
    m2 = np.bincount(t, dx * dx, B)
    c = np.bincount(t, dx * (y - my[t]), B)
    beta = np.where(m2 > 0, c / np.where(m2 > 0, m2, 1.0), 0.0)
    w = np.stack([my - beta * mx, beta], axis=1)
    return x, y, t, w


@pytest.mark.parametrize("is_max,reverse", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_k1_scan_matches_pallas(is_max, reverse):
    rng = np.random.default_rng(1)
    n = 32768 + 4321                     # one full TPU block and a ragged one
    v = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    fill = t_seg.INT32_MIN if is_max else t_seg.INT32_MAX
    got = scan_kernel.scan_i32(torch.from_numpy(v), is_max=is_max, fill=fill,
                               reverse=reverse)
    want = j_scan.scan_i32(jnp.asarray(v), is_max=is_max, fill=fill,
                           reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_k2_moments_match_jax(ref):
    x, y, t, _ = _inputs()
    yf = y.astype(np.float64)
    spans = t_seg.make_spans(torch.from_numpy(t), B)
    cnt = t_seg.aug_count(spans)
    sx = t_seg.range_sum(torch.from_numpy(x), spans.aug_starts, spans.aug_ends)
    sy = t_seg.range_sum(torch.from_numpy(yf), spans.aug_starts, spans.aug_ends)
    mean_x, mean_y = sx / cnt.clamp(min=1), sy / cnt.clamp(min=1)
    m2, c = select_kernel.aug_centered_moments(
        torch.from_numpy(x), torch.from_numpy(yf), mean_x, mean_y,
        spans.aug_starts, spans.aug_ends)

    jspans = j_seg.make_spans(jnp.asarray(t), B)
    np.testing.assert_array_equal(np.asarray(jspans.aug_starts),
                                  spans.aug_starts.numpy())
    np.testing.assert_array_equal(np.asarray(jspans.aug_ends),
                                  spans.aug_ends.numpy())
    args = (jspans, jnp.asarray(x), jnp.asarray(yf), jnp.asarray(mean_x.numpy()),
            jnp.asarray(mean_y.numpy()))
    if ref == "xla":
        jm2, jc = j_seg.aug_centered_moments(*args)
    else:
        jm2, jc, ovf = j_seg.aug_centered_moments_pallas(*args, span=B)
        assert int(ovf) == 0
    atol = 1e-15 * cnt.numpy()
    for got, want in ((m2.numpy(), np.asarray(jm2)), (c.numpy(), np.asarray(jc))):
        bad = np.abs(got - want) > atol + 1e-9 * np.abs(want)
        assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5], want[bad][:5])
    assert (cnt.numpy() > 0).sum() > B // 2


def _jax_sweep(xn, y, t, w, n):
    """two_layer.py:269-280 of rmi_tpu, jitted on the CPU."""
    p = jnp.floor(j_linear_predict(w, t, xn))
    p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(n)))
    pred = p.astype(jnp.int32)
    return jnp.abs(jnp.minimum(pred, n) - jnp.minimum(jnp.minimum(y, n), n))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_k3_sweep_matches_jax(ref):
    x, y, t, w = _inputs(2)
    got = sweep_kernel.sweep_errors(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(t), torch.from_numpy(w), N,
                                    leaf_type="linear")
    got = got.numpy()
    if ref == "xla":
        want = jax.jit(_jax_sweep, static_argnums=4)(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(w), N)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert np.count_nonzero(got) > N // 2
        return
    jt = jnp.asarray(t)
    blk_lo, _ = j_sweep.block_leaf_bounds(jt)
    want, ovf = j_sweep.sweep_errors(
        jnp.asarray(x), jnp.asarray(y), jt, j_sweep.pad_param_table(jnp.asarray(w)),
        blk_lo, leaf_type="linear", n=N, B=B, ppm=2, span=B)
    assert int(ovf) == 0
    diff = np.abs(got.astype(np.int64) - np.asarray(want).astype(np.int64))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= N // 1000


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_k4_leaf_eval_matches_jax(ref):
    x, _, t, w = _inputs(3)
    rng = np.random.default_rng(4)
    sel = rng.integers(0, N, 20_000)
    # queries between keys too: exercises floor boundaries off the key set
    xq = np.concatenate([x[sel], np.clip(x[sel] + rng.normal(0, 1e-5, sel.size), 0, 1)])
    leaf = np.concatenate([t[sel], t[sel]]).astype(np.int64)
    bound = N - 1
    got = eval_kernel.leaf_eval_clamped(torch.from_numpy(xq), torch.from_numpy(w),
                                        torch.from_numpy(leaf), bound,
                                        leaf_type="linear").numpy()
    if ref == "xla":
        want = jax.jit(lambda w_, i_, x_: j_predict_clamped(
            j_linear_predict(w_, i_, x_), bound))(
            jnp.asarray(w), jnp.asarray(leaf), jnp.asarray(xq))
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    rows = j_sweep.pad_param_table(jnp.asarray(w))[jnp.asarray(leaf)]
    want = j_eval.leaf_eval_clamped(jnp.asarray(xq), rows, leaf_type="linear",
                                    ppm=2, n=bound)
    diff = np.abs(got.astype(np.int64) - np.asarray(want).astype(np.int64))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= xq.size // 1000


def _zoo_inputs(leaf, seed):
    """(model input x, y, t, rows) of _inputs with rows from the port's
    own fit of leaf model ``leaf``; lognormal's x are raw key values."""
    x, y, t, _ = _inputs(seed)
    if get_model(leaf).input_domain == "raw":
        x = x * 2.0 ** 50 + 1.0
    tt = torch.from_numpy(t)
    w = get_model(leaf).fit_leaves(torch.from_numpy(x), torch.from_numpy(y),
                                   t_seg.make_spans(tt, B))
    return x, y, t, w.numpy()


@pytest.mark.parametrize("leaf", ["loglinear", "normal", "lognormal"])
def test_k3_sweep_zoo_matches_jax(leaf):
    x, y, t, w = _zoo_inputs(leaf, 5)
    xin = kernel_input(get_model(leaf), torch.from_numpy(x))
    got = sweep_kernel.sweep_errors(xin, torch.from_numpy(y), torch.from_numpy(t),
                                    torch.from_numpy(w), N, leaf_type=leaf).numpy()

    def jax_sweep(x_, y_, t_, w_):
        p = jnp.floor(j_get_model(leaf).predict({"w": w_}, t_, x_))
        p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(N)))
        return jnp.abs(p.astype(jnp.int32) - jnp.minimum(y_, N))
    want = jax.jit(jax_sweep)(*map(jnp.asarray, (x, y, t, w)))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.count_nonzero(got) > N // 10


@pytest.mark.parametrize("leaf", ["loglinear", "normal", "lognormal"])
def test_k4_leaf_eval_zoo_matches_jax(leaf):
    x, _, t, w = _zoo_inputs(leaf, 6)
    rng = np.random.default_rng(7)
    sel = rng.integers(0, N, 20_000)
    span = x[-1] - x[0]
    xq = np.concatenate([x[sel], x[sel] + rng.normal(0, 1e-5 * span, sel.size),
                         [np.nan, np.inf, -np.inf, -1.0, 0.0]])
    leaf_ids = np.concatenate([t[sel], t[sel], t[:5]]).astype(np.int64)
    bound = N - 1
    got = eval_kernel.leaf_eval_clamped(
        kernel_input(get_model(leaf), torch.from_numpy(xq)), torch.from_numpy(w),
        torch.from_numpy(leaf_ids), bound, leaf_type=leaf).numpy()
    want = jax.jit(lambda w_, i_, x_: j_predict_clamped(
        j_get_model(leaf).predict({"w": w_}, i_, x_), bound))(
        *map(jnp.asarray, (w, leaf_ids, xq)))
    np.testing.assert_array_equal(got, np.asarray(want))


def _with_empty_leaves(t):
    """Leaf ids of _inputs with leaves 300-304 and the last three empty."""
    t = t.astype(np.int64)
    t[t >= 300] += 5
    return np.minimum(t, B - 4).astype(np.int32)


@pytest.mark.parametrize("shape", ["spread", "empty_leaves", "B1"])
@pytest.mark.parametrize("leaf", ["linear", "cubic", "loglinear", "normal"])
def test_k3_leaf_max_matches_jax(leaf, shape):
    """K3's plain version against rmi_tpu: its jitted per-key errors, then
    its scatter-free seg.range_max over the spans."""
    x, y, t, w = _zoo_inputs(leaf, 8)
    nb = B
    if shape == "empty_leaves":
        t = _with_empty_leaves(t)
    if shape == "B1":
        nb, t, w = 1, np.zeros_like(t), w[B // 2:B // 2 + 1]
    spans = t_seg.make_spans(torch.from_numpy(t), nb)
    got = sweep_kernel.sweep_leaf_max(torch.from_numpy(x), torch.from_numpy(y),
                                      spans.starts, spans.ends, torch.from_numpy(w),
                                      N, leaf_type=leaf)
    assert got.dtype == torch.int32 and got.shape == (nb,)

    def jax_leaf_max(x_, y_, t_, w_):
        p = jnp.floor(j_get_model(leaf).predict({"w": w_}, t_, x_))
        p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(N)))
        err = jnp.abs(p.astype(jnp.int32) - jnp.minimum(y_, N))
        jspans = j_seg.make_spans(t_, nb)
        return j_seg.range_max(err, jspans.starts, jspans.ends, 0), err
    want, err = jax.jit(jax_leaf_max)(*map(jnp.asarray, (x, y, t, w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the port's own plain segmented max over its per-key errors
    np.testing.assert_array_equal(
        t_seg.range_max(torch.from_numpy(np.array(err)), spans.starts, spans.ends,
                        0).numpy(), got.numpy())
    empty = (spans.ends == spans.starts).numpy()
    assert not got.numpy()[empty].any()
    if shape == "empty_leaves":
        assert empty.sum() >= 8
    assert np.count_nonzero(got.numpy()) > (0 if shape == "B1" else nb // 4)


def test_k3_leaf_max_gaps_and_refusals():
    """Keys that lie in no span count for no leaf; a bound past the int32
    errors' range, or rows that do not match the spans, are refused."""
    x, y, _, w = _zoo_inputs("linear", 8)
    tx, ty, tw = (torch.from_numpy(a) for a in (x, y, w[:2]))
    starts, ends = torch.tensor([10, 500]), torch.tensor([200, 500])
    got = sweep_kernel.sweep_leaf_max(tx, ty, starts, ends, tw, N, leaf_type="linear")
    err = sweep_kernel.sweep_errors(tx, ty, torch.zeros(N, dtype=torch.int32), tw, N,
                                    leaf_type="linear")
    assert got.tolist() == [int(err[10:200].max()), 0]
    with pytest.raises(ValueError):
        sweep_kernel.sweep_leaf_max(tx, ty, starts, ends, tw, 2**31, leaf_type="linear")
    with pytest.raises(ValueError):
        sweep_kernel.sweep_leaf_max(tx, ty, starts, ends, tw[:1], N, leaf_type="linear")
    with pytest.raises(ValueError):
        sweep_kernel.sweep_leaf_max(tx, ty, starts.int(), ends, tw, N, leaf_type="linear")


def _run_keys(case):
    """Sorted int64 keys with duplicate runs, [n], and leaf ids that are
    a function of the key."""
    rng = np.random.default_rng(len(case))
    n, nb = 40_003, 256
    base = np.sort(rng.integers(0, 1 << 40, n // 3))
    keys = np.repeat(base, rng.integers(1, 9, base.size))[:n]
    if case == "ends_in_run":
        keys[-37:] = keys[-1]
    t = np.minimum(keys * nb >> 40, nb - 1)
    if case == "final_run_alone":        # the last leaf holds the final run only
        keys[-50:] = keys[-1]
        t = np.minimum(t, nb - 2)
        t[-50:] = nb - 1
    return keys, t.astype(np.int32), nb


def _run_end_max(keys, yfix, starts, ends):
    """csrc/run_max.cu's formula in numpy: a run's length read off its
    last key, i - yfix[i] + 1, where the next key differs."""
    n = keys.size
    i = np.arange(n)
    ends_run = np.zeros(n, bool)
    ends_run[:-1] = keys[1:] != keys[:-1]
    val = np.where(ends_run, i - yfix + 1, 0)
    return np.array([val[a:b].max() if b > a else 0 for a, b in zip(starts, ends)])


@pytest.mark.parametrize("case", ["dups", "ends_in_run", "final_run_alone"])
def test_run_max_matches_jax(case):
    keys, t, nb = _run_keys(case)
    n = keys.size
    tk = torch.from_numpy(keys)
    yfix = two_layer.fixdups_i32(tk)
    spans = t_seg.make_spans(torch.from_numpy(t), nb)
    got = sweep_kernel.span_run_max(tk, yfix, spans.starts, spans.ends)
    assert got.dtype == torch.int32

    jk = jnp.asarray(keys)
    jspans = j_seg.make_spans(jnp.asarray(t), nb)
    runs = j_two_layer._run_lengths_i32(jk, n, run_start=jnp.asarray(yfix.numpy()))
    want = j_seg.range_max(runs, jspans.starts, jspans.ends, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sweep_kernel.run_lengths_plain(tk, yfix).numpy(), np.asarray(runs))
    np.testing.assert_array_equal(
        _run_end_max(keys, yfix.numpy(), spans.starts.numpy(), spans.ends.numpy()),
        got.numpy())
    assert got.max() >= 8
    if case == "final_run_alone":
        assert int(got[-1]) == 0 and int(spans.ends[-1] - spans.starts[-1]) == 50


def test_run_max_edge_sizes():
    """n = 0, n = 1 and all keys equal: every run is the final run."""
    z = torch.zeros(3, dtype=torch.int64)
    for keys in (torch.zeros(0, dtype=torch.int64), torch.tensor([7]),
                 torch.full((100,), 5)):
        n = keys.shape[0]
        yfix = torch.zeros(n, dtype=torch.int32)
        ends = torch.tensor([0, n, n])
        assert not sweep_kernel.span_run_max(keys, yfix, z, ends).any()
        assert not _run_end_max(keys.numpy(), yfix.numpy(), z.numpy(), ends.numpy()).any()


TOPS = ["linear", "robust_linear", "loglinear", "linear_spline", "cubic", "normal",
        "lognormal"]


@pytest.mark.parametrize("top", TOPS)
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2 ** 31), log_n=st.integers(6, 11),
       max_run=st.integers(1, 40), nb=st.sampled_from([1, 7, 64, 1000]))
def test_runs_never_straddle_leaves(top, seed, log_n, max_run, nb):
    """Equal keys get one leaf id under every ported top, so a duplicate
    run lies in one leaf's span and the run-length kernel may read each
    run's length off its last key: its formula equals the plain version
    on the build's own spans."""
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    base = np.sort(rng.integers(1, 1 << 50, n).astype(np.uint64))
    keys = np.repeat(base, rng.integers(1, max_run + 1, n))[:n]
    img = torch.from_numpy((keys ^ np.uint64(1 << 63)).view(np.int64))
    mtop = get_model(top)
    kminf, s = two_layer.norm_constants(img)
    top_in = two_layer.model_float_input(mtop, img, kminf, s)
    yfix = two_layer.fixdups_i32(img)
    _, t, _ = two_layer._assign_body(top_in, yfix, top_type=top, B=nb)
    same = img[1:] == img[:-1]
    assert bool((t[1:][same] == t[:-1][same]).all())
    assert bool((t[1:] >= t[:-1]).all())
    spans = t_seg.make_spans(t, nb)
    want = sweep_kernel.span_run_max_plain(img, yfix, spans.starts, spans.ends)
    np.testing.assert_array_equal(
        _run_end_max(img.numpy(), yfix.numpy(), spans.starts.numpy(), spans.ends.numpy()),
        want.numpy())


def _j_fit_spans(t, B, trim):
    """rmi_tpu's spans of leaf ids t, trimmed as its _slr_ranges trims
    robust_linear's (rmi_tpu/models/linear.py:54-75)."""
    spans = j_seg.make_spans(jnp.asarray(t), B)
    if not trim:
        return spans
    total = spans.aug_ends - spans.aug_starts
    bnd = jnp.maximum(jnp.int64(1), (total.astype(jnp.float64) * 1e-4).astype(jnp.int64))
    ok = (2 * bnd + 1) < total
    lo = jnp.where(ok, spans.aug_starts + bnd, spans.aug_starts)
    hi = jnp.where(ok, jnp.maximum(spans.aug_ends - bnd, spans.aug_starts + bnd),
                   spans.aug_ends)
    return j_seg.Spans(t=spans.t, starts=lo, ends=hi, aug_starts=lo, aug_ends=hi,
                       nonempty=lo < hi, has_prev=jnp.zeros_like(spans.has_prev),
                       has_next=jnp.zeros_like(spans.has_next), n=spans.n, B=spans.B)


_SPAN_ARRAYS = ("t", "starts", "ends", "aug_starts", "aug_ends", "nonempty", "has_prev",
                "has_next")


def _j_fit_stats(x, yf, fields, n, B, ref, xx):
    """rmi_tpu's leaf-fit statistics over the spans of ``fields`` (their
    arrays) and n, B: ((mean_x, mean_y, m2, c), or the normal fit's
    (mean, m2), by the xla or the Pallas route; the Pallas kernel's
    window overflow, 0 on the xla route)."""
    spans = j_seg.Spans(**fields, n=n, B=B)
    cnt = j_seg.aug_count(spans)
    safe = jnp.maximum(cnt, 1.0)
    lo, hi = spans.aug_starts, spans.aug_ends
    rsum = j_seg.range_sum_blocked if ref == "pallas" else j_seg.range_sum
    mx = rsum(x, lo, hi) / safe
    ovf = jnp.int32(0)
    if xx:
        mx = jnp.where(cnt == 0, 0.0, mx)
        if ref == "pallas":
            m2, _, ovf = j_seg.aug_centered_moments_pallas(spans, x, x, mx, mx, span=B)
        else:
            m2 = j_seg.aug_centered_dot(spans, x, x, mx, mx)
        return (mx, m2), ovf
    my = rsum(yf, lo, hi) / safe
    if ref == "pallas":
        m2, c, ovf = j_seg.aug_centered_moments_pallas(spans, x, yf, mx, my, span=B)
    else:
        m2, c = j_seg.aug_centered_moments(spans, x, yf, mx, my)
    return (mx, my, m2, c), ovf


@pytest.mark.parametrize("xx", [False, True])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["sparse", "chunk_edges", "trimmed"])
def test_fit_moments_match_jax(kind, ref, xx):
    x, y, t, B, trim = fit_arrays(kind)
    tx, ty, lo, hi = fit_case(kind)
    jspans = _j_fit_spans(t, B, trim)
    np.testing.assert_array_equal(np.asarray(jspans.aug_starts), lo.numpy())
    np.testing.assert_array_equal(np.asarray(jspans.aug_ends), hi.numpy())
    got = select_kernel.aug_fit_moments(tx, None if xx else ty, lo, hi)
    fields = {f: getattr(jspans, f) for f in _SPAN_ARRAYS}
    want, ovf = jax.jit(_j_fit_stats, static_argnums=(3, 4, 5, 6))(
        jnp.asarray(x), jnp.asarray(y.astype(np.float64)), fields, jspans.n, B, ref, xx)
    assert int(ovf) == 0
    want = [torch.from_numpy(np.array(w)) for w in want]
    tol = select_kernel.fit_tolerance(tx, None if xx else ty, lo, hi, want)
    cnt = (hi - lo).double()
    # rmi_tpu's own moments are range sums of the per-key terms over the
    # whole array (prefix sums or block partials): within 2^11 L u of the
    # terms' whole-array sum, sum m2 (and sum sqrt(m2 syy) for c)
    whole = 2048 * select_kernel.scan_levels(x.shape[0]) * 2.0 ** -53
    m2 = want[-1] if xx else want[2]
    mags = {len(got) - 1: m2} if xx else {2: m2, 3: torch.sqrt(m2 * select_kernel.aug_centered_xx_plain(
        ty.double(), want[1], lo, hi))}
    for i, (g, w, t_) in enumerate(zip(got, want, tol)):
        if i in mags:                                       # m2 and c
            t_ = t_ + 1e-9 * w.abs() + 1e-15 * cnt + whole * float(mags[i].sum())
        bad = (g - w).abs() > t_
        assert not bad.any(), (i, np.flatnonzero(bad.numpy())[:5], g[bad][:5], w[bad][:5])


def _j_log_fit(x, yf, t, B):
    """rmi_tpu's loglinear leaf fit, jitted: _loglinear_fit_leaves' rows
    and the statistics _slr_ranges takes them from with weights (its
    _log_targets, aug_masked_stats, the means, aug_centered_moments)."""
    spans = j_seg.make_spans(t, B)
    rows = j_linear._loglinear_fit_leaves(x, yf, spans, x)
    ln, w = j_linear._log_targets(yf)
    cnt, sx = j_seg.aug_masked_stats(spans, x, w)
    _, sy = j_seg.aug_masked_stats(spans, ln, w)
    safe = jnp.maximum(cnt, 1.0)
    mx, my = sx / safe, sy / safe
    return rows, (cnt, mx, my, *j_seg.aug_centered_moments(spans, x, ln, mx, my, w))


@pytest.mark.parametrize("kind", [k for k in FIT_EDGES if k != "trimmed"])
def test_log_fit_rows_match_jax(kind):
    """The port's loglinear leaf rows (aug_fit_log_moments' plain version,
    then _slr_from_moments) against jax.jit of rmi_tpu's
    _loglinear_fit_leaves on the same keys.  Both sides take the sums as
    whole-array prefix-sum differences: the count is exact on both, the
    means and moments within fit_tolerance's log form plus the rounding
    of rmi_tpu's range sums of the per-key terms (2^11 L u of their
    whole-array sum, as test_fit_moments_match_jax).  A row's beta = c /
    m2 and alpha = mean_y - beta mean_x move by first order in those
    (beta by (tc + |beta| tm2) / (m2 - tm2), alpha by ty + |mean_x| dbeta
    + |beta| tx), with 4 ulps of each for the division and the FMA;
    leaves of at most one kept key or of m2 within tm2 of 0 (no
    variance) must give the same row bit for bit, as empty leaves do."""
    x, y, t, B, _ = fit_arrays(kind)
    tx, ty, lo, hi = fit_case(kind)
    cnt, mx, my, m2, c = select_kernel.aug_fit_log_moments(tx, ty, lo, hi)
    got = get_model("loglinear").fit_leaves(tx, ty, t_seg.make_spans(torch.from_numpy(t), B))
    rows, want = jax.jit(_j_log_fit, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(y.astype(np.float64)), jnp.asarray(t), B)
    want = [torch.from_numpy(np.array(w)) for w in want]
    rows = torch.from_numpy(np.array(rows))
    tol = select_kernel.fit_tolerance(tx, ty, lo, hi, want, log_form=True)
    whole = 2048 * select_kernel.scan_levels(x.shape[0]) * 2.0 ** -53
    ln, w = select_kernel._log_targets(ty)
    syy = select_kernel.aug_centered_moments_plain(ln, ln, want[2], want[2], lo, hi,
                                                   weights=w)[0]
    tol[3] = tol[3] + whole * float(want[3].sum())
    tol[4] = tol[4] + whole * float(torch.sqrt(want[3] * syy).sum())
    for i, (g, wv, t_) in enumerate(zip((cnt, mx, my, m2, c), want, tol)):
        bad = (g - wv).abs() > t_
        assert not bad.any(), (i, np.flatnonzero(bad.numpy())[:5], g[bad][:5], wv[bad][:5])
    assert torch.equal(cnt, want[0])
    u = 2.0 ** -53
    beta = rows[:, 1].abs()
    well = (want[0] > 1) & (want[3] > tol[3])
    dbeta = torch.where(well, (tol[4] + beta * tol[3]) / (want[3] - tol[3]).clamp(min=1e-300),
                        0.0) + 4 * u * beta
    dalpha = tol[2] + want[1].abs() * dbeta + beta * tol[1] + 4 * u * (
        want[2].abs() + (beta * want[1]).abs())
    diff = (got - rows).abs()
    assert (diff[:, 1] <= dbeta).all() and (diff[:, 0] <= dalpha).all()
    assert torch.equal(got[~well].view(torch.int64), rows[~well].view(torch.int64))


@pytest.mark.parametrize("scan", ["xla", "pallas"])
@pytest.mark.parametrize("kind", [k for k in FIXDUPS_EDGES if k != "empty"])
def test_fixdups_matches_jax(monkeypatch, kind, scan):
    monkeypatch.setenv("RMI_SCAN_KERNEL", "1" if scan == "pallas" else "0")
    keys = fixdups_case(kind)
    want = j_two_layer._fixdups_i32(jnp.asarray(keys.numpy()))
    np.testing.assert_array_equal(two_layer.fixdups_i32(keys).numpy(), np.asarray(want))
