"""Cubic leaves and the robust_linear model of the port against rmi_tpu.

Over books-like and duplicate-heavy u64 keys (n = 2^15), the specs
``robust_linear,cubic``, ``cubic,cubic``, ``linear,cubic`` and
``robust_linear,linear`` at B in {64, 1024}:

  (a) with rmi_tpu's parameters carried across (trained_from_numpy), leaf
      ids, per-key sweep errors, both epsilon probes, the whole stage C,
      max_err, lookup and search are bit-equal to rmi_tpu's;
  (b) the cubic leaf fit against jax.jit(rmi_tpu.models.cubic.
      _fit_cubic_ranges) on the same inputs: slopes bit-equal wherever
      the monotonicity clamp is off and within 2 ulps where it is on (XLA
      computes the clamp's 3 / sqrt with an rsqrt that is not correctly
      rounded, models/cubic.py); the closed-form coefficients bit-equal
      on every cubic leaf given the same slopes; every row bit-equal
      where the slopes are;
  (c) K6's plain version against rmi_tpu's _abs_err_sum (rtol 1e-12,
      plus 1e-13 of the summed total for the prefix-sum differences)
      and against window_select in Pallas interpret mode followed by the
      range sums (within the bound that its f32 hi/lo parameter pairs
      allow), with empty, one-key and all-duplicate leaves;
  (d) the robust_linear top bit-equal to _robust_fit_top, the untrimmed
      fallback of tiny containers included;
  (e) independent builds: FixDups and max_err (with its index) equal;
      leaf errors differ by at most 1, in at most 3 leaves more than
      rmi_tpu's own build differs from its leaf fit compiled alone (on
      duplicate-heavy keys at B = 1024 that is ~176 leaves: XLA rounds
      the fit differently inside the monolithic build program);
      avg_log2 within 1e-7 relative beyond what the differing leaves
      and leaf counts explain;
  (f) |guess - lower_bound| <= err on every key and exact search.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu.convert import CUBIC_CASE_CUBIC
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.models.base import predict_clamped as j_predict_clamped
from rmi_tpu.models.cubic import (_abs_err_sum as j_abs_err_sum,
                                  _fit_cubic_ranges as j_fit_cubic_ranges,
                                  cubic_predict as j_cubic_predict)
from rmi_tpu.models.linear import (_linear_predict as j_linear_predict,
                                   _robust_fit_top as j_robust_fit_top)
from rmi_tpu.ops.select_kernel import window_select as j_window_select
from rmi_tpu.train import two_layer as j_two_layer
from rmi_tpu.utils import segments as j_seg

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.models import cubic as t_cubic
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import cubic_l1_kernel, eval_kernel, sweep_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

N = 1 << 15
SPECS = ("robust_linear,cubic", "cubic,cubic", "linear,cubic", "robust_linear,linear")
COMBOS = [(kind, spec, B) for kind in ("books", "dups") for spec in SPECS
          for B in (64, 1024)]


@functools.lru_cache(maxsize=None)
def _keys(kind, n=N):
    rng = np.random.default_rng(2024)
    if kind == "books":
        c = np.cumsum(rng.exponential(size=n))
        return (c * (2.0 ** 55 / c[-1])).astype(np.uint64)
    base = np.sort(rng.integers(0, 2 ** 40, n // 4).astype(np.uint64))
    keys = np.repeat(base, rng.integers(1, 16, size=base.size))[:n]
    assert keys.size == n
    return keys


@functools.lru_cache(maxsize=None)
def _builds(kind, spec, B):
    keys = _keys(kind)
    rj = rmi_tpu.train(JDataset.from_numpy(keys, jkeys.KeyType.U64), spec, B)
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    return keys, rj, rp


def _carried(kind, spec, B):
    keys, rj, _ = _builds(kind, spec, B)
    return rt.trained_from_numpy(
        spec, B, tkeys.KeyType.U64, keys, np.asarray(rj.device_top_params["w"]),
        np.asarray(rj.device_leaf_params["w"]), np.asarray(rj.leaf_errors),
        rj.norm_offset, rj.norm_scale, device="cpu")


def _stage_inputs(rc):
    """Normalized keys, leaf ids, FixDups and spans of an index's keys."""
    xn = two_layer.normalize(rc.keys, rc.norm_offset, rc.norm_scale)
    t = two_layer.predict_top_assignment(get_model(rc.top_type), rc.device_top_params,
                                         xn, rc.branching_factor - 1).to(torch.int32)
    return xn, t, two_layer.fixdups_i32(rc.keys), seg.make_spans(t, rc.branching_factor)


def _queries(keys, rng):
    q = rng.integers(0, 2 ** 56, 6_000, dtype=np.uint64)
    edges = np.array([0, 1, keys[0], max(int(keys[0]) - 1, 0), keys[-1],
                      int(keys[-1]) + 1, 2 ** 64 - 1], dtype=np.uint64)
    return np.concatenate([q, edges, keys[rng.integers(0, keys.size, 2_000)]])


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_carried_params_bit_equal(kind, spec, B):
    keys, rj, _ = _builds(kind, spec, B)
    rc = _carried(kind, spec, B)
    assert (rc.model_max_error, rc.model_max_error_idx) == \
        (rj.model_max_error, rj.model_max_error_idx)
    top_w = jnp.asarray(np.asarray(rj.device_top_params["w"]))
    leaf_w = jnp.asarray(rc.device_leaf_params.numpy())
    j_top, j_leaf = j_get_model(rc.top_type), j_get_model(rc.leaf_type)

    @jax.jit
    def jax_ids(k, off, s):
        xraw = jkeys.as_float(k)
        xn = (xraw - off) * s
        return j_two_layer.predict_top_assignment(j_top, {"w": top_w}, k, xn, xraw,
                                                  B - 1), xn
    t_j, xn_j = jax_ids(jnp.asarray(keys), jnp.float64(rc.norm_offset),
                        jnp.float64(rc.norm_scale))
    xn, t, yfix, spans = _stage_inputs(rc)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(xn_j))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))

    @jax.jit
    def jax_sweep(xn_, y_, t_):
        p = jnp.floor(j_leaf.predict({"w": leaf_w}, t_, xn_))
        p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(N)))
        return jnp.abs(p.astype(jnp.int32) - jnp.minimum(y_, N))
    err = sweep_kernel.sweep_errors(xn, yfix, t, rc.device_leaf_params, N,
                                    leaf_type=rc.leaf_type)
    np.testing.assert_array_equal(
        err.numpy(), np.asarray(jax_sweep(xn_j, jnp.asarray(yfix.numpy()), t_j)))

    next_idx, next_key, prev_key = two_layer.lower_bound_fills(
        spans, rc.keys, tkeys.KeyType.U64)

    @jax.jit
    def jax_probe(k, off, s):
        x = (jkeys.as_float(k) - off) * s
        return j_predict_clamped(j_leaf.predict({"w": leaf_w}, jnp.arange(B), x), N)
    for probe in (tkeys.minus_epsilon(next_key, tkeys.KeyType.U64),
                  tkeys.plus_epsilon(prev_key, tkeys.KeyType.U64)):
        got = eval_kernel.leaf_eval_clamped(
            two_layer.normalize(probe, rc.norm_offset, rc.norm_scale),
            rc.device_leaf_params, torch.arange(B), N, leaf_type=rc.leaf_type)
        want = jax_probe(jnp.asarray(tkeys.from_image(probe)),
                         jnp.float64(rc.norm_offset), jnp.float64(rc.norm_scale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    leaf_errors, metrics = two_layer.sweep_body(
        rc.keys, xn, yfix, spans, rc.device_leaf_params, next_idx, next_key,
        prev_key, rc.norm_offset, rc.norm_scale, tkeys.KeyType.U64,
        leaf_type=rc.leaf_type)
    np.testing.assert_array_equal(leaf_errors.numpy(),
                                  np.asarray(rj.leaf_errors).astype(np.int64))
    assert (metrics["model_max_error"], metrics["model_max_error_idx"]) == \
        (rj.model_max_error, rj.model_max_error_idx)

    for qs in (keys, _queries(keys, np.random.default_rng(7))):
        g, e = rt.lookup(rc, tkeys.to_image(qs))
        gj, ej = rmi_tpu.lookup(rj, jnp.asarray(qs))
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(e.numpy(), np.asarray(ej).astype(np.int64))
        np.testing.assert_array_equal(rt.search(rc, tkeys.to_image(qs)).numpy(),
                                      np.asarray(rmi_tpu.search(rj, jnp.asarray(qs))))


def _jax_leaf_fit(xn, yfix, t, B):
    """rmi_tpu's cubic leaf fit compiled alone: (w, m1, m2, case)."""
    def fit(x_, y_, t_):
        out = j_fit_cubic_ranges(x_, y_.astype(jnp.float64), j_seg.make_spans(t_, B),
                                 x_, None)
        return out["w"], out["aux"]["m1"], out["aux"]["m2"], out["aux"]["case"]
    return [np.array(a) for a in jax.jit(fit)(jnp.asarray(xn.numpy()),
                                                jnp.asarray(yfix.numpy()),
                                                jnp.asarray(t.numpy()))]


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("kind,B", [(k, B) for k in ("books", "dups") for B in (1024, 4096)])
def test_cubic_leaf_fit_matches_jax(kind, B):
    rc = _carried(kind, "robust_linear,cubic", 1024)
    xn, _, yfix, _ = _stage_inputs(rc)
    # a leaf assignment of its own, with leaves of very different widths
    x = xn.numpy()
    t = torch.from_numpy(np.maximum.accumulate(
        np.clip(np.floor((x + 0.05 * np.sin(7 * x)) * B), 0, B - 1)).astype(np.int32))
    spans = seg.make_spans(t, B)
    jw, jm1, jm2, jcase = _jax_leaf_fit(xn, yfix, t, B)
    first = spans.aug_starts.clamp(0, N - 1)
    last = (spans.aug_ends - 1).clamp(0, N - 1)
    xmin, xmax = xn[first], xn[last]
    ymin, ymax = yfix[first].double(), yfix[last].double()
    m1, m2 = t_cubic._slopes(xn, yfix, xmin, ymin, xmax, ymax, xmin == xmax)
    clamped = jm1 * jm1 + jm2 * jm2 > 8.99
    for got, want in ((m1.numpy(), jm1), (m2.numpy(), jm2)):
        np.testing.assert_array_equal(got[~clamped], want[~clamped])
        assert _ulps(got[clamped], want[clamped]).max() <= 2
    assert clamped.sum() > 50

    # the closed forms with rmi_tpu's slopes: bit-equal on every cubic leaf
    cub = jcase == CUBIC_CASE_CUBIC
    coeffs = t_cubic._coeffs(xmin, ymin, xmax, ymax, torch.from_numpy(jm1),
                             torch.from_numpy(jm2))
    for c in range(4):
        np.testing.assert_array_equal(coeffs[c].numpy()[cub], jw[cub, c])
    assert cub.sum() > B // 4

    # whole rows, where the slopes agree
    w = t_cubic._fit_cubic_ranges(xn, yfix, spans).numpy()
    same = (m1.numpy() == jm1) & (m2.numpy() == jm2)
    np.testing.assert_array_equal(w[same], jw[same])


def _k6_inputs(seed=0, n=(1 << 15) + 517, B=1024):
    """Keys with duplicate runs and one long all-duplicate run, leaf ids
    with empty, one-key and all-duplicate leaves, and the port's
    cubic and spline candidates for them."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(size=n) * (rng.random(n) > 0.2)
    gaps[5000:5400] = 0.0
    x = np.cumsum(gaps)
    x = (x - x[0]) / (x[-1] - x[0])
    first = np.concatenate([[True], x[1:] != x[:-1]])
    y = np.maximum.accumulate(np.where(first, np.arange(n), 0)).astype(np.int32)
    t = np.floor(x * B * 0.9).astype(np.int64)
    t[t >= 500] += 3                        # leaves 500-502 empty
    for lo, hi in ((n // 3, n // 3 + 1),    # a leaf with one key
                   (5001, 5399)):           # a leaf inside the duplicate run
        t[lo:hi] = t[lo - 1] + 1
        t[hi:] = np.maximum(t[hi:], t[lo] + 1)
    t = np.minimum(t, B - 1).astype(np.int32)
    xt, yt, tt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)
    spans = seg.make_spans(tt, B)
    cubic_w, lin_w, _ = t_cubic._candidates(xt, yt, spans)
    cnt = (spans.ends - spans.starts).numpy()
    assert (cnt == 0).sum() >= 3 and (cnt == 1).any()
    assert ((xt[spans.aug_starts] == xt[(spans.aug_ends - 1).clamp(min=0)])
            & spans.nonempty).any()                    # an all-duplicate leaf
    return xt, yt, tt, spans, cubic_w, lin_w


def _jspans(spans):
    return j_seg.make_spans(jnp.asarray(spans.t.numpy()), spans.B)


def test_k6_plain_matches_abs_err_sum():
    x, y, t, spans, cubic_w, lin_w = _k6_inputs()
    c_err, l_err = cubic_l1_kernel.cubic_l1_sums(x, y, cubic_w, lin_w, spans)
    js = _jspans(spans)
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.float64))
    for got, w, predict in ((c_err, cubic_w, j_cubic_predict),
                            (l_err, lin_w, j_linear_predict)):
        want = np.asarray(jax.jit(lambda w_: j_abs_err_sum(w_, predict, xj, yj, js))(
            jnp.asarray(w.numpy())))
        tol = 1e-12 * np.abs(want) + 1e-13 * want.sum()
        assert (np.abs(got.numpy() - want) <= tol).all()
        assert (want > 0).sum() > spans.B // 2


def test_k6_plain_matches_window_select_pallas():
    """rmi_tpu's Pallas path of the L1 sums (rmi_tpu/models/cubic.py:146-
    173): window_select in interpret mode hands each key its leaf's six
    parameters as f32 hi/lo pairs (48 bits), XLA evaluates and sums."""
    x, y, t, spans, cubic_w, lin_w = _k6_inputs(1)
    B = spans.B
    c_err, l_err = cubic_l1_kernel.cubic_l1_sums(x, y, cubic_w, lin_w, spans)
    js = _jspans(spans)
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.float64))
    cw, lw = jnp.asarray(cubic_w.numpy()), jnp.asarray(lin_w.numpy())
    sel, ovf = j_window_select(js.t, [cw[:, 0], cw[:, 1], cw[:, 2], cw[:, 3],
                                      lw[:, 0], lw[:, 1]], B=B, span=B)
    assert int(ovf) == 0
    ca, cb, cc, cd, la, lb = sel
    leaf_ids = jnp.arange(B)
    ip = jnp.clip(js.starts - 1, 0, js.n - 1)
    inx = jnp.clip(js.ends, 0, js.n - 1)
    for got, pred, w, predict in (
            (c_err, ((ca * xj + cb) * xj + cc) * xj + cd, cw, j_cubic_predict),
            (l_err, lb * xj + la, lw, j_linear_predict)):
        want = (j_seg.range_sum_blocked(jnp.abs(pred - yj), js.starts, js.ends)
                + jnp.where(js.has_prev, jnp.abs(predict(w, leaf_ids, xj[ip]) - yj[ip]), 0.0)
                + jnp.where(js.has_next, jnp.abs(predict(w, leaf_ids, xj[inx]) - yj[inx]), 0.0))
        # |parameter error| <= 2^-48 |p| per column, and the evaluation's
        # own roundings: bound each key's |pred| error by 2^-45 times the
        # sum of its terms' magnitudes
        rows = np.abs(np.asarray(w))[spans.t.numpy()]
        xa = np.abs(x.numpy())
        powers = np.stack([xa ** (rows.shape[1] - 1 - k) for k in range(rows.shape[1])], 1)
        bound_per_key = 2.0 ** -45 * (rows * powers).sum(1)
        bound = seg.range_sum(torch.from_numpy(bound_per_key), spans.starts,
                              spans.ends).numpy()
        diff = np.abs(got.numpy() - np.asarray(want))
        assert (diff <= bound + 1e-12 * np.abs(np.asarray(want)) + 1e-9).all()


@pytest.mark.parametrize("kind,n", [("books", N), ("dups", N), ("books", 20_000),
                                    ("dups", 77_777), ("dups", 5), ("books", 3)])
def test_robust_top_bit_equal(kind, n):
    """Trimmed containers at every size, and the untrimmed fallback where
    2 bnd + 1 >= n (n = 3 and 5)."""
    keys = _keys(kind, max(n, 64))[:n] if n < 64 else _keys(kind, n)
    x = keys.astype(np.float64)
    x = (x - x[0]) / (x[-1] - x[0])
    first = np.concatenate([[True], keys[1:] != keys[:-1]])
    y = np.maximum.accumulate(np.where(first, np.arange(n), 0)).astype(np.float64)
    ys = np.trunc(y * (1024 / n))
    want = jax.jit(lambda a, b: j_robust_fit_top(a, b, b, n))(jnp.asarray(x), jnp.asarray(ys))
    got = get_model("robust_linear").fit_top(torch.from_numpy(x), torch.from_numpy(ys),
                                             0.0, float(ys[-1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_self_difference(kind, spec, B):
    """Leaf errors on which rmi_tpu's build differs from rmi_tpu's cubic
    leaf fit compiled alone, on the build's own leaf assignment (stage C
    is the port's, which is bit-equal to rmi_tpu's on given rows)."""
    _, rj, _ = _builds(kind, spec, B)
    rc = _carried(kind, spec, B)
    xn, t, yfix, spans = _stage_inputs(rc)
    w = torch.from_numpy(_jax_leaf_fit(xn, yfix, t, B)[0])
    next_idx, next_key, prev_key = two_layer.lower_bound_fills(spans, rc.keys,
                                                               tkeys.KeyType.U64)
    patch = ~spans.nonempty & (torch.arange(B) < B - 1)
    w = torch.where(patch[:, None], get_model("cubic").constant_params(next_idx.double()), w)
    errs, _ = two_layer.sweep_body(rc.keys, xn, yfix, spans, w, next_idx, next_key,
                                   prev_key, rc.norm_offset, rc.norm_scale,
                                   tkeys.KeyType.U64, leaf_type="cubic")
    return int((errs != rc.leaf_errors).sum())


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_independent_build_parity(kind, spec, B):
    keys, rj, rp = _builds(kind, spec, B)
    np.testing.assert_array_equal(
        two_layer.fixdups_i32(rp.keys).numpy(),
        np.asarray(j_two_layer._fixdups_jit(jnp.asarray(keys))))
    assert (rp.model_max_error, rp.model_max_error_idx) == \
        (rj.model_max_error, rj.model_max_error_idx)
    if (kind, spec, B) == ("books", "robust_linear,cubic", 1024):
        # the reference's unpatched empty final leaf (two_layer.rs:182-202)
        assert (rp.model_max_error, rp.model_max_error_idx) == (N + 1, B - 1)

    e_p = rp.leaf_errors.numpy()
    e_j = np.asarray(rj.leaf_errors).astype(np.int64)
    diff = np.abs(e_p - e_j)
    allowed = 3 + (_jax_self_difference(kind, spec, B) if rp.leaf_type == "cubic" else 0)
    assert np.count_nonzero(diff) <= allowed and diff.max() <= 1

    cnt_j = _stage_inputs(_carried(kind, spec, B))[3]
    cnt_j = (cnt_j.ends - cnt_j.starts).numpy()
    spans_p = _stage_inputs(rp)[3]
    cnt_p = (spans_p.ends - spans_p.starts).numpy()
    moved = (cnt_p != cnt_j) | (e_p != e_j)
    explained = np.sum((cnt_p * np.log2(2.0 * e_p + 2.0)
                        - cnt_j * np.log2(2.0 * e_j + 2.0))[moved]) / N
    d = rp.model_avg_log2_error - rj.model_avg_log2_error
    assert abs(d - explained) <= 1e-7 * abs(rj.model_avg_log2_error)


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_bound_holds_and_search_is_exact(kind, spec, B):
    keys, _, rp = _builds(kind, spec, B)
    g, e = rt.lookup(rp, tkeys.to_image(keys))
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0
    for q in (keys, _queries(keys, np.random.default_rng(11))):
        got = rt.search(rp, tkeys.to_image(q)).numpy()
        np.testing.assert_array_equal(got, np.searchsorted(keys, q, side="left"))
