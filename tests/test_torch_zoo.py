"""The loglinear, normal, lognormal and linear_spline models of the port
against rmi_tpu on the CPU.

Over books-like and duplicate-heavy u64 keys (n = 2^15): ``cubic,loglinear``,
``cubic,normal`` and ``cubic,lognormal`` at B in {64, 1024}; the four
models as tops (``loglinear,linear``, ``normal,linear``,
``lognormal,linear``, ``linear_spline,linear``) at B = 256 and
linear_spline leaves (``cubic,linear_spline``) at B = 1024 on books-like
keys:

  (a) with rmi_tpu's parameters carried across (trained_from_numpy), leaf
      ids, per-key sweep errors, both epsilon probes, the whole stage C,
      max_err, lookup and search are bit-equal to rmi_tpu's, and the
      search plan is rmi_tpu's (its "hier" plan is the port's "bounded"
      one).  torch's log on the CPU (glibc's) and XLA's disagree in the
      last bit on 0 of the 2^16 test keys (so lognormal needs no
      allowance here), on 2 of the 2^15 FixDups positions and on about
      67 of 10^6 random values (test_log_disagreements);
  (b) the top fits bit-equal to jax.jit of rmi_tpu's fit_top; the
      linear_spline leaf fit bit-equal to jax.jit of its leaf fit; the
      loglinear, normal and lognormal leaf fits within the rounding of
      the per-leaf sums (rmi_tpu subtracts prefix sums of the whole
      array, the port sums each leaf): 1e-9 of each row's |alpha| +
      |beta| for loglinear, 1e-11 relative for the means, and for the
      variance cnt * stdev^2 1e-12 of the sum over all leaves; scale
      bit-equal;
  (c) K2's weighted and variance-only plain versions against rmi_tpu's
      aug_centered_moments(weights=...) and aug_centered_dot, rtol 1e-12
      plus 1e-13 of the summed total (rmi_tpu's prefix differences),
      with empty, one-key and all-dropped leaves (y = 0, ln y = -inf);
  (d) independent builds: FixDups and max_err (with its leaf) equal; leaf
      errors differ by at most 1, in at most 3 leaves; avg_log2 within
      1e-7 relative beyond what the differing leaves explain;
  (e) |guess - lower_bound| <= err on every key and exact search.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu import lookup_fast as jlf
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.models.base import predict_clamped as j_predict_clamped
from rmi_tpu.train import two_layer as j_two_layer
from rmi_tpu.utils import segments as j_seg

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.base import kernel_input
from rmi_tpu_torch.models.linear import log_targets
from rmi_tpu_torch.ops import eval_kernel, select_kernel, sweep_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

N = 1 << 15
COMBOS = ([(kind, spec, B) for kind in ("books", "dups")
           for spec in ("cubic,loglinear", "cubic,normal", "cubic,lognormal")
           for B in (64, 1024)]
          + [("books", f"{top},linear", 256)
             for top in ("loglinear", "normal", "lognormal", "linear_spline")]
          + [("books", "cubic,linear_spline", 1024)])
NEW_MODELS = ("loglinear", "normal", "lognormal", "linear_spline")


@functools.lru_cache(maxsize=None)
def _keys(kind):
    rng = np.random.default_rng(2024)
    if kind == "books":
        c = np.cumsum(rng.exponential(size=N))
        return (c * (2.0 ** 55 / c[-1])).astype(np.uint64)
    base = np.sort(rng.integers(0, 2 ** 40, N // 4).astype(np.uint64))
    keys = np.repeat(base, rng.integers(1, 16, size=base.size))[:N]
    assert keys.size == N
    return keys


@functools.lru_cache(maxsize=None)
def _builds(kind, spec, B):
    keys = _keys(kind)
    rj = rmi_tpu.train(JDataset.from_numpy(keys, jkeys.KeyType.U64), spec, B)
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    return keys, rj, rp


@functools.lru_cache(maxsize=None)
def _carried(kind, spec, B):
    keys, rj, _ = _builds(kind, spec, B)
    return rt.trained_from_numpy(
        spec, B, tkeys.KeyType.U64, keys, np.asarray(rj.device_top_params["w"]),
        np.asarray(rj.device_leaf_params["w"]), np.asarray(rj.leaf_errors),
        rj.norm_offset, rj.norm_scale, device="cpu")


def _stage_inputs(rc):
    """The leaf's model input, leaf ids, FixDups and spans of an index."""
    mleaf = get_model(rc.leaf_type)
    x = two_layer.model_float_input(mleaf, rc.keys, rc.norm_offset, rc.norm_scale)
    t = two_layer.top_assignment(get_model(rc.top_type), rc.device_top_params,
                                 rc.keys, rc.norm_offset, rc.norm_scale,
                                 rc.branching_factor - 1).to(torch.int32)
    return x, t, two_layer.fixdups_i32(rc.keys), seg.make_spans(t, rc.branching_factor)


@functools.partial(jax.jit, static_argnames=("top", "leaf", "B"))
def _jax_stage(keys, top_w, leaf_w, off, s, yfix, *, top, leaf, B):
    """rmi_tpu's leaf ids and per-key sweep errors for given rows
    (two_layer.py:257-300 of rmi_tpu)."""
    n = keys.shape[0]
    mtop, mleaf = j_get_model(top), j_get_model(leaf)
    xraw = jkeys.as_float(keys)
    xn = (xraw - off) * s
    t = j_two_layer.predict_top_assignment(mtop, {"w": top_w}, keys, xn, xraw, B - 1)
    lin = j_two_layer.model_float_input(mleaf, xn, xraw)
    p = jnp.floor(mleaf.predict({"w": leaf_w}, t, lin))
    p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(n)))
    return t, jnp.abs(p.astype(jnp.int32) - jnp.minimum(yfix, n))


@functools.partial(jax.jit, static_argnames=("leaf", "n"))
def _jax_probe(probe_keys, leaf_w, off, s, *, leaf, n):
    """rmi_tpu's epsilon-probe predictions (two_layer.py:302-316)."""
    mleaf = j_get_model(leaf)
    pf = jkeys.as_float(probe_keys)
    x = pf if mleaf.input_domain == "raw" else (pf - off) * s
    return j_predict_clamped(mleaf.predict({"w": leaf_w},
                                           jnp.arange(leaf_w.shape[0]), x), n)


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
    off, s = jnp.float64(rc.norm_offset), jnp.float64(rc.norm_scale)
    mleaf = get_model(rc.leaf_type)

    x, t, yfix, spans = _stage_inputs(rc)
    t_j, err_j = _jax_stage(jnp.asarray(keys), top_w, leaf_w, off, s,
                            jnp.asarray(yfix.numpy()), top=rc.top_type,
                            leaf=rc.leaf_type, B=B)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    err = sweep_kernel.sweep_errors(kernel_input(mleaf, x), yfix, t,
                                    rc.device_leaf_params, N, leaf_type=rc.leaf_type)
    np.testing.assert_array_equal(err.numpy(), np.asarray(err_j))

    next_idx, next_key, prev_key = two_layer.lower_bound_fills(
        spans, rc.keys, tkeys.KeyType.U64)
    for probe in (tkeys.minus_epsilon(next_key, tkeys.KeyType.U64),
                  tkeys.plus_epsilon(prev_key, tkeys.KeyType.U64)):
        xp = two_layer.model_float_input(mleaf, probe, rc.norm_offset, rc.norm_scale)
        got = eval_kernel.leaf_eval_clamped(kernel_input(mleaf, xp), rc.device_leaf_params,
                                            torch.arange(B), N, leaf_type=rc.leaf_type)
        want = _jax_probe(jnp.asarray(tkeys.from_image(probe)), leaf_w, off, s,
                          leaf=rc.leaf_type, n=N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    leaf_errors, metrics = two_layer.sweep_body(
        rc.keys, x, yfix, spans, rc.device_leaf_params, next_idx, next_key,
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
    kind_j = jlf.get_plan(rj).kind
    assert lf.get_plan(rc).kind == (kind_j if kind_j != "hier" else "bounded")


def test_log_disagreements():
    """The counts (a) states: torch's CPU log against XLA's under jit."""
    jlog = jax.jit(jnp.log)

    def count(v):
        return int(np.count_nonzero(torch.log(torch.from_numpy(v)).numpy()
                                    != np.asarray(jlog(jnp.asarray(v)))))
    assert count(np.concatenate([_keys("books"), _keys("dups")]).astype(np.float64)) == 0
    assert count(np.arange(N, dtype=np.float64)) == 2
    v = np.exp(np.random.default_rng(5).uniform(0.0, 44.0, 1_000_000))
    assert 0 < count(v) < 200


def _top_inputs(kind, model):
    """A top fit's inputs as rmi_tpu's stage A makes them at B = 1024."""
    keys = _keys(kind)
    img = tkeys.to_image(keys)
    off, s = two_layer.norm_constants(img)
    x = two_layer.model_float_input(get_model(model), img, off, s)
    sf = 1024 / N
    ys = torch.trunc(two_layer.fixdups_i32(img).double() * sf)
    ep = np.trunc(np.arange(N, dtype=np.float64) * sf)
    return x, ys, ep


@pytest.mark.parametrize("kind", ["books", "dups"])
@pytest.mark.parametrize("model", NEW_MODELS)
def test_top_fit_bit_equal(model, kind):
    x, ys, ep = _top_inputs(kind, model)
    want = jax.jit(lambda a, b, c: j_get_model(model).fit_top(
        keys_f=a, ys_f=b, ep_ys_f=c, n=N))(*map(jnp.asarray, (x.numpy(), ys.numpy(), ep)))
    got = get_model(model).fit_top(x, ys, float(ep[0]), float(ep[-1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _leaf_assignment(x, B):
    """Leaf ids with leaves of very different widths, an empty run of
    leaves and one single-key leaf."""
    x = np.asarray(x)
    u = (x - x[0]) / (x[-1] - x[0])
    t = np.maximum.accumulate(np.clip(np.floor((u + 0.05 * np.sin(7 * u)) * B),
                                      0, B - 1)).astype(np.int64)
    t[t >= B // 2] = np.minimum(t[t >= B // 2] + 4, B - 1)
    k = N // 3
    t[k] = t[k - 1] + 1
    t[k + 1:] = np.maximum(t[k + 1:], t[k] + 1)
    return torch.from_numpy(np.minimum(t, B - 1).astype(np.int32))


@pytest.mark.parametrize("model", NEW_MODELS)
def test_leaf_fit_matches_jax(model):
    B = 1024
    img = tkeys.to_image(_keys("books"))
    off, s = two_layer.norm_constants(img)
    x = two_layer.model_float_input(get_model(model), img, off, s)
    yfix = two_layer.fixdups_i32(img)
    t = _leaf_assignment(two_layer.normalize(img, off, s), B)
    spans = seg.make_spans(t, B)
    assert (~spans.nonempty).sum() >= 3 and ((spans.ends - spans.starts) == 1).any()
    got = get_model(model).fit_leaves(x, yfix, spans).numpy()
    jm = j_get_model(model)
    want = np.asarray(jax.jit(lambda a, b, c: jm.fit_leaves(
        a, b.astype(jnp.float64), j_seg.make_spans(c, B), a))(
        *map(jnp.asarray, (x.numpy(), yfix.numpy(), t.numpy()))))
    if model == "linear_spline":
        np.testing.assert_array_equal(got, want)
        return
    ok = spans.nonempty.numpy()
    # empty leaves: (0, 0) for loglinear, (0, NaN, -inf) for the normals
    np.testing.assert_array_equal(got[~ok], want[~ok])
    got, want = got[ok], want[ok]
    if model == "loglinear":
        tol = 1e-9 * (np.abs(want[:, 0]) + np.abs(want[:, 1]))
        assert (np.abs(got - want) <= tol[:, None]).all()
        return
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-11, atol=0)
    cnt = seg.aug_count(spans).numpy()[ok]
    ss_got, ss_want = cnt * got[:, 1] ** 2, cnt * want[:, 1] ** 2
    assert (np.abs(ss_got - ss_want) <= 1e-12 * ss_want.sum()).all()
    np.testing.assert_array_equal(got[:, 2], want[:, 2])


def _k2_inputs():
    """Normalized keys whose first 50 are one duplicate run (y = 0, so
    ln y = -inf: leaf 0 is all dropped), FixDups positions, and leaf ids
    with empty and one-key leaves."""
    rng = np.random.default_rng(9)
    n, B = N + 517, 1024
    gaps = rng.exponential(size=n) * (rng.random(n) > 0.1)
    gaps[:50] = 0.0
    x = np.cumsum(gaps)
    x = (x - x[0]) / (x[-1] - x[0])
    first = np.concatenate([[True], x[1:] != x[:-1]])
    y = np.maximum.accumulate(np.where(first, np.arange(n), 0)).astype(np.float64)
    t = np.floor(x * B * 0.9).astype(np.int64) + 1
    t[:20] = 0                                   # inside the run, with its edge
    t[t >= 600] += 3                             # leaves 600-602 empty
    k = n // 3
    t[k] = t[k - 1] + 1
    t[k + 1:] = np.maximum(t[k + 1:], t[k] + 1)
    t = np.minimum(t, B - 1).astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t), B


def _close(got, want):
    tol = 1e-12 * np.abs(want) + 1e-13 * np.abs(want).sum()
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("variant", ["weighted", "xx_only"])
def test_k2_variants_match_jax(variant):
    x, y, t, B = _k2_inputs()
    spans = seg.make_spans(t, B)
    cnt = (spans.ends - spans.starts).numpy()
    assert (cnt == 0).sum() >= 3 and (cnt == 1).any()
    js = j_seg.make_spans(jnp.asarray(t.numpy()), B)
    if variant == "weighted":
        ln, w = log_targets(y)
        c_w, sx, sy = seg.aug_masked_stats(spans, w, x, ln)
        assert float(c_w[0]) == 0.0 and float(seg.aug_count(spans)[0]) > 0   # all dropped
        mx, my = sx / c_w.clamp(min=1), sy / c_w.clamp(min=1)
        got = select_kernel.aug_centered_moments(x, ln, mx, my, spans.aug_starts,
                                                 spans.aug_ends, weights=w)
        want = j_seg.aug_centered_moments(js, *map(jnp.asarray, (
            x.numpy(), ln.numpy(), mx.numpy(), my.numpy())), weights=jnp.asarray(w.numpy()))
        for g, wv in zip(got, want):
            _close(g.numpy(), np.asarray(wv))
        return
    mx = seg.aug_sum(spans, x) / seg.aug_count(spans).clamp(min=1)
    m2 = select_kernel.aug_centered_xx(x, mx, spans.aug_starts, spans.aug_ends)
    want = j_seg.aug_centered_dot(js, jnp.asarray(x.numpy()), jnp.asarray(x.numpy()),
                                  jnp.asarray(mx.numpy()), jnp.asarray(mx.numpy()))
    _close(m2.numpy(), np.asarray(want))
    assert (m2.numpy()[cnt == 0] == 0).all()


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_independent_build_parity(kind, spec, B):
    keys, rj, rp = _builds(kind, spec, B)
    np.testing.assert_array_equal(
        two_layer.fixdups_i32(rp.keys).numpy(),
        np.asarray(j_two_layer._fixdups_jit(jnp.asarray(keys))))
    assert (rp.model_max_error, rp.model_max_error_idx) == \
        (rj.model_max_error, rj.model_max_error_idx)
    e_p = rp.leaf_errors.numpy()
    e_j = np.asarray(rj.leaf_errors).astype(np.int64)
    diff = np.abs(e_p - e_j)
    assert np.count_nonzero(diff) <= 3 and diff.max() <= 1

    spans_j = _stage_inputs(_carried(kind, spec, B))[3]
    cnt_j = (spans_j.ends - spans_j.starts).numpy()
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
