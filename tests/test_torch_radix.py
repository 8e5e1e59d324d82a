"""The integer-output models of the port (radix, bradix, the radix hint
tables as top and leaf, histogram) against rmi_tpu on the CPU
(``RMI_PALLAS`` unset: XLA's f64 path).

Over books-like and duplicate-heavy u64 keys (n = 2^15): each of
``radix``, ``bradix``, ``radix8``, ``radix18`` and ``histogram`` as the
top of linear leaves at B in {64, 1024}; ``radix22,cubic`` at B = 256;
hint-table leaves ``cubic,radix8`` at B = 1024 and ``linear,radix18`` at
B = 16 (B * 2^bits within the cap of 2^26):

  (a) with rmi_tpu's parameters carried across (trained_from_numpy),
      leaf ids, per-key sweep errors, both epsilon probes, the leaf
      errors of the whole stage C, max_err, lookup, search and the plan
      kind are bit-equal to rmi_tpu's;
  (b) each integer top fit is bit-equal to jax.jit of rmi_tpu's fit_top
      (w_int, high, table, count, pivots, radix_index), and the hint-table
      leaf fit to jax.jit of its fit_leaves (tables, prefixes, shifts),
      also on keys at the ends of the u64 range;
  (c) independent builds: FixDups, leaf ids and max_err (with its leaf)
      equal; hint-table leaf errors equal; linear and cubic leaf errors
      differ by at most 1 in at most 3 leaves and avg_log2 within 1e-7
      relative beyond what those leaves explain (test_torch_zoo.py's
      rule); the bound holds and search is exact;
  (d) the u64 helpers (keys.shr, shl, ult, umin, clz64) against numpy
      uint64 at keys 0, 2^63 - 1, 2^63 and 2^64 - 1, and the models'
      predictions against rmi_tpu's at prefix + bits of 64 and more and
      at bits 0;
  (e) histogram,linear at B = 32 holds |guess - lb| <= err on clustered
      keys like those on which rmi_tpu's Pallas build broke the bound;
  (f) a top-only model as a leaf raises ValueError, as in rmi_tpu.
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
from rmi_tpu.models.base import clamp_int as j_clamp_int
from rmi_tpu.models.base import predict_clamped as j_predict_clamped
from rmi_tpu.train import two_layer as j_two_layer
from rmi_tpu.utils import segments as j_seg

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch.models import clamp_int, get_model
from rmi_tpu_torch.models.base import kernel_input
from rmi_tpu_torch.ops import eval_kernel, sweep_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

N = 1 << 15
TOPS = ("radix", "bradix", "radix8", "radix18", "histogram")
COMBOS = ([(kind, f"{top},linear", B) for kind in ("books", "dups") for top in TOPS
           for B in (64, 1024)]
          + [(kind, spec, B) for kind in ("books", "dups")
             for spec, B in (("radix22,cubic", 256), ("cubic,radix8", 1024),
                             ("linear,radix18", 16))])
EDGES = np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1], dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def _keys(kind):
    rng = np.random.default_rng(2024)
    if kind == "books":
        c = np.cumsum(rng.exponential(size=N))
        return (c * (2.0 ** 55 / c[-1])).astype(np.uint64)
    if kind == "dups":
        base = np.sort(rng.integers(0, 2 ** 40, N // 4).astype(np.uint64))
        keys = np.repeat(base, rng.integers(1, 16, size=base.size))[:N]
        assert keys.size == N
        return keys
    # "ends": runs at 0, 2^63 - 1, 2^63 and 2^64 - 1 around random keys
    mid = rng.integers(0, 2 ** 64 - 1, N - 4 * 64, dtype=np.uint64)
    return np.sort(np.concatenate([np.repeat(EDGES[[0, 2, 3, 4]], 64), mid]))


def _np_params(p):
    """rmi_tpu's parameter dict as numpy arrays, without its host-only
    entries (two_layer._predict_params)."""
    return {k: np.asarray(v) for k, v in j_two_layer._predict_params(p).items()}


def _carry(p, mdef):
    return p if mdef.output_int else p["w"]


@functools.lru_cache(maxsize=None)
def _builds(kind, spec, B):
    keys = _keys(kind)
    rj = rmi_tpu.train(JDataset.from_numpy(keys, jkeys.KeyType.U64), spec, B)
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    return keys, rj, rp


@functools.lru_cache(maxsize=None)
def _carried(kind, spec, B):
    keys, rj, _ = _builds(kind, spec, B)
    top, leaf = spec.split(",")
    return rt.trained_from_numpy(
        spec, B, tkeys.KeyType.U64, keys,
        _carry(_np_params(rj.device_top_params), get_model(top)),
        _carry(_np_params(rj.device_leaf_params), get_model(leaf)),
        np.asarray(rj.leaf_errors), rj.norm_offset, rj.norm_scale, device="cpu")


def _stage_inputs(rc):
    """The leaf's model input, leaf ids, FixDups and spans of an index."""
    mleaf = get_model(rc.leaf_type)
    x = two_layer.model_float_input(mleaf, rc.keys, rc.norm_offset, rc.norm_scale)
    t = two_layer.top_assignment(get_model(rc.top_type), rc.device_top_params,
                                 rc.keys, rc.norm_offset, rc.norm_scale,
                                 rc.branching_factor - 1).to(torch.int32)
    return x, t, two_layer.fixdups_i32(rc.keys), seg.make_spans(t, rc.branching_factor)


@functools.partial(jax.jit, static_argnames=("top", "leaf", "B"))
def _jax_stage(keys, top_p, leaf_p, off, s, yfix, *, top, leaf, B):
    """rmi_tpu's leaf ids and per-key sweep errors (two_layer.py:257-280
    of rmi_tpu)."""
    n = keys.shape[0]
    mtop, mleaf = j_get_model(top), j_get_model(leaf)
    xraw = jkeys.as_float(keys)
    xn = (xraw - off) * s
    t = j_two_layer.predict_top_assignment(mtop, top_p, keys, xn, xraw, B - 1)
    if mleaf.output_int:
        pred = j_clamp_int(mleaf.predict(leaf_p, t, keys), n).astype(jnp.int32)
    else:
        p = jnp.floor(mleaf.predict(leaf_p, t, xn))
        pred = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(n))).astype(jnp.int32)
    return t, jnp.abs(jnp.minimum(pred, n) - jnp.minimum(yfix, n))


@functools.partial(jax.jit, static_argnames=("leaf", "n", "B"))
def _jax_probe(probe_keys, leaf_p, off, s, *, leaf, n, B):
    """rmi_tpu's epsilon-probe predictions (two_layer.py:302-322)."""
    mleaf = j_get_model(leaf)
    if mleaf.output_int:
        return j_clamp_int(mleaf.predict(leaf_p, jnp.arange(B), probe_keys), n)
    x = (jkeys.as_float(probe_keys) - off) * s
    return j_predict_clamped(mleaf.predict(leaf_p, jnp.arange(B), x), n)


def _probe(rc, probe_keys):
    """The port's epsilon-probe predictions, as sweep_body makes them."""
    mleaf, B = get_model(rc.leaf_type), rc.branching_factor
    if mleaf.output_int:
        return clamp_int(mleaf.predict(rc.device_leaf_params, torch.arange(B),
                                       probe_keys), N)
    x = two_layer.model_float_input(mleaf, probe_keys, rc.norm_offset, rc.norm_scale)
    return eval_kernel.leaf_eval_clamped(kernel_input(mleaf, x), rc.device_leaf_params,
                                         torch.arange(B), N, leaf_type=rc.leaf_type)


def _queries(keys, rng):
    q = rng.integers(0, 2 ** 56, 6_000, dtype=np.uint64)
    edges = np.array([keys[0], max(int(keys[0]) - 1, 0), keys[-1],
                      min(int(keys[-1]) + 1, 2 ** 64 - 1)], dtype=np.uint64)
    return np.concatenate([q, EDGES, edges, keys[rng.integers(0, keys.size, 2_000)]])


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_carried_params_bit_equal(kind, spec, B):
    keys, rj, _ = _builds(kind, spec, B)
    rc = _carried(kind, spec, B)
    assert (rc.model_max_error, rc.model_max_error_idx) == \
        (rj.model_max_error, rj.model_max_error_idx)
    leaf_p = j_two_layer._predict_params(rj.device_leaf_params)
    off, s = jnp.float64(rc.norm_offset), jnp.float64(rc.norm_scale)

    x, t, yfix, spans = _stage_inputs(rc)
    t_j, err_j = _jax_stage(jnp.asarray(keys), rj.device_top_params, leaf_p, off, s,
                            jnp.asarray(yfix.numpy()), top=rc.top_type,
                            leaf=rc.leaf_type, B=B)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    if get_model(rc.leaf_type).output_int:
        err = two_layer.int_sweep_errors(rc.keys, yfix, t, rc.device_leaf_params, N,
                                         leaf_type=rc.leaf_type)
    else:
        err = sweep_kernel.sweep_errors(x, yfix, t, rc.device_leaf_params, N,
                                        leaf_type=rc.leaf_type)
    np.testing.assert_array_equal(err.numpy(), np.asarray(err_j))

    next_idx, next_key, prev_key = two_layer.lower_bound_fills(
        spans, rc.keys, tkeys.KeyType.U64)
    for probe in (tkeys.minus_epsilon(next_key, tkeys.KeyType.U64),
                  tkeys.plus_epsilon(prev_key, tkeys.KeyType.U64)):
        want = _jax_probe(jnp.asarray(tkeys.from_image(probe)), leaf_p, off, s,
                          leaf=rc.leaf_type, n=N, B=B)
        np.testing.assert_array_equal(_probe(rc, probe).numpy(), np.asarray(want))

    leaf_errors, metrics_t = two_layer.sweep_body(
        rc.keys, x, yfix, spans, rc.device_leaf_params, next_idx, next_key,
        prev_key, rc.norm_offset, rc.norm_scale, tkeys.KeyType.U64,
        leaf_type=rc.leaf_type)
    metrics = two_layer.metrics_dict(metrics_t.tolist())
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
    assert lf.get_plan(rc).kind == kind_j


def _assert_params_equal(got, want):
    """The port's integer parameters against rmi_tpu's: u64 values as
    their bits, u32 tables as values, pivots as keys."""
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k]
        if k == "pivots":
            np.testing.assert_array_equal(tkeys.from_image(g), w, err_msg=k)
        elif w.dtype == np.uint32:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.uint64).view(np.int64),
                                          err_msg=k)


TOP_FITS = ([(model, kind, B) for model in TOPS for kind in ("books", "dups", "ends")
             for B in (64, 1024)]
            + [("radix22", kind, 256) for kind in ("books", "dups", "ends")])


@pytest.mark.parametrize("model,kind,B", TOP_FITS)
def test_top_fit_bit_equal(model, kind, B):
    keys = _keys(kind)
    img = tkeys.to_image(keys)
    sf = B / N
    ys = torch.trunc(two_layer.fixdups_i32(img).double() * sf)
    ep = np.trunc(np.arange(N, dtype=np.float64) * sf)
    jm = j_get_model(model)
    want = jax.jit(lambda k, y, e: jm.fit_top(keys_f=None, ys_f=y, ep_ys_f=e, n=N, keys=k,
                                              B=B, scale=sf))(
        jnp.asarray(keys), jnp.asarray(ys.numpy()), jnp.asarray(ep))
    _assert_params_equal(get_model(model).fit_top(img, ys, B, sf), want)


def _leaf_assignment(keys, B):
    """Leaf ids with leaves of very different widths, a run of empty
    leaves and a one-key leaf."""
    x = np.log1p(np.asarray(keys, np.float64))
    u = (x - x[0]) / (x[-1] - x[0])
    t = np.maximum.accumulate(np.clip(np.floor((u + 0.05 * np.sin(7 * u)) * B),
                                      0, B - 1)).astype(np.int64)
    t[t >= B // 2] = np.minimum(t[t >= B // 2] + 4, B - 1)
    k = N // 3
    t[k] = t[k - 1] + 1
    t[k + 1:] = np.maximum(t[k + 1:], t[k] + 1)
    return torch.from_numpy(np.minimum(t, B - 1).astype(np.int32))


@pytest.mark.parametrize("kind", ["books", "dups", "ends"])
@pytest.mark.parametrize("model,B", [("radix8", 1024), ("radix18", 16)])
def test_leaf_fit_bit_equal(model, B, kind):
    keys = _keys(kind)
    img = tkeys.to_image(keys)
    yfix = two_layer.fixdups_i32(img)
    t = _leaf_assignment(keys, B)
    spans = seg.make_spans(t, B)
    assert (~spans.nonempty).any()
    jm = j_get_model(model)
    want = jax.jit(lambda k, y, tt: jm.fit_leaves(
        None, y.astype(jnp.float64), j_seg.make_spans(tt, B), None, keys_raw=k))(
        jnp.asarray(keys), jnp.asarray(yfix.numpy()), jnp.asarray(t.numpy()))
    _assert_params_equal(get_model(model).fit_leaves(img, yfix, spans), want)


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_independent_build_parity(kind, spec, B):
    keys, rj, rp = _builds(kind, spec, B)
    np.testing.assert_array_equal(
        two_layer.fixdups_i32(rp.keys).numpy(),
        np.asarray(j_two_layer._fixdups_jit(jnp.asarray(keys))))
    assert (rp.model_max_error, rp.model_max_error_idx) == \
        (rj.model_max_error, rj.model_max_error_idx)
    t_p = _stage_inputs(rp)[1]
    spans_j = _stage_inputs(_carried(kind, spec, B))[3]
    np.testing.assert_array_equal(t_p.numpy(), spans_j.t.numpy())
    e_p = rp.leaf_errors.numpy()
    e_j = np.asarray(rj.leaf_errors).astype(np.int64)
    if get_model(rp.leaf_type).output_int:
        np.testing.assert_array_equal(e_p, e_j)
        assert rp.model_avg_log2_error == pytest.approx(rj.model_avg_log2_error,
                                                        rel=1e-12)
        return
    diff = np.abs(e_p - e_j)
    assert np.count_nonzero(diff) <= 3 and diff.max() <= 1
    cnt = (spans_j.ends - spans_j.starts).numpy()
    moved = e_p != e_j
    explained = np.sum(cnt[moved] * (np.log2(2.0 * e_p + 2.0)
                                     - np.log2(2.0 * e_j + 2.0))[moved]) / N
    d = rp.model_avg_log2_error - rj.model_avg_log2_error
    assert abs(d - explained) <= 1e-7 * abs(rj.model_avg_log2_error)


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_bound_holds_and_search_is_exact(kind, spec, B):
    keys, _, rp = _builds(kind, spec, B)
    g, e = rt.lookup(rp, tkeys.to_image(keys))
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0
    q = _queries(keys, np.random.default_rng(11))
    for qs, fn in ((keys, rt.search), (q, rt.search), (np.sort(q), rt.search_sorted)):
        got = fn(rp, tkeys.to_image(qs)).numpy()
        np.testing.assert_array_equal(got, np.searchsorted(keys, qs, side="left"))


def _u64(v):
    return tkeys.u64_bits(tkeys.to_image(np.asarray(v, np.uint64)))


def _np(t):
    return t.numpy().view(np.uint64)


def test_u64_helpers_at_the_edges():
    rng = np.random.default_rng(3)
    vals = np.concatenate([EDGES, rng.integers(0, 2 ** 64 - 1, 60, dtype=np.uint64)])
    b = _u64(vals)
    np.testing.assert_array_equal(_np(b), vals)
    np.testing.assert_array_equal(tkeys.u64_bits(b).numpy(), tkeys.to_image(vals).numpy())
    for a in range(0, 70):
        sh = np.uint64(min(a, 63))
        zero = np.zeros_like(vals)
        np.testing.assert_array_equal(_np(tkeys.shr(b, a)), vals >> sh if a < 64 else zero)
        np.testing.assert_array_equal(_np(tkeys.shl(b, a)), vals << sh if a < 64 else zero)
    amounts = torch.from_numpy(rng.integers(0, 70, vals.size))
    want = np.where(amounts.numpy() < 64,
                    vals >> np.minimum(amounts.numpy(), 63).astype(np.uint64), 0)
    np.testing.assert_array_equal(_np(tkeys.shr(b, amounts)), want)
    np.testing.assert_array_equal(
        tkeys.clz64(b).numpy(), [64 - int(v).bit_length() for v in vals])
    A, C = np.meshgrid(vals, vals)
    a, c = _u64(A.ravel()), _u64(C.ravel())
    np.testing.assert_array_equal(tkeys.ult(a, c).numpy(), A.ravel() < C.ravel())
    np.testing.assert_array_equal(_np(tkeys.umin(a, c)), np.minimum(A.ravel(), C.ravel()))
    # histogram's underflow: u64::MAX clamps to the bound
    np.testing.assert_array_equal(clamp_int(torch.tensor([-1, 0, 5, 9]), 7).numpy(),
                                  [7, 0, 5, 7])


@pytest.mark.parametrize("model,params", [
    ("radix", {"w_int": [0, 0]}), ("radix", {"w_int": [0, 1]}),
    ("radix", {"w_int": [1, 63]}), ("radix", {"w_int": [64, 5]}),
    ("radix", {"w_int": [63, 2]}), ("radix", {"w_int": [40, 30]}),
    ("bradix", {"w_int": [0, 10, 2 ** 64 - 3], "high": 0}),
    ("bradix", {"w_int": [3, 62, 1000], "high": 1}),
    ("bradix", {"w_int": [60, 8, 2 ** 64 - 1], "high": 1}),
    ("bradix", {"w_int": [64, 8, 17], "high": 0}),
])
def test_bit_models_predict_at_the_edges(model, params):
    """radix and bradix predictions with hand-set parameters (prefix and
    bits at and past 64, bits 0, wrapped clamps) on keys at the ends of
    the u64 range, against rmi_tpu's predict."""
    keys = np.concatenate([EDGES, _keys("ends")[::97]])
    jp = {k: jnp.asarray(np.asarray(v, np.uint64)) for k, v in params.items()}
    want = np.asarray(jax.jit(lambda p, k: j_get_model(model).predict(p, None, k))(
        jp, jnp.asarray(keys)))
    tp = _int_params(params)
    got = get_model(model).predict(tp, None, tkeys.to_image(keys))
    np.testing.assert_array_equal(_np(got), want)


def _int_params(params):
    return {k: torch.from_numpy(np.asarray(np.asarray(v, np.uint64).view(np.int64)))
            for k, v in params.items()}


@pytest.mark.parametrize("bits", [8, 18])
def test_table_predict_at_the_edges(bits):
    """Hint-table buckets at prefix + bits past 64 (shift 0) and at
    prefix 64, as top and as leaf, against rmi_tpu's predict."""
    keys = np.concatenate([EDGES, _keys("ends")[::97]])
    rng = np.random.default_rng(bits)
    size = 1 << bits
    prefixes = np.array([0, 30, 60, 64 - bits, 63, 64], np.uint64)
    shifts = np.where(prefixes + bits > 64, 0, 64 - prefixes - bits).astype(np.uint64)
    tables = rng.integers(0, 2 ** 31, (prefixes.size, size)).astype(np.uint32)
    ids = rng.integers(0, prefixes.size, keys.size)
    leaf = {"tables": tables, "prefixes": prefixes, "shifts": shifts}
    jm, tm = j_get_model(f"radix{bits}"), get_model(f"radix{bits}")
    want = np.asarray(jax.jit(jm.predict)(
        {k: jnp.asarray(v) for k, v in leaf.items()}, jnp.asarray(ids), jnp.asarray(keys)))
    got = tm.predict({"tables": torch.from_numpy(tables.astype(np.int32)),
                      **_int_params({"prefixes": prefixes, "shifts": shifts})},
                     torch.from_numpy(ids), tkeys.to_image(keys))
    np.testing.assert_array_equal(_np(got), want)
    for prefix in (0, 50, 64 - bits, 63, 64):
        top = {"w_int": np.array([prefix, bits], np.uint64), "table": tables[0]}
        want = np.asarray(jax.jit(lambda p, k: jm.predict(p, None, k))(
            {k: jnp.asarray(v) for k, v in top.items()}, jnp.asarray(keys)))
        got = tm.predict({"table": torch.from_numpy(tables[0].astype(np.int32)),
                          **_int_params({"w_int": top["w_int"]})}, None,
                         tkeys.to_image(keys))
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("seed", range(8))
def test_histogram_bound_on_clustered_keys(seed):
    """Clustered keys as rmi_tpu's fuzz test draws them (three centres,
    keys at +0..63 of them, with duplicates): rmi_tpu's build with
    RMI_PALLAS=1 (its df64 sweep, interpreted on the CPU) breaks the
    bound on 2 keys each of seeds 3 and 7 (ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    n = 168
    centres = rng.integers(0, 2 ** 62, 3, dtype=np.uint64)
    keys = np.sort(centres[rng.integers(0, 3, n)] + rng.integers(0, 64, n).astype(np.uint64))
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), "histogram,linear", 32)
    g, e = rt.lookup(rp, tkeys.to_image(keys))
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0
    np.testing.assert_array_equal(rt.search(rp, tkeys.to_image(keys)).numpy(), lb)


@pytest.mark.parametrize("spec", ["linear,radix", "linear,histogram", "linear,bradix"])
def test_top_only_model_as_leaf_raises(spec):
    keys = _keys("books")
    with pytest.raises(ValueError):
        rmi_tpu.train(JDataset.from_numpy(keys, jkeys.KeyType.U64), spec, 64)
    with pytest.raises(ValueError):
        rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, 64)
