"""The port's main-path slice (build + serve) against the JAX build.

Over books-like and duplicate-heavy u64 keys, ``cubic,linear`` and
``linear,linear``, B in {64, 1024}:

  (a) with the JAX build's parameters carried across
      (trained_from_numpy), leaf ids, per-key sweep errors, probe
      predictions, leaf errors, max_err, lookup and search are bit-equal
      to JAX's: both compute fma(beta, x, alpha) and the cubic Horner
      chain as FMAs, the CPU JAX build under jit and torch.addcmul here;
  (b) trained independently, FixDups is bit-equal and max_err equal; at
      most 3 leaf errors differ, each by at most 1 (the PARITY.json rule:
      summation order moves a floor() across an integer), and
      model_avg_log2_error agrees within 1e-7 relative once the part the
      differing leaves explain is taken out;
  (c) |guess - lower_bound| <= err on every key;
  (d) search equals np.searchsorted(side="left") on every key and on
      random, out-of-range and duplicate queries.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.models.base import predict_clamped as j_predict_clamped
from rmi_tpu.models.linear import _linear_predict as j_linear_predict
from rmi_tpu.train import two_layer as j_two_layer
from rmi_tpu.utils import segments as j_seg

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import eval_kernel, sweep_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

N = 1 << 15
COMBOS = [(kind, spec, B) for kind in ("books", "dups")
          for spec in ("cubic,linear", "linear,linear") for B in (64, 1024)]


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


def _jax_leaf_ids(keys, spec, B, w, off, s):
    mtop = j_get_model(spec.split(",")[0])

    @jax.jit
    def f(k, w_, off_, s_):
        xraw = jkeys.as_float(k)
        xn = (xraw - off_) * s_
        return j_two_layer.predict_top_assignment(mtop, {"w": w_}, k, xn,
                                                  xraw, B - 1), xn
    t, xn = f(jnp.asarray(keys), w, jnp.float64(off), jnp.float64(s))
    return np.asarray(t), np.asarray(xn)


def _queries(keys, rng):
    q = rng.integers(0, 2 ** 56, 6_000, dtype=np.uint64)
    edges = np.array([0, 1, keys[0], max(int(keys[0]) - 1, 0), keys[-1],
                      int(keys[-1]) + 1, 2 ** 64 - 1], dtype=np.uint64)
    return np.concatenate([q, edges, keys[rng.integers(0, keys.size, 2_000)]])


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_carried_params_bit_equal(kind, spec, B):
    keys, rj, _ = _builds(kind, spec, B)
    top_w = np.asarray(rj.device_top_params["w"])
    leaf_w = np.asarray(rj.device_leaf_params["w"])
    errs_j = np.asarray(rj.leaf_errors).astype(np.int64)
    rc = rt.trained_from_numpy(spec, B, tkeys.KeyType.U64, keys, top_w, leaf_w,
                               errs_j, rj.norm_offset, rj.norm_scale, device="cpu")
    assert rc.model_max_error == rj.model_max_error
    assert rc.model_max_error_idx == rj.model_max_error_idx

    # leaf ids, from the same top parameters
    t_j, xn_j = _jax_leaf_ids(keys, spec, B, jnp.asarray(top_w),
                              rj.norm_offset, rj.norm_scale)
    img = rc.keys
    xn = two_layer.normalize(img, rc.norm_offset, rc.norm_scale)
    np.testing.assert_array_equal(xn.numpy(), xn_j)
    t = two_layer.predict_top_assignment(
        get_model(rc.top_type), rc.device_top_params, xn, B - 1).to(torch.int32)
    np.testing.assert_array_equal(t.numpy(), t_j)

    # per-key sweep errors (two_layer.py:269-280 of rmi_tpu)
    yfix = two_layer.fixdups_i32(img)
    err = sweep_kernel.sweep_errors(xn, yfix, t, rc.device_leaf_params, N,
                                    leaf_type="linear")

    @jax.jit
    def jax_sweep(xn_, y_, t_, w_):
        p = jnp.floor(j_linear_predict(w_, t_, xn_))
        p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(N)))
        return jnp.abs(p.astype(jnp.int32) - jnp.minimum(y_, N))
    want = jax_sweep(jnp.asarray(xn_j), jnp.asarray(yfix.numpy()),
                     jnp.asarray(t_j), jnp.asarray(leaf_w))
    np.testing.assert_array_equal(err.numpy(), np.asarray(want))

    # epsilon probes (two_layer.py:302-322 of rmi_tpu)
    spans = seg.make_spans(t, B)
    next_idx, next_key, prev_key = two_layer.lower_bound_fills(
        spans, img, tkeys.KeyType.U64)
    jspans = j_seg.make_spans(jnp.asarray(t_j), B)
    jn_idx, jn_key, jp_key = j_two_layer.lower_bound_fills(
        jspans, jnp.asarray(keys), jkeys.KeyType.U64)
    np.testing.assert_array_equal(next_idx.numpy(), np.asarray(jn_idx))
    np.testing.assert_array_equal(tkeys.from_image(next_key), np.asarray(jn_key))
    np.testing.assert_array_equal(tkeys.from_image(prev_key), np.asarray(jp_key))
    ids = torch.arange(B)

    @jax.jit
    def jax_probe(k, w_, off_, s_):
        x = (jkeys.as_float(k) - off_) * s_
        return j_predict_clamped(j_linear_predict(w_, jnp.arange(B), x), N)
    for tk, jk in ((tkeys.minus_epsilon(next_key, tkeys.KeyType.U64),
                    jkeys.minus_epsilon(jn_key, jkeys.KeyType.U64)),
                   (tkeys.plus_epsilon(prev_key, tkeys.KeyType.U64),
                    jkeys.plus_epsilon(jp_key, jkeys.KeyType.U64))):
        got = eval_kernel.leaf_eval_clamped(
            two_layer.normalize(tk, rc.norm_offset, rc.norm_scale),
            rc.device_leaf_params, ids, N, leaf_type="linear")
        want = jax_probe(jk, jnp.asarray(leaf_w), jnp.float64(rc.norm_offset),
                         jnp.float64(rc.norm_scale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the port's whole stage C on the carried parameters
    leaf_errors, metrics_t = two_layer.sweep_body(
        img, xn, yfix, spans, rc.device_leaf_params, next_idx, next_key,
        prev_key, rc.norm_offset, rc.norm_scale, tkeys.KeyType.U64,
        leaf_type="linear")
    metrics = two_layer.metrics_dict(metrics_t.tolist())
    np.testing.assert_array_equal(leaf_errors.numpy(), errs_j)
    assert metrics["model_max_error"] == rj.model_max_error

    # serving
    q = _queries(keys, np.random.default_rng(7))
    for qs in (keys, q):
        g, e = rt.lookup(rc, tkeys.to_image(qs))
        gj, ej = rmi_tpu.lookup(rj, jnp.asarray(qs))
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(e.numpy(), np.asarray(ej).astype(np.int64))
        np.testing.assert_array_equal(rt.search(rc, tkeys.to_image(qs)).numpy(),
                                      np.asarray(rmi_tpu.search(rj, jnp.asarray(qs))))


def _counts(keys, spec, B, top_w, off, s):
    t, _ = _jax_leaf_ids(keys, spec, B, jnp.asarray(top_w), off, s)
    return np.bincount(t, minlength=B)


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_independent_build_parity(kind, spec, B):
    keys, rj, rp = _builds(kind, spec, B)
    img = rp.keys
    np.testing.assert_array_equal(
        two_layer.fixdups_i32(img).numpy(),
        np.asarray(j_two_layer._fixdups_jit(jnp.asarray(keys))))
    assert rp.model_max_error == rj.model_max_error

    e_p = rp.leaf_errors.numpy()
    e_j = np.asarray(rj.leaf_errors).astype(np.int64)
    diff = np.abs(e_p - e_j)
    assert np.count_nonzero(diff) <= 3 and diff.max() <= 1

    cnt_j = _counts(keys, spec, B, np.asarray(rj.device_top_params["w"]),
                    rj.norm_offset, rj.norm_scale)
    xn = two_layer.normalize(img, rp.norm_offset, rp.norm_scale)
    t = two_layer.predict_top_assignment(get_model(rp.top_type),
                                         rp.device_top_params, xn, B - 1)
    cnt_p = np.bincount(t.numpy(), minlength=B)
    assert np.array_equal(cnt_p, cnt_j) or spec == "linear,linear"
    moved = (cnt_p != cnt_j) | (e_p != e_j)
    explained = np.sum((cnt_p * np.log2(2.0 * e_p + 2.0)
                        - cnt_j * np.log2(2.0 * e_j + 2.0))[moved]) / N
    d = rp.model_avg_log2_error - rj.model_avg_log2_error
    assert abs(d - explained) <= 1e-7 * abs(rj.model_avg_log2_error)


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_bound_holds_on_every_key(kind, spec, B):
    keys, _, rp = _builds(kind, spec, B)
    g, e = rt.lookup(rp, tkeys.to_image(keys))
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0


@pytest.mark.parametrize("kind,spec,B", COMBOS)
def test_search_is_exact(kind, spec, B):
    keys, _, rp = _builds(kind, spec, B)
    for q in (keys, _queries(keys, np.random.default_rng(11))):
        got = rt.search(rp, tkeys.to_image(q)).numpy()
        np.testing.assert_array_equal(got, np.searchsorted(keys, q, side="left"))


@pytest.mark.parametrize("keys_dtype,spec,err", [
    (np.float64, "linear,radix", ValueError),             # f64 keys, a top-only leaf
    (np.uint64, "cubic,bradix", ValueError),              # a top-only model as leaf
    (np.uint64, "cubic,histogram", ValueError),
    (np.uint64, "linear,linear,linear", ValueError),      # two layers only
], ids=["f64-keys", "cubic,bradix", "cubic,histogram", "linear,linear,linear"])
def test_unported_specs_raise(keys_dtype, spec, err):
    with pytest.raises(err):
        data = rt.RMIDataset.from_numpy(_keys("books").astype(keys_dtype), device="cpu")
        rt.train(data, spec, 64)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 3 * 1024 * 1024 + 5])
def test_prefix_sum_exclusive_matches_jax(n):
    """The row scan (1024 per row, row totals scanned in turn): over the
    first row it adds in sequence, so it equals numpy's sequential
    cumsum exactly; everywhere it agrees with rmi_tpu's cumsum within
    1e-13 relative (summation order)."""
    v = np.random.default_rng(n).random(n) * 1e6
    got = seg.prefix_sum_exclusive(torch.from_numpy(v)).numpy()
    want = np.asarray(j_seg.prefix_sum_exclusive(jnp.asarray(v)))
    assert got.shape == want.shape == (n + 1,)
    head = np.concatenate([[0.0], np.cumsum(v[:1024])])
    np.testing.assert_array_equal(got[:1025], head[:n + 1])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
