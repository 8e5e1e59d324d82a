"""f64 keys through the port against rmi_tpu on the CPU.

  (a) the key image: a bit view with a sign fix.  It round-trips every
      f64 (normals, subnormals, +-0.0, +-inf; -0.0 comes back as +0.0 and
      a NaN as a NaN), orders as numpy orders the values, puts every NaN
      below -inf, and equals rmi_tpu's ordered_u64 ^ 2^63 on everything
      but subnormals, which rmi_tpu maps to +0's image, whatever their
      sign (its arithmetic image works on the values, which XLA on the
      CPU flushes to zero, rmi_tpu/keys.py:176-222; a reference quirk);
  (b) plus_epsilon, minus_epsilon (the absolute f64::EPSILON) and as_int
      (clip to [0, 2^64 - 1], truncate) equal rmi_tpu's;
  (c) independent builds on f64_like keys (tools/parity_report.py's
      generator, copied) held to the PARITY rule: FixDups and max_err
      with its leaf equal, at most 3 leaf errors differing, each by 1,
      avg_log2 within 1e-7 relative beyond what they explain; for the
      float models as tops and leaves, and for the integer models, which
      rmi_tpu computes on as_int of the raw float;
  (d) builds carried across (trained_from_numpy) bit-equal to rmi_tpu's:
      leaf ids, per-key sweep errors, the whole stage C (probes included)
      and max_err, lookup, search of out-of-range, -0.0, +-inf and NaN
      queries, and the search plan's kind;
  (e) the artifact files of a carried-across build byte for byte
      rmi_tpu's (key_type "f64", ``double`` keys in the C++); load_artifact
      reads them back into an index whose lookup equals rmi_tpu's load of
      the same files, and the saved index's wherever the loaded top keeps
      the query's leaf (the raw round trip may move a query on a leaf
      boundary, tests/test_torch_artifacts.py); the generated C++ and the
      native server (key_is_float) compute in the raw domain: they agree
      with each other, hold the bound on every key, give the port's guess
      and error on all but 0.1% of the keys (a key the raw top sends to
      the next leaf), and the server's search is exact; both CLIs on one
      ``*_f64`` SOSD file write the same files;
  (f) lookup's kernel route on the CPU (its plain version) decodes f64
      images: guess and err bit-equal to lookup written out on the
      decoded floats.
"""

import functools
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu import lookup_fast as jlf
from rmi_tpu import serialize as jser
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.models import get_model as j_get_model
from rmi_tpu.train import two_layer as j_two_layer

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch import native
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.models.base import kernel_input
from rmi_tpu_torch.ops import eval_kernel, sweep_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg
from test_torch_artifacts import _outputs, assert_same_files, carry, compile_and_run
from test_torch_cli import assert_same_outputs, run_both

N = 1 << 13
F64 = KeyType.F64
# the float models as tops over linear leaves and as leaves under a cubic
# or linear top, at two branching factors
FLOAT_SPECS = [("linear,linear", 256), ("robust_linear,linear", 256),
               ("linear_spline,linear", 256), ("cubic,linear", 256),
               ("cubic,linear", 1024), ("loglinear,linear", 256),
               ("normal,linear", 256), ("lognormal,linear", 256),
               ("cubic,robust_linear", 256), ("cubic,linear_spline", 1024),
               ("cubic,loglinear", 64), ("cubic,loglinear", 1024),
               ("cubic,normal", 64), ("cubic,normal", 1024),
               ("cubic,lognormal", 64), ("cubic,lognormal", 1024),
               ("linear,cubic", 256)]
# the integer models, on as_int of the keys
INT_SPECS = [("radix,linear", 256), ("bradix,linear", 256), ("radix18,linear", 256),
             ("histogram,linear", 256), ("cubic,radix8", 256), ("radix8,radix8", 64)]
CARRIED = [("cubic,linear", 256), ("linear_spline,linear", 256), ("cubic,loglinear", 64),
           ("normal,linear", 256), ("linear,cubic", 256), ("radix,linear", 256),
           ("histogram,linear", 256), ("cubic,radix8", 256), ("radix8,radix8", 64)]


def f64_like(n: int, seed: int = 13) -> np.ndarray:
    """f64 keys (osm_cellids-style float CDF): tools/parity_report.py's
    generator."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(size=n)
    csum = np.cumsum(gaps)
    return np.sort((csum * (1e12 / csum[-1])).astype(np.float64))


@functools.lru_cache(maxsize=None)
def _keys():
    return f64_like(N)


@functools.lru_cache(maxsize=None)
def _jax_build(spec, B):
    rj = rmi_tpu.train(JDataset.from_numpy(_keys()), spec, B)
    rj.raw_inputs = rj.raw_thunk.__defaults__
    return rj


@functools.lru_cache(maxsize=None)
def _port_build(spec, B):
    return rt.train(rt.RMIDataset.from_numpy(_keys(), device="cpu"), spec, B)


@functools.lru_cache(maxsize=None)
def _carried(spec, B):
    return carry(_jax_build(spec, B), _keys())


def _values():
    """Normals of both signs over the whole exponent range, subnormals,
    the signed zeros and infinities, f64::MAX and NaNs."""
    rng = np.random.default_rng(3)
    normals = (rng.choice([-1.0, 1.0], 4000)
               * np.ldexp(rng.uniform(1.0, 2.0, 4000), rng.integers(-1022, 1024, 4000)))
    subnormals = rng.choice([-1.0, 1.0], 200) * rng.integers(1, 2 ** 52, 200) * 5e-324
    special = np.array([0.0, -0.0, np.inf, -np.inf, sys.float_info.max,
                        -sys.float_info.max, 5e-324, -5e-324, 2.2250738585072014e-308,
                        1.0, -1.0, 2.0 ** 64, 2.0 ** 63, np.nan, -np.nan])
    return np.concatenate([normals, subnormals, special])


def _subnormal(x):
    return (x != 0) & (np.abs(x) < sys.float_info.min)


# ---------------------------------------------------------------------------
# (a) the image
# ---------------------------------------------------------------------------

def test_image_round_trips():
    x = _values()
    back = tkeys.from_image(tkeys.to_image(x), F64)
    nan = np.isnan(x)
    assert np.isnan(back[nan]).all()
    want = np.where(x == 0, 0.0, x)            # -0.0 comes back as +0.0
    np.testing.assert_array_equal(back[~nan].view(np.int64), want[~nan].view(np.int64))


def test_image_orders_as_numpy():
    x = _values()
    img = tkeys.to_image(x).numpy()
    nan = np.isnan(x)
    assert (img[nan] == tkeys.IMAGE_MIN).all() and (img[~nan] > tkeys.IMAGE_MIN).all()
    v, i = x[~nan], img[~nan]
    # the signed order of images is the order of values (-0.0 == +0.0)
    np.testing.assert_array_equal(np.argsort(i, kind="stable"),
                                  np.argsort(np.where(v == 0, 0.0, v), kind="stable"))
    def cmp(a):
        return (a[:, None] > a[None, :]).astype(np.int8) - (a[:, None] < a[None, :])
    np.testing.assert_array_equal(cmp(i), cmp(v))


def test_image_equals_rmi_tpu_but_subnormals():
    x = _values()
    want = (np.asarray(jkeys.ordered_u64(jnp.asarray(x), jkeys.KeyType.F64))
            ^ np.uint64(1 << 63)).view(np.int64)
    got = tkeys.to_image(x).numpy()
    sub = _subnormal(x)
    np.testing.assert_array_equal(got[~sub], want[~sub])
    # rmi_tpu's arithmetic image flushes subnormals of either sign to
    # +0's image; the port keeps their bits
    assert (want[sub] == 0).all() and (got[sub] != 0).all()


def test_image_on_the_device_path():
    """keys.f64_image of a tensor is to_image of its array, and
    f64_of_image / as_float decode it."""
    x = _values()
    t = torch.from_numpy(x)
    img = tkeys.f64_image(t)
    np.testing.assert_array_equal(img.numpy(), tkeys.to_image(x).numpy())
    ok = ~np.isnan(x)
    np.testing.assert_array_equal(tkeys.as_float(img, F64).numpy()[ok],
                                  np.where(x == 0, 0.0, x)[ok])


# ---------------------------------------------------------------------------
# (b) epsilons and as_int
# ---------------------------------------------------------------------------

def _eps_values():
    return np.array([0.0, 2.0 ** -53, 2.0 ** -52, 1e-300, 0.5, 1.0, 1.5, 2.0, 3.0,
                     1e6, 1e12, 2.0 ** 63, -1.0, -2.0 ** -52, sys.float_info.max])


@pytest.mark.parametrize("name", ["minus_epsilon", "plus_epsilon"])
def test_epsilons_equal_rmi_tpu(name):
    x = _eps_values()
    got = tkeys.from_image(getattr(tkeys, name)(tkeys.to_image(x), F64), F64)
    want = np.asarray(getattr(jkeys, name)(jnp.asarray(x), jkeys.KeyType.F64))
    np.testing.assert_array_equal(got.view(np.int64),
                                  np.where(want == 0, 0.0, want).view(np.int64))


def test_as_int_equals_rmi_tpu():
    x = np.concatenate([_eps_values(), _values(),
                        np.random.default_rng(4).uniform(0, 2.0 ** 64, 3000)])
    got = tkeys.as_int(tkeys.to_image(x), F64).numpy().view(np.uint64)
    want = np.asarray(jkeys.as_int(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_fills_are_f64_max_and_zero():
    assert tkeys.from_image(torch.tensor([F64.max_image]), F64)[0] == sys.float_info.max
    assert tkeys.from_image(torch.tensor([F64.zero_image]), F64)[0] == 0.0
    assert F64.max_value == sys.float_info.max


# ---------------------------------------------------------------------------
# (c) independent builds: the PARITY rule
# ---------------------------------------------------------------------------

def _counts(rmi):
    t = two_layer.top_assignment(get_model(rmi.top_type), rmi.device_top_params,
                                 rmi.keys, rmi.norm_offset, rmi.norm_scale,
                                 rmi.branching_factor - 1, rmi.key_type)
    spans = seg.make_spans(t.to(torch.int32), rmi.branching_factor)
    return (spans.ends - spans.starts).numpy()


def assert_parity(keys, rj, rp, rc, allowed=3):
    """The PARITY rule (ROADMAP.md, North star) between rmi_tpu's build rj
    (rc: carried across) and the port's rp of the same keys."""
    np.testing.assert_array_equal(two_layer.fixdups_i32(rp.keys).numpy(),
                                  np.asarray(j_two_layer._fixdups_jit(jnp.asarray(keys))))
    assert (rp.model_max_error, rp.model_max_error_idx) == \
        (rj.model_max_error, rj.model_max_error_idx)
    e_p = rp.leaf_errors.numpy()
    e_j = np.asarray(rj.leaf_errors).astype(np.int64)
    diff = np.abs(e_p - e_j)
    assert np.count_nonzero(diff) <= allowed and diff.max() <= 1
    cnt_p, cnt_j = _counts(rp), _counts(rc)
    moved = (cnt_p != cnt_j) | (e_p != e_j)
    explained = np.sum((cnt_p * np.log2(2.0 * e_p + 2.0)
                        - cnt_j * np.log2(2.0 * e_j + 2.0))[moved]) / keys.size
    d = rp.model_avg_log2_error - rj.model_avg_log2_error
    assert abs(d - explained) <= 1e-7 * abs(rj.model_avg_log2_error)


@pytest.mark.parametrize("spec,B", FLOAT_SPECS + INT_SPECS)
def test_independent_build_parity(spec, B):
    keys = _keys()
    rp = _port_build(spec, B)
    assert rp.key_type is F64
    assert_parity(keys, _jax_build(spec, B), rp, _carried(spec, B))
    g, e = rt.lookup(rp, rp.keys)
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0


# ---------------------------------------------------------------------------
# (d) carried across: bit-equal
# ---------------------------------------------------------------------------

def _queries(keys, rng):
    """Values over and beyond the key range, the keys themselves, the
    signed zeros, the infinities and NaN."""
    span = keys[-1] - keys[0]
    q = rng.uniform(keys[0] - span / 8, keys[-1] + span / 8, 3000)
    edges = np.array([-0.0, 0.0, -1.0, np.inf, -np.inf, np.nan, keys[0], keys[-1],
                      np.nextafter(keys[0], -np.inf), np.nextafter(keys[-1], np.inf),
                      2.0 ** 70, -2.0 ** 70])
    return np.concatenate([q, edges, keys[rng.integers(0, keys.size, 1000)]])


@functools.partial(jax.jit, static_argnames=("top", "leaf", "B"))
def _jax_stage(keys, top_p, leaf_p, off, s, yfix, *, top, leaf, B):
    """rmi_tpu's leaf ids and, for a float leaf, its per-key sweep errors
    (two_layer.py:257-300 of rmi_tpu)."""
    n = keys.shape[0]
    mtop, mleaf = j_get_model(top), j_get_model(leaf)
    xraw = jkeys.as_float(keys)
    xn = (xraw - off) * s
    t = j_two_layer.predict_top_assignment(mtop, top_p, keys, xn, xraw, B - 1)
    if mleaf.output_int:
        return t, t
    p = jnp.floor(mleaf.predict(leaf_p, t, j_two_layer.model_float_input(mleaf, xn, xraw)))
    p = jnp.where(jnp.isnan(p), 0.0, jnp.clip(p, 0.0, jnp.float64(n)))
    return t, jnp.abs(p.astype(jnp.int32) - jnp.minimum(yfix, n))


@pytest.mark.parametrize("spec,B", CARRIED)
def test_carried_build_bit_equal(spec, B):
    keys = _keys()
    rj, rc = _jax_build(spec, B), _carried(spec, B)
    top, leaf = spec.split(",")
    mtop, mleaf = get_model(top), get_model(leaf)
    kmin, s = rc.norm_offset, rc.norm_scale
    t = two_layer.top_assignment(mtop, rc.device_top_params, rc.keys, kmin, s, B - 1,
                                 F64).to(torch.int32)
    yfix = two_layer.fixdups_i32(rc.keys)
    t_j, err_j = _jax_stage(jnp.asarray(keys), j_two_layer._predict_params(
        rj.device_top_params), j_two_layer._predict_params(rj.device_leaf_params),
        jnp.float64(kmin), jnp.float64(s), jnp.asarray(yfix.numpy()), top=top, leaf=leaf,
        B=B)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    x = two_layer.model_float_input(mleaf, rc.keys, kmin, s, F64)
    if not mleaf.output_int:
        err = sweep_kernel.sweep_errors(kernel_input(mleaf, x), yfix, t,
                                        rc.device_leaf_params, N, leaf_type=leaf)
        np.testing.assert_array_equal(err.numpy(), np.asarray(err_j))
    spans = seg.make_spans(t, B)
    next_idx, next_key, prev_key = two_layer.lower_bound_fills(spans, rc.keys, F64)
    leaf_errors, metrics_t = two_layer.sweep_body(
        rc.keys, x, yfix, spans, rc.device_leaf_params, next_idx, next_key, prev_key,
        kmin, s, F64, leaf_type=leaf)
    metrics = two_layer.metrics_dict(metrics_t.tolist())
    np.testing.assert_array_equal(leaf_errors.numpy(),
                                  np.asarray(rj.leaf_errors).astype(np.int64))
    assert (metrics["model_max_error"], metrics["model_max_error_idx"]) == \
        (rj.model_max_error, rj.model_max_error_idx)
    for q in (keys, _queries(keys, np.random.default_rng(5))):
        g, e = rt.lookup(rc, tkeys.to_image(q))
        gj, ej = rmi_tpu.lookup(rj, jnp.asarray(q))
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(e.numpy(), np.asarray(ej).astype(np.int64))
        got = rt.search(rc, tkeys.to_image(q)).numpy()
        np.testing.assert_array_equal(got, np.asarray(rmi_tpu.search(rj, jnp.asarray(q))))
        ok = ~np.isnan(q)
        np.testing.assert_array_equal(got[ok], np.searchsorted(keys, q[ok], side="left"))
    assert lf.get_plan(rc).kind == jlf.get_plan(rj).kind


def test_search_sorted_and_large_batches_exact():
    """search_sorted (K5's plain version) and the sort route on f64 images,
    NaN and the signed zeros and infinities among the queries."""
    keys = _keys()
    rc = _carried("cubic,linear", 256)
    q = _queries(keys, np.random.default_rng(6))
    q = np.concatenate([q] * (((1 << 14) // q.size) + 1))[:1 << 14]
    img = tkeys.to_image(q)
    want = torch.searchsorted(rc.keys, img).numpy()
    np.testing.assert_array_equal(rt.search_sorted(rc, img.sort().values).numpy(),
                                  np.sort(want))
    plan = lf.get_plan(rc)
    np.testing.assert_array_equal(lf.serve_via_sort(rc, plan, img).numpy(), want)
    assert want[np.isnan(q)].max() == 0


def test_integer_top_refuses_the_packed_plan():
    """rmi_tpu's int-output tops route f64 keys by their truncated value,
    so neither package builds a packed plan for them (rmi_tpu
    lookup_fast.py:592-595), though the top is monotone."""
    rc = _carried("radix,linear", 256)
    assert lf.get_plan(rc).kind == jlf.get_plan(_jax_build("radix,linear", 256)).kind \
        == "hier"


# ---------------------------------------------------------------------------
# (e) artifacts, C++ and the native server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,B", [("cubic,linear", 256), ("linear_spline,linear", 256),
                                    ("histogram,linear", 256), ("cubic,radix8", 256)])
def test_carried_build_writes_the_same_bytes(tmp_path, spec, B):
    rj = _jax_build(spec, B)
    d1, d2 = _outputs(tmp_path, rj, _carried(spec, B), True)
    assert "double key" in (d2 / "ns.h").read_text()
    assert '"key_type": "f64"' in (d2 / "rmi_data" / "ns.json").read_text()
    assert_same_files(d1, d2)
    meta = str(d2 / "rmi_data" / "ns.json")
    rc = _carried(spec, B)
    loaded = rt.load_artifact(meta, keys=rc.keys, device="cpu")
    assert loaded.key_type is F64
    qn = _queries(_keys(), np.random.default_rng(8))
    q = tkeys.to_image(qn)
    g, e = rt.lookup(loaded, q)
    gj, ej = rmi_tpu.lookup(jser.load_artifact(meta), jnp.asarray(qn))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    same_leaf = (two_layer.top_assignment(get_model(rc.top_type), rc.device_top_params, q,
                                          rc.norm_offset, rc.norm_scale, B - 1, F64)
                 == two_layer.top_assignment(get_model(rc.top_type), loaded.device_top_params,
                                             q, loaded.norm_offset, loaded.norm_scale, B - 1,
                                             F64)).numpy()
    assert same_leaf.mean() > 0.99
    g1, e1 = rt.lookup(rc, q)
    np.testing.assert_array_equal(g.numpy()[same_leaf], g1.numpy()[same_leaf])
    np.testing.assert_array_equal(e.numpy()[same_leaf], e1.numpy()[same_leaf])
    np.testing.assert_array_equal(rt.search(loaded, q).numpy(),
                                  torch.searchsorted(loaded.keys, q).numpy())


@pytest.mark.parametrize("spec,B", [("cubic,linear", 256), ("linear,linear", 64)])
def test_generated_cpp_and_native_server(tmp_path, spec, B):
    keys = _keys()
    rp = _port_build(spec, B)
    cg, ce, size = compile_and_run(str(tmp_path / "cpp"), rp, "f", keys)
    assert size == rt.rmi_size(rp)
    assert "double key" in (tmp_path / "cpp" / "f.h").read_text()
    lb = np.searchsorted(keys, keys, side="left")
    assert (np.abs(cg - lb) <= ce).all()
    g, e = rt.lookup(rp, rp.keys)
    assert np.count_nonzero((cg != g.numpy()) | (ce != e.numpy())) <= keys.size // 1000
    meta = rt.output_rmi("nat", rp, data_dir=str(tmp_path / "nat"), emit_cpp=False)
    with native.NativeRMI(meta) as srv:
        ng, ne = srv.lookup(keys)
        np.testing.assert_array_equal(ng.astype(np.int64), cg)
        np.testing.assert_array_equal(ne.astype(np.int64), ce)
        # non-negative queries: the server compares the keys' 64-bit words
        q = np.abs(_queries(keys, np.random.default_rng(9)))
        q = q[~np.isnan(q)]
        np.testing.assert_array_equal(srv.search(q, keys).astype(np.int64),
                                      np.searchsorted(keys, q, side="left"))


def test_cli_on_an_f64_file(tmp_path, monkeypatch):
    """Both CLIs on one ``*_f64`` SOSD file, a sum-free configuration: the
    same files (``double`` keys, key_type "f64"), floats in the dumps."""
    path = str(tmp_path / "keys_f64")
    rt.write_sosd_file(path, _keys())
    (d1, r1), (d2, r2) = run_both(tmp_path, monkeypatch, [
        path, "fk", "linear_spline,linear_spline", "64", "--stats-file", "stats.json",
        "--dump-ll-model-data", "3", "--zero-build-time"])
    assert r1 == r2 == 0
    assert "rmi_data/fk_L1_PARAMETERS" in assert_same_outputs(d1, d2)
    assert "uint64_t lookup(double key, size_t* err);" in (d2 / "fk.h").read_text()
    meta = json.loads((d2 / "rmi_data" / "fk.json").read_text())
    assert meta["key_type"] == "f64"
    keys = json.loads((d2 / "ll_model_data_3.json").read_text())["keys"]
    assert keys and all(isinstance(k, float) for k in keys)


def test_cachefix_refuses_f64():
    with pytest.raises(ValueError, match="integer data"):
        rt.train_bounded(rt.RMIDataset.from_numpy(_keys(), device="cpu"), "linear,linear",
                         64, 8)


# ---------------------------------------------------------------------------
# (f) lookup's plain route decodes f64 images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", ["linear", "cubic", "loglinear", "normal"])
def test_lookup_plain_decodes_f64(leaf):
    rc = _carried("cubic,linear", 256) if leaf == "linear" else _port_build(
        {"cubic": "linear,cubic", "loglinear": "cubic,loglinear",
         "normal": "cubic,normal"}[leaf], {"cubic": 256, "loglinear": 64, "normal": 64}[leaf])
    q = _queries(_keys(), np.random.default_rng(10))
    img = tkeys.to_image(q)
    guess, err = eval_kernel.lookup_clamped_plain(
        img, rc.device_top_params, rc.device_leaf_params, rc.leaf_errors, N,
        rc.norm_offset, rc.norm_scale, top_type=rc.top_type, leaf_type=rc.leaf_type,
        key_type=F64)
    x = (torch.from_numpy(np.where(q == 0, 0.0, q)) - rc.norm_offset) * rc.norm_scale
    mtop = get_model(rc.top_type)
    ids = eval_kernel.predict_clamped(mtop.predict(rc.device_top_params, None, x),
                                      rc.branching_factor - 1)
    want = eval_kernel.predict_clamped(
        eval_kernel.leaf_predict(rc.leaf_type, rc.device_leaf_params, ids, x), N - 1)
    np.testing.assert_array_equal(guess.numpy(), want.numpy())
    np.testing.assert_array_equal(err.numpy(), rc.leaf_errors[ids].numpy())
