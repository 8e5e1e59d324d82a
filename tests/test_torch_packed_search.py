"""The packed plan's search and K5's window bounds (ops/packed_kernel.py)
against rmi_tpu on the CPU.

rmi_tpu builds each index from keys made with numpy seeds (n <= 2^16),
and ``trained_from_numpy`` carries it across, so both packages serve the
same parameters.  rmi_tpu's _fast_search_packed, _fast_search_packed_wide
and _sorted_stats_direct run under JAX on the CPU, as its own tests run
them.  Held bit-equal (every value is an integer, so no tolerance):

  * packed_search_plain against rmi_tpu's packed search of the plan's
    kind and np.searchsorted(side="left");
  * sorted_bounds_plain against the window bounds of rmi_tpu's anchors:
    LB1 of each block's first and last query, from _sorted_stats_direct,
    minus 1 and plus F, clamped to the stripe count; rmi_tpu's LB1_f of a
    sorted batch padded as rmi_tpu pads it, every KQ / 128-th;
  * the numpy mirror of rmi_packed_search and rmi_sorted_bounds
    (csrc/packed.cu) in tools/count_torch_packed_reads.py, which counts
    the leaf row whole (a long row by its chunks' last samples, then one
    chunk) and then 64-byte blocks of the stripe-first keys and of the
    stripe placed by interpolation, against the plain versions' whole-row
    counts on the same inputs; and that mirror on its own shapes, beside
    the design before it.

The cases: every top of lookup_fast._MONOTONE_TOPS but radix26 and
radix28 (hint tables of 256 MB and 1 GB, which run the table kind's code
with other bits and are served on the card only), and the loglinear,
normal and lognormal tops, whose fitted rows are monotone here
(_scalar_top_monotone), over u64 keys; u32 keys; f64 keys under affine
tops; both plan kinds; n not a multiple of 64 and n < 64.  The queries:
keys of the index, duplicate runs, random images over the whole domain,
below and above the keys' range, 0 and 2^64 - 1 (f64: -0.0, +-inf, NaN);
the sorted batch ends in a short K5 block.
"""

import dataclasses
import functools
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu import lookup_fast as jlf
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.ops import sorted_serve_kernel as jssk
from rmi_tpu.train import two_layer as j_two_layer

import rmi_tpu_torch as rt
from rmi_tpu_torch import config
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import packed_kernel as pk
from rmi_tpu_torch.ops.sorted_serve_kernel import KQ, STRIPE

from test_torch_lookup_kernel import PACKED_EDGE_BS, PACKED_EDGES, packed_edge_case

N = (1 << 16) - 37           # not a multiple of 64
NQ = 4096                    # queries a search batch: one shape, one compile a case
NQ_SORTED = 3 * KQ + 77      # the last K5 block short
SUBQ = jssk.SUBQ             # rmi_tpu's anchor spacing, 128 queries

# (keys, spec, B, the plan kind rmi_tpu makes)
CASES = [
    ("books", "linear,linear", 4, "packed_wide"),
    ("books", "robust_linear,linear", 256, "packed"),
    ("books", "linear_spline,linear", 8, "packed_wide"),
    ("books", "cubic,linear", 256, "packed"),
    ("books", "cubic,cubic", 2, "packed_wide"),
    ("books", "radix,linear", 64, "packed"),
    ("books", "bradix,linear", 64, "packed"),
    ("books", "radix8,linear", 64, "packed"),
    ("books", "radix18,linear", 256, "packed"),
    ("books", "radix22,linear", 16, "packed"),
    ("books", "histogram,linear", 64, "packed"),
    ("books", "histogram,linear", 4, "packed_wide"),
    ("books", "loglinear,linear", 64, "packed"),
    ("books", "normal,linear", 8, "packed_wide"),
    ("books", "lognormal,linear", 64, "packed"),
    ("u32", "cubic,linear", 64, "packed"),
    ("u32", "radix,linear", 8, "packed_wide"),
    ("f64", "linear,linear", 4, "packed_wide"),
    ("f64", "cubic,linear", 128, "packed"),
    ("f64", "normal,linear", 64, "packed"),
    ("tiny", "linear,linear", 2, "packed"),
]
KEY_TYPES = {"books": KeyType.U64, "u32": KeyType.U32, "f64": KeyType.F64,
             "tiny": KeyType.U64}
J_KEY_TYPES = {KeyType.U64: jkeys.KeyType.U64, KeyType.U32: jkeys.KeyType.U32,
               KeyType.F64: jkeys.KeyType.F64}


@functools.lru_cache(maxsize=None)
def _keys(kind):
    """Sorted keys with runs of equal keys: books-like u64 (N), books-like
    u32, f64 values in [1, 1e12], and 50 u64 keys."""
    rng = np.random.default_rng(19)
    n = 50 if kind == "tiny" else N
    c = np.cumsum(rng.exponential(size=n) * (rng.random(n) > 0.1))
    c = (c - c[0]) / (c[-1] - c[0])
    if kind == "u32":
        return (c * (2.0 ** 32 - 2)).astype(np.uint32)
    if kind == "f64":
        return 1.0 + c * 1e12
    return (c * 2.0 ** 55).astype(np.uint64) + np.uint64(1 << 40)


@functools.lru_cache(maxsize=None)
def _indexes(kind, spec, B):
    keys = _keys(kind)
    key_type = KEY_TYPES[kind]
    rj = rmi_tpu.train(JDataset.from_numpy(keys, J_KEY_TYPES[key_type]), spec, B)
    top, leaf = spec.split(",")

    def carried(p, name):
        if get_model(name).output_int:
            return {k: np.asarray(v) for k, v in j_two_layer._predict_params(p).items()}
        return np.asarray(p["w"])
    rc = rt.trained_from_numpy(
        spec, B, key_type, keys, carried(rj.device_top_params, top),
        carried(rj.device_leaf_params, leaf), np.asarray(rj.leaf_errors).astype(np.int64),
        rj.norm_offset, rj.norm_scale, device="cpu")
    return keys, rj, rc


def _queries(keys, key_type, nq, seed):
    """[nq] numpy queries of the keys' dtype, every class."""
    rng = np.random.default_rng(seed)
    dt = keys.dtype
    k = nq // 6
    if key_type is KeyType.F64:
        lo, hi = keys[0], keys[-1]
        edges = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, -1.0, lo, hi,
                          np.nextafter(lo, -np.inf), np.nextafter(hi, np.inf)])
        rand = np.concatenate([rng.uniform(lo, hi, k), rng.uniform(-1e13, 2e12, k)])
        below, above = rng.uniform(-1e3, lo, k), rng.uniform(hi, 1e15, k)
    else:
        top = np.iinfo(dt).max
        lo, hi = int(keys[0]), int(keys[-1])
        edges = np.array([0, top, lo, hi, max(lo - 1, 0), min(hi + 1, top)], dtype=dt)
        rand = np.concatenate([rng.integers(lo, hi, k, dtype=dt, endpoint=True),
                               rng.integers(0, top, k, dtype=dt, endpoint=True)])
        below = rng.integers(0, lo, k, dtype=dt, endpoint=True)
        above = rng.integers(hi, top, k, dtype=dt, endpoint=True)
    existing = keys[rng.integers(0, keys.size, k)]
    runs = np.repeat(keys[rng.integers(0, keys.size, max(1, k // 32))], 32)
    q = np.concatenate([edges.astype(dt), rand, below, above, existing, runs]).astype(dt)
    q = np.concatenate([q[:edges.size], rng.permutation(q[edges.size:])])
    return np.resize(q, nq)


def _lower_bounds(keys, q):
    """np.searchsorted over the images, which orders f64 keys as the
    packages do (NaN first, -0.0 as +0.0)."""
    return np.searchsorted(tkeys.to_image(keys).numpy(), tkeys.to_image(q).numpy())


def _j_search(rj, q):
    """rmi_tpu's packed search of its plan's kind."""
    jp = jlf.get_plan(rj)
    common = (jnp.float64(rj.norm_offset), jnp.float64(rj.norm_scale))
    kw = dict(top_type=rj.top_type, B=rj.branching_factor, n=rj.num_rmi_rows,
              key_type=rj.key_type, S=jp.S)
    if jp.kind == "packed":
        return jlf._fast_search_packed(jnp.asarray(q), rj.device_top_params, jp.rows_u32,
                                       *common, jp.level0_pair, jp.kmin_key, jp.kmax_key, **kw)
    return jlf._fast_search_packed_wide(jnp.asarray(q), rj.device_top_params, jp.rows_u32,
                                        *common, jp.level1_pair, jp.level0_pair, jp.kmin_key,
                                        jp.kmax_key, F=jp.F, **kw)


def _j_lb1(rj, q):
    """rmi_tpu's LB1 of each query of ``q``: _sorted_stats_direct's LB1_f
    of a batch that holds each query SUBQ times, padded to whole blocks of
    rmi_tpu's K5 with the last."""
    jp = jlf.get_plan(rj)
    batch = _padded(np.repeat(q, SUBQ), jssk.KQ)
    lb1, _ = jlf._sorted_stats_direct(
        jnp.asarray(batch), rj.device_top_params, jp.rows_u32,
        jnp.float64(rj.norm_offset), jnp.float64(rj.norm_scale), jp.kmin_key, jp.kmax_key,
        top_type=rj.top_type, B=rj.branching_factor, S=jp.S, F=jp.F, key_type=rj.key_type)
    return np.asarray(lb1).astype(np.int64)[:q.size]


def _padded(q, block):
    """``q`` padded with its last entry to a multiple of ``block``."""
    return np.concatenate([q, np.repeat(q[-1:], -q.size % block)])


def _case_ids(c):
    return f"{c[0]}-{c[1]}-{c[2]}"


@pytest.mark.parametrize("kind,spec,B,plan_kind", CASES, ids=map(_case_ids, CASES))
def test_packed_search_is_rmi_tpus(kind, spec, B, plan_kind):
    keys, rj, rc = _indexes(kind, spec, B)
    plan = lf.get_plan(rc)
    assert plan.kind == jlf.get_plan(rj).kind == plan_kind
    assert (plan.S, plan.F) == (jlf.get_plan(rj).S, jlf.get_plan(rj).F)
    q = _queries(keys, rc.key_type, NQ, 5)
    got = pk.packed_search_plain(rc, plan, tkeys.to_image(q)).numpy()
    np.testing.assert_array_equal(got, _lower_bounds(keys, q))
    np.testing.assert_array_equal(got, np.asarray(_j_search(rj, q)))
    # the wrapper on CPU tensors, and fast_search, are the plain version
    np.testing.assert_array_equal(pk.packed_search(rc, plan, tkeys.to_image(q)).numpy(), got)
    np.testing.assert_array_equal(lf.fast_search(rc, tkeys.to_image(q)).numpy(), got)


def _sorted_batch(keys, key_type):
    q = _queries(keys, key_type, NQ_SORTED, 7)
    return q[np.argsort(tkeys.to_image(q).numpy(), kind="stable")]


@pytest.mark.parametrize("kind,spec,B,plan_kind", CASES, ids=map(_case_ids, CASES))
def test_sorted_bounds_are_rmi_tpus(kind, spec, B, plan_kind):
    keys, rj, rc = _indexes(kind, spec, B)
    plan = lf.get_plan(rc)
    qs = _sorted_batch(keys, rc.key_type)
    img = tkeys.to_image(qs)
    lo, hi = pk.sorted_bounds_plain(rc, plan, img)
    nb = -(-qs.size // KQ)
    first = np.arange(nb) * KQ
    last = np.minimum(first + KQ - 1, qs.size - 1)
    assert lo.shape == hi.shape == (nb,)
    j_lb1 = _j_lb1(rj, np.concatenate([qs[first], qs[last]]))
    nrows0 = plan.stripe_first.shape[0]
    np.testing.assert_array_equal(lo.numpy(), np.clip(j_lb1[:nb] - 1, 0, nrows0))
    np.testing.assert_array_equal(hi.numpy(), np.clip(j_lb1[nb:] + plan.F, 0, nrows0))
    # rmi_tpu's own anchors of the batch, padded with its last query to
    # whole blocks as rmi_tpu pads it
    pad = _padded(qs, jssk.KQ)
    jp = jlf.get_plan(rj)
    j_f, _ = jlf._sorted_stats_direct(
        jnp.asarray(pad), rj.device_top_params, jp.rows_u32, jnp.float64(rj.norm_offset),
        jnp.float64(rj.norm_scale), jp.kmin_key, jp.kmax_key, top_type=rj.top_type,
        B=rj.branching_factor, S=jp.S, F=jp.F, key_type=rj.key_type)
    every_block = np.asarray(j_f)[:nb * KQ // SUBQ:KQ // SUBQ]
    np.testing.assert_array_equal(lo.numpy(), np.clip(every_block - 1, 0, nrows0))
    # every query's lb1 - 1 and lb1 lie in its block's window
    lb1 = np.searchsorted(plan.stripe_first.numpy(), img.numpy())
    blk = np.arange(qs.size) // KQ
    assert np.all(lo.numpy()[blk] <= np.maximum(lb1 - 1, 0))
    assert np.all(lb1 <= hi.numpy()[blk])
    # the wrapper on CPU tensors is the plain version; so is lookup_fast's
    for got in (pk.sorted_bounds(rc, plan, img), lf.sorted_bounds(rc, plan, img)):
        assert torch.equal(got[0], lo) and torch.equal(got[1], hi)


# --- the kernel's counts, mirrored in numpy ---------------------------------

@functools.lru_cache(maxsize=None)
def _read_replay():
    """tools/count_torch_packed_reads.py, the host replay of csrc/packed.cu
    read for read."""
    path = config.PACKAGE_DIR.parent / "tools" / "count_torch_packed_reads.py"
    spec = importlib.util.spec_from_file_location("count_torch_packed_reads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mirror_lb1(plan, leaf, q):
    """csrc/packed.cu Plan::lb1: the row whole (a long one by its chunks'
    last samples, then one chunk), LB1 = base + (c1 - 1) F."""
    rr = _read_replay()
    b = rr.count_row(plan.rows.numpy(), plan.rows.shape[1], leaf, q, rr.Reads(q.size))
    return plan.base.numpy()[leaf] + (b.r - 1) * plan.F


def _mirror_search(plan, keys, leaf, q, off):
    """Plan::search of csrc/packed.cu, the keys ``off`` entries into their
    64-byte block and the stripe-first keys as far into theirs."""
    return _read_replay().search(plan, keys, leaf, q, off=off, sf_off=off)[0]


@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("kind,spec,B,plan_kind", CASES, ids=map(_case_ids, CASES))
def test_kernel_counts_by_halving_equal_the_plain_counts(kind, spec, B, plan_kind, off):
    """The kernel's counts (the row whole, then blocks placed by
    interpolation, halving where it cannot place them) as the replay
    follows them equal the plain versions' whole-row counts, with the
    blocks on the arrays' own alignment and three entries off it."""
    keys, _, rc = _indexes(kind, spec, B)
    plan = lf.get_plan(rc)
    img = tkeys.to_image(keys).numpy()
    q = tkeys.to_image(_queries(keys, rc.key_type, NQ, 9))
    leaf = pk._leaf_ids(rc, plan, q).numpy()
    LB1 = _mirror_lb1(plan, leaf, q.numpy())
    np.testing.assert_array_equal(LB1, pk.stripe_lower_limits(rc, plan, q).numpy())
    np.testing.assert_array_equal(_mirror_search(plan, img, leaf, q.numpy(), off),
                                  pk.packed_search_plain(rc, plan, q).numpy())
    qs = tkeys.to_image(_sorted_batch(keys, rc.key_type))
    anchors = pk._anchors(qs)
    L = _mirror_lb1(plan, pk._leaf_ids(rc, plan, anchors).numpy(), anchors.numpy())
    nb, nrows0 = L.size // 2, plan.stripe_first.shape[0]
    lo, hi = pk.sorted_bounds_plain(rc, plan, qs)
    np.testing.assert_array_equal(np.clip(L[:nb] - 1, 0, nrows0), lo.numpy())
    np.testing.assert_array_equal(np.clip(L[nb:] + plan.F, 0, nrows0), hi.numpy())


@functools.lru_cache(maxsize=None)
def _edge_index(case, B):
    keys, key_type, q = packed_edge_case(case, seed=23)
    return rt.train(rt.RMIDataset.from_numpy(keys, key_type, device="cpu"), "linear,linear",
                    B), q


@pytest.mark.parametrize("B", PACKED_EDGE_BS)
@pytest.mark.parametrize("case", PACKED_EDGES)
def test_kernel_counts_at_the_packed_edges(case, B):
    """The replay of csrc/packed.cu at the card tests' edges
    (test_torch_lookup_kernel.packed_edge_case: u32 and f64 images, runs
    of equal keys across stripes, queries at stripe-first keys, stripes
    whose keys jump, a ragged last stripe, queries outside the keys), the
    keys on their block's boundary and one entry past it: the plain
    answers and the lower bounds, and the plain LB1."""
    rmi, q = _edge_index(case, B)
    plan = lf.get_plan(rmi)
    assert plan.kind in pk.PACKED_KINDS
    want = pk.packed_search_plain(rmi, plan, q).numpy()
    np.testing.assert_array_equal(want, np.searchsorted(rmi.keys.numpy(), q.numpy()))
    leaf = pk._leaf_ids(rmi, plan, q).numpy()
    np.testing.assert_array_equal(_mirror_lb1(plan, leaf, q.numpy()),
                                  pk.stripe_lower_limits(rmi, plan, q).numpy())
    for off in (0, 1):
        np.testing.assert_array_equal(
            _mirror_search(plan, rmi.keys.numpy(), leaf, q.numpy(), off), want)


@pytest.mark.parametrize("shape", ["path1", "path5", "zoo_wide", "histogram", "u32", "f64"])
def test_read_mirror_is_the_plain_search(shape):
    """tools/count_torch_packed_reads.py on its shapes at 2^16 keys: both
    replays answer what packed_search_plain answers and the kept one's
    LB1 is stripe_lower_limits' (measure checks both); the kept design
    reads fewer sectors of device memory a query, and waits for fewer
    dependent rounds, than the design before."""
    rr = _read_replay()
    rmi = rr.shape_index(shape, 1 << 16)
    got = rr.measure(rmi, rr.shape_queries(rmi, 1 << 13, 3))
    assert got["plan"][0] == ("packed" if shape in ("path1", "path5", "u32", "f64")
                              else "packed_wide")
    assert got["kept"]["device_sectors"] < got["before"]["device_sectors"]
    assert got["kept"]["rounds"] < got["before"]["rounds"]


def test_cases_cover_both_plans_and_every_top():
    kinds = {c[3] for c in CASES}
    assert kinds == {"packed", "packed_wide"}
    tops = {c[1].split(",")[0] for c in CASES}
    assert set(lf._MONOTONE_TOPS) - tops == {"radix26", "radix28"}
    assert set(lf._SCALAR_TOPS) <= tops
    assert {KEY_TYPES[c[0]] for c in CASES} == {KeyType.U64, KeyType.U32, KeyType.F64}


def test_wrappers_refuse_bad_inputs():
    keys, _, rc = _indexes("books", "cubic,linear", 256)
    plan = lf.get_plan(rc)
    q = tkeys.to_image(keys[:100])
    for fn in (pk.packed_search, pk.sorted_bounds):
        with pytest.raises(ValueError, match="1-D int64"):
            fn(rc, plan, q.int())
        with pytest.raises(ValueError, match="1-D int64"):
            fn(rc, plan, q[None])
        with pytest.raises(ValueError, match="packed one"):
            fn(rc, lf.Plan("hier", plan.n), q)
        with pytest.raises(ValueError, match="rows"):
            fn(rc, dataclasses.replace(plan, S=plan.S + 2), q)
        with pytest.raises(ValueError, match="rows"):      # no bases beside the rows
            fn(rc, dataclasses.replace(plan, base=None), q)
        with pytest.raises(ValueError, match="rows"):      # rows off a 16-byte boundary
            wide = torch.empty(plan.rows.numel() + 1, dtype=torch.int64)
            fn(rc, dataclasses.replace(plan, rows=wide[1:].view(plan.rows.shape)), q)
        with pytest.raises(ValueError, match="keys"):
            fn(rc, dataclasses.replace(plan, n=plan.n + 1), q)
        with pytest.raises(ValueError, match="device"):
            fn(rc, plan, q.to("meta"))
    # an empty batch
    assert pk.packed_search(rc, plan, q[:0]).shape == (0,)
    assert pk.sorted_bounds(rc, plan, q[:0])[0].shape == (0,)
