"""The hierarchical search plan ("hier") against rmi_tpu on the CPU.

  (a) get_plan(...).kind equals rmi_tpu's: ``linear,linear 100`` on u32
      keys, the integer tops on f64 keys (which take no packed plan), a
      loglinear and a normal top that are not monotone, table leaves
      (``cubic,radix8``), and packed and packed_wide configurations;
  (b) with rmi_tpu's build carried across (trained_from_numpy), the
      plan's levels and K are rmi_tpu's, and resolve over the levels
      keys[::64^k] is bit-equal to rmi_tpu's resolve over its overlapped
      rows on every query inside the keys' range, for lookup's guess and
      err and for guesses moved inside and outside the error window, f64
      keys with NaN, +-inf and -0.0 queries included, and answers a query
      outside the range by its end (#(keys < q), where rmi_tpu counts
      through the levels from the guess); hier_start_level is rmi_tpu's K;
  (c) search through a hierarchical plan equals rmi_tpu's and is exact
      against searchsorted on duplicate-heavy keys, on keys ending in a
      duplicate run and on out-of-range queries; lookup equals rmi_tpu's;
      search_sorted and the large-batch route never sort or run K5 for it;
  (d) resolve, the wrapper of rmi_hier_resolve (ops/hier_kernel.py), runs
      resolve_plain on the CPU and is bit-equal to rmi_tpu's resolve inside
      the keys' range, and #(keys < q) outside it (as in (b)), from
      levels K = 0..3 (test_torch_lookup_kernel.resolve_case: n not a
      multiple of 64, runs of equal keys across a row's edge, queries
      below the first key and above the last, guess - err < 0 and
      guess + err > n), with the plan's packed levels or without; the
      packed levels are keys[::64^k], each on a 32-byte boundary; and at
      its edges (resolve_edge_case: counts on each window's edges at every
      level, guesses off by err + 1 and by whole rows, queries beyond the
      keys, duplicate runs across sectors and rows, last rows shorter than
      a sector, K = 4..10 over few keys).

A top that is not monotone over the keys assigns them leaf ids out of
order, which neither package's spans expect: independent builds then
differ (outlier_bottom: max_err 119 here, 15679 in rmi_tpu), and a key
may lie outside its leaf's error window in both.  Such configurations
are held to rmi_tpu through carried-across builds only (ROADMAP.md
Queue 3, closed notes).
"""

import functools
import importlib
import importlib.util

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rmi_tpu
from rmi_tpu import lookup_fast as jlf
from rmi_tpu.data import RMIDataset as JDataset

import rmi_tpu_torch as rt
from test_torch_artifacts import carry
from test_torch_lookup_kernel import (RESOLVE_EDGES, level_counts, resolve_case,
                                      resolve_edge_case)
from rmi_tpu_torch import config
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch.ops import hier_kernel
from rmi_tpu_torch.ops import sorted_serve_kernel as ssk

N = 1 << 14
# the module (the package exports its function lookup under the same name)
tlookup = importlib.import_module("rmi_tpu_torch.lookup")


@functools.lru_cache(maxsize=None)
def _keys(kind):
    rng = np.random.default_rng(17)
    if kind == "u32":                      # books_like_u32 (tools/parity_report.py)
        c = np.cumsum(rng.exponential(size=N))
        return np.maximum((c * (2.0 ** 31 / c[-1])).astype(np.uint32), np.uint32(1))
    if kind == "f64":
        c = np.cumsum(rng.exponential(size=N))
        return np.sort(c * (1e12 / c[-1]))
    if kind == "f64_dups":                 # runs of up to 40 equal floats, the last of 300
        base = np.sort(rng.uniform(1.0, 1e9, N // 8))
        keys = np.repeat(base, rng.integers(1, 40, base.size))[:N - 300]
        return np.concatenate([keys, np.full(300, keys[-1] + 5.0)])
    if kind == "books":
        c = np.cumsum(rng.exponential(size=N))
        return (c * (2.0 ** 50 / c[-1])).astype(np.uint64)
    if kind == "outlier_bottom":           # a loglinear top that is not monotone
        rest = rng.integers(2 ** 50 - 2 ** 20, 2 ** 50, N - 1)
        return np.sort(np.concatenate([rest, [1]]).astype(np.uint64))
    if kind == "outlier_top":              # a normal top that is not monotone
        rest = rng.integers(1, 2 ** 20, N - 1)
        return np.sort(np.concatenate([rest, [2 ** 50]]).astype(np.uint64))
    raise KeyError(kind)


@functools.lru_cache(maxsize=None)
def _builds(kind, spec, B):
    keys = _keys(kind)
    rj = rmi_tpu.train(JDataset.from_numpy(keys), spec, B)
    rp = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, B)
    return keys, rj, rp


PLAN_CASES = [("u32", "linear,linear", 100), ("f64", "radix,linear", 256),
              ("f64", "bradix,linear", 256), ("f64", "histogram,linear", 256),
              ("f64", "radix18,linear", 256), ("f64_dups", "radix,linear", 64),
              ("outlier_bottom", "loglinear,linear", 256),
              ("outlier_top", "normal,linear", 256), ("books", "cubic,radix8", 256),
              ("books", "cubic,linear", 256), ("books", "linear,linear", 1),
              ("f64", "cubic,linear", 256)]
HIER_CASES = [c for c in PLAN_CASES if c[0] in ("f64", "f64_dups", "outlier_bottom",
                                                  "outlier_top")
              and c[1] != "cubic,linear"]


@functools.lru_cache(maxsize=None)
def _carried(kind, spec, B):
    keys, rj, _ = _builds(kind, spec, B)
    rj.raw_inputs = rj.raw_thunk.__defaults__
    return keys, rj, carry(rj, keys)


@pytest.mark.parametrize("kind,spec,B", PLAN_CASES)
def test_plan_kind_equals_rmi_tpu(kind, spec, B):
    _, rj, rp = _builds(kind, spec, B)
    assert lf.get_plan(rp).kind == jlf.get_plan(rj).kind


def test_plan_kinds_cover_every_plan():
    kinds = {jlf.get_plan(_builds(*c)[1]).kind for c in PLAN_CASES}
    assert kinds == {"hier", "packed", "packed_wide"}


@pytest.mark.parametrize("max_err", [0, 1, 30, 31, 2015, 2016, 129023, 129024,
                                     2991815, 1 << 40])
def test_start_level_is_rmi_tpus(max_err):
    want = jlf.SearchPlan(jnp.arange(4, dtype=jnp.uint64), max_err, levels=False).K
    assert lf.hier_start_level(max_err) == want


def _queries(keys, rng, n=3000):
    """Queries over and beyond the key range, existing keys, and the
    images' extremes (for f64 keys: NaN, the infinities and -0.0)."""
    if keys.dtype == np.float64:
        span = keys[-1] - keys[0]
        q = rng.uniform(keys[0] - span / 8, keys[-1] + span / 8, n)
        edges = np.array([np.nan, -np.inf, np.inf, -0.0, 0.0, keys[0], keys[-1],
                          np.nextafter(keys[-1], np.inf)])
    else:
        hi = int(np.iinfo(keys.dtype).max)
        q = rng.integers(0, min(hi, int(keys[-1]) * 2 + 2), n, dtype=np.uint64)
        edges = np.array([0, keys[0], max(int(keys[0]) - 1, 0), keys[-1],
                          min(int(keys[-1]) + 1, hi), hi], dtype=np.uint64)
        q, edges = q.astype(keys.dtype), edges.astype(keys.dtype)
    return np.concatenate([q, edges, keys[rng.integers(0, keys.size, 1000)]])


def _assert_resolve(got, want, keys, q):
    """``got`` (the port's resolve) equals ``want`` (rmi_tpu's) on every
    query inside the keys' range and #(keys < q) on every query outside
    it, which the port answers by its end; all int64 images."""
    got, want, keys, q = (np.asarray(a) for a in (got, want, keys, q))
    out = (q <= keys[0]) | (q > keys[-1])
    np.testing.assert_array_equal(got[~out], want[~out])
    np.testing.assert_array_equal(got[out], np.searchsorted(keys, q[out], side="left"))


def _j_levels(rj):
    plan = jlf.get_plan(rj)
    return tuple(plan.levels), tuple(plan.level_lens), plan.K


@pytest.mark.parametrize("kind,spec,B", HIER_CASES)
def test_resolve_bit_equal(kind, spec, B):
    keys, rj, rp = _carried(kind, spec, B)
    plan = lf.get_plan(rp)
    assert plan.kind == "hier"
    levels, lens, K = _j_levels(rj)
    assert plan.K == K and [lv.shape[0] for lv in plan.levels] == list(lens)
    qn = _queries(keys, np.random.default_rng(3))
    q = tkeys.to_image(qn)
    guess, err = rt.lookup(rp, q)
    rng = np.random.default_rng(4)
    shift = torch.from_numpy(rng.integers(-1, 2, q.shape[0])) * err
    for g in (guess, guess + shift, (guess - 3 * err).clamp(min=0)):
        got = lf.resolve(plan.levels, q, g, err, K=plan.K, n=plan.n,
                         packed=plan.packed)
        want = jlf.resolve(levels, jnp.asarray(qn), jnp.asarray(g.numpy()),
                           jnp.asarray(err.numpy()), K=K, n=plan.n, level_lens=lens)
        _assert_resolve(got.numpy(), want, plan.levels[0].numpy(), q.numpy())


@pytest.mark.parametrize("kind,spec,B", HIER_CASES)
def test_hier_search_exact(kind, spec, B):
    keys, rj, rp = _carried(kind, spec, B)
    assert lf.get_plan(rp).kind == "hier"
    qn = _queries(keys, np.random.default_rng(5))
    q = tkeys.to_image(qn)
    got = rt.search(rp, q).numpy()
    np.testing.assert_array_equal(got, np.asarray(rmi_tpu.search(rj, jnp.asarray(qn))))
    ok = ~np.isnan(qn) if qn.dtype == np.float64 else np.ones(qn.size, bool)
    np.testing.assert_array_equal(got[ok], np.searchsorted(keys, qn[ok], side="left"))
    for a, b in zip(rt.lookup(rp, rp.keys), rmi_tpu.lookup(rj, jnp.asarray(keys))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind,spec,B", [c for c in HIER_CASES if c[0].startswith("f64")])
def test_independent_hier_build_holds_the_bound(kind, spec, B):
    """A monotone top's independent build: the bound on every key and
    exact search through its own hierarchical plan."""
    keys, _, rp = _builds(kind, spec, B)
    assert lf.get_plan(rp).kind == "hier"
    g, e = rt.lookup(rp, rp.keys)
    lb = np.searchsorted(keys, keys, side="left")
    assert int(np.sum(np.abs(g.numpy() - lb) > e.numpy())) == 0
    qn = _queries(keys, np.random.default_rng(6))
    ok = ~np.isnan(qn)
    got = rt.search(rp, tkeys.to_image(qn)).numpy()
    np.testing.assert_array_equal(got[ok], np.searchsorted(keys, qn[ok], side="left"))


def test_hier_never_sorts_or_runs_k5(monkeypatch):
    """search_sorted and search of a batch past SORT_SERVE_MIN take the
    hierarchical resolve, as rmi_tpu's do (lookup_fast.py:907-912)."""
    keys, _, rp = _carried("f64", "radix,linear", 256)
    assert lf.get_plan(rp).kind == "hier"

    def refuse(*a, **kw):
        raise AssertionError("a hierarchical plan reached K5")
    monkeypatch.setattr(ssk, "serve_sorted", refuse)
    monkeypatch.setattr(ssk, "serve_sorted_scatter", refuse)
    monkeypatch.setattr(tlookup, "SORT_SERVE_MIN", 1 << 10)
    qn = _queries(keys, np.random.default_rng(6), n=1 << 14)
    q = tkeys.to_image(qn)
    want = torch.searchsorted(rp.keys, q).numpy()
    np.testing.assert_array_equal(rt.search(rp, q).numpy(), want)
    np.testing.assert_array_equal(rt.search_sorted(rp, q.sort().values).numpy(),
                                  np.sort(want))


def test_bounded_search_stays_for_other_keys():
    """search(..., keys=) serves other keys through lookup and the bounded
    binary search, whatever the plan."""
    keys, _, rp = _builds("f64", "radix,linear", 256)
    qn = _queries(keys, np.random.default_rng(7))
    q = tkeys.to_image(qn)
    np.testing.assert_array_equal(rt.search(rp, q, keys=rp.keys).numpy(),
                                  rt.search(rp, q).numpy())


# (d) the resolve's wrapper against rmi_tpu's resolve; max_err for K = 0..3
RESOLVE_MAX_ERR = {0: 31, 1: 1984, 2: 126976, 3: 1 << 20}


@pytest.mark.parametrize("K", [0, 1, 2, 3])
def test_resolve_wrapper_equals_rmi_tpu(K):
    keys, q, guess, err = resolve_case(K, 40 + K)
    n = keys.shape[0]
    jplan = jlf.SearchPlan(jnp.asarray(keys.numpy()), RESOLVE_MAX_ERR[K])
    assert jplan.K == K == lf.hier_start_level(RESOLVE_MAX_ERR[K]) and n % 64
    levels, packed = hier_kernel.hier_levels(keys, K)
    want = np.asarray(jlf.resolve(jplan.levels, jnp.asarray(q.numpy()),
                                  jnp.asarray(guess.numpy()), jnp.asarray(err.numpy()),
                                  K=K, n=n, level_lens=tuple(jplan.level_lens)))
    got = lf.resolve(levels, q, guess, err, K=K, n=n, packed=packed)
    _assert_resolve(got.numpy(), want, keys.numpy(), q.numpy())
    np.testing.assert_array_equal(
        hier_kernel.resolve_plain(levels, q, guess, err, K=K, n=n).numpy(), got.numpy())
    # exact where the guess holds the lower bound within an err the plan's
    # K covers, the edges guess - err < 0 and guess + err > n among them
    lb = np.searchsorted(keys.numpy(), q.numpy(), side="left")
    g, e = guess.numpy(), err.numpy()
    ok = (np.abs(g - lb) <= e) & (e <= RESOLVE_MAX_ERR[K])
    assert ok[2:4].all() and g[2] - e[2] < 0 and g[3] + e[3] > n
    np.testing.assert_array_equal(want[ok], lb[ok])


@pytest.mark.parametrize("K", [0, 1, 2, 3])
def test_packed_levels(K):
    keys = resolve_case(K, 50)[0]
    levels, (upper, index) = hier_kernel.hier_levels(keys, K)
    assert levels[0] is keys and len(levels) == K + 1 and index.shape == (K, 2)
    for k in range(1, K + 1):
        off, length = index[k - 1].tolist()
        assert torch.equal(upper[off:off + length], keys[::64 ** k])
        assert torch.equal(levels[k], keys[::64 ** k])
        assert levels[k].data_ptr() == upper.data_ptr() + 8 * off
        assert off % hier_kernel.SECTOR == 0          # on a 32-byte boundary
    assert torch.equal(hier_kernel.pack_levels(levels)[0], upper)


def _rmi_tpu_max_err(K):
    """A max error for which rmi_tpu's SearchPlan starts at level K."""
    return 31 * 64 ** K if K < 10 else 1 << 62


@pytest.mark.parametrize("kind,K", RESOLVE_EDGES)
def test_resolve_edges_equal_rmi_tpu(kind, K):
    """The resolve at its edges (test_torch_lookup_kernel.resolve_edge_case,
    the inputs the kernel is held to on the card): the wrapper on the CPU
    and resolve_plain bit-equal to rmi_tpu's resolve inside the keys'
    range and exact outside it; exact where the
    guess holds the bound within the plan's reach; and the cases reach
    what they are for: at every level a count at its window's lower edge
    and one at its upper edge, and where a level has two entries or more
    one strictly inside."""
    keys, q, guess, err = resolve_edge_case(kind, K, 90 + K)
    n = keys.shape[0]
    jplan = jlf.SearchPlan(jnp.asarray(keys.numpy()), _rmi_tpu_max_err(K))
    assert jplan.K == K
    want = np.asarray(jlf.resolve(jplan.levels, jnp.asarray(q.numpy()),
                                  jnp.asarray(guess.numpy()), jnp.asarray(err.numpy()),
                                  K=K, n=n, level_lens=tuple(jplan.level_lens)))
    levels, packed = hier_kernel.hier_levels(keys, K)
    got = lf.resolve(levels, q, guess, err, K=K, n=n, packed=packed).numpy()
    _assert_resolve(got, want, keys.numpy(), q.numpy())
    np.testing.assert_array_equal(
        hier_kernel.resolve_plain(levels, q, guess, err, K=K, n=n).numpy(), got)
    lb = np.searchsorted(keys.numpy(), q.numpy(), side="left")
    g, e = guess.numpy(), err.numpy()
    ok = (np.abs(g - lb) <= e) & (e <= (31 * 64 ** K // 2 if K else 31))
    assert ok.any()
    np.testing.assert_array_equal(want[ok], lb[ok])
    for (c, w), lv in zip(level_counts(levels, q, guess, err, K=K, n=n), levels[::-1]):
        assert (c == 0).any() and (c == w).any()
        assert ((c > 0) & (c < w)).any() or lv.shape[0] < 2


def _read_replay():
    """tools/count_torch_hier_reads.py, the host replay of the kernel's reads."""
    path = config.PACKAGE_DIR.parent / "tools" / "count_torch_hier_reads.py"
    spec = importlib.util.spec_from_file_location("count_torch_hier_reads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind,K", RESOLVE_EDGES)
def test_read_replay_finds_the_resolves_answers(kind, K):
    """The replay that counts the kernel's reads a query follows a search
    that finds resolve_plain's answers at the resolve's edges, and reads
    no entry outside its level."""
    keys, q, guess, err = resolve_edge_case(kind, K, 90 + K)
    n = keys.shape[0]
    levels = hier_kernel.hier_levels(keys, K)[0]
    counters = {k: [] for k in range(K + 1)}
    got = _read_replay().replay([lv.numpy() for lv in levels], q.numpy(), guess.numpy(),
                                err.numpy(), K, n, counters)
    want = hier_kernel.resolve_plain(levels, q, guess, err, K=K, n=n)
    np.testing.assert_array_equal(got, want.numpy())
    for k, cs in counters.items():
        assert all(0 <= s < -(-levels[k].shape[0] // 4) for c in cs for s in c.sectors)


def test_resolve_refuses_bad_inputs():
    keys, q, guess, err = resolve_case(1, 60)
    levels, packed = hier_kernel.hier_levels(keys, 1)
    with pytest.raises(ValueError):
        lf.resolve(levels, q.int(), guess, err, K=1, n=keys.shape[0], packed=packed)
    with pytest.raises(ValueError):
        lf.resolve(levels, q, guess[1:], err, K=1, n=keys.shape[0], packed=packed)
    with pytest.raises(ValueError):
        lf.resolve(levels, q, guess, err, K=2, n=keys.shape[0], packed=packed)
