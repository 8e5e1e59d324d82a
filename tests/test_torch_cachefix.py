"""The port's cachefix (--bounded) against rmi_tpu's on the CPU
(rmi_tpu_torch.cache_fix, native, train.api.train_bounded and lookup's
cachefix branches).

  (a) the port's build of native/rmi_native.cpp: its spline equals the
      plain version _cache_fix_py, and its knots are bit-equal to
      rmi_tpu.cache_fix.cache_fix, for line sizes 4, 8 and 64, with
      duplicates, on the exponential-gap 2^56 keys that once split an
      unfused spline from the reference (tests/test_cachefix.py), and
      for u32 keys promoted to u64; fewer keys than the line size raise;
  (b) train_bounded: knots bit-equal to rmi_tpu's, lookup (position and
      err = line_size) equal to rmi_tpu's on keys and other queries,
      |pos - lb| <= line_size on every key, search with the original keys
      exact on every key and equal to rmi_tpu's elsewhere, rmi_size
      = rmi_tpu's = 16 + layers + 16 * knots;
  (c) cachefix_interp equals rmi_tpu's _cachefix_interp on a sweep of
      lerp values across cache-line boundaries at ulp steps and random
      ones (rmi_tpu's rule: a value within eps of a boundary goes up) and
      at the kernel's edges, and bounded_lower_bound equals rmi_tpu's
      _bounded_search_jit at its edges (both wrappers run their plain
      versions here; test_torch_cuda_kernels.py holds the kernels to
      them on the card); the kernels' search as the host replay of
      tools/count_torch_cachefix_reads.py follows it (interpolated sector
      reads, the knots' sample) answers what the plain versions answer
      at those edges and over windows of 2^16 keys, on arrays that start
      on a sector's boundary and one entry past it;
  (d) the artifact of a train_bounded index: a carried-across JAX build
      writes rmi_tpu's bytes (L2 blob included), load_artifact serves it
      as before the save, the generated C++ and the native server equal
      the port's lookup on every key.
"""

import functools
import importlib
import importlib.util

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rmi_tpu import cache_fix as j_cache_fix
from rmi_tpu import serialize as jser
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.train.api import train_bounded as j_train_bounded

import rmi_tpu_torch as rt
from rmi_tpu_torch import cache_fix, config, native
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.ops.cachefix_kernel import (bounded_lower_bound, bounded_lower_bound_plain,
                                               cachefix_interp, cachefix_interp_plain)

from test_torch_artifacts import assert_same_files, carry, compile_and_run
from test_torch_lookup_kernel import (BOUNDED_EDGES, CACHEFIX_EDGES, WIDE_WINDOWS,
                                      bounded_edge_case, cachefix_edge_case, wide_window_case)

j_lookup = importlib.import_module("rmi_tpu.lookup")
SPEC, B = "linear_spline,linear", 64


@functools.lru_cache(maxsize=None)
def _keys(kind):
    rng = np.random.default_rng(21)
    if kind == "dups":
        base = np.sort(rng.integers(2, 500, size=3000, dtype=np.uint64))
        return base * np.uint64(13) + np.uint64(7)
    if kind == "wide":           # exponential gaps over 2^56 (test_cachefix.py)
        csum = np.cumsum(np.random.default_rng(7).exponential(size=20_000))
        return np.maximum((csum * (2.0 ** 56 / csum[-1])).astype(np.uint64),
                          np.uint64(1))
    if kind == "u32":
        return np.sort(rng.integers(10, 2 ** 30, size=3000).astype(np.uint32))
    keys = np.sort(rng.integers(10, 2 ** 40, size=5000, dtype=np.uint64))
    keys[100:140] = keys[100]
    return keys


@functools.lru_cache(maxsize=None)
def _builds(kind, line):
    keys = _keys(kind)
    rj = j_train_bounded(JDataset.from_numpy(keys), SPEC, B, line)
    rj.raw_inputs = rj.raw_thunk.__defaults__
    rp = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"), SPEC, B, line)
    return keys, rj, rp


def _queries(keys):
    rng = np.random.default_rng(5)
    hi = int(keys[-1]) + 100
    return np.concatenate([keys, rng.integers(0, hi, 4000, dtype=np.uint64),
                           np.array([0, 2 ** 64 - 1], dtype=np.uint64)])


# --------------------------------------------------------------------------
# (a) the spline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("line", [4, 8, 64])
@pytest.mark.parametrize("kind", ["books", "dups", "wide", "u32"])
def test_native_spline_knots(kind, line):
    keys = _keys(kind)
    data = rt.RMIDataset.from_numpy(keys, device="cpu")
    sk, sv = cache_fix.cache_fix(data, line)
    jk, jv = j_cache_fix.cache_fix(JDataset.from_numpy(keys).as_u64(), line)
    np.testing.assert_array_equal(sk, np.asarray(jk, np.uint64))
    np.testing.assert_array_equal(sv, np.asarray(jv, np.uint64))
    assert sk.dtype == sv.dtype == np.uint64
    uk, uo = data.as_u64().unique()
    pk, pv = cache_fix._cache_fix_py(uk.astype(np.uint64), uo, line)
    np.testing.assert_array_equal(sk, pk)
    np.testing.assert_array_equal(sv, pv)


def test_unique_is_rmi_tpus():
    keys = _keys("dups")
    uk, uo = rt.RMIDataset.from_numpy(keys, device="cpu").unique()
    jk, jo = JDataset.from_numpy(keys).unique()
    np.testing.assert_array_equal(uk, jk)
    np.testing.assert_array_equal(uo, jo)
    assert uo.dtype == np.uint64


def test_u32_promotes_to_u64():
    data = rt.RMIDataset.from_numpy(_keys("u32"), device="cpu")
    u64 = data.as_u64()
    assert u64.key_type is tkeys.KeyType.U64 and data.key_type is tkeys.KeyType.U32
    np.testing.assert_array_equal(u64.to_numpy(), _keys("u32").astype(np.uint64))


def test_fewer_keys_than_the_line_raise():
    with pytest.raises(ValueError, match="fewer items than the line size"):
        cache_fix.cache_fix(rt.RMIDataset.from_numpy(np.arange(4, dtype=np.uint64),
                                                     device="cpu"), 8)


def test_preknot_insertion():
    sk, _ = native.cache_fix(np.asarray([10, 20, 30, 40], np.uint64),
                             np.arange(4, dtype=np.uint64), 2)
    assert sk[0] == 9      # the first candidate is key - 1 (10 - 1 != last_key 0)


# --------------------------------------------------------------------------
# (b) train_bounded, lookup and search
# --------------------------------------------------------------------------

@pytest.mark.parametrize("line", [4, 8, 64])
@pytest.mark.parametrize("kind", ["books", "dups", "u32"])
def test_bounded_against_rmi_tpu(kind, line):
    keys, rj, rp = _builds(kind, line)
    np.testing.assert_array_equal(rp.cache_fix[1], rj.cache_fix[1])
    np.testing.assert_array_equal(rp.cache_fix[2], rj.cache_fix[2])
    assert rp.cache_fix[0] == line and rp.num_data_rows == keys.shape[0]
    assert rp.num_rmi_rows == rj.cache_fix[1].shape[0]
    assert rt.rmi_size(rp) == jser.rmi_size(rj) == \
        16 + (16 + 8) * B + 16 * rj.cache_fix[1].shape[0]

    q = _queries(keys.astype(np.uint64))
    pos, err = rt.lookup(rp, tkeys.to_image(q))
    jpos, jerr = j_lookup.lookup(rj, jnp.asarray(q))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    assert (err.numpy() == line).all()

    n = keys.shape[0]
    lb = np.searchsorted(keys, keys)
    assert (np.abs(pos.numpy()[:n] - lb) <= line).all()
    idx = rt.search(rp, tkeys.to_image(q), keys=tkeys.to_image(keys)).numpy()
    np.testing.assert_array_equal(idx, np.searchsorted(keys, q, side="left"))
    # rmi_tpu's answers where its window holds the lower bound (every key;
    # test_search_between_keys_is_exact shows a query where it does not)
    jidx = np.asarray(j_lookup.search(rj, jnp.asarray(q),
                                      keys=jnp.asarray(keys.astype(np.uint64))))
    right = jidx == np.searchsorted(keys, q, side="left")
    assert right[:n].all()
    np.testing.assert_array_equal(idx[right], jidx[right])
    g, e, i = rt.lookup_and_search(rp, tkeys.to_image(q), keys=tkeys.to_image(keys))
    assert torch.equal(g, pos) and torch.equal(e, err) and np.array_equal(i.numpy(), idx)


def test_search_between_keys_is_exact():
    """A query between a key that ends a run of equal keys and the next
    key has the next key's lower bound, a run away from the spline's
    position there (the spline passes within the line of both keys' lower
    bounds and runs straight between them): rmi_tpu's search answers
    inside pos +- (line + 1) and misses it; the port's searches all the
    keys where the window's answer is not the lower bound."""
    keys = np.repeat(np.arange(1, 61, dtype=np.uint64) * np.uint64(1000),
                     np.tile(np.asarray([1, 200, 1], np.int64), 20))
    q = np.arange(int(keys[0]) - 3, int(keys[-1]) + 4, 7, dtype=np.uint64)
    lb = np.searchsorted(keys, q, side="left")
    rj = j_train_bounded(JDataset.from_numpy(keys), SPEC, B, 8)
    jidx = np.asarray(j_lookup.search(rj, jnp.asarray(q), keys=jnp.asarray(keys)))
    assert (jidx != lb).any()             # the reference's window misses these
    rp = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"), SPEC, B, 8)
    img = tkeys.to_image(keys)
    np.testing.assert_array_equal(rt.search(rp, tkeys.to_image(q), keys=img).numpy(), lb)
    np.testing.assert_array_equal(rt.search(rp, img, keys=img).numpy(),
                                  np.searchsorted(keys, keys, side="left"))


def test_search_needs_the_original_keys():
    keys, _, rp = _builds("books", 8)
    with pytest.raises(ValueError, match="original key array"):
        rt.search(rp, tkeys.to_image(keys))
    with pytest.raises(ValueError, match="original key array"):
        rt.search_sorted(rp, tkeys.to_image(keys))


def test_wide_keys_end_to_end():
    """The 2^56-gap keys: the bound on every key and exact search."""
    keys = np.unique(_keys("wide"))
    rp = rt.train_bounded(rt.RMIDataset.from_numpy(keys, device="cpu"), SPEC, 128, 8)
    img = tkeys.to_image(keys)
    pos, _ = rt.lookup(rp, img)
    lb = np.searchsorted(keys, keys)
    assert (np.abs(pos.numpy() - lb) <= 8).all()
    np.testing.assert_array_equal(rt.search(rp, img, keys=img).numpy(), lb)


# --------------------------------------------------------------------------
# (c) the lerp
# --------------------------------------------------------------------------

# the two-knot lerps across cache-line boundaries: (D, v0, v1, line)
TWO_KNOTS = {"d2^50": ((1 << 50) + 1, 13, 35, 8), "d2^40": ((1 << 40) + 7, 1001, 1777, 8),
             "d1e10": (12345678901, 5, 999999, 64), "d2^60": ((1 << 60) + 3, 3, 2 ** 40 + 5, 4)}


def _interp_case(case):
    """(knots, vals, queries, start, err, line): a TWO_KNOTS lerp swept at
    ulp steps around its middle, where the first case's lerp crosses 24,
    and at random points; or an edge of cachefix_edge_case."""
    if case not in TWO_KNOTS:
        return cachefix_edge_case(case, seed=3)
    D, v0, v1, line = TWO_KNOTS[case]
    rng = np.random.default_rng(3)
    q = np.concatenate([np.arange(D // 2 - 400, D // 2 + 400, dtype=np.uint64),
                        rng.integers(0, D, 4000, dtype=np.uint64)])
    sk, sv = np.asarray([0, D], np.uint64), np.asarray([v0, v1], np.uint64)
    return sk, sv, q, np.zeros(q.shape, np.int64), np.full(q.shape, 2, np.int64), line


@pytest.mark.parametrize("total", [1000, 200_000_000])
@pytest.mark.parametrize("case", [*TWO_KNOTS, *CACHEFIX_EDGES])
def test_interp_is_rmi_tpus(case, total):
    """The port's cachefix_interp (on the CPU its plain version) equals
    rmi_tpu's _cachefix_interp: the two-knot sweeps and the kernel's
    edges (err 0, windows clamped at 0 and at the knot count, queries past
    the last knot, equal knot keys, lerps within eps of a line boundary,
    one knot, the whole u64 range)."""
    sk, sv, q, start, errs, line = _interp_case(case)
    want = j_lookup._cachefix_interp(jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(q),
                                     jnp.asarray(start), jnp.asarray(errs),
                                     line_size=line, total_keys=total)
    args = (tkeys.to_image(sk), torch.from_numpy(sv.astype(np.int64)), tkeys.to_image(q),
            torch.from_numpy(start), torch.from_numpy(errs), line, total)
    got = cachefix_interp(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cachefix_interp_plain(*args).numpy(), np.asarray(want))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", BOUNDED_EDGES)
def test_bounded_lower_bound_is_rmi_tpus(case, exact):
    """bounded_lower_bound (on the CPU its plain version) equals rmi_tpu's
    _bounded_search_jit at the kernel's edges, the trip count exactly
    covering the widest window and too short for it among them; with
    ``exact`` (the cachefix search's mode, which rmi_tpu lacks) it is the
    lower bound over the first n keys on every query, whatever the window
    and the trips."""
    keys, q, guess, err, n, iters = bounded_edge_case(case, seed=4)
    args = (tkeys.to_image(keys), tkeys.to_image(q), torch.from_numpy(guess),
            torch.from_numpy(err), n, iters)
    if exact:
        want = np.searchsorted(keys[:n], q, side="left")
    else:
        want = j_lookup._bounded_search_jit(jnp.asarray(keys), jnp.asarray(q),
                                            jnp.asarray(guess), jnp.asarray(err), n=n,
                                            iters=iters)
    np.testing.assert_array_equal(bounded_lower_bound(*args, exact).numpy(), np.asarray(want))
    np.testing.assert_array_equal(bounded_lower_bound_plain(*args, exact).numpy(),
                                  np.asarray(want))


@functools.lru_cache(maxsize=None)
def _read_replay():
    """tools/count_torch_cachefix_reads.py, the host replay of the kernels'
    reads."""
    path = config.PACKAGE_DIR.parent / "tools" / "count_torch_cachefix_reads.py"
    spec = importlib.util.spec_from_file_location("count_torch_cachefix_reads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(*arrays):
    """Key images of u64 arrays, int64 copies of the rest, as numpy."""
    return [tkeys.to_image(a).numpy() if a.dtype == np.uint64 else a.astype(np.int64)
            for a in arrays]


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", [*BOUNDED_EDGES, *WIDE_WINDOWS])
def test_read_replay_is_the_bounded_lower_bound(case, exact, off):
    """rmi_bounded_lower_bound's search as the host replay follows it
    answers what bounded_lower_bound_plain answers, at the kernel's edges
    (a trip count too short for a window among them: halving there) and
    over windows of 2^16 keys (uniform, clustered, duplicate runs, u32
    images, windows narrower than a sector, errors below 0, n below the
    keys' count), with and without ``exact``, the keys starting on a
    32-byte boundary (off 0) and one entry past it."""
    keys, q, guess, err, n, iters = (bounded_edge_case(case, seed=7) if case in BOUNDED_EDGES
                                     else wide_window_case(case, seed=7))
    kimg, qimg = _images(keys, q)
    want = bounded_lower_bound_plain(*(torch.from_numpy(a) for a in (kimg, qimg, guess, err)),
                                     n, iters, exact)
    got = _read_replay().bounded(kimg, qimg, guess, err, n, iters, exact, off)
    np.testing.assert_array_equal(got, want.numpy())


def _interp_inputs(case):
    """(knots, vals, queries as u64; start, err; line) of a CACHEFIX_EDGES
    case, or of a WIDE_WINDOWS one with the keys as knots."""
    if case in CACHEFIX_EDGES:
        return cachefix_edge_case(case, seed=8)
    keys, q, start, err, n, _ = wide_window_case(case, seed=8)
    vals = np.cumsum(np.random.default_rng(8).integers(0, 50, keys.size)).astype(np.uint64)
    return keys[:n], vals[:n], q, start, err, 8


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("case", [*CACHEFIX_EDGES, *WIDE_WINDOWS])
def test_read_replay_is_the_interpolation(case, off):
    """rmi_cachefix_interp's knot search as the host replay follows it
    (through the knots' sample where a window holds more than KNOT_STRIDE
    knots) gives cachefix_interp_plain's positions at the kernel's edges
    and over windows of 2^16 knots, the knots and their sample starting on
    a 32-byte boundary and one entry past it."""
    knots, vals, q, start, err, line = _interp_inputs(case)
    kimg, vals, qimg = _images(knots, vals, q)
    total = 1 << 40
    want = cachefix_interp_plain(*(torch.from_numpy(a) for a in (kimg, vals, qimg, start, err)),
                                 line, total)
    got = _read_replay().interp(kimg, vals, qimg, start, err, line, total, off, off)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("case", ["uniform", "u32", "clustered"])
def test_read_replay_reads_fewer_sectors_than_halving(case):
    """Over windows of 2^16 keys the kernels' search makes fewer than half
    the dependent reads a query of the halving search it replaced, and
    reads fewer distinct sectors, where the keys are locally even (path
    8's shape: uniform keys, u32 images); over clusters far apart, where
    interpolating between a window's ends misleads, it makes no more."""
    rr = _read_replay()
    keys, q, guess, err, n, iters = wide_window_case(case, seed=9)
    kimg, qimg = _images(keys, q)
    new, old = rr.Reads(q.size), rr.Reads(q.size)
    rr.bounded(kimg, qimg, guess, err, n, iters, reads=new)
    lo, hi = rr.windows(guess, err, n)
    rr.halving(kimg, qimg, lo, hi, iters, old)
    if case == "clustered":
        assert new.rounds.mean() <= old.rounds.mean()
    else:
        assert new.rounds.mean() < old.rounds.mean() / 2
        assert new.sectors().mean() < old.sectors().mean()


# --------------------------------------------------------------------------
# (d) the artifact of a bounded index
# --------------------------------------------------------------------------

@pytest.mark.parametrize("include_errors", [True, False])
def test_carried_bounded_build_writes_the_same_bytes(tmp_path, include_errors):
    keys, rj, _ = _builds("books", 8)
    rc = carry(rj, rj.cache_fix[1])
    assert rc.cache_fix is rj.cache_fix and rc.num_data_rows == keys.shape[0]
    d1, d2 = tmp_path / "rmi_tpu", tmp_path / "port"
    rj.build_time = rc.build_time = 0
    jser.output_rmi("cf", rj, data_dir=str(d1 / "rmi_data"), cpp_dir=str(d1),
                    include_errors=include_errors)
    rt.output_rmi("cf", rc, data_dir=str(d2 / "rmi_data"), cpp_dir=str(d2),
                  include_errors=include_errors)
    assert (d2 / "rmi_data" / "cf_L2_PARAMETERS").exists()
    assert_same_files(d1, d2)


def test_bounded_artifact_round_trip(tmp_path):
    keys, _, rp = _builds("books", 8)
    meta = rt.output_rmi("cf", rp, data_dir=str(tmp_path), emit_cpp=False)
    loaded = rt.load_artifact(meta, device="cpu")
    q = tkeys.to_image(_queries(keys))
    np.testing.assert_array_equal(rt.lookup(loaded, q)[0].numpy(),
                                  rt.lookup(rp, q)[0].numpy())
    img = tkeys.to_image(keys)
    np.testing.assert_array_equal(rt.search(loaded, img, keys=img).numpy(),
                                  np.searchsorted(keys, keys))
    assert rt.rmi_size(loaded) == rt.rmi_size(rp)


def test_bounded_cpp_and_native(tmp_path):
    keys, _, rp = _builds("books", 8)
    cg, _, csize = compile_and_run(str(tmp_path / "cpp"), rp, "gcf", keys)
    pos, _ = rt.lookup(rp, tkeys.to_image(keys))
    np.testing.assert_array_equal(cg, pos.numpy())
    assert csize == rt.rmi_size(rp)
    lb = np.searchsorted(keys, keys)
    assert (np.abs(cg - lb) <= 8).all()          # cache_fix_wiki/main.cpp:36
    meta = rt.output_rmi("cfn", rp, data_dir=str(tmp_path / "nat"), emit_cpp=False)
    with native.NativeRMI(meta) as srv:
        ng, ne = srv.lookup(keys)
        np.testing.assert_array_equal(ng.astype(np.int64), pos.numpy())
        assert (ne == 8).all()
        np.testing.assert_array_equal(srv.search(keys, keys), lb)
