"""The port's serving layer (rmi_tpu_torch/lookup_fast.py, K5) against
rmi_tpu's, on the CPU.

Keys come from numpy seeds (n = 2^16, books-like and duplicate-heavy);
rmi_tpu builds each index and ``trained_from_numpy`` carries it across,
so both packages serve the same parameters.  rmi_tpu runs as its own
tests run it: JAX on the CPU, its K5 in Pallas interpret mode; the
port's K5 wrapper runs its plain version on CPU tensors.  Held bit-equal
(every value is an integer, so no tolerance):

  * the plan: (starts, next_idx), (S, F), the leaf rows (rmi_tpu's u32
    hi/lo words joined and mapped to int64 images) and the plan kind;
  * the sorted-batch anchors LB1_f (rmi_tpu's _sorted_stats_direct);
  * fast_search against rmi_tpu's fast_search and np.searchsorted on
    random, existing, duplicate, below-range and above-range queries,
    each with 0 and 2^64 - 1;
  * fast_search_sorted and fast_search_via_sort against rmi_tpu's
    sorted kernel path and np.searchsorted, on sorted and unsorted
    batches; search_sorted against search.

An index with one leaf over 2^20 keys has no packed plan and serves
through the bounded plan; a window moved off the true lb1 makes the
plain K5 wrong, so the tests above hold the window bounds, not just
searchsorted.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmi_tpu
from rmi_tpu import keys as jkeys
from rmi_tpu import lookup_fast as jlf
from rmi_tpu.data import RMIDataset as JDataset

import rmi_tpu_torch as rt
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch.ops import sorted_serve_kernel as ssk

N = 1 << 16
NQ_SORTED = 1 << 14          # one batch shape, so rmi_tpu compiles once
NQ_CLASS = 4096
CONFIGS = [("books", "cubic,linear", 256), ("dups", "linear,linear", 64),
           ("books", "linear,linear", 4)]     # the last one: F > 1
QUERY_CLASSES = ["random", "existing", "duplicates", "below", "above"]
# K5's sample level: CONFIGS and keys in duplicate runs longer than a stripe
K5_CONFIGS = CONFIGS + [("runs", "linear,linear", 64)]
K5_CLASSES = ["dense", "sparse", "runs", "extremes", "ragged"]
# K5's plain version on arrays without an index: runs longer than a
# group (dups8) and than a stripe (dups64)
K5_ARRAY_CASES = ["dense", "sparse", "dups8", "dups64", "extremes", "ragged"]


@functools.lru_cache(maxsize=None)
def _keys(kind):
    rng = np.random.default_rng(2025)
    if kind == "books":
        c = np.cumsum(rng.exponential(size=N))
        return (c * (2.0 ** 55 / c[-1])).astype(np.uint64) + np.uint64(1 << 40)
    if kind == "runs":          # runs of 1 to 299 keys
        base = np.sort(rng.integers(1 << 20, 1 << 40, N // 64).astype(np.uint64))
        keys = np.repeat(base, rng.integers(1, 300, size=base.size))[:N]
    else:                       # "dups": runs of 1 to 15 keys
        base = np.sort(rng.integers(1 << 20, 1 << 40, N // 4).astype(np.uint64))
        keys = np.repeat(base, rng.integers(1, 16, size=base.size))[:N]
    assert keys.size == N
    return keys


@functools.lru_cache(maxsize=None)
def _indexes(kind, spec, B):
    keys = _keys(kind)
    rj = rmi_tpu.train(JDataset.from_numpy(keys, jkeys.KeyType.U64), spec, B)
    rc = rt.trained_from_numpy(
        spec, B, tkeys.KeyType.U64, keys, np.asarray(rj.device_top_params["w"]),
        np.asarray(rj.device_leaf_params["w"]),
        np.asarray(rj.leaf_errors).astype(np.int64), rj.norm_offset,
        rj.norm_scale, device="cpu")
    return keys, rj, rc


def _queries(keys, cls, seed):
    rng = np.random.default_rng(seed)
    lo, hi = int(keys[0]), int(keys[-1])
    if cls == "random":
        q = rng.integers(0, 2 ** 56, NQ_CLASS, dtype=np.uint64)
    elif cls == "existing":
        q = keys[rng.integers(0, keys.size, NQ_CLASS)]
    elif cls == "duplicates":
        q = np.repeat(keys[rng.integers(0, keys.size, NQ_CLASS // 64)], 64)
    elif cls == "below":
        q = rng.integers(0, lo + 1, NQ_CLASS, dtype=np.uint64)
    else:
        q = rng.integers(hi, 2 ** 64 - 1, NQ_CLASS, dtype=np.uint64,
                         endpoint=True)
    q = q.astype(np.uint64)
    q[-2:] = [0, 2 ** 64 - 1]
    return q


def _batch(keys, seed):
    """NQ_SORTED queries of every class, unsorted."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([_queries(keys, c, seed + i)
                        for i, c in enumerate(QUERY_CLASSES)])
    return rng.permutation(q)[:NQ_SORTED]


def _img(q):
    return tkeys.to_image(q)


@pytest.mark.parametrize("kind,spec,B", CONFIGS)
def test_plan_bit_equal(kind, spec, B):
    keys, rj, rc = _indexes(kind, spec, B)
    starts, next_idx = lf.leaf_spans(rc)
    j_starts, j_next = jlf._leaf_spans_host(rj)
    np.testing.assert_array_equal(starts.numpy(), j_starts)
    np.testing.assert_array_equal(next_idx.numpy(), j_next)

    assert lf.packed_sample_lanes(rc) == jlf.packed_sample_lanes(rj)
    S, F = lf.packed_plan_shape(rc)
    assert (S, F) == jlf.packed_plan_shape(rj)
    if B == 4:
        assert F > 1          # the wide plan is covered

    plan, jplan = lf.get_plan(rc), jlf.get_plan(rj)
    assert plan.kind == jplan.kind == ("packed" if F == 1 else "packed_wide")
    assert lf.get_plan(rc) is plan     # kept on the index
    rows32 = np.asarray(jplan.rows_u32)[:B].astype(np.uint64)
    base = rows32[:, 0]
    samples = (rows32[:, 1:1 + S] << np.uint64(32)) | rows32[:, 1 + S:1 + 2 * S]
    want = np.concatenate([base.astype(np.int64)[:, None],
                           _img(samples.ravel()).numpy().reshape(B, S)], 1)
    np.testing.assert_array_equal(plan.rows.numpy(), want)
    np.testing.assert_array_equal(plan.stripe_first.numpy(), _img(keys[::64]).numpy())
    np.testing.assert_array_equal(plan.group_first.numpy(), _img(keys[::8]).numpy())


@pytest.mark.parametrize("kind,spec,B", CONFIGS)
def test_sorted_anchors_bit_equal(kind, spec, B):
    keys, rj, rc = _indexes(kind, spec, B)
    qs = np.sort(_batch(keys, 3))
    plan, jplan = lf.get_plan(rc), jlf.get_plan(rj)
    LB1_f, LB1_l = lf.sorted_anchors(rc, plan, _img(qs))
    j_LB1_f, _ = jlf._sorted_stats_direct(
        jnp.asarray(qs), rj.device_top_params, jplan.rows_u32,
        jnp.float64(rj.norm_offset), jnp.float64(rj.norm_scale),
        jplan.kmin_key, jplan.kmax_key, top_type=rj.top_type,
        B=rj.branching_factor, S=jplan.S, F=jplan.F, key_type=rj.key_type)
    # rmi_tpu anchors every 128 queries, the port every K5 block
    np.testing.assert_array_equal(LB1_f.numpy(),
                                  np.asarray(j_LB1_f)[::ssk.KQ // 128])
    # the bracket the window bounds rest on: LB1 <= lb1 <= LB1 + F
    lb1 = np.searchsorted(keys[::64], qs)
    for L, at in ((LB1_f, qs[::ssk.KQ]), (LB1_l, qs[ssk.KQ - 1::ssk.KQ])):
        true = np.searchsorted(keys[::64], at)
        assert np.all(L.numpy() <= true) and np.all(true <= L.numpy() + plan.F)
    lo, hi = lf.sorted_bounds(rc, plan, _img(qs))
    blk = np.arange(qs.size) // ssk.KQ
    assert np.all(lo.numpy()[blk] <= np.maximum(lb1 - 1, 0))
    assert np.all(lb1 <= hi.numpy()[blk])


@pytest.mark.parametrize("cls", QUERY_CLASSES)
@pytest.mark.parametrize("kind,spec,B", CONFIGS)
def test_fast_search_matches(kind, spec, B, cls):
    keys, rj, rc = _indexes(kind, spec, B)
    q = _queries(keys, cls, 11)
    got = lf.fast_search(rc, _img(q)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(keys, q, side="left"))
    np.testing.assert_array_equal(got, np.asarray(jlf.fast_search(rj, jnp.asarray(q))))


@pytest.mark.parametrize("kind,spec,B", CONFIGS)
def test_sorted_paths_match(kind, spec, B):
    keys, rj, rc = _indexes(kind, spec, B)
    q = _batch(keys, 5)
    qs = np.sort(q)
    want_sorted = np.searchsorted(keys, qs, side="left")
    j_sorted = jlf._sorted_kernel_search_direct(rj, jlf.get_plan(rj),
                                                jnp.asarray(qs))
    np.testing.assert_array_equal(np.asarray(j_sorted), want_sorted)

    got = lf.fast_search_sorted(rc, _img(qs)).numpy()
    np.testing.assert_array_equal(got, want_sorted)
    np.testing.assert_array_equal(lf.fast_search_via_sort(rc, _img(qs)).numpy(),
                                  want_sorted)
    # an unsorted batch: sort -> K5 -> scatter back
    got = lf.fast_search_via_sort(rc, _img(q)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(keys, q, side="left"))
    order = np.argsort(q, kind="stable")
    np.testing.assert_array_equal(got[order], np.asarray(j_sorted))

    # the public entry points route there and agree with each other
    np.testing.assert_array_equal(rt.search_sorted(rc, _img(qs)).numpy(),
                                  rt.search(rc, _img(qs)).numpy())
    np.testing.assert_array_equal(rt.search(rc, _img(q)).numpy(), got)


@pytest.mark.parametrize("extra", [1, 37, ssk.KQ - 1])
def test_ragged_sorted_batch(extra):
    """nq not a multiple of the kernel block: the last block is short."""
    keys, _, rc = _indexes(*CONFIGS[0])
    qs = np.sort(np.concatenate([_batch(keys, 7), _batch(keys, 8)[:extra]]))
    got = lf.sorted_search(rc, lf.get_plan(rc), _img(qs)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(keys, qs, side="left"))


@pytest.mark.parametrize("move", ["lo_up", "hi_down"])
def test_window_off_lb1_breaks_plain_k5(move):
    keys, _, rc = _indexes(*CONFIGS[0])
    plan = lf.get_plan(rc)
    qs = _img(np.sort(_batch(keys, 9)))
    lo, hi = lf.sorted_bounds(rc, plan, qs)
    want = np.searchsorted(keys, tkeys.from_image(qs), side="left")
    ok = ssk.serve_sorted_plain(qs, plan.group_first, rc.keys, lo, hi)
    np.testing.assert_array_equal(ok.numpy(), want)
    if move == "lo_up":
        lo = lo + 3
    else:
        hi = (hi - 3).clamp(min=0)
    bad = ssk.serve_sorted_plain(qs, plan.group_first, rc.keys, lo, hi)
    assert int((bad.numpy() != want).sum()) > 0
    # the wrapper runs the plain version on CPU tensors
    assert torch.equal(ssk.serve_sorted(qs, plan.group_first, rc.keys, lo, hi),
                       bad)


def test_serve_sorted_refuses_bad_inputs():
    keys, _, rc = _indexes(*CONFIGS[0])
    plan = lf.get_plan(rc)
    q = rc.keys[:ssk.KQ + 1]
    lo = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):             # one bound per block
        ssk.serve_sorted(q, plan.group_first, rc.keys, lo[:1], lo[:1])
    with pytest.raises(ValueError):             # int64 only
        ssk.serve_sorted(q.int(), plan.group_first, rc.keys, lo, lo)
    with pytest.raises(ValueError):             # group_first = keys[::8]
        ssk.serve_sorted(q, plan.group_first[1:], rc.keys, lo, lo)
    with pytest.raises(ValueError):             # one order index per query
        ssk.serve_sorted_scatter(q, torch.arange(q.shape[0] - 1), plan.group_first,
                                 rc.keys, lo, lo)


def test_bounded_plan_serves_exactly():
    """One leaf over 2^20 keys: no sample spacing F <= 64 covers it, so
    the plan is "bounded" (lookup + bounded binary search) on every route."""
    rng = np.random.default_rng(12)
    keys = np.sort(rng.integers(0, 2 ** 50, 1 << 20, dtype=np.uint64))
    rc = rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), "linear,linear", 1)
    assert lf.packed_plan_shape(rc) is None
    assert lf.get_plan(rc).kind == "bounded"
    q = np.concatenate([rng.integers(0, 2 ** 51, NQ_SORTED - 4, dtype=np.uint64),
                        np.array([0, keys[0], keys[-1], 2 ** 64 - 1], np.uint64)])
    want = np.searchsorted(keys, q, side="left")
    qs = np.sort(q)
    for fn, x, w in ((rt.search, q, want), (lf.fast_search, q, want),
                     (lf.fast_search_via_sort, q, want),
                     (rt.search_sorted, qs, np.sort(want))):
        np.testing.assert_array_equal(fn(rc, _img(x)).numpy(), w)


# ---------------------------------------------------------------------------
# K5's sample level group_first = keys[::8], its windows and its scatter
# ---------------------------------------------------------------------------

def _k5_batch(keys, cls, seed):
    """A sorted batch of NQ_SORTED queries (100 fewer for "ragged", whose
    last block is short) of one class: uniform over the key range; one
    block over the whole range with the rest below and above it
    ("sparse": its window exceeds the kernel's shared-memory cap); existing
    keys, 100 queries each ("runs"); the extreme images and the range's
    ends among uniform queries ("extremes")."""
    rng = np.random.default_rng(seed)
    lo, hi = int(keys[0]), int(keys[-1])
    nq = NQ_SORTED - 100 if cls == "ragged" else NQ_SORTED
    if cls == "sparse":
        below = (NQ_SORTED - ssk.KQ) // 2 // ssk.KQ * ssk.KQ
        q = np.concatenate([
            rng.integers(0, lo, below, dtype=np.uint64),
            rng.integers(lo, hi, ssk.KQ, dtype=np.uint64, endpoint=True),
            rng.integers(hi + 1, 2 ** 64 - 1, nq - below - ssk.KQ, dtype=np.uint64,
                         endpoint=True)])
    elif cls == "runs":
        q = np.repeat(keys[rng.integers(0, keys.size, nq // 100 + 1)], 100)[:nq]
    else:
        q = rng.integers(lo, hi, nq, dtype=np.uint64, endpoint=True)
        if cls == "extremes":
            ends = np.array([0, 1, lo - 1, lo, lo + 1, hi - 1, hi, hi + 1,
                             2 ** 64 - 2, 2 ** 64 - 1], dtype=np.uint64)
            q[:nq // 2] = ends[rng.integers(0, ends.size, nq // 2)]
    return np.sort(q.astype(np.uint64))


@pytest.mark.parametrize("cls", K5_CLASSES)
@pytest.mark.parametrize("kind,spec,B", K5_CONFIGS)
def test_k5_sample_level_matches_rmi_tpu(kind, spec, B, cls):
    """The plain K5 over keys[::8] with sorted_bounds' windows against
    rmi_tpu's sorted kernel path and np.searchsorted; the scatter entry
    (serve_via_sort) on the same batch shuffled."""
    keys, rj, rc = _indexes(kind, spec, B)
    plan = lf.get_plan(rc)
    assert plan.kind != "bounded"
    qs = _k5_batch(keys, cls, 21)
    want = np.searchsorted(keys, qs, side="left")
    j_sorted = jlf._sorted_kernel_search_direct(rj, jlf.get_plan(rj), jnp.asarray(qs))
    np.testing.assert_array_equal(np.asarray(j_sorted), want)
    lo, hi = lf.sorted_bounds(rc, plan, _img(qs))
    got = ssk.serve_sorted_plain(_img(qs), plan.group_first, rc.keys, lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)
    if cls == "sparse":
        glo, ghi = ssk.group_bounds(lo, hi, N)
        assert int((ghi - glo).max()) > ssk.WINDOW_CAP
    q = np.random.default_rng(22).permutation(qs)
    np.testing.assert_array_equal(lf.serve_via_sort(rc, plan, _img(q)).numpy(),
                                  np.searchsorted(keys, q, side="left"))


@pytest.mark.parametrize("kind,spec,B", K5_CONFIGS)
def test_k5_window_holds_the_count(kind, spec, B):
    """glo <= ceil(lb / g) <= ghi for every query, at both levels, on the
    windows sorted_bounds gives."""
    keys, _, rc = _indexes(kind, spec, B)
    plan = lf.get_plan(rc)
    for cls in K5_CLASSES:
        qs = _k5_batch(keys, cls, 23)
        lo, hi = lf.sorted_bounds(rc, plan, _img(qs))
        blk = np.arange(qs.size) // ssk.KQ
        for g in ssk.LEVELS:
            c = np.searchsorted(keys[::g], qs)
            glo, ghi = [t.numpy()[blk] for t in ssk.group_bounds(lo, hi, N, g)]
            assert np.all(glo <= c) and np.all(c <= ghi), (cls, g)


def _k5_arrays(case):
    """(sorted int64 keys, sorted int64 queries) for the plain K5, n = 2^16."""
    rng = np.random.default_rng(K5_ARRAY_CASES.index(case))
    if case.startswith("dups"):         # runs longer than a group or a stripe
        run = (9, 17) if case == "dups8" else (65, 300)
        base = np.sort(rng.integers(-(1 << 40), 1 << 40, N // run[0]))
        keys = np.repeat(base, rng.integers(*run, base.size))[:N]
        q = np.concatenate([keys[rng.integers(0, N, 1 << 13)],
                            rng.integers(-(1 << 41), 1 << 41, 1 << 12)])
        return keys, np.sort(q)
    keys = np.sort(rng.integers(-(1 << 62), 1 << 62, N))
    nq = {"dense": 1 << 14, "sparse": ssk.KQ + 300, "extremes": 1 << 13,
          "ragged": 3 * ssk.KQ + 17}[case]
    q = rng.integers(-(1 << 62), 1 << 62, nq)
    if case == "sparse":                # the last block above every key
        q[ssk.KQ:] = 1 << 62
    if case == "extremes":
        keys[:5] = tkeys.IMAGE_MIN
        keys[-70:] = tkeys.KeyType.U64.max_image
        q[:300] = tkeys.IMAGE_MIN
        q[300:600] = tkeys.KeyType.U64.max_image
        q[600:700] = tkeys.KeyType.U64.max_image - 1
    return np.sort(keys), np.sort(q)


def _tight_bounds(keys, q):
    """Per-block [lo, hi] in stripes: the least and the largest lb1 =
    #(keys[::64] < q) of the block's queries, the narrowest window the
    kernel's contract lo <= lb1 <= hi allows."""
    lb1 = np.searchsorted(keys[::64], q)
    nb = -(-q.size // ssk.KQ)
    blocks = np.concatenate([lb1, np.full(nb * ssk.KQ - q.size, lb1[-1])])
    blocks = blocks.reshape(nb, ssk.KQ)
    return torch.from_numpy(blocks.min(1)), torch.from_numpy(blocks.max(1))


@pytest.mark.parametrize("case", K5_ARRAY_CASES)
def test_k5_plain_matches_searchsorted(case):
    """The plain K5 and the CPU wrappers at both levels, and the scatter
    entry's plain version on the batch shuffled, against np.searchsorted."""
    keys, q = _k5_arrays(case)
    lo, hi = _tight_bounds(keys, q)
    want = np.searchsorted(keys, q, side="left")
    tk, tq = torch.from_numpy(keys), torch.from_numpy(q)
    if case == "sparse":        # block 0 spans every stripe, block 1 a few
        glo, ghi = ssk.group_bounds(lo, hi, N)
        assert int(ghi[0] - glo[0]) > ssk.WINDOW_CAP >= int(ghi[1] - glo[1])
    for g in ssk.LEVELS:
        gf = tk[::g].contiguous()
        got = ssk.serve_sorted_plain(tq, gf, tk, lo, hi, g)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(ssk.serve_sorted_level(tq, gf, tk, lo, hi, g), got)
    gf = tk[::ssk.GROUP].contiguous()
    assert torch.equal(ssk.serve_sorted(tq, gf, tk, lo, hi), torch.from_numpy(want))
    perm = torch.from_numpy(np.random.default_rng(5).permutation(q.size))
    # the batch in the order perm: sorting it gives q back and perm as order
    unsorted = torch.empty_like(tq)
    unsorted[perm] = tq
    out = ssk.serve_sorted_scatter_plain(tq, perm, gf, tk, lo, hi)
    np.testing.assert_array_equal(
        out.numpy(), np.searchsorted(keys, unsorted.numpy(), side="left"))
    assert torch.equal(ssk.serve_sorted_scatter(tq, perm, gf, tk, lo, hi), out)


def test_k5_refuses_misaligned_keys():
    """The kernel reads keys in 16-byte vectors: a view that starts 8
    bytes in raises on every device, never reads misaligned."""
    keys = torch.arange(0, 8 * 4097, 8, dtype=torch.int64)
    view = keys[1:]
    assert view.data_ptr() % 16 == 8
    q = view[:100].clone()
    b = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="16-byte"):
        ssk.serve_sorted(q, view[::8].contiguous(), view, b, b + 64)
    with pytest.raises(ValueError, match="16-byte"):
        ssk.serve_sorted_scatter(q, torch.arange(100), view[::8].contiguous(), view,
                                 b, b + 64)
    aligned = view.clone()
    got = ssk.serve_sorted(q, aligned[::8].contiguous(), aligned, b, b + 64)
    np.testing.assert_array_equal(got.numpy(), np.arange(100))
