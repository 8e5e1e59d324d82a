"""Stage A's top fits (ops/top_kernel.py: rmi_top_cubic_candidates,
rmi_top_l1_cubic, rmi_top_moments, rmi_top_table_fit) and the hier
search past the keys' ends, on the CPU against rmi_tpu.

  (a) each top fit's plain route, stage A whole (two_layer._assign_body),
      against rmi_tpu's jitted stage A on the same numpy keys: the leaf
      ids bit-equal, and the top bit-equal, for the robust_linear, radix8
      and radix22 tops on u64, u32 and f64 keys (the cubic, linear, normal
      and radix18 tops are test_torch_top_kernels.py's (d)); where rmi_tpu
      fuses the linear-family fit into its stage A on integer keys and
      adds in another order (test_torch_top_kernels.STAGE_ULPS), the row is
      bit-equal to rmi_tpu's fit_top jitted alone on the stage's inputs;
  (b) a host mirror of rmi_top_moments' summation order (csrc/top_fit.cu:
      a walking warp's tile of level-1 windows summed row by row, the
      level-2 sum of the rows, each window of the levels above summed by
      the warp that completes it, the FMA chain of 32 or fewer) bit-equal
      to segments.whole_array_sum, and the mirror's whole fit (the means,
      the centered sums, the degenerate cases) bit-equal to
      top_moments_plain, on top_fit_case's keys; a host mirror of
      rmi_top_table_fit's search (tools/count_torch_table_reads.py) equal
      to top_table_fit_plain; a host mirror of rmi_top_cubic_candidates'
      warp searches (aten's binary search, top_kernel.SEARCH_LEVELS steps
      a round from the ballots of every midpoint the round can reach)
      equal to torch.searchsorted on both sides, on sorted keys with long
      runs at both ends and on keys led by NaN, where only aten's own
      midpoints give its answer;
  (c) search through the hierarchical plan past the keys' ends: an
      integer top routes a query outside the range whose bits differ in
      the keys' common prefix to a leaf whose window does not hold its
      lower bound; the port answers it exactly (resolve answers a query
      outside the range by its end, whatever its guess), where rmi_tpu's
      search does not.
"""

import functools
import importlib.util
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import rmi_tpu
from rmi_tpu.data import RMIDataset as JDataset
from rmi_tpu.models import get_model as j_get_model

import rmi_tpu_torch as rt
from rmi_tpu_torch import config
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch import lookup_fast as lf
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import hier_kernel, top_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg
from test_torch_fit_kernels import TOP_FIT_EDGES, top_fit_case
from test_torch_lookup_kernel import resolve_edge_case
from test_torch_top_kernels import STAGE_ULPS, _carried, _j_stage, _keys

WIN = 32       # segments._XLA_WINDOW


# (a) the plain routes against rmi_tpu's stage A --------------------------

@pytest.mark.parametrize("kind", ["u64", "u32", "f64"])
@pytest.mark.parametrize("top", ["robust_linear", "radix8", "radix22"])
def test_stage_a_plain_route_is_rmi_tpus(top, kind):
    B = 1000
    jy, params, jt = _j_stage(top, kind, B)
    keys, key_type = _keys(kind)
    img = tkeys.to_image(keys)
    kminf, s = two_layer.norm_constants(img, key_type)
    top_in = two_layer.model_float_input(get_model(top), img, kminf, s, key_type)
    yfix = two_layer.fixdups_i32(img)
    top_w, t, _ = two_layer._assign_body(top_in, yfix, top_type=top, B=B, keys=img,
                                         key_type=key_type)
    np.testing.assert_array_equal(t.numpy(), jt)
    want = _carried(top, params)
    if isinstance(want, dict):
        assert set(top_w) == set(want)
        assert all(torch.equal(top_w[k], want[k]) for k in want)
        return
    sf, n = B / keys.size, keys.size
    ys = top_kernel.scaled_targets(yfix, sf)
    alone = jax.jit(lambda a, b, c: j_get_model(top).fit_top(keys_f=a, ys_f=b, ep_ys_f=c, n=n))(
        *map(jnp.asarray, (top_in.numpy(), ys.numpy(),
                           np.trunc(np.arange(n, dtype=np.float64) * sf))))
    assert torch.equal(top_w.view(torch.int64), torch.from_numpy(np.array(alone)).view(
        torch.int64))
    w = want.numpy()
    assert (np.abs(top_w.numpy() - w) <= STAGE_ULPS * np.spacing(np.abs(w).max())).all()


# (b) the moments kernel's order, mirrored ---------------------------------

def _level(length):
    """(front, windows) of XLA's windows over ``length`` (csrc/top_fit.cu
    Level)."""
    pad = (WIN - length % WIN) % WIN
    return pad // 2, (length + pad) // WIN


def _in_order(cols):
    """Each row of [rows, k] summed from 0 in column order."""
    acc = torch.zeros(cols.shape[0], dtype=torch.float64)
    for k in range(cols.shape[1]):
        acc = acc + cols[:, k]
    return acc


def _gather(values, pos):
    """values[pos], 0.0 where pos lies outside them."""
    ok = (pos >= 0) & (pos < values.shape[0])
    return torch.where(ok, values[pos.clamp(0, max(values.shape[0] - 1, 0))], 0.0)


def kernel_order_sum(values, lo, hi, times=None):
    """[1]: sum of values[lo:hi] (times values * times) as rmi_top_moments
    adds it: at most 32 values one loop (an FMA chain over [lo, hi) with
    ``times``); else level 2 from level 0 as the walk's warps do (row r
    of warp w2's tile is level-1 window 32 w2 - front1 + r, whose
    position k is 32 j - front0 + k), or where level 1 has at most 32
    windows their sum in sequence (one walk window, front1 = 0, its rows
    past them zeros), then each level's windows as climb adds them and
    the last level's loop."""
    n = values.shape[0]
    if n <= WIN:
        acc = torch.zeros((), dtype=torch.float64)
        if times is not None:
            for i in range(lo, hi):
                acc = torch.addcmul(acc, values[i], times[i])
            return acc.reshape(1)
        for i in range(n):
            acc = acc + (values[i] if lo <= i < hi else 0.0)
        return acc.reshape(1)
    v = values if times is None else values * times
    v = torch.where((torch.arange(n) >= lo) & (torch.arange(n) < hi), v, 0.0)
    f0, l1 = _level(n)
    k = torch.arange(WIN)
    if l1 > WIN:
        f1, l2 = _level(l1)
        w2 = torch.arange(l2)
        pos = ((w2 * WIN - f1)[:, None, None] + k[None, :, None]) * WIN - f0 + k[None, None, :]
        rows = _in_order(_gather(v, pos).reshape(-1, WIN)).reshape(l2, WIN)
        cur = _in_order(rows)
    else:
        cur = _in_order(_gather(v, torch.arange(l1)[:, None] * WIN - f0 + k))
    while cur.shape[0] > WIN:
        front, windows = _level(cur.shape[0])
        cur = _in_order(_gather(cur, torch.arange(windows)[:, None] * WIN - front + k))
    return _in_order(cur[None, :])


SUM_NS = (1, 2, 31, 32, 33, 100, 1024, 1025, 1056, 32768, 32769, 40000, 1 << 16)


@pytest.mark.parametrize("n", SUM_NS)
def test_kernel_order_sum_is_whole_array_sums(n):
    """The mirror bit-equal to segments.whole_array_sum on the CPU, over
    values of mixed signs and magnitudes (each sum's order shows in its
    bits), the whole array and a span inside it, plain and of products."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.normal(0.0, 1.0, n) * 10.0 ** rng.integers(-8, 9, n))
    w = torch.from_numpy(rng.normal(0.0, 1e3, n))
    for lo, hi in ((0, n), (n // 7, n - n // 5)):
        for times in (None, w):
            want = seg.whole_array_sum(v, lo, hi, times=times)
            got = kernel_order_sum(v, lo, hi, times)
            assert torch.equal(got.view(torch.int64), want.view(torch.int64)), (lo, hi, times)


def moments_mirror(top, x, yfix, sf):
    """rmi_top_moments' row from kernel_order_sum: pass 1's sums and means
    (linear: times the count's reciprocal; normal: over the count), pass
    2's centered sums, then _slr_from_moments' or _ncdf_ranges' cases."""
    n = x.shape[0]
    lo, hi = top_kernel.top_span(top, n)
    y = top_kernel.scaled_targets(yfix, sf)
    cnt = float(hi - lo)
    safe = max(cnt, 1.0)
    sx = kernel_order_sum(x, lo, hi)
    if top == "normal":
        mean = sx / safe
        dx = x - mean
        ss = kernel_order_sum(dx, lo, hi, dx)
        stdev = torch.sqrt(ss.clamp(min=0.0) / safe)
        return torch.stack([mean, stdev, y[n - 1:]], dim=-1)
    inv = 1.0 / torch.tensor([safe], dtype=torch.float64)
    mx, my = sx * inv, kernel_order_sum(y, lo, hi) * inv
    dx, dy = x - mx, y - my
    m2, c = kernel_order_sum(dx, lo, hi, dx), kernel_order_sum(dx, lo, hi, dy)
    var_zero = bool(m2 <= 0.0)
    beta = torch.zeros(1, dtype=torch.float64) if var_zero else c / m2
    alpha = torch.addcmul(my, beta, mx, value=-1)
    if cnt == 1 or var_zero:
        alpha, beta = my, torch.zeros(1, dtype=torch.float64)
    return torch.stack([alpha, beta], dim=-1)


@pytest.mark.parametrize("n", (1, 3, 33, 1025, 4099))
@pytest.mark.parametrize("kind", TOP_FIT_EDGES)
@pytest.mark.parametrize("top", sorted(top_kernel.MOMENT_TOPS))
def test_moments_mirror_is_the_plain_fit(top, kind, n):
    img, key_type = top_fit_case(kind, n)
    kminf, s = two_layer.norm_constants(img, key_type)
    x = two_layer.model_float_input(get_model(top), img, kminf, s, key_type)
    yfix = two_layer.fixdups_i32(img)
    sf = 1000 / n
    want = top_kernel.top_moments_plain(top, x, yfix, sf)
    got = moments_mirror(top, x, yfix, sf)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int64), want[~nan].view(torch.int64))
    assert torch.equal(top_kernel.top_moments(top, x, yfix, sf).view(torch.int64),
                       want.view(torch.int64))


# (b') the table fit's search, mirrored --------------------------------------

@functools.lru_cache(maxsize=None)
def _table_replay():
    """tools/count_torch_table_reads.py, the host replay of csrc/top_fit.cu's
    table fit read for read."""
    path = config.PACKAGE_DIR.parent / "tools" / "count_torch_table_reads.py"
    spec = importlib.util.spec_from_file_location("count_torch_table_reads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TABLE_MIRROR_CASES = ([(kind, n) for kind in ("u64", "u32", "f64") for n in (1, 4099, 1 << 16)]
                      + [("dups", 4099), ("clustered", 1 << 16)])


@pytest.mark.parametrize("bits", [8, 18])
@pytest.mark.parametrize("kind,n", TABLE_MIRROR_CASES)
def test_table_search_mirror_is_the_plain_fit(kind, n, bits):
    """The kernel's search (a thread a slot from the keys' two ends, 64-byte
    blocks placed by interpolation), replayed on the host, gives
    top_table_fit_plain's table and prefix on top_fit_case's keys."""
    img, key_type = top_fit_case(kind, n)
    ints = tkeys.int_image(img, key_type)
    yfix = two_layer.fixdups_i32(img)
    sf = 1000 / n
    want = top_kernel.top_table_fit_plain(ints, yfix, sf, bits)
    got, prefix = _table_replay().table_search(ints, yfix, sf, bits)
    np.testing.assert_array_equal(got, want["table"].numpy())
    assert prefix == int(want["w_int"][0])


# (b'') the cubic candidates' warp searches, mirrored ----------------------------

def warp_search_mirror(x, v, right, levels=top_kernel.SEARCH_LEVELS):
    """(index, rounds) of csrc/top.cu's search_f64 on the host: each round
    lane k - 1 takes node k's bracket down the round's tree of ``levels``
    steps below (lo, hi) (heap-numbered, a right step for a 1 bit), reads
    its midpoint where the bracket is not empty and ballots aten's step
    there; the walk leaves the tree at an empty bracket (lo >= hi, the end)
    or below its last level, one step under its parent's bracket."""
    def goes_right(m):
        return not (m > v) if right else not (m >= v)
    width = 1 << levels
    lo, hi, rounds = 0, len(x), 0
    while lo < hi:
        rounds += 1
        brackets, go, alive = {}, 0, 0
        for k in range(1, width):
            a, b = lo, hi
            for d in range(k.bit_length() - 2, -1, -1):
                mid = a + ((b - a) >> 1)
                a, b = (mid + 1, b) if (k >> d) & 1 else (a, mid)
            brackets[k] = (a, b)
            if a < b:
                alive |= 1 << (k - 1)
                go |= goes_right(x[a + ((b - a) >> 1)]) << (k - 1)
        w = 1
        while w < width and (alive >> (w - 1)) & 1:
            w = 2 * w + ((go >> (w - 1)) & 1)
        if w < width:
            lo, hi = brackets[w]
        else:
            a, b = brackets[w >> 1]
            mid = a + ((b - a) >> 1)
            lo, hi = (mid + 1, b) if w & 1 else (a, mid)
    return lo, rounds


@settings(max_examples=60, deadline=None)
@given(lead=st.integers(0, 3), first=st.integers(0, 700), middle=st.integers(0, 300),
       last=st.integers(0, 700), seed=st.integers(0, 2 ** 16),
       ends=st.sampled_from([(0.0, 1.0), (-math.inf, math.inf), (-1.0, -1.0), (2.5, 2.5)]))
def test_warp_search_mirror_is_searchsorted(lead, first, middle, last, seed, ends):
    """The warp search, mirrored, equals torch.searchsorted (aten's walk)
    on both sides for the candidates' values (x[0] right, x[n - 1] left)
    and a few others, on sorted keys with runs of up to 700 equal keys at
    each end (several rounds of 31 midpoints), all keys equal, +-inf at
    the ends, and keys led by NaN (keys.f64_image puts NaN keys first)."""
    lo_v, hi_v = ends
    mid = np.sort(np.random.default_rng(seed).uniform(-1.0, 1.0, middle))
    if lo_v == hi_v:
        mid[:] = lo_v
    elif math.isfinite(hi_v - lo_v):
        mid = lo_v + (hi_v - lo_v) * (mid + 1) / 2
    x = np.concatenate([np.full(lead, np.nan), np.full(first, lo_v), mid,
                        np.full(last, hi_v)])
    if x.shape[0] == 0:
        return
    t = torch.from_numpy(x)
    for v, right in ((x[0], True), (x[-1], False), (x[-1], True), (x[0], False),
                     (lo_v, True), (hi_v, False), (0.0, True), (np.nan, False)):
        want = int(torch.searchsorted(t, torch.tensor([v], dtype=torch.float64), right=right))
        got, rounds = warp_search_mirror(x, v, right)
        assert got == want, (v, right, got, want)
        assert rounds <= max(1, math.ceil(math.log2(x.shape[0] + 1) / top_kernel.SEARCH_LEVELS))


def test_top_fit_wrappers_refuse_bad_inputs():
    x = torch.linspace(0, 1, 64, dtype=torch.float64)
    y = torch.arange(64, dtype=torch.int32)
    img = torch.arange(64, dtype=torch.int64)
    with pytest.raises(ValueError):
        top_kernel.top_cubic_candidates(x, y[:63], 1.0)          # yfix not like x
    with pytest.raises(ValueError):
        top_kernel.top_cubic_candidates(x, y, 1.0, keys=img[:3])  # keys not like x
    with pytest.raises(ValueError):
        top_kernel.top_moments("cubic", x, y, 1.0)               # not a moments top
    with pytest.raises(ValueError):
        top_kernel.top_moments("linear", x.float(), y, 1.0)      # not f64
    with pytest.raises(ValueError):
        top_kernel.top_table_fit(img, y, 1.0, 12)                # no such table
    with pytest.raises(ValueError):
        top_kernel.top_table_fit(x, y, 1.0, 8)                   # not images
    with pytest.raises(ValueError):
        top_kernel.top_table_fit(img[:0], y[:0], 1.0, 8)         # no keys


# (c) the hier search past the keys' ends ----------------------------------

def _crafted(side):
    """f64 keys whose integer images share a prefix that a query just
    outside them does not: "above" ends on the double below 2^30, whose
    next double truncates to 2^30; in "below" every key has bit 40 and
    2^40 - 1 (just below the first) sets all the bits under it.  A few
    keys spread wide at the far end give the leaf the query is routed to
    a line that does not reach the query's lower bound."""
    rng = np.random.default_rng(24)
    n = 1 << 14
    if side == "above":
        keys = np.concatenate([rng.uniform(131.0, 2.0 ** 29, 32),
                               rng.uniform(2.0 ** 29, 2.0 ** 30, n - 32)])
        keys[-1] = np.nextafter(2.0 ** 30, 0.0)
        return np.sort(keys), np.array([2.0 ** 30, 2.0 ** 30 + 1e3, 2.0 ** 31])
    keys = np.concatenate([rng.uniform(2.0 ** 40 + 5.0, 2.0 ** 40 + 2.0 ** 37, n - 32),
                           rng.uniform(2.0 ** 40 + 2.0 ** 37, 2.0 ** 40 + 2.0 ** 38, 32)])
    return np.sort(keys), np.array([2.0 ** 40 - 1.0, 2.0 ** 40 - 0.5, 2.0 ** 39])


@functools.lru_cache(maxsize=None)
def _crafted_builds(side, spec):
    keys, q = _crafted(side)
    return (keys, q, rmi_tpu.train(JDataset.from_numpy(keys), spec, 256),
            rt.train(rt.RMIDataset.from_numpy(keys, device="cpu"), spec, 256))


@pytest.mark.parametrize("spec", ["radix18,linear", "radix22,linear"])
@pytest.mark.parametrize("side", ["above", "below"])
def test_hier_search_past_the_ends_is_exact(side, spec):
    """The port's search, search_sorted and fast_search answer the queries
    past the ends exactly; rmi_tpu's search answers the first two of them
    wrong (the fault both packages had)."""
    keys, qn, rj, rp = _crafted_builds(side, spec)
    assert lf.get_plan(rp).kind == "hier"
    want = np.searchsorted(keys, qn, side="left")
    q = tkeys.to_image(qn)
    np.testing.assert_array_equal(rt.search(rp, q).numpy(), want)
    np.testing.assert_array_equal(lf.fast_search(rp, q).numpy(), want)
    np.testing.assert_array_equal(rt.search_sorted(rp, q.sort().values).numpy(), np.sort(want))
    j = np.asarray(rmi_tpu.search(rj, jnp.asarray(qn)))
    assert (j[:2] != want[:2]).all()


@pytest.mark.parametrize("kind,K", [("extremes", 0), ("extremes", 1), ("dups", 2), ("edges", 3)])
def test_resolve_ends(kind, K):
    """The resolve answers #(keys < q) on every query outside the keys'
    range whatever its guess (lookup's, or one at either end of the keys
    with err 0), through the wrapper and resolve_plain."""
    keys, q, guess, err = resolve_edge_case(kind, K, 90 + K)
    levels, packed = hier_kernel.hier_levels(keys, K)
    n = keys.shape[0]
    out = (q <= keys[0]) | (q > keys[-1])
    assert out.any() and (~out).any()
    want = torch.searchsorted(keys, q[out])
    zero = torch.zeros_like(err)
    for g, e in ((guess, err), (zero, zero), (torch.full_like(guess, n), zero)):
        got = hier_kernel.resolve_plain(levels, q, g, e, K=K, n=n)
        assert torch.equal(got[out], want)
        assert torch.equal(lf.resolve(levels, q, g, e, K=K, n=n, packed=packed), got)
