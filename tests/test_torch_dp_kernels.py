"""The data-parallel build's per-shard kernel forms against the eager
chains they replace (rmi_tpu_torch/parallel/dp_trainer.py), on the CPU.

Each form's wrapper (scan_kernel.fixdups_carry, sweep_kernel.
span_run_max_carry, select_kernel.aug_fit_sums and aug_centered_moments on
int32 targets, top_kernel.top_l1_partial) runs its plain version here; the
tests hold it, bit for bit, to the eager code the dp build ran before
those kernels (written out below as ``eager_*``), on shards cut by hand
from keys made with numpy from a seed, in one process: a fake DPGroup
hands every rank the gathered shard edges, so dp_trainer's own carries
(shard_edges, run_carries, dist_fixdups) run as on a rank.  The shards
show the edges: a run continuing across one shard boundary, across
several and over a whole shard, the last shards padded (n not divisible
by the world, a shard of pads alone), a leaf whose augmented span crosses
a shard, empty clips.  The integers are also held to the single-device
build's (FixDups and the per-leaf longest runs of the whole array).  No
jax: the card tests (tests/test_torch_cuda_kernels.py, marker ``cuda``)
hold the kernels to these plain versions on the same shards.
"""

import numpy as np
import pytest
import torch

from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models.base import normalize
from rmi_tpu_torch.models.cubic import cubic_predict
from rmi_tpu_torch.models.linear import linear_predict, log_targets
from rmi_tpu_torch.ops import scan_kernel, select_kernel, sweep_kernel, top_kernel
from rmi_tpu_torch.parallel import dp_trainer
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg


def _keys(n, seed, runs=()):
    """n sorted u64 keys from ``seed``, each (start, stop) of ``runs`` made
    one run of equal keys."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 2 ** 40, size=n, dtype=np.uint64))
    for a, b in runs:
        keys[a:b] = keys[a]
    return np.sort(keys)


# case -> (keys, world, B): n, the world and the runs chosen to show the edges
EDGE_CASES = {
    # a run across the boundary of shards 0 and 1 (250 keys a shard)
    "one_boundary": (_keys(1000, 1, [(240, 262)]), 4, 16),
    # a run from shard 0 over the whole of shard 1 into shard 2
    "several": (_keys(1000, 2, [(230, 530)]), 4, 16),
    # a run over exactly one whole shard, and one starting a shard
    "whole_shard": (_keys(1000, 3, [(250, 500), (750, 760)]), 4, 16),
    # n not divisible by the world: the last shard padded, a run into it
    "padded": (_keys(1001, 4, [(990, 1001)]), 4, 16),
    # the last key's run across a boundary, and the pads after it
    "final_run": (_keys(999, 5, [(740, 999)]), 4, 8),
    # two shards of pads (m = 2): shard 2 holds one key and a pad, shard 3 pads
    "pads_only": (_keys(5, 6, [(1, 3)]), 4, 4),
    # every key equal
    "all_equal": (_keys(37, 7, [(0, 37)]), 4, 8),
    # dense leaves, many of them empty (B above the keys a shard)
    "empty_clips": (_keys(333, 8, [(80, 90), (160, 170)]), 3, 512),
}


class FakeGroup:
    """A DPGroup of one rank of ``world`` in this process: its all_gather
    returns every rank's tensor, given beforehand (``gathered``)."""

    def __init__(self, rank, world, gathered):
        self.rank, self.world, self.gathered = rank, world, gathered

    def all_gather(self, t):
        assert torch.equal(t, self.gathered[self.rank])
        return self.gathered


def _shards(keys_np, world):
    """(shards, n, m): the ranks' shards as dp_trainer.local_shard cuts
    them (the last ones padded with max-key sentinels)."""
    img = tkeys.to_image(keys_np)
    n = img.shape[0]
    m = -(-n // world)
    shards = []
    for r in range(world):
        part = img[min(r * m, n):min(r * m + m, n)]
        pad = part.new_full((m - part.shape[0],), KeyType.U64.max_image)
        shards.append(torch.cat([part, pad]))
    return shards, n, m


def _groups(shards):
    edges = torch.stack([dp_trainer.shard_edges(k) for k in shards])
    return [FakeGroup(r, len(shards), edges) for r in range(len(shards))]


# ---------------------------------------------------------------------------
# the eager chains the dp build ran before its per-shard kernels
# ---------------------------------------------------------------------------

def eager_fixdups(shards):
    """Every rank's global first-occurrence indices, int32: where(changed,
    i, 0), the first key a change unless it equals the previous rank's
    last, K1's running max, then the maximum with the largest last value
    of the ranks before."""
    m = shards[0].shape[0]
    local = []
    for r, k in enumerate(shards):
        changed = torch.ones(m, dtype=torch.bool)
        torch.ne(k[1:], k[:-1], out=changed[1:])
        if r > 0:
            changed[:1] = k[:1] != shards[r - 1][-1:]
        gidx = torch.arange(r * m, r * m + m, dtype=torch.int32)
        local.append(scan_kernel.scan_i32_plain(torch.where(changed, gidx, 0), is_max=True))
    lasts = torch.stack([v[-1] for v in local])
    return [torch.maximum(v, torch.where(torch.arange(len(shards)) < r, lasts, 0).max())
            for r, v in enumerate(local)]


def eager_run_ends(shards, n):
    """Every rank's global last index of each key's run, int32: the run
    ends where(ends, i, n - 1), the last key an end unless it equals the
    next rank's first, K1's reverse running min, then the minimum with the
    smallest first value of the ranks after (n - 1 past the last)."""
    m, world = shards[0].shape[0], len(shards)
    local = []
    for r, k in enumerate(shards):
        ends = torch.ones(m, dtype=torch.bool)
        torch.ne(k[1:], k[:-1], out=ends[:-1])
        if r < world - 1:
            ends[-1:] = k[-1:] != shards[r + 1][:1]
        gidx = torch.arange(r * m, r * m + m, dtype=torch.int32)
        local.append(scan_kernel.scan_i32_plain(torch.where(ends, gidx, n - 1), is_max=False,
                                                reverse=True))
    firsts = torch.stack([v[0] for v in local])
    return [torch.minimum(v, torch.where(torch.arange(world) > r, firsts, n - 1).min())
            for r, v in enumerate(local)]


def eager_longest(shard, yfix, run_end, t_local, off, n, B):
    """A rank's per-leaf longest counted run, int64 [B]: run_end - yfix + 1
    where run_end < n - 1 and the key is no pad, scattered by leaf id."""
    is_pad = torch.arange(off, off + shard.shape[0]) >= n
    counted = torch.where((run_end < n - 1) & ~is_pad, run_end - yfix + 1, 0)
    return torch.zeros(B, dtype=torch.int64).scatter_reduce_(0, t_local.long(),
                                                             counted.long(), "amax")


def eager_range_sums(vs, lo, hi):
    """[len(vs), k]: each value's f64 prefix sum over the shard, taken at
    the clip's bounds (dp_trainer._range_sums before the collective)."""
    out = []
    for v in vs:
        c = seg.prefix_sum_exclusive(v)
        out.append(c[hi] - c[lo])
    return torch.stack(out)


def _bits(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.is_floating_point():
        a, b = a.view(torch.int64), b.view(torch.int64)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# leaves over the global keys: a monotone leaf id per key, clipped per rank
# ---------------------------------------------------------------------------

def _leaves(keys_np, n, B):
    """(t [n] int32, spans): each key's leaf, a monotone function of the
    key (equal keys share a leaf), some leaves empty."""
    k = keys_np.astype(np.float64)
    span = max(k[-1] - k[0], 1.0)
    t = np.minimum(((k - k[0]) / span * (B - 0.5)) ** 1.3 / B ** 0.3, B - 1).astype(np.int32)
    t = torch.from_numpy(np.maximum.accumulate(t))
    return t, seg.make_spans(t, B)


def _clip(spans, m, r):
    """dp_trainer._local_spans of rank r (shards of m keys)."""
    return dp_trainer._local_spans(spans, None, m, FakeGroup(r, 1, None))


def _t_local(t, n, m, r, B):
    """Rank r's leaf ids, the pads routed to the last leaf."""
    part = t[min(r * m, n):min(r * m + m, n)]
    return torch.cat([part, part.new_full((m - part.shape[0],), B - 1)])


def _x_y(shards, n, r):
    """Rank r's normalized keys (its model input, pads included) and its
    global FixDups targets, as the dp build makes them."""
    kminf, s = two_layer.norm_constants(torch.cat(shards)[:n], KeyType.U64)
    return normalize(shards[r], kminf, s), eager_fixdups(shards)[r]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", EDGE_CASES)
def test_fixdups_carry_is_the_eager_chain(case):
    keys_np, world, _ = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    want = eager_fixdups(shards)
    groups = _groups(shards)
    for r, (k, comm) in enumerate(zip(shards, groups)):
        got = dp_trainer.dist_fixdups(k, comm, dp_trainer.dist_carries(k, n, comm))
        _bits(got, want[r])
        c = dp_trainer.dist_carries(k, n, comm)
        _bits(scan_kernel.fixdups_carry_plain(k, r * m, c.continues_left, c.start), want[r])
    # and the single-device FixDups of the real keys
    glob = scan_kernel.fixdups(torch.cat(shards)[:n])
    _bits(torch.cat(want)[:n], glob)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_run_bounds_are_the_eager_chain(case):
    keys_np, world, _ = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    want = eager_run_ends(shards, n)
    for r, (k, comm) in enumerate(zip(shards, _groups(shards))):
        yfix = dp_trainer.dist_fixdups(k, comm)
        start, end = dp_trainer.dist_run_bounds(k, yfix, n, comm)
        _bits(end, want[r])
        _bits(start, yfix)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_span_run_max_carry_is_the_eager_chain(case):
    keys_np, world, B = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    t, spans = _leaves(keys_np, n, B)
    yfix_all = eager_fixdups(shards)
    ends_all = eager_run_ends(shards, n)
    met = torch.zeros(B, dtype=torch.int64)
    for r, (k, comm) in enumerate(zip(shards, _groups(shards))):
        c = dp_trainer.dist_carries(k, n, comm)
        local = _clip(spans, m, r)
        got = sweep_kernel.span_run_max_carry(k, yfix_all[r], local.starts, local.ends, r * m,
                                              n, c.continues_right, c.end)
        want = eager_longest(k, yfix_all[r], ends_all[r], _t_local(t, n, m, r, B), r * m, n,
                             B)
        _bits(got.long(), want)
        met = torch.maximum(met, got.long())
    # the ranks' maxima met: the single-device per-leaf longest runs
    img = torch.cat(shards)[:n]
    glob = sweep_kernel.span_run_max(img, scan_kernel.fixdups(img), spans.starts, spans.ends)
    _bits(met, glob.long())


@pytest.mark.parametrize("form", ["xy", "xx", "log"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_aug_fit_sums_is_the_eager_chain(case, form):
    keys_np, world, B = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    _, spans = _leaves(keys_np, n, B)
    for r in range(world):
        x, y = _x_y(shards, n, r)
        local = _clip(spans, m, r)
        lo, hi = local.aug_starts, local.aug_ends
        got = select_kernel.aug_fit_sums(x, None if form == "xx" else y, lo, hi,
                                         log=form == "log")
        if form == "log":
            ln, w = log_targets(y.double())
            want = eager_range_sums((w, x * w, ln * w), lo, hi)
        else:
            want = eager_range_sums((x, y.double()), lo, hi)
            want = torch.stack([(hi - lo).double(), want[0],
                                want[1] if form == "xy" else torch.zeros_like(want[1])])
        for g, w_ in zip(got, want):
            _bits(g, w_)


@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_centered_moments_on_targets_are_the_eager_chain(case, log):
    keys_np, world, B = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    _, spans = _leaves(keys_np, n, B)
    rng = np.random.default_rng(21)
    for r in range(world):
        x, y = _x_y(shards, n, r)
        local = _clip(spans, m, r)
        lo, hi = local.aug_starts, local.aug_ends
        mean_x = torch.from_numpy(rng.random(B))
        mean_y = torch.from_numpy(rng.random(B) * n)
        got = select_kernel.aug_centered_moments(x, y, mean_x, mean_y, lo, hi, log=log)
        if log:
            ln, w = log_targets(y.double())
            want = select_kernel.aug_centered_moments(x, ln, mean_x, mean_y, lo, hi,
                                                      weights=w)
        else:
            want = select_kernel.aug_centered_moments(x, y.double(), mean_x, mean_y, lo, hi)
        for g, w_ in zip(got, want):
            _bits(g, w_)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_top_l1_partial_is_the_eager_chain(case):
    keys_np, world, B = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    sf = float(B) / float(n)
    rng = np.random.default_rng(22)
    cand = torch.from_numpy(np.concatenate([rng.standard_normal(6) * [1, 1, n, 1, 1, n],
                                            np.zeros(top_kernel.CAND - 6)]))
    total = torch.zeros(2, dtype=torch.float64)
    for r in range(world):
        x, y = _x_y(shards, n, r)
        real = max(0, min(m, n - r * m))
        got = top_kernel.top_l1_partial(x, y, sf, cand, real)
        ys = two_layer._scale(y.double(), sf)
        lo = torch.zeros(1, dtype=torch.int64)
        hi = torch.full((1,), real, dtype=torch.int64)
        want = eager_range_sums(((cubic_predict(cand[None, :4], None, x) - ys).abs_(),
                                 (linear_predict(cand[None, 4:6], None, x) - ys).abs_()),
                                lo, hi)
        _bits(got, want[:, 0])
        total = total + got
    # over every rank: the whole-array sums, to rounding
    img = torch.cat(shards)[:n]
    xs = torch.cat([_x_y(shards, n, r)[0] for r in range(world)])[:n]
    single = top_kernel.top_l1_cubic_plain(xs, scan_kernel.fixdups(img), sf, cand)[0]
    torch.testing.assert_close(total, single, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_pads_routed_by_count(case):
    """The pads, the shard's rows past n, take the last leaf by a slice
    where the dp build masked them, and drop out of bradix's bucket counts
    by a slice of the buckets."""
    keys_np, world, B = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    t, _ = _leaves(keys_np, n, B)
    for r, k in enumerate(shards):
        real = max(0, min(m, n - r * m))
        t_r = torch.cat([t, t.new_zeros(world * m - n)])[r * m:r * m + m].clone()
        is_pad = torch.arange(r * m, r * m + m) >= n
        want = torch.where(is_pad, B - 1, t_r).to(torch.int32)
        t_r[real:] = B - 1
        _bits(t_r, want)
        slots = torch.arange(B + 1)
        bucket = t_r.long()
        _bits(torch.searchsorted(bucket[:real], slots),
              torch.searchsorted(torch.where(is_pad, B, bucket), slots))


@pytest.mark.parametrize("case", ["padded", "pads_only", "several"])
def test_run_carries_are_the_eager_carries(case):
    """shard_edges and run_carries give every rank the carries of the
    eager chain's collectives: its FixDups start the largest last value of
    the eager running max on the ranks before, and whether its first and
    last key continue a neighbour's run."""
    keys_np, world, _ = EDGE_CASES[case]
    shards, n, m = _shards(keys_np, world)
    edges = torch.stack([dp_trainer.shard_edges(k) for k in shards])
    lasts = torch.stack([v[-1] for v in eager_fixdups(shards)])
    for r in range(world):
        c = dp_trainer.run_carries(edges, m, n, r)
        assert c.start.dtype == torch.int32 and c.end.dtype == torch.int32
        assert int(c.start) == (int(lasts[:r].max()) if r else 0)
        assert bool(c.continues_left) == (r > 0 and bool(shards[r][0] == shards[r - 1][-1]))
        assert bool(c.continues_right) == (r < world - 1
                                           and bool(shards[r][-1] == shards[r + 1][0]))


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(8, dtype=torch.float64)
    y = torch.zeros(8, dtype=torch.int32)
    lo = hi = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        select_kernel.aug_fit_sums(x, None, lo, hi, log=True)
    with pytest.raises(ValueError):
        select_kernel.aug_fit_sums(x, y.long(), lo, hi)
    with pytest.raises(ValueError):
        select_kernel.aug_centered_moments(x, y, x[:2], x[:2], lo, hi, weights=x)
    with pytest.raises(ValueError):
        select_kernel.aug_centered_moments(x, x, x[:2], x[:2], lo, hi, log=True)
    with pytest.raises(ValueError):
        top_kernel.top_l1_partial(x, y, 1.0, torch.zeros(top_kernel.CAND,
                                                         dtype=torch.float64), 9)
    with pytest.raises(ValueError):
        scan_kernel.fixdups_carry(torch.zeros(8, dtype=torch.int64), 2 ** 31 - 4,
                                  torch.zeros(1, dtype=torch.bool),
                                  torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError):
        sweep_kernel.span_run_max_carry(torch.zeros(8, dtype=torch.int64), y, lo, hi, 0, 0,
                                        torch.zeros(1, dtype=torch.bool),
                                        torch.zeros((), dtype=torch.int32))


def test_edge_cases_show_their_edges():
    """The shards above hold what they are meant to: a run over a whole
    shard and across several boundaries, n not divisible by the world and
    a shard of pads alone, a leaf whose augmented span crosses a shard
    boundary, and empty clips of non-empty leaves."""
    seen = set()
    for keys_np, world, B in EDGE_CASES.values():
        shards, n, m = _shards(keys_np, world)
        _, spans = _leaves(keys_np, n, B)
        runs = np.unique(keys_np, return_counts=True)[1]
        if runs.max() >= 2 * m:
            seen.add("run over a whole shard")
        if n % world:
            seen.add("n not divisible")
        if any(r * m >= n for r in range(world)):
            seen.add("a shard of pads")
        bounds = torch.arange(1, world) * m
        lo, hi = spans.aug_starts, spans.aug_ends
        if ((lo[:, None] < bounds) & (bounds < hi[:, None])).any():
            seen.add("augmented span across a shard")
        for r in range(world):
            local = _clip(spans, m, r)
            if ((local.aug_starts == local.aug_ends) & spans.nonempty).any():
                seen.add("empty clip of a leaf")
    assert seen == {"run over a whole shard", "n not divisible", "a shard of pads",
                    "augmented span across a shard", "empty clip of a leaf"}


def _trace_tool():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "trace_torch_build.py"
    spec = importlib.util.spec_from_file_location("trace_torch_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_op_census_counts_the_m_sized_operators():
    """tools/trace_torch_build.py's census (its --dp trace and the card's
    one-rank dp test count the build's torch operators over m elements
    with it): an elementwise pass, a copy and a gather by an [m] index
    over m; a binary search of a few queries, a gather by a short index, a
    view (an empty one too), a fill of a few rows and a [B] op under it."""
    tool = _trace_tool()
    m, B = 4096, 64
    keys = torch.arange(m, dtype=torch.int64)
    t = torch.zeros(m, dtype=torch.int32)
    census = tool.OpCensus()
    with census:
        torch.searchsorted(keys, torch.arange(B))           # few read
        keys[[0, -1]]                                       # a short gather
        keys[:m - 3]                                        # a view
        t[m:] = 1                                           # an empty view, filled
        t[m - 2:] = B - 1                                   # two rows filled
        torch.zeros(B).add_(1.0)                            # [B]
    assert tool.m_sized(census.ops, m) == {}
    census = tool.OpCensus()
    with census:
        keys + 1                                            # elementwise over m
        keys.clone()                                        # a copy of m
        idx = torch.arange(m)                               # m written
        keys[idx]                                           # a gather of m
        torch.searchsorted(keys, keys)                      # m queries
    assert tool.m_sized(census.ops, m) == {"aten::add": 1, "aten::clone": 1,
                                           "aten::arange": 1, "aten::index": 1,
                                           "aten::searchsorted": 1}


def test_profiled_device_ops_over_m():
    """The profiler's side of the --dp check (device_ops_over): the
    device operations a torch operator launched, counted where one of its
    recorded inputs (a tensor list by its largest) holds m elements or
    more and it is not a gather or a search."""
    from types import SimpleNamespace as Evt
    tool = _trace_tool()
    m = 1000
    events = [Evt(name="aten::add", kernels=[1], input_shapes=[[m], []]),
              Evt(name="aten::cat", kernels=[1, 2], input_shapes=[[[3], [m, 2]]]),
              Evt(name="aten::searchsorted", kernels=[1], input_shapes=[[m], [4]]),
              Evt(name="aten::mul", kernels=[1], input_shapes=[[m - 1], []]),
              Evt(name="aten::slice", kernels=[], input_shapes=[[m], [], [], [], []]),
              Evt(name="rmi_fixdups_carry", kernels=[1], input_shapes=[])]
    prof = Evt(events=lambda: events)
    assert tool.device_ops_over(prof, m) == {"aten::add": 1, "aten::cat": 2}
