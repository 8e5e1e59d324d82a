"""The leaf fits' moments and FixDups (rmi_aug_fit_moments and rmi_fixdups)
on the CPU: their wrappers' plain versions, the edge cases the card tests
share, and a mirror of the fit kernel's summation order.

On the CPU ``select_kernel.aug_fit_moments`` and ``scan_kernel.fixdups``
run their plain versions, which must be the build's composition before
the kernels, bit for bit (the range sums as prefix-sum differences, the
means, K2's plain terms; FixDups' arange, compare, select and running
max), so every CPU build keeps its bits.  tests/test_torch_kernels_ref.py
holds them to rmi_tpu; tests/test_torch_cuda_kernels.py holds the kernels
to them on the card, on these cases (no jax here: the card's machine has
none).  ``fit_mirror`` adds a leaf's keys in the kernel's order (csrc/
moments.cu: lane-strided, a butterfly of shuffles, a long leaf's chunks
in chunk order), so that fit_tolerance, the card's bound against the
plain version, is tried here on what the kernel computes.
"""

import numpy as np
import pytest
import torch

import rmi_tpu_torch as rt
from rmi_tpu_torch import data as rdata
from rmi_tpu_torch import keys as tkeys
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.models import linear
from rmi_tpu_torch.ops import scan_kernel, select_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

CHUNK = select_kernel.FIT_CHUNK
WARP = scan_kernel.FIXDUPS_WARP_KEYS

# leaf key counts of "chunk_edges": augmented spans of chunk - 1 .. chunk + 1
# keys and of two and three chunks, one-key and empty leaves
CHUNK_EDGE_COUNTS = (CHUNK - 2, CHUNK - 1, CHUNK, 1, 0, 2 * CHUNK - 2, 2 * CHUNK - 1, 0,
                     3 * CHUNK + 1, 5)
FIT_EDGES = ("books", "sparse", "single", "chunk_edges", "long", "trimmed", "dups",
             "first_run", "long_first_run")
# leaf key counts of the first-run cases: the first run (FixDups target 0,
# ln y = -inf: every key dropped by the loglinear fit) covers two leaves
# whole ("first_run"), or a leaf of two chunks whole and the next leaf's
# first chunks ("long_first_run")
FIRST_RUN_COUNTS = {"first_run": ((100, 150, 1, 0, 200, 2549), 300),
                    "long_first_run": ((5000, 9000, 1, 0, 4000, 13767), 3 * CHUNK + 5)}


# the top fits' key sets (ops/top_kernel.py): top_fit_case
TOP_FIT_EDGES = ("u64", "u32", "f64", "dups", "f64_edges", "clustered")


def top_fit_case(kind, n, seed=0):
    """(sorted images, key type) of n keys of ``kind`` for the top fits,
    made from a seed: u64, u32 and f64 keys with runs of equal keys (f64
    across 0), n equal keys, f64 keys with NaN, -inf, both zeros and +inf
    among them (the images put NaN first), and u64 keys in two clusters
    2^62 apart, whose hint tables hold runs of empty slots."""
    rng = np.random.default_rng(seed + len(kind))

    def runs(v):
        return np.repeat(v, rng.integers(1, 4, v.size))[:n]
    key_type = KeyType.U64
    if kind in CANDIDATE_EDGES:
        return candidate_case(kind, n, rng)
    if kind == "u32":
        keys, key_type = runs(rng.integers(0, 2 ** 32, n, dtype=np.uint64)).astype(np.uint32), \
            KeyType.U32
    elif kind in ("f64", "f64_edges"):
        keys, key_type = runs(rng.normal(0.0, 1e6, n)), KeyType.F64
        if kind == "f64_edges":
            keys[:5] = np.array([np.nan, -np.inf, -0.0, 0.0, np.inf])[:n]
    elif kind == "dups":
        keys = np.full(n, 123456789, dtype=np.uint64)
    elif kind == "clustered":
        keys = np.concatenate([rng.integers(2 ** 40, 2 ** 40 + 2 ** 20, n // 2, dtype=np.uint64),
                               rng.integers(2 ** 62, 2 ** 62 + 2 ** 30, n - n // 2,
                                            dtype=np.uint64)])
    else:
        keys = runs(rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64, endpoint=True))
    return tkeys.to_image(keys).sort().values, key_type


# the cubic candidates' further key sets (rmi_top_cubic_candidates' two
# searches): candidate_case
CANDIDATE_EDGES = ("end_runs", "f64_nan_led", "f64_ninf_led", "f64_pinf", "f64_pinf_end")


def candidate_case(kind, n, rng):
    """(sorted images, key type) of n keys for the cubic top's searches:
    u64 keys whose first and last n // 3 are equal (runs the search walks
    through); f64 keys led by NaN or -inf, all +inf, or ending in +inf
    (x all NaN under the first three, x 0 then NaN under the last: the
    norm constants' span is NaN or inf)."""
    if kind == "end_runs":
        r = n // 3
        mid = np.sort(rng.integers(1, 2 ** 63, n - 2 * r, dtype=np.uint64))
        keys = np.concatenate([np.zeros(r, np.uint64), mid,
                               np.full(r, 2 ** 64 - 1, np.uint64)])
        return tkeys.to_image(keys).sort().values, KeyType.U64
    keys = rng.normal(0.0, 1e6, n)
    if kind == "f64_nan_led":
        keys[:7] = np.nan
    elif kind == "f64_ninf_led":
        keys[:40] = -np.inf
    elif kind == "f64_pinf":
        keys[:] = np.inf
    else:
        keys[:40] = np.inf
    return tkeys.to_image(keys).sort().values, KeyType.F64


# the hint-table fit's key sets (rmi_top_table_fit): table_edge_case
TABLE_EDGES = ("books", "books_u32", "books_f64", "one_bucket", "skips", "one_key")


def table_edge_case(kind, seed=0):
    """(integer-key images, int32 FixDups of the keys, sf) of ``kind``,
    made from a seed: 2^22 books-like keys (data.books_like_on_device on
    the CPU) as u64, shifted right by 30 as u32, and cast to f64 and
    scaled by 2^-32 (their truncated integer images, keys.int_image);
    2^16 equal keys (all in one bucket); top_fit_case's two clusters 2^62
    apart at 2^20 keys (runs of empty slots between them); one key.  sf
    is 65536 / n, path 5's."""
    if kind.startswith("books"):
        u = rdata.books_like_on_device(1 << 22, seed, torch.device("cpu"))
        if kind == "books_u32":
            img = (tkeys.u64_bits(u) >> 30).add_(tkeys.IMAGE_MIN)
            ints = img
        elif kind == "books_f64":
            img = tkeys.f64_image(tkeys.as_float(u).mul_(2.0 ** -32))
            ints = tkeys.int_image(img, KeyType.F64)
        else:
            img = ints = u
    else:
        case, n = {"one_bucket": ("dups", 1 << 16), "skips": ("clustered", 1 << 20),
                   "one_key": ("u64", 1)}[kind]
        img, key_type = top_fit_case(case, n, seed)
        ints = tkeys.int_image(img, key_type)
    return ints, scan_kernel.fixdups(img), 65536 / img.shape[0]


def _fixdups_np(x):
    first = np.concatenate([[True], x[1:] != x[:-1]])
    return np.maximum.accumulate(np.where(first, np.arange(x.shape[0]), 0)).astype(np.int32)


def leaf_arrays(n, B, seed, keep=0.95, counts=None):
    """(x f64, FixDups y int32, leaf ids t int32) as numpy, made from a
    seed: n sorted normalized keys, a share ``keep`` of them starting a
    new run of equal keys, and their B leaves, non-decreasing: floor(x B),
    or ``counts`` keys each."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.exponential(size=n) * (rng.random(n) < keep))
    x = (x - x[0]) / max(x[-1] - x[0], 1.0)
    t = (np.repeat(np.arange(B), counts) if counts is not None
         else np.clip(np.floor(x * B), 0, B - 1))
    return x, _fixdups_np(x), t.astype(np.int32)


def fit_arrays(kind):
    """(x, y, t, B, trim) of edge case ``kind``: leaf_arrays', and
    whether the build trims the spans (robust_linear)."""
    seed = FIT_EDGES.index(kind) + 40
    if kind in FIRST_RUN_COUNTS:
        counts, run = FIRST_RUN_COUNTS[kind]
        counts = np.array(counts)
        x, _, t = leaf_arrays(int(counts.sum()), counts.shape[0], seed, counts=counts)
        x[:run] = x[0]
        return x, _fixdups_np(x), t, counts.shape[0], False
    if kind == "chunk_edges":
        counts = np.array(CHUNK_EDGE_COUNTS)
        return (*leaf_arrays(int(counts.sum()), counts.shape[0], seed, counts=counts),
                counts.shape[0], False)
    n, B = {"books": ((1 << 15) + 517, 1024), "sparse": (3001, 4096), "single": (1, 2),
            "long": (1 << 16, 3), "trimmed": (1 << 16, 3), "dups": (50_000, 64)}[kind]
    return (*leaf_arrays(n, B, seed, keep=0.2 if kind == "dups" else 0.95), B,
            kind == "trimmed")


def fit_case(kind):
    """(x, y, aug_starts, aug_ends) CPU tensors of ``kind``: the spans the
    build fits (robust_linear's trimmed ones for "trimmed")."""
    x, y, t, B, trim = fit_arrays(kind)
    spans = seg.make_spans(torch.from_numpy(t), B)
    if trim:
        spans = linear.trimmed(spans)
    return torch.from_numpy(x), torch.from_numpy(y), spans.aug_starts, spans.aug_ends


FIXDUPS_EDGES = ("empty", "one", "all_equal", "unique", "runs_cross_warps",
                 "run_over_many_warps", "ragged", "dups")


def fixdups_case(kind):
    """Sorted int64 key images of ``kind`` (n at most 2^16), from a seed:
    runs that end just past a warp's first key, a run over many warps'
    keys, every key one run, n not a multiple of a warp's keys."""
    rng = np.random.default_rng(FIXDUPS_EDGES.index(kind) + 70)
    if kind == "empty":
        keys = np.zeros(0, np.int64)
    elif kind == "one":
        keys = np.array([-5], np.int64)
    elif kind == "all_equal":
        keys = np.full(5 * WARP + 3, 1 << 40, np.int64)
    elif kind == "unique":
        keys = np.sort(rng.choice(1 << 50, 3 * WARP + 7, replace=False)).astype(np.int64)
    elif kind == "runs_cross_warps":
        # runs of 2 .. 70 keys starting 1 .. 40 keys before each warp's first
        keys = np.arange(16 * WARP, dtype=np.int64) * 3 - (1 << 62)
        for w in range(1, 16):
            s = w * WARP - int(rng.integers(1, 41))
            keys[s:s + int(rng.integers(2, 71))] = keys[s]
    elif kind == "run_over_many_warps":
        keys = np.concatenate([np.arange(100), np.full(9 * WARP + 11, 100),
                               np.arange(101, 1000)]).astype(np.int64)
    elif kind == "ragged":
        keys = np.sort(rng.integers(-(1 << 62), 1 << 62, 7 * WARP + 1234))
    else:
        keys = np.sort(np.repeat(rng.integers(0, 1 << 62, 20_000),
                                 rng.geometric(0.4, 20_000)))[:1 << 16]
    return torch.from_numpy(keys.astype(np.int64))


# -- FixDups -----------------------------------------------------------------

def _fixdups_composition(keys):
    """two_layer.fixdups_i32 before the kernel, written out."""
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int32)
    changed = torch.ones(n, dtype=torch.bool)
    torch.ne(keys[1:], keys[:-1], out=changed[1:])
    return torch.cummax(torch.where(changed, idx, 0), 0).values


@pytest.mark.parametrize("kind", FIXDUPS_EDGES)
def test_fixdups_cpu_is_the_composition(kind):
    """On the CPU fixdups_i32 is its plain version, the composition it was,
    bit for bit, and each key's lower bound among the keys."""
    keys = fixdups_case(kind)
    got = two_layer.fixdups_i32(keys)
    assert got.dtype == torch.int32 and got.shape == keys.shape
    assert torch.equal(got, _fixdups_composition(keys))
    assert torch.equal(got, scan_kernel.fixdups_plain(keys))
    lb = np.searchsorted(keys.numpy(), keys.numpy(), side="left")
    np.testing.assert_array_equal(got.numpy(), lb)


def test_fixdups_refuses_bad_keys():
    for bad in (torch.zeros(4, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int64),
                torch.zeros(4, dtype=torch.float64)):
        with pytest.raises(ValueError, match="fixdups"):
            scan_kernel.fixdups(bad)


# -- the leaf fits' moments ----------------------------------------------------

def _fit_composition(x, y, lo, hi):
    """_slr_ranges' and _ncdf_ranges' statistics before the kernel,
    written out: (mean_x, mean_y, m2, c) and the normal fit's (mean, m2)."""
    cnt = (hi - lo).double()
    safe = cnt.clamp(min=1.0)
    yf = y.double()
    mean_x = seg.range_sum(x, lo, hi) / safe
    mean_y = seg.range_sum(yf, lo, hi) / safe
    m2, c = select_kernel.aug_centered_moments_plain(x, yf, mean_x, mean_y, lo, hi)
    mean = torch.where(cnt == 0, 0.0, seg.range_sum(x, lo, hi) / safe)
    return (mean_x, mean_y, m2, c), (mean, select_kernel.aug_centered_xx_plain(x, mean, lo, hi))


def _bits(t):
    return t.view(torch.int64)


@pytest.mark.parametrize("kind", FIT_EDGES)
def test_fit_moments_cpu_is_the_composition(kind):
    """On the CPU aug_fit_moments (both forms) is the fits' composition
    before the kernel, bit for bit."""
    x, y, lo, hi = fit_case(kind)
    want_lin, want_xx = _fit_composition(x, y, lo, hi)
    got_lin = select_kernel.aug_fit_moments(x, y, lo, hi)
    got_xx = select_kernel.aug_fit_moments(x, None, lo, hi)
    assert len(got_lin) == 4 and len(got_xx) == 2
    for got, want in zip((*got_lin, *got_xx), (*want_lin, *want_xx)):
        assert got.dtype == torch.float64 and got.shape == lo.shape
        assert torch.equal(_bits(got), _bits(want))


def test_fit_moments_refuses_bad_inputs():
    x, y, lo, hi = fit_case("books")
    bad = [(x.float(), y, lo, hi), (x, y.long(), lo, hi), (x, y[:-1], lo, hi),
           (x, y, lo.int(), hi), (x, y, lo, hi[:-1]), (x[None], y, lo, hi)]
    for args in bad:
        with pytest.raises(ValueError, match="aug_fit_moments"):
            select_kernel.aug_fit_moments(*args)


def _warp_sum(v):
    """csrc/moments.cu warp_sum: 32 lanes' values by xor shuffles, as the
    card adds them (each step a pair, the same bits in either order)."""
    v = list(v)
    for off in (16, 8, 4, 2, 1):
        v = [v[lane] + v[lane ^ off] for lane in range(32)]
    assert len(set(np.asarray(v).view(np.int64).tolist())) == 1
    return v[0]


def _lanes(values, start=0.0):
    """Lane l's sum of values[l], values[l + 32], ... in sequence."""
    acc = [start] * 32
    for i, v in enumerate(values):
        acc[i % 32] = acc[i % 32] + v
    return acc


def fit_mirror(x, y, lo, hi, log=False):
    """What rmi_aug_fit_moments computes, in its order, in numpy f64 (and
    Python ints for the sum of y): (mean_x, mean_y, m2, c), [B] each; with
    ``log``, rmi_aug_fit_log_moments' (cnt, mean_x, mean_y, m2, c), its ln
    y torch's log on the CPU, a dropped key's terms 0.0 as the kernel adds
    them."""
    if log:
        ln = torch.log(torch.from_numpy(y).double()).numpy()
        keep = np.isfinite(ln)
        ln = np.where(keep, ln, 0.0)
    out = np.zeros((5 if log else 4, lo.shape[0]))
    for j, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        chunks = [(s, min(b, s + CHUNK)) for s in range(a, b, CHUNK)] or [(a, a)]
        if log:
            xs = [np.where(keep[s:e], x[s:e], 0.0) for s, e in chunks]
            ys = [ln[s:e] for s, e in chunks]
            ws = [keep[s:e] for s, e in chunks]
            sy = [_warp_sum(_lanes(c)) for c in ys]
            n_kept = sum(int(w.sum()) for w in ws)
        else:
            xs = [x[s:e] for s, e in chunks]
            ys = [y[s:e].astype(np.int64) for s, e in chunks]
            ws = [np.ones(e - s, bool) for s, e in chunks]
            sy = [int(sum(c.tolist())) for c in ys]
            n_kept = b - a
        sx = [_warp_sum(_lanes(c)) for c in xs]
        if len(chunks) > 1:
            sx = [_warp_sum(_lanes(sx))]
            sy = [_warp_sum(_lanes(sy))] if log else [sum(sy)]
        cnt = max(float(n_kept), 1.0)
        mx, my = sx[0] / cnt, float(sy[0]) / cnt
        dxs = [np.where(w, c - mx, 0.0) for c, w in zip(xs, ws)]
        m2 = [_warp_sum(_lanes(d * d)) for d in dxs]
        cc = [_warp_sum(_lanes(d * np.where(w, v.astype(np.float64) - my, 0.0)))
              for d, v, w in zip(dxs, ys, ws)]
        if len(chunks) > 1:
            m2, cc = [_warp_sum(_lanes(m2))], [_warp_sum(_lanes(cc))]
        out[:, j] = (n_kept, mx, my, m2[0], cc[0]) if log else (mx, my, m2[0], cc[0])
    return torch.from_numpy(out)


@pytest.mark.parametrize("kind", [k for k in FIT_EDGES if k != "books"])
def test_fit_mirror_within_tolerance(kind):
    """The kernel's arithmetic, mirrored, lies within fit_tolerance of the
    plain version on every edge case, its mean of y from the exact sum."""
    x, y, lo, hi = fit_case(kind)
    want = select_kernel.aug_fit_moments_plain(x, y, lo, hi)
    got = fit_mirror(x.numpy(), y.numpy(), lo, hi)
    tol = select_kernel.fit_tolerance(x, y, lo, hi, want)
    for g, w, t in zip(got, want, tol):
        assert ((g - w).abs() <= t).all()
    exact = [sum(y[a:b].tolist()) / max(b - a, 1) for a, b in zip(lo.tolist(), hi.tolist())]
    assert got[1].tolist() == exact


# -- the loglinear leaf fit's moments (rmi_aug_fit_log_moments) -----------------

def _log_chain(x, y, lo, hi):
    """_slr_ranges' weighted statistics before the kernel, written out:
    log_targets, the masked range sums, the means, K2 weighted's terms."""
    ln, w = linear.log_targets(y.double())
    cnt = seg.range_sum(w, lo, hi)
    safe = cnt.clamp(min=1.0)
    mean_x = seg.range_sum(x * w, lo, hi) / safe
    mean_y = seg.range_sum(ln * w, lo, hi) / safe
    return (cnt, mean_x, mean_y, *select_kernel.aug_centered_moments_plain(
        x, ln, mean_x, mean_y, lo, hi, weights=w))


@pytest.mark.parametrize("kind", FIT_EDGES)
def test_log_fit_cpu_is_the_chain(kind):
    """On the CPU aug_fit_log_moments is the loglinear fit's chain before
    the kernel, bit for bit, and the model's leaf rows are
    _loglinear_fit's on f64 targets; leaves of the first run alone count
    no key and fit (0, 0)."""
    x, y, lo, hi = fit_case(kind)
    got = select_kernel.aug_fit_log_moments(x, y, lo, hi)
    assert len(got) == 5
    for g, w in zip(got, _log_chain(x, y, lo, hi)):
        assert g.dtype == torch.float64 and g.shape == lo.shape
        assert torch.equal(_bits(g), _bits(w))
    _, _, t, B, trim = fit_arrays(kind)
    if trim:
        return
    spans = seg.make_spans(torch.from_numpy(t), B)
    rows = linear._loglinear_leaves(x, y, spans)
    assert torch.equal(_bits(rows), _bits(linear._loglinear_fit(x, y.double(), spans)))
    dropped = (got[0] == 0) & (hi > lo)
    assert (kind not in FIRST_RUN_COUNTS) or int(dropped.sum()) >= 1
    assert (rows[dropped] == 0).all()


@pytest.mark.parametrize("kind", [k for k in FIT_EDGES if k != "books"])
def test_log_fit_mirror_within_tolerance(kind):
    """The log form's arithmetic, mirrored, lies within fit_tolerance's log
    form of the plain version on every edge case, its count exact."""
    x, y, lo, hi = fit_case(kind)
    want = select_kernel.aug_fit_log_moments_plain(x, y, lo, hi)
    got = fit_mirror(x.numpy(), y.numpy(), lo, hi, log=True)
    tol = select_kernel.fit_tolerance(x, y, lo, hi, want, log_form=True)
    for g, w, t in zip(got, want, tol):
        assert ((g - w).abs() <= t).all()
    assert torch.equal(got[0], want[0]) and not tol[0].any()


def test_log_fit_tolerance_is_needed():
    """On 1024 leaves the mirrored kernel's mean of ln y and its moments
    differ from the plain version's prefix-sum differences on some leaves,
    within fit_tolerance's log form, which is nonzero wherever a key is
    kept and 0 for the count."""
    x, y, lo, hi = fit_case("books")
    want = select_kernel.aug_fit_log_moments_plain(x, y, lo, hi)
    got = fit_mirror(x.numpy(), y.numpy(), lo, hi, log=True)
    tol = select_kernel.fit_tolerance(x, y, lo, hi, want, log_form=True)
    kept = want[0] > 0
    assert int(kept.sum()) > 1000 and not tol[0].any()
    for i in (1, 2, 3, 4):
        assert (tol[i][kept] > 0).all()
        assert ((got[i] - want[i]).abs() <= tol[i]).all()
    assert int((got[2] != want[2]).sum()) > 0


def test_log_fit_refuses_bad_inputs():
    x, y, lo, hi = fit_case("books")
    bad = [(x.float(), y, lo, hi), (x, y.long(), lo, hi), (x, y[:-1], lo, hi),
           (x, None, lo, hi), (x, y, lo.int(), hi), (x, y, lo, hi[:-1])]
    for args in bad:
        with pytest.raises(ValueError, match="aug_fit_log_moments"):
            select_kernel.aug_fit_log_moments(*args)


@pytest.mark.parametrize("kind", FIT_EDGES)
def test_fit_capacity_holds_every_chunk(kind):
    """fit_capacity's slots hold the chunks of every leaf longer than a
    chunk, for the spans the build fits."""
    x, _, lo, hi = fit_case(kind)
    length = hi - lo
    chunks = int(((length + CHUNK - 1) // CHUNK)[length > CHUNK].sum())
    assert chunks <= select_kernel.fit_capacity(x.shape[0], lo.shape[0])
    assert int(length.sum()) <= x.shape[0] + 2 * lo.shape[0]


@pytest.mark.parametrize("spec", ["cubic,linear", "radix18,robust_linear", "linear,normal",
                                  "cubic,lognormal", "linear,loglinear", "loglinear,linear"])
def test_leaf_fits_take_the_wrapper(monkeypatch, spec):
    """The linear, robust_linear, normal and lognormal leaf fits call
    aug_fit_moments once, with the int32 FixDups targets (none for the
    normal forms); loglinear leaves call aug_fit_log_moments once, with
    the same targets, and K2 weighted not at all; the top fits keep their
    whole-array sums and call neither (a loglinear top: K2 weighted's
    whole-array form)."""
    calls = []
    for name in ("aug_fit_moments", "aug_fit_log_moments", "aug_centered_moments"):
        def counting(*args, _real=getattr(select_kernel, name), _name=name, **kw):
            y = args[1]
            calls.append((_name, None if y is None else y.dtype))
            return _real(*args, **kw)
        monkeypatch.setattr(select_kernel, name, counting)
    keys = np.sort(np.random.default_rng(3).integers(0, 1 << 62, 20_000, dtype=np.uint64))
    rt.train(rdata.RMIDataset.from_numpy(keys, device="cpu"), spec, 64)
    leaf = spec.split(",")[1]
    fit = "aug_fit_log_moments" if leaf == "loglinear" else "aug_fit_moments"
    y = None if leaf in ("normal", "lognormal") else torch.int32
    assert calls == [(fit, y)]
