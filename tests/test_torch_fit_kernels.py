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
FIT_EDGES = ("books", "sparse", "single", "chunk_edges", "long", "trimmed", "dups")


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


def fit_mirror(x, y, lo, hi):
    """What rmi_aug_fit_moments computes, in its order, in numpy f64 (and
    Python ints for the sum of y): (mean_x, mean_y, m2, c), [B] each."""
    out = np.zeros((4, lo.shape[0]))
    for j, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        chunks = [(s, min(b, s + CHUNK)) for s in range(a, b, CHUNK)] or [(a, a)]
        xs = [x[s:e] for s, e in chunks]
        ys = [y[s:e].astype(np.int64) for s, e in chunks]
        sx = [_warp_sum(_lanes(c)) for c in xs]
        sy = [int(sum(c.tolist())) for c in ys]
        if len(chunks) > 1:
            sx, sy = [_warp_sum(_lanes(sx))], [sum(sy)]
        cnt = max(float(b - a), 1.0)
        mx, my = sx[0] / cnt, float(sy[0]) / cnt
        m2 = [_warp_sum(_lanes((c - mx) * (c - mx))) for c in xs]
        cc = [_warp_sum(_lanes((c - mx) * (d.astype(np.float64) - my)))
              for c, d in zip(xs, ys)]
        if len(chunks) > 1:
            m2, cc = [_warp_sum(_lanes(m2))], [_warp_sum(_lanes(cc))]
        out[:, j] = mx, my, m2[0], cc[0]
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
                                  "cubic,lognormal", "linear,loglinear"])
def test_leaf_fits_take_the_wrapper(monkeypatch, spec):
    """The linear, robust_linear, normal and lognormal leaf fits call
    aug_fit_moments once, with the int32 FixDups targets (none for the
    normal forms); loglinear leaves keep K2 weighted and the top fits
    their whole-array sums, and do not call it."""
    calls = []
    real = select_kernel.aug_fit_moments

    def counting(x, y, lo, hi):
        calls.append(None if y is None else y.dtype)
        return real(x, y, lo, hi)
    monkeypatch.setattr(select_kernel, "aug_fit_moments", counting)
    keys = np.sort(np.random.default_rng(3).integers(0, 1 << 62, 20_000, dtype=np.uint64))
    rt.train(rdata.RMIDataset.from_numpy(keys, device="cpu"), spec, 64)
    leaf = spec.split(",")[1]
    want = {"linear": [torch.int32], "robust_linear": [torch.int32], "normal": [None],
            "lognormal": [None], "loglinear": []}[leaf]
    assert calls == want
