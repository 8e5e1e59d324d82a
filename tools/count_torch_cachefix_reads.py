"""The reads rmi_bounded_lower_bound and rmi_cachefix_interp make a query:
a host replay of csrc/cachefix.cu's search, on the key shapes of
chip_smoke.py's paths 8, 11 and 6b.

    python3 tools/count_torch_cachefix_reads.py [--n 4194304] [--queries 16384]

The replay (``bounded``, ``interp_res``, ``interp``) follows the kernels
read for read, all queries of a batch in lockstep: a search narrows a
bracket (p, r] by whole 32-byte sectors (four int64 entries, placed by
the array's address: ``off`` is the entry offset of a[0] inside its
sector), a window wider than ENDS_ABOVE entries reads its two ends'
sectors first, both in one round, then each read is placed where the
ends' values put q (INTERP_ROUNDS times at most) or in the middle, and
the one sector left is read whole; the interpolation searches the knots'
sample (knots[::KNOT_STRIDE]) first where a window holds more than
KNOT_STRIDE knots, then reads the pair's values.  A read of a
sector is one dependent read (two 16-byte loads on the card); a round
may read two sectors (a window's ends).  Where the trip count does not
cover a window, the replay halves as the plain version does.  Its answers
are checked against the plain versions (ops/cachefix_kernel.py).

Shapes, each at --n keys (200M on the card):
  path8          bounded_search on ``linear,linear`` with max(2, 100 n /
                 200M) leaves over u32 keys of path 8's gaps (books-like
                 keys >> 30: exponential gaps of mean 2^32 / 200M,
                 rounded), queries uniform over the keys, 1/16 of them keys;
  osm, wiki      path 11's cache_fix_osm (``cubic,linear``, 786432 leaves
                 at 200M) and cache_fix_wiki (``linear_spline,linear``,
                 4194304) lookups of keys drawn at random: the knots'
                 search and the values, leaves scaled with n (osm's
                 clusters hold ~4096 keys at every n; the wiki keys are a
                 slice of the 200M keys' range at their density);
  books          path 6b (``linear_spline,linear 4194304 --bounded 8`` on
                 books-like keys);
  osm_search, wiki_search
                 the cachefix ``search`` with the original keys (exact
                 mode) of queries uniform over the keys, 1/16 keys;
  wiki_missed    that search of queries just after a duplicate run's last
                 key whose window misses their lower bound (the whole
                 array searched).
The counts are the replay's, not read from the card.  Prints one JSON
line: per shape the dependent reads a query (rounds), the distinct
32-byte sectors of the keys or knots (device memory at 200M keys), of the
sample (L2) and of the values, and the halving search's reads and
sectors over the same windows (the design before, values aside).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rmi_tpu_torch.ops.cachefix_kernel import (KNOT_STRIDE, bounded_lower_bound_plain,  # noqa: E402
                                               interp_iters, knot_positions)

ENDS_ABOVE = 32       # csrc/cachefix.cu's kEndsAbove
INTERP_ROUNDS = 4     # kInterpRounds


class Reads:
    """Each query's dependent reads (rounds) and the sectors it reads."""

    def __init__(self, m):
        self.rounds = np.zeros(m, np.int64)
        self.pairs = []

    def read(self, sel, *sectors):
        """One round for the queries ``sel``, each reading one sector of
        every array in ``sectors``."""
        self.rounds[sel] += 1
        self.pairs += [(sel, s) for s in sectors]

    def sectors(self):
        """[m] distinct sectors a query read."""
        out = np.zeros(self.rounds.shape[0], np.int64)
        if self.pairs:
            qi = np.concatenate([p[0] for p in self.pairs])
            s = np.concatenate([p[1] for p in self.pairs])
            qi = np.unique(np.stack([qi, s], 1), axis=0)[:, 0]
            out += np.bincount(qi, minlength=out.shape[0])
        return out


def sector_of(j, off):
    """The first entry of the sector that holds entry j."""
    return ((j + off) & ~3) - off


class Bracket:
    """The kernel's Bracket for every query: the answer in (p, r], the
    values at the ends that were read."""

    def __init__(self, p, r):
        m = p.shape[0]
        self.p, self.r = p.copy(), r.copy()
        self.lov, self.hiv = np.zeros(m, np.int64), np.zeros(m, np.int64)
        self.has_lo, self.has_hi = np.zeros(m, bool), np.zeros(m, bool)


def _narrow(a, b, sel, s, q):
    """Narrow b at the queries sel by the sector at s (entries outside
    a are never inside a bracket)."""
    for t in range(4):
        j = s + t
        inside = (j > b.p[sel]) & (j < b.r[sel])
        v = a[np.clip(j, 0, a.shape[0] - 1)]
        lt = v < q[sel]
        up, down = sel[inside & lt], sel[inside & ~lt]
        b.p[up], b.lov[up], b.has_lo[up] = j[inside & lt], v[inside & lt], True
        b.r[down], b.hiv[down], b.has_hi[down] = j[inside & ~lt], v[inside & ~lt], True


def finish(a, off, q, b, reads):
    """The kernel's finish: narrow every bracket to one entry."""
    rounds = np.full(q.shape[0], INTERP_ROUNDS)
    while True:
        sel = np.flatnonzero(b.r - b.p > 1)
        if sel.size == 0:
            return b
        p, r = b.p[sel], b.r[sel]
        first, last = p + 1, r - 1
        one = sector_of(first, off) == sector_of(last, off)
        lerp = ~one & b.has_lo[sel] & b.has_hi[sel] & (rounds[sel] > 0)
        rounds[sel[lerp]] -= 1
        # the differences from lov as u64, exact, then rounded to doubles
        lov = b.lov[sel].astype(np.uint64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            f = ((q[sel].astype(np.uint64) - lov).astype(np.float64)
                 / (b.hiv[sel].astype(np.uint64) - lov).astype(np.float64))
        f = np.fmin(np.fmax(f, 0.0), 1.0)
        at = np.minimum(first + (np.where(lerp, f, 0.0)
                                 * (r - p - 1).astype(np.float64)).astype(np.int64), last)
        j = np.where(one, first, np.where(lerp, at, p + ((r - p) >> 1)))
        s = sector_of(j, off)
        reads.read(sel, s)
        _narrow(a, b, sel, s, q)


def window(a, off, q, lo, hi, reads):
    """The kernel's window: the bracket of each window [lo, hi), narrowed."""
    b = Bracket(lo - 1, hi)
    wide = np.flatnonzero(hi - lo > ENDS_ABOVE)
    s0, s1 = sector_of(lo[wide], off), sector_of(hi[wide] - 1, off)
    reads.read(wide, s0, s1)
    _narrow(a, b, wide, s0, q)
    _narrow(a, b, wide, s1, q)
    return finish(a, off, q, b, reads)


def halving(a, q, lo, hi, iters, reads):
    """The plain version's fixed-trip halving, for windows ``iters`` does
    not cover."""
    lo, hi = lo.copy(), hi.copy()
    for _ in range(iters):
        sel = np.flatnonzero(lo < hi)
        if sel.size == 0:
            break
        mid = (lo[sel] + hi[sel]) >> 1
        reads.read(sel, sector_of(mid, 0))
        right = a[mid] < q[sel]
        lo[sel[right]] = mid[right] + 1
        hi[sel[~right]] = mid[~right]
    return lo


def bit_length(w):
    """Halving steps that end a search of w entries (0 for w <= 0)."""
    return np.array([int(x).bit_length() if x > 0 else 0 for x in w], np.int64)


def windows(guess, err, n):
    """[lo, hi): guess -/+ err clamped to [0, n], wrapping as int64; hi
    no lower than lo (an empty window answers lo)."""
    with np.errstate(over="ignore"):
        lo = np.clip(guess - err, 0, n)
        return lo, np.maximum(np.clip(guess + err + 1, 0, n), lo)


def bounded(keys, q, guess, err, n, iters, exact=False, off=0, reads=None):
    """rmi_bounded_lower_bound's answers, read for read into ``reads``."""
    reads = reads if reads is not None else Reads(q.shape[0])
    lo, hi = windows(guess, err, n)
    covered = iters >= bit_length(hi - lo)
    out = np.empty(q.shape[0], np.int64)
    for sel, search in ((np.flatnonzero(covered), lambda *a: window(keys, off, *a).r),
                        (np.flatnonzero(~covered), lambda *a: halving(keys, *a[:3], iters,
                                                                      a[3]))):
        if sel.size:
            sub = _Sub(reads, sel)
            out[sel] = search(q[sel], lo[sel], hi[sel], sub.view())
            sub.merge()
    if not exact:
        return out
    last = keys[np.clip(out - 1, 0, keys.shape[0] - 1)]
    at = keys[np.clip(out, 0, keys.shape[0] - 1)]
    found = ((out == 0) | (last < q)) & ((out == n) | (at >= q))
    # the kernel reads the key beyond a covered window's edge only; a
    # short search's check reads keys[j - 1] and keys[j]
    edge = covered & ((out == lo) & (lo > 0) | (out == hi) & (hi < n))
    reads.read(np.flatnonzero(edge), sector_of(np.where(out == lo, lo - 1, hi)[edge], off))
    short = np.flatnonzero(~covered)
    reads.read(short, sector_of(np.maximum(out[short] - 1, 0), off))
    miss = np.flatnonzero(~found)
    if miss.size:
        sub = _Sub(reads, miss)
        out[miss] = window(keys, off, q[miss], np.zeros(miss.size, np.int64),
                           np.full(miss.size, n, np.int64), sub.view()).r
        sub.merge()
    return out


class _Sub:
    """The reads of a subset of the queries, merged back into the whole."""

    def __init__(self, reads, idx):
        self.reads, self.idx = reads, idx
        self.sub = Reads(idx.shape[0])

    def view(self):
        return self.sub

    def merge(self):
        self.reads.rounds[self.idx] += self.sub.rounds
        self.reads.pairs += [(self.idx[s], t) for s, t in self.sub.pairs]


def interp_res(knots, sample, q, start, err, off=0, sample_off=0, reads=None,
               sample_reads=None):
    """rmi_cachefix_interp's knot search: res for each query, its reads of
    the knots into ``reads`` and of the sample into ``sample_reads``."""
    num_pts, m = knots.shape[0], q.shape[0]
    reads = reads if reads is not None else Reads(m)
    sample_reads = sample_reads if sample_reads is not None else Reads(m)
    lo, hi = windows(start, err, num_pts)
    iters = interp_iters(num_pts)
    if (iters < bit_length(hi - lo)).any():
        raise AssertionError("interp_iters covers every window")
    res = np.empty(m, np.int64)
    small = np.flatnonzero(hi - lo <= KNOT_STRIDE)
    sub = _Sub(reads, small)
    res[small] = window(knots, off, q[small], lo[small], hi[small], sub.view()).r
    sub.merge()
    wide = np.flatnonzero(hi - lo > KNOT_STRIDE)
    if wide.size:
        lw, hw, qw = lo[wide], hi[wide], q[wide]
        k0 = (lw + KNOT_STRIDE - 1) // KNOT_STRIDE
        ssub = _Sub(sample_reads, wide)
        s = window(sample, sample_off, qw, k0, (hw - 1) // KNOT_STRIDE + 1, ssub.view())
        ssub.merge()
        b = Bracket(np.where(s.has_lo, s.p * KNOT_STRIDE, lw - 1),
                    np.where(s.has_hi, s.r * KNOT_STRIDE, hw))
        b.lov, b.hiv, b.has_lo, b.has_hi = s.lov, s.hiv, s.has_lo, s.has_hi
        sub = _Sub(reads, wide)
        res[wide] = finish(knots, off, qw, b, sub.view()).r
        sub.merge()
    return res


def interp(knots, vals, q, start, err, line_size, total_keys, off=0, sample_off=0,
           reads=None, sample_reads=None):
    """rmi_cachefix_interp's positions (knot_positions of interp_res)."""
    res = interp_res(knots, knots[::KNOT_STRIDE], q, start, err, off, sample_off, reads,
                     sample_reads)
    return knot_positions(*(torch.from_numpy(np.ascontiguousarray(x)) for x in
                            (knots, vals, q, res)), line_size, total_keys).numpy()


def value_sectors(res, num_pts, off=0):
    """Distinct sectors of the values a query reads: those of r - 1 and r."""
    r = np.clip(res, 1, max(num_pts - 1, 0))
    r0 = np.where(r - 1 < 0, r - 1 + num_pts, r - 1)
    return np.where(res >= num_pts, 0,
                    1 + (sector_of(r0, off) != sector_of(r, off)).astype(np.int64))


def _summary(reads, extra=None):
    out = {"reads": float(reads.rounds.mean()), "sectors": float(reads.sectors().mean())}
    return {**out, **(extra or {})}


def halving_summary(a, q, guess, err, n, iters, whole=False):
    """The reads of the halving design these kernels replaced: steps over each
    window, and with ``whole`` over all of a[0 : n] after them."""
    reads = Reads(q.shape[0])
    lo, hi = windows(guess, err, n)
    halving(a, q, lo, hi, iters, reads)
    if whole:
        zero = np.zeros(q.shape[0], np.int64)
        halving(a, q, zero, zero + n, n.bit_length() + 1, reads)
    return {"halving_reads": float(reads.rounds.mean()),
            "halving_sectors": float(reads.sectors().mean())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--queries", type=int, default=1 << 14)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    import rmi_tpu_torch as rt
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch.keys import KeyType, to_image
    from rmi_tpu_torch.lookup import _rmi_lookup, err_iters, lookup
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from count_torch_hier_reads import path8_keys

    n, nq = args.n, args.queries
    rng = np.random.default_rng(args.seed + 1)
    out = {"n": n, "queries": nq, "knot_stride": KNOT_STRIDE}

    def plain_bounded(keys, q, g, e, nn, iters, exact=False):
        t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (keys, q, g, e)]
        return bounded_lower_bound_plain(*t, nn, iters, exact).numpy()

    # path 8: bounded_search over the u32 keys
    keys = path8_keys(n, args.seed)
    B = max(2, 100 * n // 200_000_000)
    rmi = rt.train(rt.RMIDataset.from_numpy(keys.astype(np.uint32), device="cpu"),
                   "linear,linear", B)
    q = rng.integers(keys[0], keys[-1], nq)
    q[:nq // 16] = keys[rng.integers(0, n, nq // 16)]
    qi = to_image(q.astype(np.uint32))
    g, e = (t.numpy() for t in lookup(rmi, qi))
    kimg, qi = to_image(keys.astype(np.uint32)).numpy(), qi.numpy()
    iters = err_iters(rmi.model_max_error)
    reads = Reads(nq)
    got = bounded(kimg, qi, g, e, n, iters, reads=reads)
    if not np.array_equal(got, plain_bounded(kimg, qi, g, e, n, iters)):
        raise RuntimeError("path8: the replay differs from bounded_lower_bound_plain")
    out["path8"] = _summary(reads, {"B": B, "max_err": rmi.model_max_error,
                                    "window_log2_mean": float(np.log2(2 * e + 1).mean()),
                                    **halving_summary(kimg, qi, g, e, n, iters)})

    for kind, spec, B200 in (("osm", "cubic,linear", 786432),
                             ("wiki", "linear_spline,linear", 4194304),
                             ("books", "linear_spline,linear", 4194304)):
        if kind == "wiki":     # a slice of the 200M keys' range at their density
            raw = np.floor(np.linspace(1.0e9, 1.0e9 + 0.7e9 * n / 200e6, n)
                           + np.random.default_rng(7).exponential(50.0, size=n))
            raw = np.sort(raw).astype(np.uint64)
        else:
            raw = rdata.synthetic_dataset(kind, n, KeyType.U64, seed=7)
        idx = rt.train_bounded(rt.RMIDataset.from_numpy(raw, device="cpu"), spec,
                               max(64, B200 * n // 200_000_000), 8)
        knots, vals = idx.keys.numpy(), idx.cache_fix[2].astype(np.int64)
        sk = to_image(raw[rng.integers(0, n, nq)])
        start, err = (t.numpy() for t in _rmi_lookup(idx, sk))
        sk = sk.numpy()
        reads, sreads = Reads(nq), Reads(nq)
        res = interp_res(knots, knots[::KNOT_STRIDE], sk, start, err, reads=reads,
                         sample_reads=sreads)
        want = bounded_lower_bound_plain(*(torch.from_numpy(x) for x in (knots, sk, start, err)),
                                         knots.shape[0], interp_iters(knots.shape[0])).numpy()
        if not np.array_equal(res, want):
            raise RuntimeError(f"{kind}: the replay's knot search differs from the plain version")
        vs = value_sectors(res, knots.shape[0])
        out[kind] = _summary(reads, {"knots": int(knots.shape[0]),
                                     "sample_reads": float(sreads.rounds.mean()),
                                     "sample_sectors": float(sreads.sectors().mean()),
                                     "value_sectors": float(vs.mean()),
                                     "window_log2_mean": float(np.log2(2 * err + 1).mean()),
                                     **halving_summary(knots, sk, start, err, knots.shape[0],
                                                       interp_iters(knots.shape[0]))})
        if kind == "books":
            continue
        # the cachefix search with the original keys
        kimg = to_image(raw).numpy()
        qs = rng.integers(int(kimg[0]), int(kimg[-1]), nq)
        qs[:nq // 16] = kimg[rng.integers(0, n, nq // 16)]
        pos, perr = (t.numpy() for t in lookup(idx, torch.from_numpy(qs)))
        iters = max(1, int(np.ceil(np.log2(2 * 8 + 2))) + 2)
        reads = Reads(nq)
        got = bounded(kimg, qs, pos, perr + 1, n, iters, exact=True, reads=reads)
        if not np.array_equal(got, np.searchsorted(kimg, qs, side="left")):
            raise RuntimeError(f"{kind}_search: the replay is not the lower bound")
        out[f"{kind}_search"] = _summary(reads, halving_summary(kimg, qs, pos, perr + 1, n,
                                                                iters))
        if kind == "wiki":
            # queries just after a duplicate run's last key, whose window misses
            ends = np.flatnonzero((kimg[1:-1] == kimg[:-2]) & (kimg[2:] > kimg[1:-1] + 1)) + 1
            qm = kimg[ends] + 1
            pos, perr = (t.numpy() for t in lookup(idx, torch.from_numpy(qm)))
            lb = np.searchsorted(kimg, qm, side="left")
            missed = (lb < pos - perr - 1) | (lb > pos + perr + 2)
            qm, pos, perr = qm[missed][:nq], pos[missed][:nq], perr[missed][:nq]
            reads = Reads(qm.shape[0])
            got = bounded(kimg, qm, pos, perr + 1, n, iters, exact=True, reads=reads)
            if not np.array_equal(got, np.searchsorted(kimg, qm, side="left")):
                raise RuntimeError("wiki_missed: the replay is not the lower bound")
            out["wiki_missed"] = _summary(reads, {"candidates": int(ends.shape[0]),
                                                  "missed": int(missed.sum()),
                                                  **halving_summary(kimg, qm, pos, perr + 1, n,
                                                                    iters, whole=True)})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
