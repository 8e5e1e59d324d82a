"""The reads rmi_packed_search makes a query: a host replay of
csrc/packed.cu's search, and of the design it replaced, on the shapes of
chip_smoke.py's packed plans.

    python3 tools/count_torch_packed_reads.py [--n 16777216] [--queries 65536]

Both replays follow their kernel read for read, all queries of a batch
in lockstep, and count per query the dependent rounds (reads that wait
for an earlier one; reads issued together are one round) and the
distinct 32-byte sectors of each array (by address: ``off`` is the entry
offset of a[0] inside its 64-byte block).  ``search`` is the kept design
(csrc/packed.cu): the leaf row whole beside its base (a row longer than
16 samples: each chunk's last sample first, then one chunk), then
64-byte blocks placed by interpolation between the values known on
either side of q (kInterpRounds at most, then halving by blocks), over
the wide plan's stripe-first keys and over the stripe's keys.
``search_before`` is the design before it: the row by halving
steps until at most 8 entries are left, then those 8; the wide plan's
128 stripe-first keys alike; the stripe through its 8 entries of
keys[::8] and then one 8-key group.  Their answers, and the kept
design's LB1, are checked against the plain versions
(ops/packed_kernel.py).

Shapes, each at --n keys (200M on the card), B scaled so that a leaf
holds as many keys as at 200M:
  path1      ``cubic,linear 262144`` on books-like u64 keys (packed, S = 16);
  path5      ``radix18,linear 65536`` on the same keys (packed, S ~ 50);
  zoo_wide   ``normal,linear 4096`` on them (packed_wide, F = 32);
  histogram  ``histogram,linear 4096`` on them (packed_wide, F = 8);
  u32        path 1's spec on the keys >> 30 (path 8's u32 images);
  f64        path 1's spec on the keys cast to f64 and scaled by 2^-32
             (path 7's images).
Queries: uniform over the key range, 1/16 of them keys (chip_smoke's
make_queries without its eight edges).  The keys (device memory at 200M
keys, 1.6 GB) and keys[::8] (200 MB) are read from device memory; the
rows and bases (path 1: 35.7 MB) mostly from L2; keys[::64] (25 MB) from
either.  The counts are the replay's, not read from the card.  Prints
one JSON line: per shape the plan, each design's rounds and sectors a
query by array, and for the kept design how often the stripe's count
closed after one block read, and how often a count fell back to halving.
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

from rmi_tpu_torch import keys as keymod  # noqa: E402
from rmi_tpu_torch.ops import packed_kernel as pk  # noqa: E402

STRIPE = 64           # keys a stripe (csrc/packed.cu kStripe)
WIDTH = 128           # the wide plan's window of stripe-first keys (kWidth)
CHUNK = 16            # samples a row read (kChunk)
BLOCK = 8             # entries a read of the keys or stripe-first keys (kBlock)
INTERP_ROUNDS = 3     # kInterpRounds
IMAGE_MAX = np.iinfo(np.int64).max


class Reads:
    """Each query's dependent rounds and the sectors it reads, by array."""

    def __init__(self, m):
        self.rounds = np.zeros(m, np.int64)
        self.pairs = {}

    def round(self, sel):
        self.rounds[sel] += 1

    def touch(self, name, sel, entries, off=0):
        """The queries ``sel`` read entries ``entries`` (one each) of array
        ``name``, whose a[0] lies ``off`` entries into its sector."""
        self.pairs.setdefault(name, []).append((sel, (entries + off) >> 2))

    def sectors(self, name):
        """[m] distinct sectors of ``name`` a query read."""
        out = np.zeros(self.rounds.shape[0], np.int64)
        if self.pairs.get(name):
            qi = np.concatenate([p[0] for p in self.pairs[name]])
            s = np.concatenate([p[1] for p in self.pairs[name]])
            qi = np.unique(np.stack([qi, s], 1), axis=0)[:, 0]
            out += np.bincount(qi, minlength=out.shape[0])
        return out


class Bracket:
    """The kernel's Bracket for every query: the answer, the first j with
    a[j] >= q, in (p, r]; the values at the ends that are known."""

    def __init__(self, p, r, lov=None, hiv=None, has_lo=None, has_hi=None):
        m = p.shape[0]
        self.p, self.r = p.astype(np.int64), r.astype(np.int64)
        self.lov = np.zeros(m, np.int64) if lov is None else lov.copy()
        self.hiv = np.zeros(m, np.int64) if hiv is None else hiv.copy()
        self.has_lo = np.zeros(m, bool) if has_lo is None else has_lo.copy()
        self.has_hi = np.zeros(m, bool) if has_hi is None else has_hi.copy()

    def narrow(self, sel, j, v, q):
        """Bracket::narrow at the queries ``sel`` by entry j of value v."""
        inside = (j > self.p[sel]) & (j < self.r[sel])
        lt = v < q[sel]
        up, down = sel[inside & lt], sel[inside & ~lt]
        self.p[up], self.lov[up], self.has_lo[up] = j[inside & lt], v[inside & lt], True
        self.r[down], self.hiv[down], self.has_hi[down] = j[inside & ~lt], v[inside & ~lt], True


def block_of(j, off):
    """The first entry of the BLOCK-entry block that holds entry j."""
    return ((j + off) & ~(BLOCK - 1)) - off


def finish(a, off, q, b, reads, name, stats=None):
    """csrc/packed.cu finish: b narrowed to one entry over a, a block a
    round.  ``stats`` counts the queries that read more than one block
    ("more") and that halved ("halving")."""
    m = q.shape[0]
    rounds = np.full(m, INTERP_ROUNDS)
    blocks = np.zeros(m, np.int64)
    halved = np.zeros(m, bool)
    n = a.shape[0]
    while True:
        sel = np.flatnonzero(b.r - b.p > 1)
        if sel.size == 0:
            break
        p, r = b.p[sel], b.r[sel]
        first, last = p + 1, r - 1
        one = block_of(first, off) == block_of(last, off)
        lerp = ~one & b.has_lo[sel] & b.has_hi[sel] & (rounds[sel] > 0)
        rounds[sel[lerp]] -= 1
        lov = b.lov[sel].astype(np.uint64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            f = ((q[sel].astype(np.uint64) - lov).astype(np.float64)
                 / (b.hiv[sel].astype(np.uint64) - lov).astype(np.float64))
        f = np.fmin(np.fmax(f, 0.0), 1.0)
        at = np.minimum(first + (np.where(lerp, f, 0.0) * (r - p - 1).astype(np.float64))
                        .astype(np.int64), last)
        mid = ~one & ~lerp
        halved[sel[mid]] = True
        j = np.where(one, first, np.where(lerp, at, p + ((r - p) >> 1)))
        s = block_of(j, off)
        reads.round(sel)
        blocks[sel] += 1
        for t in range(BLOCK):
            e = s + t
            ok = (e >= 0) & (e < n)
            reads.touch(name, sel[ok], e[ok], off)
            b.narrow(sel[ok], e[ok], a[e[ok]], q)
    if stats is not None:
        stats["more"] = stats.get("more", 0) + int((blocks > 1).sum())
        stats["halving"] = stats.get("halving", 0) + int(halved.sum())
    return b


def count_row(rows, Sp, leaf, q, reads):
    """csrc/packed.cu count_row: the bracket (c1 - 1, c1] of each query's
    row, with the samples on either side where the row holds them."""
    m = q.shape[0]
    start = leaf * Sp
    b = Bracket(np.full(m, -1), np.full(m, Sp))
    flat = rows.ravel()
    alls = np.arange(m)
    reads.round(alls)
    if Sp > CHUNK:                   # each chunk's last sample, then one chunk
        for k in range(-(-Sp // CHUNK) - 1):
            e = np.full(m, CHUNK * k + CHUNK - 1)
            reads.touch("rows", alls, start + e)
            b.narrow(alls, e, flat[start + e], q)
        reads.round(alls)
    at = b.p + 1
    length = np.minimum(Sp - at, CHUNK)
    for t in range(CHUNK):
        sel = np.flatnonzero(t < length)
        e = at[sel] + t
        reads.touch("rows", sel, start[sel] + e)
        b.narrow(sel, e, flat[start[sel] + e], q)
    return b


def search(plan, keys, leaf, q, reads=None, stats=None, off=0, sf_off=0):
    """rmi_packed_search's answers and LB1, read for read into ``reads``:
    the kept design, keys starting ``off`` entries into their 64-byte
    block and the stripe-first keys ``sf_off``."""
    reads = reads if reads is not None else Reads(q.shape[0])
    stats = stats if stats is not None else {}
    rows, base = plan.rows.numpy(), plan.base.numpy()
    S, F, n = plan.S, plan.F, keys.shape[0]
    Sp, nrows0 = rows.shape[1], -(-n // STRIPE)
    sf = plan.stripe_first.numpy()
    reads.touch("base", np.arange(q.shape[0]), leaf)
    rb = count_row(rows, Sp, leaf, q, reads)
    c1 = rb.r
    LB1 = base[leaf] + (c1 - 1) * F
    hi_known = rb.has_hi & (c1 < S) & (LB1 + F < nrows0)
    if F == 1:
        sb = Bracket(LB1, LB1 + 1, rb.lov, rb.hiv, rb.has_lo, hi_known)
    else:
        r1 = np.clip(LB1, 0, nrows0) >> 6
        sb = Bracket(r1 * STRIPE - 1, np.minimum(r1 * STRIPE + WIDTH, nrows0))
        lo_sel, hi_sel = np.flatnonzero(rb.has_lo), np.flatnonzero(hi_known)
        sb.narrow(lo_sel, LB1[lo_sel], rb.lov[lo_sel], q)
        sb.narrow(hi_sel, LB1[hi_sel] + F, rb.hiv[hi_sel], q)
        sstats = stats.setdefault("stripe_first", {})
        finish(sf, sf_off, q, sb, reads, "stripe_first", sstats)
    row = np.clip(np.minimum(sb.r, nrows0) - 1, 0, nrows0 - 1)
    kb = Bracket(row * STRIPE - 1, np.minimum(row * STRIPE + STRIPE, n))
    lo = sb.has_lo & (sb.p == row)
    kb.p[lo], kb.lov[lo], kb.has_lo[lo] = row[lo] * STRIPE, sb.lov[lo], True
    hi = sb.has_hi & (sb.r == row + 1)
    kb.hiv[hi], kb.has_hi[hi] = sb.hiv[hi], True
    kstats = stats.setdefault("keys", {})
    kstats["both_ends"] = kstats.get("both_ends", 0) + int((kb.has_lo & kb.has_hi).sum())
    finish(keys, off, q, kb, reads, "keys", kstats)
    return kb.r, LB1


# --- the design before ------------------------------------------------------

def _count8(a, start, avail, q, sel, reads, name):
    """count8 of a[start : start + min(avail, 8)], one round."""
    k = np.arange(8)
    ok = k < np.minimum(avail, 8)[:, None]
    e = start[:, None] + k
    reads.round(sel)
    reads.touch(name, np.repeat(sel, 8)[ok.ravel()], e[ok])
    v = np.where(ok, a[np.where(ok, e, 0)], IMAGE_MAX)
    return (v < q[sel][:, None]).sum(1)


def _count_below(a, start, length, q, sel, reads, name):
    """count_below of a[start : start + length] at the queries ``sel``:
    halving steps while 8 entries or more are left, then count8."""
    lo, hi = np.zeros(sel.size, np.int64), length.copy()
    while True:
        active = np.flatnonzero(hi - lo >= 8)
        if active.size == 0:
            return lo + _count8(a, start + lo, hi - lo, q, sel, reads, name)
        mid = (lo[active] + hi[active] + 1) >> 1
        e = start[active] + mid - 1
        reads.round(sel[active])
        reads.touch(name, sel[active], e)
        below = a[e] < q[sel[active]]
        lo[active] = np.where(below, mid, lo[active])
        hi[active] = np.where(below, hi[active], mid - 1)


def search_before(plan, keys, leaf, q, reads=None):
    """The answers of the design before, read for read, over rows of
    [base, S samples] ([B, 1 + S], as the plan held them then)."""
    m = q.shape[0]
    reads = reads if reads is not None else Reads(m)
    S, F, n = plan.S, plan.F, keys.shape[0]
    old = np.concatenate([plan.base.numpy()[:, None], plan.rows.numpy()[:, :S]], 1).ravel()
    alls = np.arange(m)
    start = leaf * (1 + S)
    reads.touch("rows", alls, start)        # the base, beside the first read
    c1 = _count_below(old, start + 1, np.full(m, S), q, alls, reads, "rows")
    LB1 = old[start] + (c1 - 1) * F
    sf, gf = plan.stripe_first.numpy(), plan.group_first.numpy()
    nrows0, ng = sf.shape[0], gf.shape[0]
    if F == 1:
        row = np.clip(LB1, 0, nrows0 - 1)
    else:
        r1 = np.clip(LB1, 0, nrows0) >> 6
        s0 = r1 * STRIPE
        length = np.clip(np.minimum(nrows0 - s0, WIDTH), 0, None)
        lb = s0 + _count_below(sf, s0, length, q, alls, reads, "stripe_first")
        row = np.clip(np.minimum(lb, nrows0) - 1, 0, nrows0 - 1)
    g0 = row * (STRIPE // 8)
    c = _count8(gf, g0, ng - g0, q, alls, reads, "group_first")
    sel = np.flatnonzero(c > 0)
    at = (g0[sel] + c[sel] - 1) * 8
    out = row * STRIPE
    out[sel] = at + _count8(keys, at, n - at, q, sel, reads, "keys")
    return np.minimum(out, n)


# --- the shapes ---------------------------------------------------------------

SHAPES = {   # name: (spec, B at 200M keys, key kind)
    "path1": ("cubic,linear", 262144, "u64"),
    "path5": ("radix18,linear", 65536, "u64"),
    "zoo_wide": ("normal,linear", 4096, "u64"),
    "histogram": ("histogram,linear", 4096, "u64"),
    "u32": ("cubic,linear", 262144, "u32"),
    "f64": ("cubic,linear", 262144, "f64"),
}


def shape_index(name, n, seed=42):
    """The index of shape ``name`` over n books-like keys made on the CPU
    (data.books_like_on_device), as images of its key kind."""
    import rmi_tpu_torch as rt
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch.keys import KeyType
    spec, B200, kind = SHAPES[name]
    u = rdata.books_like_on_device(n, seed, torch.device("cpu"))
    if kind == "f64":
        key_type, img = KeyType.F64, keymod.f64_image(keymod.as_float(u).mul_(2.0 ** -32))
    elif kind == "u32":
        key_type, img = KeyType.U32, (keymod.u64_bits(u) >> 30).add_(keymod.IMAGE_MIN)
    else:
        key_type, img = KeyType.U64, u
    B = max(2, B200 * n // 200_000_000)
    return rt.train(rdata.RMIDataset(img, key_type), spec, B)


def shape_queries(rmi, nq, seed):
    """Images uniform over the keys' range (f64: values uniform over it),
    1/16 of them keys."""
    rng = np.random.default_rng(seed)
    keys = rmi.keys
    if rmi.key_type.value == "f64":
        lo, hi = keymod.as_float(keys[[0, -1]], rmi.key_type).tolist()
        q = keymod.f64_image(torch.from_numpy(rng.uniform(lo, hi, nq))).numpy()
    else:
        q = rng.integers(int(keys[0]), int(keys[-1]), nq, dtype=np.int64)
    q[:nq // 16] = keys.numpy()[rng.integers(0, keys.shape[0], nq // 16)]
    return q


def measure(rmi, q, off=0):
    """{plan, kept design's and the design before's reads a query}, the
    answers checked against packed_search_plain and LB1 against
    stripe_lower_limits."""
    from rmi_tpu_torch import lookup_fast
    plan = lookup_fast.get_plan(rmi)
    qt = torch.from_numpy(q)
    leaf = pk._leaf_ids(rmi, plan, qt).numpy()
    keys = rmi.keys.numpy()
    want = pk.packed_search_plain(rmi, plan, qt).numpy()
    new, old, stats = Reads(q.shape[0]), Reads(q.shape[0]), {}
    got, LB1 = search(plan, keys, leaf, q, new, stats, off)
    if not np.array_equal(got, want):
        raise RuntimeError("the replay of rmi_packed_search differs from packed_search_plain")
    if not np.array_equal(LB1, pk.stripe_lower_limits(rmi, plan, qt).numpy()):
        raise RuntimeError("the replay's LB1 differs from stripe_lower_limits")
    if not np.array_equal(search_before(plan, keys, leaf, q, old), want):
        raise RuntimeError("the replay of the design before differs from packed_search_plain")
    m = q.shape[0]

    def summary(r, names):
        out = {"rounds": float(r.rounds.mean())}
        for nm in names:
            out[f"{nm}_sectors"] = float(r.sectors(nm).mean())
        dev = [nm for nm in ("keys", "group_first") if nm in names]
        out["device_sectors"] = float(sum(r.sectors(nm) for nm in dev).mean())
        return out
    kept = summary(new, ["rows", "base", "stripe_first", "keys"])
    kept["rounds_hist"] = np.bincount(new.rounds).tolist()
    ks = stats["keys"]
    kept["stripe_one_block"] = 1.0 - ks.get("more", 0) / m
    kept["stripe_both_ends"] = ks.get("both_ends", 0) / m
    kept["halving"] = (ks.get("halving", 0)
                       + stats.get("stripe_first", {}).get("halving", 0)) / m
    if plan.F > 1:
        kept["stripe_first_one_block"] = 1.0 - stats["stripe_first"].get("more", 0) / m
    return {"plan": [plan.kind, plan.S, plan.F], "B": rmi.branching_factor, "kept": kept,
            "before": summary(old, ["rows", "stripe_first", "group_first", "keys"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--queries", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    out = {"n": args.n, "queries": args.queries}
    for name in args.shapes.split(","):
        rmi = shape_index(name, args.n, args.seed)
        out[name] = measure(rmi, shape_queries(rmi, args.queries, args.seed + 1))
        print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
