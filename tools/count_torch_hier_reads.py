"""The reads rmi_hier_resolve makes a query, level by level: a host replay
of csrc/hier.cu's search, on keys of chip_smoke.py's path 8 shape.

    python3 tools/count_torch_hier_reads.py [--n 16777216] [--queries 16384]

Path 8 is ``linear,linear 100`` on 200M u32 keys (books-like keys >> 30:
exponential gaps of mean 2^32 / 200M, rounded, so some keys repeat).  The
replay makes keys of that gap at --n keys, builds ``linear,linear`` with
max(2, 100 n / 200M) leaves on the CPU (leaves of ~2M keys, as path 8's),
takes lookup's guess and error for its queries (uniform over the keys'
range, 1/16 of them keys) and follows the kernel's reads over the keys'
and queries' int64 images, as the kernel reads them: per level, the
dependent reads (a 32-byte sector read as two 16-byte loads is one),
the load instructions and the distinct 32-byte sectors a query touches.
Level 0 is the keys, which the card reads from DRAM (its sectors x 32 B
are the DRAM bytes a query needs); the levels above it fit in L2 at
200M keys.  The counts are the replay's, a mirror of the kernel on the
host, not read from the card.  Each answer is checked against
searchsorted.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAN = 64
WIDTH = 128
ROUNDS = 2        # interpolated reads inside a bracket before halving


class Counter:
    """Reads of one query at one level: dependent reads, loads, sectors."""

    def __init__(self):
        self.rounds = 0
        self.loads = 0
        self.sectors = set()

    def read(self, idx, vec=False):
        """One dependent read of entries idx (a list): a sector read two
        16-byte loads where `vec`, else one load an entry."""
        self.rounds += 1
        self.loads += 2 * math.ceil(len(idx) / 4) if vec else len(idx)
        self.sectors.update(i // 4 for i in idx)


def search(a, ln, p, span, q, bracket, st, cnt):
    """csrc/hier.cu's search: the lower bound of q among a[p + 1 .. p +
    span], st = [lov, hiv] the values beside the answer.  Mirrors the
    kernel read for read (the levels start on 32-byte boundaries: sectors
    are read whole)."""
    lov, hiv = st
    if not bracket:
        cnt.read([p + 1, p + span])
        a0, a1 = int(a[p + 1]), int(a[p + span])
        if a0 >= q:
            st[1] = a0
            return p + 1
        if a1 < q:
            st[0] = a1
            return p + span + 1
        lov, hiv, p, span = a0, a1, p + 1, span - 2
    for _ in range(ROUNDS):
        if span <= 3:
            break
        d = float(hiv) - float(lov)
        f = (float(q) - float(lov)) / d if d else math.nan
        f = 0.0 if f != f else min(max(f, 0.0), 1.0)
        s = min(p + 1 + int(f * span), p + span) & ~3
        if s + 4 > ln:
            s -= 4
        cnt.read(list(range(s, s + 4)), vec=True)
        v = [int(x) for x in a[s:s + 4]]
        below = sum(x < q for x in v)
        if below == 4:
            if s + 3 > p:
                span -= s + 3 - p
                p, lov = s + 3, v[-1]
        elif below == 0:
            if p < s <= p + span:
                span, hiv = s - 1 - p, v[0]
        else:
            st[0], st[1] = v[below - 1], v[below]
            return s + below
    c = 0
    step = WIDTH
    while step >= 4:
        if c + step <= span:
            cnt.read([p + c + step])
            v = int(a[p + c + step])
            if v < q:
                c, lov = c + step, v
            else:
                hiv = v
        step >>= 1
    r = min(span - c, 3)
    if r > 0:
        first = p + c + 1
        s = first & ~3
        one = first + r <= s + 4 and s + 4 <= ln
        cnt.read(list(range(s, s + 4)) if one else list(range(first, first + r)), vec=one)
        v = [int(x) for x in a[first:first + r]]
        for x in v[::-1]:
            if x >= q:
                hiv = x
        for x in v:
            if x < q:
                lov = x
                c += 1
    st[0], st[1] = lov, hiv
    return p + 1 + c


def replay(levels, q, guess, err, K, n, counters=None):
    """Lower bounds of queries q through levels 0..K as the kernel finds
    them; counters[k] collects level k's reads when given.  A query
    outside the keys' range is answered by its end and reads no level
    (the kernel reads the first and last key once a thread)."""
    out = np.empty(len(q), dtype=np.int64)
    sK = FAN ** K
    first, last = int(levels[0][0]), int(levels[0][-1])
    for i in range(len(q)):
        qi = int(q[i])
        if qi <= first or qi > last:
            out[i] = 0 if qi <= first else len(levels[0])
            if counters is not None:
                for k in range(K + 1):
                    counters[k].append(Counter())
            continue
        lo = min(max(int(guess[i]) - int(err[i]), 0), n)
        LB = (lo + sK - 1) // sK
        lb, st, inside = 0, [0, 0], False
        for k in range(K, -1, -1):
            a = levels[k]
            ln = len(a)
            bracket = k < K and inside
            start = w = 0
            if bracket:
                p, span = FAN * (lb - 1), FAN - 1
            else:
                if k < K:
                    LB = max(lb * FAN - FAN + 1, 0)
                nrows = max(1, -(-ln // FAN))
                start = min(max(LB >> 6, 0), nrows - 1) * FAN
                w = min(ln - start, WIDTH)
                p, span = start - 1, w
            cnt = Counter()
            lb = search(a, ln, p, span, qi, bracket, st, cnt)
            if counters is not None:
                counters[k].append(cnt)
            inside = bracket or start < lb < start + w
            lb = min(lb, ln)
        out[i] = lb
    return out


def path8_keys(n, seed):
    """Sorted int64 keys with path 8's gaps: exponential of mean 2^32 /
    200M, rounded."""
    rng = np.random.default_rng(seed)
    return np.cumsum(np.round(rng.exponential(2.0 ** 32 / 200e6, n))).astype(np.int64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--queries", type=int, default=1 << 14)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import rmi_tpu_torch as rt
    from rmi_tpu_torch import lookup_fast
    from rmi_tpu_torch.keys import to_image

    keys = path8_keys(args.n, args.seed)
    B = max(2, 100 * args.n // 200_000_000)
    rmi = rt.train(rt.RMIDataset.from_numpy(keys.astype(np.uint32), device="cpu"),
                   "linear,linear", B)
    plan = lookup_fast.get_plan(rmi)
    rng = np.random.default_rng(args.seed + 1)
    q = rng.integers(keys[0], keys[-1], args.queries)
    q[:args.queries // 16] = keys[rng.integers(0, args.n, args.queries // 16)]
    guess, err = (t.numpy() for t in rt.lookup(rmi, to_image(q.astype(np.uint32))))
    K = lookup_fast.hier_start_level(int(rmi.leaf_errors.max()))
    # the kernel reads the keys' and queries' images (u ^ 2^63, near -2^63
    # for u32 keys), whose doubles place its interpolated reads
    keys, q = (to_image(a.astype(np.uint32)).numpy() for a in (keys, q))
    levels = [keys[::FAN ** k] for k in range(K + 1)]
    counters = {k: [] for k in range(K + 1)}
    got = replay(levels, q, guess, err, K, args.n, counters)
    if not np.array_equal(got, np.searchsorted(keys, q, side="left")):
        raise RuntimeError("the replay's answers differ from searchsorted")
    per_level = {}
    for k, cs in counters.items():
        per_level[k] = {"entries": len(levels[k]),
                        "reads": float(np.mean([c.rounds for c in cs])),
                        "loads": float(np.mean([c.loads for c in cs])),
                        "sectors": float(np.mean([len(c.sectors) for c in cs]))}
    print(json.dumps({"n": args.n, "B": B, "K": K, "plan": plan.kind,
                      "max_err": int(rmi.leaf_errors.max()), "queries": args.queries,
                      "per_level": per_level,
                      "dram_bytes_per_query": 32 * per_level[0]["sectors"]}))


if __name__ == "__main__":
    main()
