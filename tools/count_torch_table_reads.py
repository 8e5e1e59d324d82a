"""The reads rmi_top_table_fit makes a slot: a host replay of
csrc/top_fit.cu's table fit, on the keys of the hint-table tops
chip_smoke.py builds.

    python3 tools/count_torch_table_reads.py [--shift 3] [--shapes path5,...]

The replay follows the kernel read for read, all slots in lockstep, and
counts a searched slot (1 through the last key's bucket) the dependent
rounds (reads that wait for an earlier one) and the distinct 32-byte
sectors and 64-byte blocks of the keys' integer images and of the
FixDups positions read: the "own" counts each slot's, the "device"
counts the whole table fit's, each sector once (what device memory
serves if L2 keeps what neighbouring slots share).  ``table_search`` is
the kernel's search: a thread a slot finds its slot's first key from
the keys' two ends by 64-byte blocks placed by interpolation between
the masked key bits known on either side (kInterp times at most, then
halving by blocks), then reads its FixDups position.  The answer is
checked against top_kernel.top_table_fit_plain (table_plain: at the
table's width here).

Shapes, at n = 200M >> --shift keys and the table's bits less --shift,
so that a slot holds as many keys as at 200M:
  path5    ``radix18,linear 65536`` on books-like u64 keys (path 5);
  radix22  ``radix22,cubic 65536`` on the same keys (the zoo's row);
  f64      ``radix18,linear 65536`` on them cast to f64 and scaled by
           2^-32 (the zoo's f64 row: the integer images keys.int_image);
  u32      radix18 on the keys >> 30 (path 8's u32 keys).
The counts are the replay's, not read from the card.  Prints a line per
shape and one JSON line.
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
from rmi_tpu_torch.ops import top_kernel  # noqa: E402

BLOCK = 8             # keys a read: a 64-byte block of the images (kBlock)
INTERP = 8            # interpolated reads a search at most (kInterp)
MASK64 = (1 << 64) - 1


class Reads:
    """Each slot's dependent rounds and the sectors it reads, by array."""

    def __init__(self, m):
        self.rounds = np.zeros(m, np.int64)
        self.pairs = {}

    def round(self, sel):
        self.rounds[sel] += 1

    def touch(self, name, sel, sectors):
        self.pairs.setdefault(name, []).append((np.asarray(sel), np.asarray(sectors)))

    def sectors(self, name, per=1):
        """(distinct runs of ``per`` sectors of ``name`` over all slots, over
        each slot's own): per = 2 counts 64-byte blocks."""
        if not self.pairs.get(name):
            return 0, 0
        qi = np.concatenate([p[0] for p in self.pairs[name]])
        s = np.concatenate([p[1] for p in self.pairs[name]]) // per
        return int(np.unique(s).size), int(np.unique(np.stack([qi, s], 1), axis=0).shape[0])


def table_geometry(images, bits):
    """(prefix, shift, mask, last bucket, masked bits m of the keys as
    uint64): csrc/top_fit.cu's, from the first and last key."""
    u = (images.numpy().view(np.uint64) ^ np.uint64(1 << 63))
    x = int(u[0] ^ u[-1])
    prefix = 64 - x.bit_length()
    shift = 0 if prefix + bits > 64 else 64 - prefix - bits
    mask = MASK64 >> prefix if prefix < 64 else 0
    m = u & np.uint64(mask)
    return prefix, shift, mask, int(m[-1]) >> shift, m


def block_of(j):
    """The first key of the BLOCK-key block that holds key j (the images
    start on a 64-byte boundary)."""
    return j & ~(BLOCK - 1)


class Bracket:
    """The answer, the first key j with m[j] >= T, in (p, r]; the masked
    bits at the ends where known."""

    def __init__(self, p, r, lov, hiv, has_lo, has_hi):
        self.p, self.r = p.astype(np.int64), r.astype(np.int64)
        self.lov, self.hiv = lov.astype(np.uint64), hiv.astype(np.uint64)
        self.has_lo, self.has_hi = has_lo.copy(), has_hi.copy()

    def narrow(self, sel, j, v, T):
        inside = (j > self.p[sel]) & (j < self.r[sel])
        lt = v < T[sel]
        up, down = sel[inside & lt], sel[inside & ~lt]
        self.p[up], self.lov[up], self.has_lo[up] = j[inside & lt], v[inside & lt], True
        self.r[down], self.hiv[down], self.has_hi[down] = j[inside & ~lt], v[inside & ~lt], True


def find(m, T, b, reads, who, stats):
    """csrc/top_fit.cu find: narrow b to one key over m by blocks, a
    block a round, for the searches ``who`` (their slot in ``reads``)."""
    n = m.shape[0]
    left = np.full(T.shape[0], INTERP)
    while True:
        sel = np.flatnonzero(b.r - b.p > 1)
        if sel.size == 0:
            return b
        p, r = b.p[sel], b.r[sel]
        first, last = p + 1, r - 1
        one = block_of(first) == block_of(last)
        lerp = ~one & b.has_lo[sel] & b.has_hi[sel] & (left[sel] > 0)
        left[sel[lerp]] -= 1
        lov = b.lov[sel]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            f = (T[sel] - lov).astype(np.float64) / (b.hiv[sel] - lov).astype(np.float64)
        f = np.fmin(np.fmax(f, 0.0), 1.0)
        at = np.minimum(first + (np.where(lerp, f, 0.0) * (r - p - 1).astype(np.float64))
                        .astype(np.int64), last)
        halve = ~one & ~lerp
        stats["halvings"] = stats.get("halvings", 0) + int(halve.sum())
        j = np.where(one, first, np.where(lerp, at, p + ((r - p) >> 1)))
        s = block_of(j)
        reads.round(who[sel])
        for t in range(BLOCK):
            e = s + t
            ok = (e >= 0) & (e < n)
            reads.touch("keys", who[sel[ok]], e[ok] >> 2)
            b.narrow(sel[ok], e[ok], m[e[ok]], T)


def ends_bracket(m, T):
    """(-1, n] narrowed by the first and last key, which every thread reads
    for the keys' prefix."""
    k, n = T.shape[0], m.shape[0]
    b = Bracket(np.full(k, -1), np.full(k, n), np.zeros(k, np.uint64), np.zeros(k, np.uint64),
                np.zeros(k, bool), np.zeros(k, bool))
    sel = np.arange(k)
    for e in (0, n - 1):
        b.narrow(sel, np.full(k, e), np.full(k, m[e], np.uint64), T)
    return b


def table_search(images, y, sf, bits, reads=None, stats=None):
    """rmi_top_table_fit's (table, prefix), read for read into ``reads``
    (a slot each)."""
    size = 1 << bits
    reads = reads if reads is not None else Reads(size)
    stats = stats if stats is not None else {}
    n = images.shape[0]
    prefix, shift, _, last_bucket, m = table_geometry(images, bits)
    slots = np.arange(size, dtype=np.int64)
    ans = np.where(slots > last_bucket, n, 0).astype(np.int64)
    live = np.flatnonzero((slots >= 1) & (slots <= last_bucket))
    if live.size:
        T = live.astype(np.uint64) << np.uint64(shift)
        b = ends_bracket(m, T)
        find(m, T, b, reads, live, stats)
        ans[live] = b.r
    over = slots > last_bucket
    pos = np.minimum(ans, n - 1)
    got = np.where(over, size, top_kernel.scaled_targets(y[torch.from_numpy(pos)], sf)
                   .numpy().astype(np.int32))
    got[0] = 0
    reads.round(live)
    reads.touch("y", live, pos[live] >> 3)
    return got, prefix


SHAPES = {   # name: (table bits at 200M keys, key kind)
    "path5": (18, "u64"),
    "radix22": (22, "u64"),
    "f64": (18, "f64"),
    "u32": (18, "u32"),
}


def shape_keys(name, n, seed=42):
    """(integer-key images, FixDups) of shape ``name`` over n books-like
    keys made on the CPU (data.books_like_on_device)."""
    from rmi_tpu_torch import data as rdata
    from rmi_tpu_torch.keys import KeyType
    from rmi_tpu_torch.train import two_layer
    u = rdata.books_like_on_device(n, seed, torch.device("cpu"))
    kind = SHAPES[name][1]
    if kind == "f64":
        img = keymod.f64_image(keymod.as_float(u).mul_(2.0 ** -32))
        ints = keymod.int_image(img, KeyType.F64)
    elif kind == "u32":
        img = ints = (keymod.u64_bits(u) >> 30).add_(keymod.IMAGE_MIN)
    else:
        img = ints = u
    return ints, two_layer.fixdups_i32(img)


def table_plain(images, y, sf, bits):
    """top_kernel.top_table_fit_plain at any table width (the models hold
    the widths of TABLE_BITS alone)."""
    from rmi_tpu_torch.models import radix
    return radix._make_table_fit_top(bits)(images, top_kernel.scaled_targets(y, sf), None, None)


def measure(images, y, bits, sf):
    """{rounds and sectors a searched slot}, the answer checked against
    top_table_fit_plain."""
    size = 1 << bits
    want = table_plain(images, y, sf, bits)["table"].numpy()
    r, stats = Reads(size), {}
    live = max(1, min(table_geometry(images, bits)[3], size - 1))   # slots 1..last bucket
    got, _ = table_search(images, y, sf, bits, r, stats)
    if not np.array_equal(got, want):
        raise RuntimeError("the replay of rmi_top_table_fit differs from top_table_fit_plain")
    out = {"slots": size, "searched": live, "keys": images.shape[0],
           "keys_a_slot": images.shape[0] / size,
           "rounds_mean": float(r.rounds.sum() / live), "rounds_max": int(r.rounds.max())}
    for nm in ("keys", "y"):
        dev, own = r.sectors(nm)
        out[f"{nm}_device_sectors"] = dev / live
        out[f"{nm}_own_sectors"] = own / live
        out[f"{nm}_device_blocks"] = r.sectors(nm, 2)[0] / live
    out["device_sectors"] = out["keys_device_sectors"] + out["y_device_sectors"]
    out["device_blocks"] = out["keys_device_blocks"] + out["y_device_blocks"]
    out["halvings"] = stats.get("halvings", 0) / live
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shift", type=int, default=3, help="n = 200M >> shift, bits less shift")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    n = 200_000_000 >> args.shift
    out = {"n": n}
    for name in args.shapes.split(","):
        bits = SHAPES[name][0] - args.shift
        images, y = shape_keys(name, n, args.seed)
        out[name] = measure(images, y, bits, 65536 / n)
        print(name, bits, json.dumps(out[name]), file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
