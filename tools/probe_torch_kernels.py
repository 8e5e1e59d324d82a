"""Run the nine card probes of rmi_tpu_torch on one CUDA card.

    python3 tools/probe_torch_kernels.py

The counterpart of probes/probe_pallas.py for the port: each probe's
kernel (rmi_tpu_torch/csrc/probes.cu) runs on the inputs that script
makes (same shapes, same numpy seeds), is compared with its plain
PyTorch version, and prints one ``[OK]`` or ``[FAIL]`` line.  Beside them:

  * D's rate table: 4096 random rows of width 128 ... 2048 f32 fetched by
    cp.async.bulk with 16 copies in flight, timed with CUDA events over 5
    launches after a warm-up, for one block and for one block per SM
    (what a kernel such as K5, which stages its windows the same way,
    sees); checked on a table of ones (each block sums 4096.0) and on a
    marked table that a stale or misplaced slot cannot sum right; then
    one SM's rate against its issuing warps (one block of 1-16 warps,
    each its own ring), and the whole-card form's TB/s: warm, cold (on
    views whose rows are not in L2, as chip_smoke.py times it) and with
    L2 flushed by a write;
  * B2 against B3 over 2^26 random elements: whether comparing u64 keys
    as (hi, lo) u32 pairs costs anything on this card (B3 reads the low
    halves only where the high halves tie, so its bytes depend on the
    data);
  * C1 and C2 at sizes where the card and not a launch sets the time,
    each in turns with its library call: C1 gathers as many random rows
    as its 128 MB table has, of 512 B and of 8 KB; C2 takes 2^24 random
    entries of a 16 MB table (held in L2) and of a 256 MB one.

The first line is the card's name and power limit.  Exits non-zero if
any probe failed.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rmi_tpu_torch import config  # noqa: E402
from rmi_tpu_torch.ops import probe_kernels as pk  # noqa: E402

REPS = 5                     # timed launches after one warm-up
SWEEP_WARPS = (1, 2, 4, 8, 16)   # D: issuing warps of one block
CARD_CALLS = 21              # D's whole-card form: launches timed alone
FLUSH_BYTES = 100 << 20      # twice the 50 MB L2
SLEEP_CYCLES = 200_000       # ~0.1 ms of card time that hides a launch's host cost
CARD_GEOMETRIES = ((8, 4), (8, 2), (8, 1), (4, 4), (4, 2), (16, 2), (16, 1), (2, 4))  # (W, F)
COMPARE_N = 1 << 26          # elements of the B2-against-B3 timing
GATHER_TABLES = ((1 << 18, 128), (1 << 14, 2048))   # C1's large cases, 128 MB each
TAKE_N = 1 << 24             # C2's large cases: indices, into 16 MB and 256 MB
TAKE_TABLES = (1 << 22, 1 << 26)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=REPS):
    """ms per call over ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(probe, dev):
    """None if the probe's kernel equals its plain version on the
    probe's inputs, else what differs."""
    args = pk.probe_inputs(probe, dev)
    got = probe.wrapper(*args)
    torch.cuda.synchronize()
    want = probe.plain(*args)
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"shape or type: {tuple(got.shape)} {got.dtype}"
    bad = int((got != want).sum())
    return f"{bad} of {got.numel()} elements differ" if bad else None


def ring_rates(dev, sms):
    """D at every width: the sums checked on both tables, then ns per
    row for one block and for one block per SM, one issuing warp each.
    Returns what failed."""
    failures = []
    for width in pk.RING_WIDTHS:
        tbl = pk.ring_table(width, dev)
        for blocks in (1, sms):
            for table, name in ((tbl, "ones"), (None, "marked")):
                t = pk.ring_table(width, dev, marked=True) if table is None else table
                got = pk.row_ring(t, blocks=blocks)
                want = pk.row_ring_plain(t, blocks=blocks)
                if not torch.equal(got, want):
                    failures.append(f"width {width}, {blocks} blocks, {name} table: "
                                    f"{int((got != want).sum())} block sums differ")
                del t
        rates = []
        for blocks in (1, sms):
            ms = cuda_ms(lambda: pk.row_ring(tbl, blocks=blocks))
            rows = pk.RING_ITERS * blocks
            ns = ms * 1e6 / rows
            rates.append(f"{blocks:3d} block{'s' if blocks > 1 else ' '}: "
                         f"{ns:8.2f} ns/row {1e3 / ns:8.1f} M rows/s "
                         f"{width * 4 / ns:7.1f} GB/s")
        log(f"     width={width:5d}: " + "   ".join(rates))
        del tbl
    return failures


def ring_warp_sweep(dev):
    """One SM's rate: one block with 1-16 issuing warps, each warp a
    stream of 4096 fetches through its own ring, at rows of 512 B to
    8 KB; the sums checked on the marked table.  Logs ns per row and the
    warp count from which the next doubling gains under 10%.  Returns
    what failed."""
    failures = []
    for width in pk.RING_WIDTHS:
        tbl = pk.ring_table(width, dev, marked=True)
        ns = {}
        for warps in SWEEP_WARPS:
            got = pk.row_ring(tbl, warps=warps)
            if not torch.equal(got, pk.row_ring_plain(tbl, warps=warps)):
                failures.append(f"width {width}, one block of {warps} warps: sums differ")
            ns[warps] = cuda_ms(lambda: pk.row_ring(tbl, warps=warps)) * 1e6 / (
                pk.RING_ITERS * warps)
        flat = next((w for w, nxt in zip(SWEEP_WARPS, SWEEP_WARPS[1:])
                     if ns[nxt] > 0.9 * ns[w]), SWEEP_WARPS[-1])
        log(f"     width={width:5d} ({width * 4} B rows), one block: "
            + ", ".join(f"{w} warps {v:.2f} ns/row" for w, v in ns.items())
            + f"; the rate stops rising at {flat} warps "
            f"({width * 4 / ns[flat]:.1f} GB/s for the SM)")
        del tbl
    return failures


def ring_card_rates(dev):
    """D's whole-card form (the probe's 4096 fetches over the card) at
    every width: partial sums checked on the marked table, then the
    kernel's device time and the TB/s of the rows it fetches, warm (the
    same walk again, its rows left in L2 by the call before), cold (each
    call on the next of pk.ring_cold_views, whose rows the calls before
    did not fetch) and flushed (L2 filled before each call by writing a
    buffer twice its size, whose dirty lines the walk must write back).
    Each call is timed alone by CUDA events around it, queued behind a
    wait on the card so that the host's launch is not in the span; the
    median of CARD_CALLS.  Returns what failed."""
    failures = []
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def alone_us(fn, flushed=False):
        times = []
        for _ in range(CARD_CALLS):
            if flushed:
                flush.fill_(1.0)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) * 1e3)
        return sorted(times)[CARD_CALLS // 2]

    for width in pk.RING_WIDTHS:
        tbl = pk.ring_table(width, dev, marked=True)
        got = pk.row_ring_card(tbl)
        if not torch.equal(got, pk.row_ring_card_plain(tbl)):
            failures.append(f"width {width}, whole-card form: partial sums differ")
        nbytes = pk.RING_ITERS * width * 4
        views = itertools.cycle(pk.ring_cold_views(width, dev))
        us = {"warm": alone_us(lambda: pk.row_ring_card(tbl)),
              "cold": alone_us(lambda: pk.row_ring_card(next(views))),
              "flushed": alone_us(lambda: pk.row_ring_card(tbl), flushed=True)}
        log(f"     width={width:5d}: whole card ({pk.ring_card_blocks()} blocks "
            f"of {pk.RING_WARPS} warps): "
            + ", ".join(f"{k} {t:.3f} us ({nbytes / t / 1e6:.3f} TB/s)" for k, t in us.items()))
        del tbl, views
    return failures


def device_us(fn, calls=100):
    """Device us per call of ``fn``: its kernels' time in a profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                if getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA"))
    return total / calls


def ring_card_geometry(dev):
    """The whole-card form's split of the probe's walk, against others:
    blocks of W issuing warps, F fetches a warp, at the narrowest and
    widest rows; each checked by its total on the table of ones, timed by
    the profiler's device time.  Returns what failed."""
    failures = []
    for width in (pk.RING_WIDTHS[0], pk.RING_WIDTHS[-1]):
        tbl = pk.ring_table(width, dev)
        times = []
        for warps, per in CARD_GEOMETRIES:
            blocks = -(-pk.RING_ITERS // (warps * per))
            run = lambda: pk._ring(tbl, pk.RING_ITERS, pk.RING_SLOTS, blocks, warps)  # noqa: E731
            if float(run().double().sum()) != pk.RING_ITERS:
                failures.append(f"width {width}, {blocks} blocks of {warps} warps: wrong total")
            times.append(f"{blocks}x{warps} warps ({per} a warp) {device_us(run):.3f} us")
        log(f"     width={width:5d}, whole-card splits, device time: " + ", ".join(times))
        del tbl
    return failures


def compare_rates(dev):
    """B2 and B3 over COMPARE_N random elements, in turns."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x, q = (torch.randint(-(1 << 63), (1 << 63) - 1, (COMPARE_N,), generator=gen,
                          device=dev) for _ in range(2))
    hi, lo, qh, ql = ((a >> s).to(torch.int32) for a in (x, q) for s in (32, 0))
    if not torch.equal(pk.less_than_u64(x, q), pk.less_than_u32pair(hi, lo, qh, ql)):
        raise RuntimeError("B2 and B3 disagree on the same keys")
    times = {"B2": [], "B3": []}
    for name in ("B2", "B3", "B3", "B2"):
        fn = ((lambda: pk.less_than_u64(x, q)) if name == "B2"
              else (lambda: pk.less_than_u32pair(hi, lo, qh, ql)))
        times[name].append(cuda_ms(fn))
    # per element B2 reads 16 B and writes 4; B3 reads the high halves
    # (8 B), the low halves only where they tie, and writes 4
    ties = int((hi == qh).sum())
    nbytes = {"B2": COMPARE_N * 20, "B3": COMPARE_N * 12 + ties * 8}
    for name, ts in times.items():
        log(f"     {name} over {COMPARE_N} elements ({nbytes[name] / 1e9:.4f} GB, "
            f"{ties} ties of the high halves), in turns B2, B3, B3, B2: "
            + ", ".join(f"{t:.4f} ms ({nbytes[name] / t / 1e6:.1f} GB/s)" for t in ts))


def in_turns(what, names, nbytes, kernel, library, want):
    """Hold ``kernel()`` to ``want``, then log its ms per call and
    ``library``'s in turns kernel, library, library, kernel, with the
    GB/s of ``nbytes``."""
    if not torch.equal(kernel(), want):
        raise RuntimeError(f"{what}: the kernel disagrees with tbl[idx]")
    times = {names[0]: [], names[1]: []}
    for k in (0, 1, 1, 0):
        times[names[k]].append(cuda_ms((kernel, library)[k]))
    log(f"     {what}, in turns {names[0]}, {names[1]}, {names[1]}, {names[0]}: "
        + "; ".join(f"{name} " + ", ".join(f"{t:.4f} ms ({nbytes / t / 1e6:.1f} GB/s)"
                                           for t in ts) for name, ts in times.items()))


def gather_rates(dev):
    """C1 and C2 at sizes where the card sets the time, in turns with the
    library call of each; GB/s count the indices, the rows or entries
    read and the output once."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows, width in GATHER_TABLES:
        tbl = torch.rand(rows, width, generator=gen, device=dev)
        idx = torch.randint(0, rows, (rows,), generator=gen, device=dev, dtype=torch.int32)
        il = idx.long()
        in_turns(f"C1: {rows} random rows of {width * 4} B from [{rows}, {width}] f32",
                 ("C1", "index_select"), rows * (4 + 8 * width),
                 lambda: pk.gather_rows(tbl, idx), lambda: torch.index_select(tbl, 0, il),
                 tbl[il])
    for ntbl in TAKE_TABLES:
        tbl = torch.rand(ntbl, generator=gen, device=dev)
        idx = torch.randint(0, ntbl, (TAKE_N,), generator=gen, device=dev, dtype=torch.int32)
        il = idx.long()
        in_turns(f"C2: {TAKE_N} random entries of {ntbl} f32", ("C2", "take"), TAKE_N * 12,
                 lambda: pk.take(tbl, idx), lambda: torch.take(tbl, il), tbl[il])


def main():
    dev = config.require_cuda()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failed = 0
    for probe in pk.PROBES:
        if probe.key == "D":
            log(f"     D: {pk.RING_ITERS} rows of [{pk.RING_ROWS}, width] f32 per issuing "
                f"warp, up to {pk.RING_SLOTS} copies in flight each, {REPS} launches "
                f"after a warm-up")
            failures = (ring_rates(dev, sms) + ring_warp_sweep(dev) + ring_card_rates(dev)
                        + ring_card_geometry(dev))
            why = "; ".join(failures) or None
        else:
            why = check(probe, dev)
        failed += why is not None
        log(f"[OK]   {probe.key} {probe.title}" if why is None
            else f"[FAIL] {probe.key} {probe.title}: {why}")
    compare_rates(dev)
    gather_rates(dev)
    if failed:
        raise SystemExit(f"{failed} of {len(pk.PROBES)} probes failed")


if __name__ == "__main__":
    main()
