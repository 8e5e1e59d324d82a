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
    marked table that a stale or misplaced slot cannot sum right;
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

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rmi_tpu_torch import config  # noqa: E402
from rmi_tpu_torch.ops import probe_kernels as pk  # noqa: E402

REPS = 5                     # timed launches after one warm-up
COMPARE_N = 1 << 26          # elements of the B2-against-B3 timing
GATHER_TABLES = ((1 << 18, 128), (1 << 14, 2048))   # C1's large cases, 128 MB each
TAKE_N = 1 << 24             # C2's large cases: indices, into 16 MB and 256 MB
TAKE_TABLES = (1 << 22, 1 << 26)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=REPS):
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
    row for one block and for one block per SM.  Returns what failed."""
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
            log(f"     D: {pk.RING_ITERS} rows of [{pk.RING_ROWS}, width] f32, "
                f"{pk.RING_SLOTS} copies in flight, {REPS} launches after a warm-up")
            failures = ring_rates(dev, sms)
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
