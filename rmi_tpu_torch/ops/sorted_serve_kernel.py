"""K5: exact lower bounds for a sorted query batch by window counts
(csrc/sorted_serve.cu).

Counterpart of rmi_tpu/ops/sorted_serve_kernel.py (the direct-count
kernel).  Queries are cut into blocks of KQ; block b carries window
bounds [lo[b], hi[b]] in 64-key stripes, which group_bounds turns into
bounds [glo[b], ghi[b]] over the sample level ``group_first =
keys[::GROUP]``, and
  c   = clamp(#(group_first < q), glo[b], ghi[b])
  row = max(c - 1, 0)
  lb  = min(GROUP * row + #(keys[GROUP row : GROUP row + GROUP] < q), n).
For bounds with lo[b] <= lb1(q) <= hi[b] on every query of the block,
lb1 = #(keys[::64] < q), that is searchsorted(keys, q, side="left");
lookup_fast.sorted_bounds derives them.  The kernel counts inside the
window only, so wrong bounds give wrong answers; the plain version
clamps to the same bounds and is wrong the same way, which lets the CPU
tests hold the bounds.  serve_sorted_scatter writes the answer of sorted
query i to out[order[i]]: the unsort of a batch sorted by torch.sort.

GROUP is 8: one 64-byte group per query.  The kernel is built for 16
too, which chip_smoke.py times beside it (serve_sorted_level); 8 was
the faster on the H100 (PERF.md).
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.ops import _build

KQ = 512          # queries per kernel block (one per thread), and per window
STRIPE = 64       # keys per stripe: the window bounds count stripes
GROUP = 8         # keys per group: group_first = keys[::GROUP]
LEVELS = (8, 16)  # the group sizes the kernel is built for
WINDOW_CAP = 6144  # group-first keys a block stages in shared memory (48 KB)
ALIGN = 16        # bytes: keys and group_first start on this boundary


def _check(q, order, group_first, keys, lo, hi, group):
    for name, t in (("q", q), ("order", order), ("group_first", group_first),
                    ("keys", keys), ("lo", lo), ("hi", hi)):
        if t is not None and (t.dtype != torch.int64 or t.dim() != 1):
            raise ValueError(f"serve_sorted: {name} must be 1-D int64")
    if group not in LEVELS:
        raise ValueError(f"serve_sorted: group must be one of {LEVELS}")
    if group_first.shape[0] != -(-keys.shape[0] // group):
        raise ValueError(f"serve_sorted: group_first must be keys[::{group}]")
    if order is not None and order.shape != q.shape:
        raise ValueError("serve_sorted: order must hold one index per query")
    nblocks = -(-q.shape[0] // KQ)
    if lo.shape[0] != nblocks or hi.shape[0] != nblocks:
        raise ValueError(f"serve_sorted: lo and hi must hold {nblocks} "
                         f"block bounds (one per {KQ} queries)")
    for name, t in (("keys", keys), ("group_first", group_first)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"serve_sorted: {name} must start on a {ALIGN}-byte "
                             f"boundary (the kernel reads it in 16-byte vectors), "
                             f"not a view such as keys[1:]")


def group_bounds(lo, hi, n: int, group: int = GROUP):
    """(glo, ghi): the blocks' windows over keys[::group], from their
    stripe bounds clamped to 0 <= lo <= hi <= ceil(n / 64) as the kernel
    clamps them.  lo <= lb1 <= hi gives 64 (lo - 1) < lb <= 64 hi, so
    ceil(lb / group) lies in [r lo - (r - 1), r hi], r = 64 / group."""
    nrows0, ng, r = -(-n // STRIPE), -(-n // group), STRIPE // group
    lo = lo.clamp(0, nrows0)
    hi = torch.maximum(hi, lo).clamp(max=nrows0)
    return (r * lo - (r - 1)).clamp(0, ng), (r * hi).clamp(max=ng)


def serve_sorted_plain(q, group_first, keys, lo, hi, group: int = GROUP):
    """The plain PyTorch version: searchsorted over group_first clamped
    to the block's window, then a masked count over the group."""
    n = keys.shape[0]
    glo, ghi = group_bounds(lo, hi, n, group)
    blk = torch.arange(q.shape[0], device=q.device) // KQ
    c = torch.searchsorted(group_first, q)
    c = torch.minimum(torch.maximum(c, glo[blk]), ghi[blk])
    row = (c - 1).clamp(min=0)
    idx = row[:, None] * group + torch.arange(group, device=q.device)
    below = (idx < n) & (keys[idx.clamp(max=n - 1)] < q[:, None])
    return (row * group + below.sum(1)).clamp(max=n)


def serve_sorted_scatter_plain(q, order, group_first, keys, lo, hi):
    """The plain version of the scatter entry: out[order] = lb."""
    out = torch.empty_like(q)
    out[order] = serve_sorted_plain(q, group_first, keys, lo, hi)
    return out


def _serve(q, order, group_first, keys, lo, hi, group):
    _check(q, order, group_first, keys, lo, hi, group)
    if q.is_cpu:
        if order is None:
            return serve_sorted_plain(q, group_first, keys, lo, hi, group)
        return serve_sorted_scatter_plain(q, order, group_first, keys, lo, hi)
    nq = q.shape[0]
    if nq == 0:       # nothing to launch, so no call of the binding, which counts one
        for t in (q, order, group_first, keys, lo, hi):
            if t is not None and (t.device != q.device or not t.is_contiguous()):
                raise ValueError("serve_sorted: every tensor must be contiguous and on "
                                 "the queries' CUDA device")
        return torch.empty_like(q)
    common = (nq, group_first, group_first.shape[0], keys, keys.shape[0], lo, hi, KQ, group,
              nq)
    if order is None:
        return _build.launch("rmi_serve_sorted", q, *common)
    return _build.launch("rmi_serve_sorted_scatter", q, order, *common)


def serve_sorted(q, group_first, keys, lo, hi) -> torch.Tensor:
    """[nq] int64 lower bounds of the sorted int64 images ``q`` in the
    sorted ``keys``; ``lo``/``hi`` [ceil(nq / KQ)] are the blocks' window
    bounds in 64-key stripes; ``group_first = keys[::GROUP]``."""
    return _serve(q, None, group_first, keys, lo, hi, GROUP)


def serve_sorted_scatter(q, order, group_first, keys, lo, hi) -> torch.Tensor:
    """serve_sorted with the answers scattered: out[order[i]] is the lower
    bound of q[i], for ``order`` a permutation of range(nq) (torch.sort's
    indices, which puts the answers back in the batch's own order)."""
    return _serve(q, order, group_first, keys, lo, hi, GROUP)


def serve_sorted_level(q, group_first, keys, lo, hi, group: int) -> torch.Tensor:
    """serve_sorted over ``group_first = keys[::group]`` for any group of
    LEVELS: chip_smoke.py times the level GROUP was chosen over with it.
    Serving calls serve_sorted."""
    return _serve(q, None, group_first, keys, lo, hi, group)
