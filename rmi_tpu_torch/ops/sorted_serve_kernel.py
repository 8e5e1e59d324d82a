"""K5: exact lower bounds for a sorted query batch by window counts
(csrc/sorted_serve.cu).

Counterpart of rmi_tpu/ops/sorted_serve_kernel.py (the direct-count
kernel).  Queries are cut into blocks of KQ; block b carries window
bounds [lo[b], hi[b]] over ``stripe_first = keys[::64]`` and
  lb1 = clamp(#(stripe_first < q), lo[b], hi[b])
  row = max(lb1 - 1, 0)
  lb  = min(64 * row + #(keys[64 row : 64 row + 64] < q), n).
For bounds with lo[b] <= lb1(q) <= hi[b] on every query of the block
that is searchsorted(keys, q, side="left"); lookup_fast.sorted_bounds
derives them.  The kernel counts inside the window only, so wrong
bounds give wrong answers; the plain version clamps to the same bounds
and is wrong the same way, which lets the CPU tests hold the bounds.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.ops import _build

KQ = 1024        # queries per kernel block, and per window
STRIPE = 64      # keys per stripe: stripe_first = keys[::STRIPE]


def _check(q, stripe_first, keys, lo, hi):
    for name, t in (("q", q), ("stripe_first", stripe_first), ("keys", keys),
                    ("lo", lo), ("hi", hi)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"serve_sorted: {name} must be 1-D int64")
    if stripe_first.shape[0] != -(-keys.shape[0] // STRIPE):
        raise ValueError("serve_sorted: stripe_first must be keys[::64]")
    nblocks = -(-q.shape[0] // KQ)
    if lo.shape[0] != nblocks or hi.shape[0] != nblocks:
        raise ValueError(f"serve_sorted: lo and hi must hold {nblocks} "
                         f"block bounds (one per {KQ} queries)")


def _clamped_bounds(lo, hi, nrows0: int):
    """0 <= lo <= hi <= nrows0, as the kernel clamps them."""
    lo = lo.clamp(0, nrows0)
    return lo, torch.maximum(hi, lo).clamp(max=nrows0)


def serve_sorted_plain(q, stripe_first, keys, lo, hi) -> torch.Tensor:
    """The plain PyTorch version: searchsorted over stripe_first clamped
    to the block's bounds, then a masked count over the stripe."""
    n, nrows0 = keys.shape[0], stripe_first.shape[0]
    lo, hi = _clamped_bounds(lo, hi, nrows0)
    blk = torch.arange(q.shape[0], device=q.device) // KQ
    lb1 = torch.searchsorted(stripe_first, q)
    lb1 = torch.minimum(torch.maximum(lb1, lo[blk]), hi[blk])
    row = (lb1 - 1).clamp(min=0)
    idx = row[:, None] * STRIPE + torch.arange(STRIPE, device=q.device)
    below = (idx < n) & (keys[idx.clamp(max=n - 1)] < q[:, None])
    return (row * STRIPE + below.sum(1)).clamp(max=n)


def serve_sorted(q, stripe_first, keys, lo, hi) -> torch.Tensor:
    """[nq] int64 lower bounds of the sorted int64 images ``q`` in the
    sorted ``keys``; ``lo``/``hi`` [ceil(nq / KQ)] are the blocks' window
    bounds over ``stripe_first = keys[::64]``."""
    _check(q, stripe_first, keys, lo, hi)
    if q.device.type == "cpu":
        return serve_sorted_plain(q, stripe_first, keys, lo, hi)
    _build.check_cuda("serve_sorted", q, stripe_first, keys, lo, hi)
    out = torch.empty_like(q)
    if q.shape[0]:
        _build.launch("rmi_serve_sorted", q, q.shape[0], stripe_first,
                      stripe_first.shape[0], keys, keys.shape[0], lo, hi, KQ,
                      out)
    return out
