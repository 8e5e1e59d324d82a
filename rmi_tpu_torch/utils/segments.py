"""Sorted-segment primitives (counterpart of rmi_tpu/utils/segments.py).

The top model is monotonic, so leaf ids over the sorted key array are
NON-DECREASING and every per-leaf reduction is a reduction over a
contiguous range.  The JAX package rewrote searchsorted, the scans and
the segmented max into TPU-friendly forms.  On the card the plain
operations serve instead: ``torch.searchsorted`` in place of
sorted_starts (make_spans) and hier_count (models/cubic.py),
``scatter_reduce`` for the segmented max; kernel K1 (ops/scan_kernel.py)
runs the two n-scale monotone scans and kernel K2 (ops/select_kernel.py)
the per-leaf moments.

Leaf-overlap semantics (two_layer.rs:52-82): a non-empty leaf j with
span [s_j, e_j) trains on the augmented range [s_j - (s_j>0),
min(e_j+1, n)); an empty leaf trains on nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rmi_tpu_torch.ops import scan_kernel, select_kernel

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


@dataclasses.dataclass
class Spans:
    """Per-leaf contiguous ranges over the sorted key array."""

    t: Optional[torch.Tensor]  # [n] int32 leaf ids (None for the whole-array span)
    starts: torch.Tensor       # [B] int64
    ends: torch.Tensor         # [B] int64
    aug_starts: torch.Tensor   # [B] int64
    aug_ends: torch.Tensor     # [B] int64
    nonempty: torch.Tensor     # [B] bool
    n: int
    B: int


def make_spans(t: torch.Tensor, B: int) -> Spans:
    """Leaf spans of non-decreasing leaf ids t: starts[j] = #{i : t[i] < j}."""
    n = t.shape[0]
    starts = torch.searchsorted(t, torch.arange(B, dtype=t.dtype, device=t.device))
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    nonempty = starts < ends
    has_prev = nonempty & (starts > 0)
    has_next = nonempty & (ends < n)
    aug_starts = torch.where(nonempty, starts - has_prev.long(), 0)
    aug_ends = torch.where(nonempty, ends + has_next.long(), 0)
    return Spans(t=t, starts=starts, ends=ends, aug_starts=aug_starts,
                 aug_ends=aug_ends, nonempty=nonempty, n=n, B=B)


def whole_array_spans(n: int, device) -> Spans:
    """A 1-leaf Spans covering the entire array (top-model fits)."""
    z = torch.zeros(1, dtype=torch.int64, device=device)
    full = torch.full((1,), n, dtype=torch.int64, device=device)
    return Spans(t=None, starts=z, ends=full, aug_starts=z, aug_ends=full,
                 nonempty=torch.ones(1, dtype=torch.bool, device=device),
                 n=n, B=1)


_SCAN_ROW = 1024


def prefix_sum_exclusive(values: torch.Tensor) -> torch.Tensor:
    """[n] -> [n+1] f64 with out[i] = sum(values[:i]), the same in every
    run (see _row_scan)."""
    v = values.double()
    out = v.new_zeros(v.shape[0] + 1)
    out[1:] = _row_scan(v)
    return out


def _row_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive f64 scan of [n] ``v`` in rows of _SCAN_ROW, each row
    offset by the scan of the row totals before it.  torch scans a 1-D
    tensor on the card with a decoupled look-back, whose float adds fall
    in an order that changes from run to run; it scans the rows of a 2-D
    tensor in a fixed order.  So the matrix has at least two rows."""
    n = v.shape[0]
    rows = max(2, -(-n // _SCAN_ROW))
    m = v.new_zeros(rows * _SCAN_ROW)
    m[:n] = v
    m = torch.cumsum(m.view(rows, _SCAN_ROW), 1)
    if n > _SCAN_ROW:
        m[1:] += _row_scan(m[:-1, -1].contiguous())[:, None]
    return m.view(-1)[:n]


def range_sum(values: torch.Tensor, starts: torch.Tensor,
              ends: torch.Tensor) -> torch.Tensor:
    """Sum of values[starts[j]:ends[j]] per j: a direct reduction for a
    single range (the top fits), prefix-sum differences otherwise."""
    if starts.shape[0] == 1:
        s0, e0 = int(starts[0]), int(ends[0])
        return values[s0:e0].double().sum().reshape(1)
    c = prefix_sum_exclusive(values)
    return c[ends] - c[starts]


def aug_count(spans: Spans) -> torch.Tensor:
    """Number of points in each augmented range (f64)."""
    return (spans.aug_ends - spans.aug_starts).double()


def aug_centered_moments(spans: Spans, x, y, mean_x, mean_y):
    """(m2, c): per-leaf sum (x-mx)^2 and sum (x-mx)(y-my) over the
    augmented ranges.  One whole-array span reduces directly, as the
    JAX package does for top fits; leaf fits run kernel K2."""
    if spans.B == 1:
        s0, e0 = int(spans.aug_starts[0]), int(spans.aug_ends[0])
        dx = x[s0:e0] - mean_x[0]
        return ((dx * dx).sum().reshape(1),
                (dx * (y[s0:e0] - mean_y[0])).sum().reshape(1))
    return select_kernel.aug_centered_moments(
        x, y, mean_x, mean_y, spans.aug_starts, spans.aug_ends)


def range_max(values: torch.Tensor, spans: Spans, fill) -> torch.Tensor:
    """max(values[starts[j]:ends[j]]) per leaf, ``fill`` for empty
    leaves: a segmented max over the leaf ids, which are sorted."""
    out = torch.full((spans.B,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, spans.t.long(), values, "amax",
                               include_self=True)


def blocked_cummax(v: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running max of int32 ``v`` (kernel K1)."""
    return scan_kernel.scan_i32(v, is_max=True, fill=INT32_MIN,
                                reverse=reverse)


def blocked_cummin(v: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running min of int32 ``v`` (kernel K1)."""
    return scan_kernel.scan_i32(v, is_max=False, fill=INT32_MAX,
                                reverse=reverse)
