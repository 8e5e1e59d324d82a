"""Sorted-segment primitives (counterpart of rmi_tpu/utils/segments.py).

The top model is monotonic, so leaf ids over the sorted key array are
NON-DECREASING and every per-leaf reduction is a reduction over a
contiguous range.  The JAX package rewrote searchsorted, the scans and
the segmented max into TPU-friendly forms.  On the card the plain
operations serve instead: ``torch.searchsorted`` in place of
sorted_starts (below) and hier_count (models/cubic.py, the integer
models); FixDups is one kernel (ops/scan_kernel.fixdups), the linear
and normal leaf fits' sums, means and moments another
(ops/select_kernel.aug_fit_moments, whose plain version is range_sum
here and K2's), the loglinear leaf fit's a third form of it
(aug_fit_log_moments: aug_masked_stats here and K2 weighted's plain
version), kernel K2 the data-parallel moments, and
the per-leaf maxima are taken inside kernel K3 and the run-length pass
(ops/sweep_kernel.py), with ``range_max`` here as their plain form.

Leaf-overlap semantics (two_layer.rs:52-82): a non-empty leaf j with
span [s_j, e_j) trains on the augmented range [s_j - (s_j>0),
min(e_j+1, n)); an empty leaf trains on nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rmi_tpu_torch.ops import select_kernel

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


def sorted_starts(t: torch.Tensor, B: int) -> torch.Tensor:
    """starts[j] = #{i : t[i] < j} for j < B and NON-DECREASING integer t
    (rmi_tpu segments.py:260, whose blocked compare-reduce form is a TPU
    workaround)."""
    return torch.searchsorted(t, torch.arange(B, dtype=t.dtype, device=t.device))


def make_spans(t: torch.Tensor, B: int) -> Spans:
    """Leaf spans of non-decreasing leaf ids t: starts[j] = #{i : t[i] < j}."""
    return spans_from_starts(t, sorted_starts(t, B), t.shape[0])


def spans_from_starts(t: Optional[torch.Tensor], starts: torch.Tensor, n: int) -> Spans:
    """The Spans of leaves starting at ``starts`` [B] (int64,
    non-decreasing) over n keys, ``t`` their leaf ids (kept as given:
    the data-parallel build passes a shard's)."""
    B = starts.shape[0]
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
    """Sum of values[starts[j]:ends[j]] per j: whole_array_sum for a
    single range (the top fits), prefix-sum differences otherwise."""
    if starts.shape[0] == 1:
        return whole_array_sum(values.double(), int(starts[0]), int(ends[0]))
    c = prefix_sum_exclusive(values)
    return c[ends] - c[starts]


_XLA_WINDOW = 32


def whole_array_sum(values: torch.Tensor, lo: int, hi: int,
                    times: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[1] f64: the sum of values[lo:hi] (of values * times when given).

    On the CPU it adds in the order in which XLA adds rmi_tpu's masked
    whole-array reductions under jit, so that the top fits equal
    rmi_tpu's bit for bit: XLA rewrites a reduction longer than 32 as
    windows of 32 summed in sequence, with the padding split between the
    two ends, then reduces the window sums the same way, and the
    masked-out elements keep their places as zeros.  A product is rounded
    before it is summed, except in a reduction of 32 or fewer, one loop
    in which XLA fuses it into the sum as an FMA; of such tiny masked
    sums (a trimmed container of 11 to 32) a few round otherwise in
    rmi_tpu.  On the card the linear-family and normal tops' fits add in
    this order inside rmi_top_moments (ops/top_kernel.top_moments, with
    no host step); the other callers here (the loglinear and lognormal
    tops, bradix's chi^2) take one reduction in torch's own fixed order."""
    n = values.shape[0]
    if times is not None and n <= _XLA_WINDOW:
        acc = values.new_zeros(())
        for a, b in zip(values[lo:hi], times[lo:hi]):
            acc = torch.addcmul(acc, a, b)
        return acc.reshape(1)
    if not values.is_cpu:
        v = values[lo:hi] if times is None else values[lo:hi] * times[lo:hi]
        return v.sum().reshape(1)
    v = values if times is None else values * times
    if not (lo == 0 and hi == n):
        masked = torch.zeros_like(v)
        masked[lo:hi] = v[lo:hi]
        v = masked
    while v.shape[0] > _XLA_WINDOW:
        pad = -v.shape[0] % _XLA_WINDOW
        rows = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        # a row's cumsum adds in sequence, as XLA's window loop does
        v = rows.view(-1, _XLA_WINDOW).cumsum(1)[:, -1].contiguous()
    return v.cumsum(0)[-1:] if v.shape[0] else v.new_zeros(1)


def aug_count(spans: Spans) -> torch.Tensor:
    """Number of points in each augmented range (f64)."""
    return (spans.aug_ends - spans.aug_starts).double()


def aug_sum(spans: Spans, values: torch.Tensor) -> torch.Tensor:
    """Per-leaf sum of ``values`` over the augmented ranges (f64 [B])."""
    return range_sum(values, spans.aug_starts, spans.aug_ends)


def aug_first_last(spans: Spans):
    """Indices of the first and last element of each augmented range,
    clipped to the array: arbitrary for empty leaves, which every fit
    special-cases."""
    n = spans.n
    return (spans.aug_starts.clamp(0, max(n - 1, 0)),
            (spans.aug_ends - 1).clamp(0, max(n - 1, 0)))


def aug_masked_stats(spans: Spans, weights, *values):
    """(count, sum, ...): the sum of the 0/1 ``weights`` and of each of
    ``values`` times them over the augmented ranges, the reference's
    item dropping (loglinear skips non-finite logs, linear.rs:63-67)."""
    if spans.B == 1:
        s0, e0 = int(spans.aug_starts[0]), int(spans.aug_ends[0])
        return (whole_array_sum(weights, s0, e0),
                *(whole_array_sum(v, s0, e0, times=weights) for v in values))
    return (range_sum(weights, spans.aug_starts, spans.aug_ends),
            *(range_sum(v * weights, spans.aug_starts, spans.aug_ends)
              for v in values))


def aug_centered_moments(spans: Spans, x, y, mean_x, mean_y, weights=None):
    """(m2, c): per-leaf sum (x-mx)^2 and sum (x-mx)(y-my) over the
    augmented ranges, each term times its 0/1 weight when ``weights`` is
    given.  One whole-array span reduces directly, as the JAX package
    does for top fits (whole_array_sum), with each product rounded
    before it is weighted (segments.py:415-420 of rmi_tpu); leaf fits
    run kernel K2."""
    if spans.B == 1:
        s0, e0 = int(spans.aug_starts[0]), int(spans.aug_ends[0])
        dx = x - mean_x[0]
        dy = y - mean_y[0]
        if weights is None:
            return (whole_array_sum(dx, s0, e0, times=dx),
                    whole_array_sum(dx, s0, e0, times=dy))
        return (whole_array_sum(dx * dx, s0, e0, times=weights),
                whole_array_sum(dx * dy, s0, e0, times=weights))
    return select_kernel.aug_centered_moments(
        x, y, mean_x, mean_y, spans.aug_starts, spans.aug_ends, weights=weights)


def aug_centered_dot(spans: Spans, x, mean_x):
    """Per-leaf sum (x - mx)^2 over the augmented ranges: rmi_tpu's
    aug_centered_dot with x as y, the one form the normal models use
    (models/normal.py).  Leaf fits run K2's variance-only variant."""
    if spans.B == 1:
        s0, e0 = int(spans.aug_starts[0]), int(spans.aug_ends[0])
        dx = x - mean_x[0]
        return whole_array_sum(dx, s0, e0, times=dx)
    return select_kernel.aug_centered_xx(x, mean_x, spans.aug_starts, spans.aug_ends)


def range_max(values: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              fill) -> torch.Tensor:
    """max(values[starts[j]:ends[j]]) per range, ``fill`` for an empty
    one: the plain segmented max, each range's elements expanded and
    scattered to its slot.  It serves the CPU and the plain versions of
    the per-leaf maxima; on the card the build takes them inside the
    kernels (ops/sweep_kernel.py)."""
    leaf, elem = select_kernel.span_elements(starts, ends)
    out = torch.full((starts.shape[0],), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, leaf, values[elem], "amax", include_self=True)
