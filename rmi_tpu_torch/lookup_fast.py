"""Exact search through the packed plan, and sorted-batch serving with
kernel K5 (counterpart of rmi_tpu/lookup_fast.py, ported as far as the
main path needs).

The packed plan.  For a top model MONOTONE over the key domain (the
linear family and cubic always; a loglinear, normal or lognormal top when
_scalar_top_monotone finds its fitted row monotone there), every
key with a smaller leaf id precedes q and every key with a larger one
follows it, so lb(q) lies in [start_j, next_idx_j] for the leaf j that
q routes to.  Each leaf's row holds its stripe base start_j // 64 and S
sample keys keys[64 (base + i F)]; the count c1 of samples below q
bounds the stripe index lb1(q) = #(stripe-first keys < q) as
    LB1 <= lb1 <= LB1 + F,    LB1 = base + (c1 - 1) F,
without evaluating the leaf model.  With F = 1 ("packed") LB1 names the
stripe; with F > 1 ("packed_wide") one count over 128 stripe-first keys
resolves lb1.  A count over the stripe's 64 keys finishes the search.
Queries route clipped to [keys[0], keys[-1]] (the cubic top is monotone
on that interval only) and count raw, so out-of-range queries resolve
through the boundary leaf.

Where no sample spacing F <= 64 covers the widest leaf, the plan is
"bounded": lookup (top eval, K4) and the bounded binary search of
lookup.bounded_search.  rmi_tpu builds its hierarchical plan there,
which is not ported yet (ROADMAP.md Queue 1, item 8).

Sorted serving.  Over a non-decreasing batch lb1 is non-decreasing, so
the leaf rows of a block's first and last query bound lb1 for every
query between them; K5 (ops/sorted_serve_kernel.py) counts inside that
window of the sample level group_first = keys[::8], then in one 8-key
group.  A batch in any order is sorted and served by K5's scatter
entry, which writes each answer back to the query's place
(fast_search_via_sort).

Keys and queries are int64 images (rmi_tpu_torch.keys), so int64
compares replace rmi_tpu's u32 hi/lo words, and the key array is read
where it lies instead of copied into [n / 64, 256] u32 rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import sorted_serve_kernel
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

STRIDE = sorted_serve_kernel.STRIPE   # keys per stripe
WIDTH = 128                           # stripe-first keys of one mid-level count

# rmi_tpu's widest u32 leaf row (a base lane and S hi and S lo words),
# kept so that (S, F) are the same integers in both packages
_PACKED_MAX_LANES = 256
# the wide plan's mid-level count covers lb1 while F + 63 < WIDTH
_WIDE_MAX_STRIDE = 64
# the port's tops that are monotone on the key domain
_MONOTONE_TOPS = ("linear", "robust_linear", "linear_spline", "cubic")
# tops that are monotone there when their fitted row is (_scalar_top_monotone)
_SCALAR_TOPS = ("loglinear", "normal", "lognormal")

# exp1's monotone region is v >= -64; phi(u) = 1/(1+exp1(-1.65451 u))
# feeds it w = -1.65451 u, so u must stay <= 64/1.65451 ~ 38.68.
# Margins absorb f64 rounding in the host-side endpoint evaluation
# (rmi_tpu/lookup_fast.py:192-196).
_EXP1_V_MIN = -63.9
_PHI_U_MAX = 38.6

SORTED_MIN = 1 << 14    # smallest batch fast_search_sorted sends to K5
MAX_CHUNK = 1 << 21     # queries per packed-search step: ~1 GB of [., 64] rows


@dataclasses.dataclass
class Plan:
    """How one index serves exact search."""

    kind: str                      # "packed", "packed_wide" or "bounded"
    n: int
    S: int = 0                     # sample keys per leaf row
    F: int = 1                     # stripes between samples
    rows: Optional[torch.Tensor] = None          # [B, 1 + S] int64
    stripe_first: Optional[torch.Tensor] = None  # keys[::64], [ceil(n / 64)]
    group_first: Optional[torch.Tensor] = None   # keys[::8], K5's sample level: n bytes
    kmin: int = 0                 # keys[0], keys[-1]: the routing domain
    kmax: int = 0


def supports_fast_path(rmi) -> bool:
    """An index with its errors and keys serves through get_plan's plan."""
    return rmi.leaf_errors is not None and rmi.keys is not None


def leaf_spans(rmi):
    """(starts, next_idx), [B] int64 each: a leaf's first row and the
    first row of the next non-empty leaf (n if none), from the top's
    assignment of the keys.  Made once and kept on the index."""
    if rmi.leaf_spans_cache is None:
        B = rmi.branching_factor
        t = two_layer.top_assignment(get_model(rmi.top_type),
                                     rmi.device_top_params, rmi.keys,
                                     rmi.norm_offset, rmi.norm_scale, B - 1)
        spans = seg.make_spans(t.to(torch.int32), B)
        next_idx = two_layer.lower_bound_fills(spans, rmi.keys,
                                               rmi.key_type)[0]
        rmi.leaf_spans_cache = (spans.starts, next_idx)
    return rmi.leaf_spans_cache


def packed_sample_lanes(rmi) -> int:
    """Sample count S that lets every leaf row reach its next_idx at
    spacing F = 1: the least S with 64 (start // 64 + S - 1) >= next_idx."""
    starts, next_idx = leaf_spans(rmi)
    lo = starts // STRIDE
    s_req = -(-(next_idx - lo * STRIDE) // STRIDE) + 1
    return max(2, int(s_req.max()))


def packed_plan_shape(rmi):
    """(S, F): F == 1 gives the packed plan, 1 < F <= 64 the wide plan;
    None when leaves are too wide even at F = 64 (the bounded plan)."""
    s_max = packed_sample_lanes(rmi)
    s_cap = (_PACKED_MAX_LANES - 1) // 2
    if s_max <= s_cap:
        return s_max, 1
    F = 2
    while F <= _WIDE_MAX_STRIDE and -(-(s_max - 1) // F) + 1 > s_cap:
        F *= 2
    if F > _WIDE_MAX_STRIDE:
        return None
    return -(-(s_max - 1) // F) + 1, F


def leaf_rows(rmi, S: int, F: int) -> torch.Tensor:
    """[B, 1 + S] int64: each leaf's stripe base start // 64, then the S
    sample keys keys[64 (base + i F)]; a sample at or past n reads as
    the key type's largest image, which no query is below."""
    starts, _ = leaf_spans(rmi)
    keys = rmi.keys
    n = keys.shape[0]
    base = starts // STRIDE
    idx = (base[:, None]
           + torch.arange(S, device=keys.device) * F) * STRIDE
    samples = torch.where(idx < n, keys[idx.clamp(max=n - 1)],
                          rmi.key_type.max_image)
    return torch.cat([base[:, None], samples], 1)


def get_plan(rmi) -> Plan:
    """The index's search plan, made on first use and kept on it."""
    if rmi.plan_cache is None:
        rmi.plan_cache = _make_plan(rmi)
    return rmi.plan_cache


def _scalar_top_monotone(rmi) -> bool:
    """Is this loglinear, normal or lognormal top non-decreasing over the
    domain-clipped query range?  (rmi_tpu/lookup_fast.py:199-234.)  Every
    floating-point step of these evaluations is weakly monotone inside
    the region, so endpoint conditions on the fitted row suffice:
      * loglinear, exp1(beta x + alpha): beta >= 0 and v >= -64 at the
        domain's low end;
      * normal and lognormal, phi((x - mean) / stdev) * scale: stdev > 0,
        scale >= 0 (NaN and -inf rows exist), and u <= 64 / 1.65451 at
        the domain's high end, so exp1's argument stays in its monotone
        region."""
    w = rmi.device_top_params[0].tolist()
    kminf, kmaxf = keymod.as_float(rmi.keys[[0, -1]]).tolist()
    if rmi.top_type == "loglinear":
        alpha, beta = w
        if not (math.isfinite(alpha) and math.isfinite(beta) and beta >= 0):
            return False
        x_lo = (kminf - rmi.norm_offset) * rmi.norm_scale
        return beta * x_lo + alpha >= _EXP1_V_MIN
    mean, stdev, scale = w
    if not (math.isfinite(mean) and math.isfinite(stdev) and stdev > 0.0
            and math.isfinite(scale) and scale >= 0.0):
        return False
    if rmi.top_type == "lognormal":
        # the raw-domain input max(0, ln x), itself non-decreasing in q
        x_hi = max(0.0, math.log(kmaxf)) if kmaxf > 0 else 0.0
    else:
        x_hi = (kmaxf - rmi.norm_offset) * rmi.norm_scale
    return (x_hi - mean) / stdev <= _PHI_U_MAX


def _monotone_top(rmi) -> bool:
    """Does the top take the packed plan's routing argument (rmi_tpu
    lookup_fast.py:587-591)?"""
    if rmi.top_type in _MONOTONE_TOPS:
        return True
    return rmi.top_type in _SCALAR_TOPS and _scalar_top_monotone(rmi)


def _make_plan(rmi) -> Plan:
    n = rmi.keys.shape[0]
    shape = packed_plan_shape(rmi) if _monotone_top(rmi) else None
    if shape is None:
        return Plan("bounded", n)
    S, F = shape
    kmin, kmax = rmi.keys[[0, -1]].tolist()
    return Plan("packed" if F == 1 else "packed_wide", n, S, F,
                leaf_rows(rmi, S, F), rmi.keys[::STRIDE].contiguous(),
                rmi.keys[::sorted_serve_kernel.GROUP].contiguous(), kmin, kmax)


def stripe_lower_limits(rmi, plan: Plan, q: torch.Tensor) -> torch.Tensor:
    """LB1 per query, with LB1 <= lb1(q) <= LB1 + F: route the clipped
    query to its leaf row and count the row's samples below q."""
    qr = q.clamp(plan.kmin, plan.kmax)
    midx = two_layer.top_assignment(get_model(rmi.top_type),
                                    rmi.device_top_params, qr, rmi.norm_offset,
                                    rmi.norm_scale, rmi.branching_factor - 1)
    rows = plan.rows[midx]
    c1 = (rows[:, 1:] < q[:, None]).sum(1)
    return rows[:, 0] + (c1 - 1) * plan.F


def _count_from(arr, start, q, width: int):
    """start + #(arr[start : start + width] < q) per query; positions
    past the end of ``arr`` count as not below q."""
    m = arr.shape[0]
    idx = start[:, None] + torch.arange(width, device=q.device)
    below = (idx < m) & (arr[idx.clamp(max=m - 1)] < q[:, None])
    return start + below.sum(1)


def _packed_search(rmi, plan: Plan, q: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of one chunk (rmi_tpu's _fast_search_packed
    and _fast_search_packed_wide).  lb lies in (64 (lb1 - 1), 64 lb1], so
    the count over stripe lb1 - 1 needs its 64 keys only."""
    nrows0 = plan.stripe_first.shape[0]
    LB1 = stripe_lower_limits(rmi, plan, q)
    if plan.F == 1:
        row = LB1.clamp(0, nrows0 - 1)       # lb1 - 1 <= LB1 <= lb1
    else:
        r1 = LB1.clamp(0, nrows0) >> 6       # 64 r1 <= lb1 <= 64 r1 + 127
        lb1 = _count_from(plan.stripe_first, r1 * STRIDE, q, WIDTH)
        row = (lb1.clamp(max=nrows0) - 1).clamp(0, nrows0 - 1)
    return _count_from(rmi.keys, row * STRIDE, q, STRIDE).clamp(max=plan.n)


def fast_search(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of int64 images in any order, through the
    index's plan, MAX_CHUNK queries at a time."""
    plan = get_plan(rmi)
    if plan.kind == "bounded":
        # imported here: rmi_tpu_torch.lookup imports this module
        from rmi_tpu_torch.lookup import bounded_search
        return bounded_search(rmi, queries)
    out = torch.empty_like(queries)
    for i in range(0, queries.shape[0], MAX_CHUNK):
        out[i:i + MAX_CHUNK] = _packed_search(rmi, plan,
                                              queries[i:i + MAX_CHUNK])
    return out


# ---------------------------------------------------------------------------
# sorted batches: kernel K5
# ---------------------------------------------------------------------------

def sorted_anchors(rmi, plan: Plan, qs: torch.Tensor):
    """(LB1_f, LB1_l): LB1 of the first and of the last query of each K5
    block of the sorted batch ``qs`` (the last block may be short).  The
    counterpart of rmi_tpu's _sorted_stats_direct, which pads the batch
    with its last query and anchors every 128 queries, so LB1_f here is
    every KQ / 128-th of its LB1_f.  The top is evaluated on these
    2 / KQ of the queries only: the kernel needs no per-query leaf."""
    nq, kq = qs.shape[0], sorted_serve_kernel.KQ
    first = torch.arange(0, nq, kq, device=qs.device)
    last = (first + kq - 1).clamp(max=nq - 1)
    LB1 = stripe_lower_limits(rmi, plan, qs[torch.cat([first, last])])
    return LB1[:first.shape[0]], LB1[first.shape[0]:]


def sorted_bounds(rmi, plan: Plan, qs: torch.Tensor):
    """K5's window bounds [lo, hi] per block of KQ sorted queries.  Over
    the block lb1 runs from lb1(first) >= LB1_f to lb1(last) <= LB1_l + F,
    so lo = LB1_f - 1 and hi = LB1_l + F hold every query's lb1 - 1 and
    lb1, clamped to the stripe count."""
    LB1_f, LB1_l = sorted_anchors(rmi, plan, qs)
    nrows0 = plan.stripe_first.shape[0]
    return (LB1_f - 1).clamp(0, nrows0), (LB1_l + plan.F).clamp(0, nrows0)


def sorted_search(rmi, plan: Plan, qs: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of a non-decreasing batch through K5."""
    qs = qs.contiguous()
    lo, hi = sorted_bounds(rmi, plan, qs)
    return sorted_serve_kernel.serve_sorted(qs, plan.group_first, rmi.keys,
                                            lo, hi)


def fast_search_sorted(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of a NON-DECREASING batch: K5 for a packed plan
    and at least SORTED_MIN queries, fast_search otherwise."""
    plan = get_plan(rmi)
    if plan.kind != "bounded" and queries.shape[0] >= SORTED_MIN:
        return sorted_search(rmi, plan, queries)
    return fast_search(rmi, queries)


def serve_via_sort(rmi, plan: Plan, queries: torch.Tensor) -> torch.Tensor:
    """Sort and serve the sorted batch with K5's scatter entry, which
    writes each answer to its query's place in the input (out[order] =
    lb), with no density gate."""
    qs, order = torch.sort(queries)
    lo, hi = sorted_bounds(rmi, plan, qs)
    return sorted_serve_kernel.serve_sorted_scatter(qs, order, plan.group_first,
                                                    rmi.keys, lo, hi)


def fast_search_via_sort(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of a batch in any order through sort -> K5 ->
    unsort, when the batch is dense enough that its blocks' windows are
    short: 4 nq >= 3 ceil(n / 64), rmi_tpu's gate.  Sparser batches, and
    bounded plans, take fast_search.  K5 never declines a batch, so
    rmi_tpu's veto and re-probe of a declining kernel have no
    counterpart."""
    plan = get_plan(rmi)
    nrows0 = -(-plan.n // STRIDE)
    if plan.kind == "bounded" or 4 * queries.shape[0] < 3 * nrows0:
        return fast_search(rmi, queries)
    return serve_via_sort(rmi, plan, queries)
