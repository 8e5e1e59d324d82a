"""Exact search through the packed and hierarchical plans, and
sorted-batch serving with kernel K5 (counterpart of
rmi_tpu/lookup_fast.py).

The packed plan.  For a top model MONOTONE over the key domain (the
linear family, cubic and the integer-output tops always; a loglinear,
normal or lognormal top when _scalar_top_monotone finds its fitted row
monotone there), every
key with a smaller leaf id precedes q and every key with a larger one
follows it, so lb(q) lies in [start_j, next_idx_j] for the leaf j that
q routes to.  Each leaf has its stripe base start_j // 64 (plan.base)
and a row of S sample keys keys[64 (base + i F)] (plan.rows, padded to
an even width); the count c1 of samples below q
bounds the stripe index lb1(q) = #(stripe-first keys < q) as
    LB1 <= lb1 <= LB1 + F,    LB1 = base + (c1 - 1) F,
without evaluating the leaf model.  With F = 1 ("packed") LB1 names the
stripe; with F > 1 ("packed_wide") one count over 128 stripe-first keys
resolves lb1.  A count over the stripe's 64 keys finishes the search.
Queries route clipped to [keys[0], keys[-1]] (the cubic top is monotone
on that interval only) and count raw, so out-of-range queries resolve
through the boundary leaf.  An integer-output top on f64 keys routes
truncated keys, so it takes no packed plan (rmi_tpu lookup_fast.py:
592-595).  The search is ops/packed_kernel.packed_search: on the card one
launch of rmi_packed_search for the whole batch, where rmi_tpu runs one
XLA program.

The hierarchical plan ("hier", rmi_tpu's SearchPlan and resolve,
lookup_fast.py:140-160, 388-413, 554-577) serves every other index: a
top that is not monotone, or leaves wider than F = 64 covers.  lookup
gives each query's guess and err (K4's fused entry where
eval_kernel.fused_lookup holds, its two steps otherwise), so lb lies in
[guess - err, guess + err].  Over the levels L_k = keys[::64^k],
k = 0..K, with K the least k such that 2 err_max / 64^k + 2 <= 64,
lb_k = #(L_k < q) is a count over the 128 entries of L_k from
64 (LB_k >> 6), for any lower limit LB_k <= lb_k within 65 of it: the
guess gives level K's limit, each level's count the next one's.  Level 0
is the key array itself and the others strided copies of it in one
tensor (n / 63 entries in all); rmi_tpu's overlapped [rows, 128] copies
of each level are a TPU layout and have no counterpart.  The resolve is
ops/hier_kernel.resolve: on the card one launch of rmi_hier_resolve
for the whole batch after one fused lookup, where rmi_tpu runs both in
one XLA program; a hierarchical plan never sorts or runs K5.

Sorted serving.  Over a non-decreasing batch lb1 is non-decreasing, so
the leaf rows of a block's first and last query bound lb1 for every
query between them; K5 (ops/sorted_serve_kernel.py) counts inside that
window of the sample level group_first = keys[::8], then in one 8-key
group.  The windows come from one rmi_sorted_bounds launch
(packed_kernel.sorted_bounds), which routes each block's first and last
query only.  A batch in any order is sorted and served by K5's scatter
entry, which writes each answer back to the query's place
(fast_search_via_sort).

Keys and queries are int64 images (rmi_tpu_torch.keys), so int64
compares replace rmi_tpu's u32 hi/lo words, and the key array is read
where it lies instead of copied into [n / 64, 256] u32 rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import hier_kernel, packed_kernel, sorted_serve_kernel
# resolve is the hier plan's (the wrapper, which _hier_search calls by
# this module's name), resolve_plain its plain version beside it
from rmi_tpu_torch.ops.hier_kernel import LEVEL_FAN, resolve
from rmi_tpu_torch.ops.hier_kernel import resolve_plain  # noqa: F401
# K5's anchors, a plain step of packed_kernel.sorted_bounds
from rmi_tpu_torch.ops.packed_kernel import sorted_anchors  # noqa: F401
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import segments as seg

STRIDE = sorted_serve_kernel.STRIPE   # keys per stripe

# rmi_tpu's widest u32 leaf row (a base lane and S hi and S lo words),
# kept so that (S, F) are the same integers in both packages
_PACKED_MAX_LANES = 256
# the wide plan's mid-level count covers lb1 while F + 63 < hier_kernel.WIDTH
_WIDE_MAX_STRIDE = 64
# the tops that are monotone on the key domain (rmi_tpu lookup_fast.py:
# 178-190): the linear family on sorted data; the cubic on its interval
# (cubic_spline.rs:67-72); radix and bradix on the keys' common prefix,
# which the domain-clipped routing query keeps; the hint tables, built
# from non-decreasing targets with the trailing fill only clamping up
# (radix.rs:94-113); the histogram, an upper_bound over pivots whose
# first is keys[0], so a clipped query never takes its underflow wrap
_MONOTONE_TOPS = ("linear", "robust_linear", "linear_spline", "cubic", "radix",
                  "bradix", "radix8", "radix18", "radix22", "radix26", "radix28",
                  "histogram")
# tops that are monotone there when their fitted row is (_scalar_top_monotone)
_SCALAR_TOPS = ("loglinear", "normal", "lognormal")

# exp1's monotone region is v >= -64; phi(u) = 1/(1+exp1(-1.65451 u))
# feeds it w = -1.65451 u, so u must stay <= 64/1.65451 ~ 38.68.
# Margins absorb f64 rounding in the host-side endpoint evaluation
# (rmi_tpu/lookup_fast.py:192-196).
_EXP1_V_MIN = -63.9
_PHI_U_MAX = 38.6

SORTED_MIN = 1 << 14    # smallest batch fast_search_sorted sends to K5
MAX_CHUNK = 1 << 21     # queries per plain packed step: ~1 GB of [., 64] rows
HIER_CHUNK = 1 << 20    # queries per plain hierarchical step: ~1 GB of [., 128] counts


@dataclasses.dataclass
class Plan:
    """How one index serves exact search."""

    kind: str                      # "packed", "packed_wide" or "hier"
    n: int
    S: int = 0                     # sample keys per leaf row
    F: int = 1                     # stripes between samples
    rows: Optional[torch.Tensor] = None          # [B, Sp] int64 samples (sample_width)
    base: Optional[torch.Tensor] = None          # [B] int64: each row's stripe base
    stripe_first: Optional[torch.Tensor] = None  # keys[::64], [ceil(n / 64)]
    group_first: Optional[torch.Tensor] = None   # keys[::8], K5's sample level: n bytes
    kmin: int = 0                 # keys[0], keys[-1]: the routing domain
    kmax: int = 0
    K: int = 0                    # hier: the level the guess starts at
    levels: Optional[List[torch.Tensor]] = None  # hier: keys[::64^k], k = 0..K
    # hier: levels 1..K in one tensor and their (offset, length), the
    # kernel's (hier_kernel.hier_levels); levels[1:] are views into it
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    # packed: the key's decode and the top's operands as the packed kernels
    # take them (packed_kernel.top_operands), made on their first launch
    top_args: Optional[tuple] = None


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
                                     rmi.norm_offset, rmi.norm_scale, B - 1,
                                     rmi.key_type)
        spans = seg.make_spans(t, B)
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


def leaf_rows(rmi, S: int, F: int):
    """(base, rows): [B] int64 each leaf's stripe base start // 64, and
    [B, Sp] int64 its S sample keys keys[64 (base + i F)], Sp =
    packed_kernel.sample_width(S) (rmi_tpu's row, the base kept apart,
    the samples on 16-byte boundaries); a sample at or past n, and the
    padding past S, read as the largest image, IMAGE_MAX, which no query
    is below (rmi_tpu's all-ones u64; an f64 +inf's image lies above
    f64::MAX's)."""
    starts, _ = leaf_spans(rmi)
    keys = rmi.keys
    n = keys.shape[0]
    base = starts // STRIDE
    lane = torch.arange(packed_kernel.sample_width(S), device=keys.device)
    idx = (base[:, None] + lane * F) * STRIDE
    rows = torch.where((idx < n) & (lane < S), keys[idx.clamp(max=n - 1)], keymod.IMAGE_MAX)
    return base, rows


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
    kminf, kmaxf = keymod.as_float(rmi.keys[[0, -1]], rmi.key_type).tolist()
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
    lookup_fast.py:587-595)?  An integer-output top routes f64 keys by
    their truncated values, so it does not on f64 keys."""
    if rmi.key_type.is_float and get_model(rmi.top_type).output_int:
        return False
    if rmi.top_type in _MONOTONE_TOPS:
        return True
    return rmi.top_type in _SCALAR_TOPS and _scalar_top_monotone(rmi)


def hier_start_level(max_err: int) -> int:
    """K: the least k with 2 max_err / 64^k + 2 <= 64 (rmi_tpu
    SearchPlan)."""
    K = 0
    while (2 * max_err) / (LEVEL_FAN ** K) + 2 > LEVEL_FAN:
        K += 1
    return K


def _make_plan(rmi) -> Plan:
    n = rmi.keys.shape[0]
    shape = packed_plan_shape(rmi) if _monotone_top(rmi) else None
    if shape is None:
        K = hier_start_level(int(rmi.leaf_errors.max()))
        levels, packed = hier_kernel.hier_levels(rmi.keys, K)
        return Plan("hier", n, K=K, levels=levels, packed=packed)
    S, F = shape
    kmin, kmax = rmi.keys[[0, -1]].tolist()
    base, rows = leaf_rows(rmi, S, F)
    return Plan("packed" if F == 1 else "packed_wide", n, S, F, rows, base,
                rmi.keys[::STRIDE].contiguous(),
                rmi.keys[::sorted_serve_kernel.GROUP].contiguous(), kmin, kmax)


def _hier_search(rmi, plan: Plan, q: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of one batch through the hierarchical plan:
    lookup, then resolve, which answers a query outside the keys' range
    by its end.  An integer top routes a query by the bits below the
    keys' common prefix, so one outside the range whose prefix differs
    (on f64 keys, the double just past a last key below 2^30 truncates
    to 2^30) reaches a leaf whose window does not hold its lower bound;
    rmi_tpu's hierarchical search answers such a query wrong too."""
    # imported here: rmi_tpu_torch.lookup imports this module
    from rmi_tpu_torch.lookup import lookup
    guess, err = lookup(rmi, q)
    return resolve(plan.levels, q, guess, err, K=plan.K, n=plan.n, packed=plan.packed)


def _packed_search(rmi, plan: Plan, q: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of one batch through the packed plan (rmi_tpu's
    _fast_search_packed and _fast_search_packed_wide):
    packed_kernel.packed_search."""
    return packed_kernel.packed_search(rmi, plan, q)


def fast_search(rmi, queries: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds of int64 images in any order, through the
    index's plan.  On the card a packed plan serves the whole batch in
    one rmi_packed_search launch, a hierarchical one in one fused lookup
    and one rmi_hier_resolve launch; on the CPU the plain versions take
    MAX_CHUNK or HIER_CHUNK queries at a time, which bounds their
    [chunk, 64] and [chunk, 128] temporaries."""
    plan = get_plan(rmi)
    step = _hier_search if plan.kind == "hier" else _packed_search
    chunk = HIER_CHUNK if plan.kind == "hier" else MAX_CHUNK
    if not queries.is_cpu or queries.shape[0] <= chunk:
        return step(rmi, plan, queries)
    out = torch.empty_like(queries)
    for i in range(0, queries.shape[0], chunk):
        out[i:i + chunk] = step(rmi, plan, queries[i:i + chunk])
    return out


# ---------------------------------------------------------------------------
# sorted batches: kernel K5
# ---------------------------------------------------------------------------

def sorted_bounds(rmi, plan: Plan, qs: torch.Tensor):
    """K5's window bounds [lo, hi] per block of KQ sorted queries
    (packed_kernel.sorted_bounds: on the card one rmi_sorted_bounds
    launch, which evaluates the top on the blocks' first and last queries
    only)."""
    return packed_kernel.sorted_bounds(rmi, plan, qs)


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
    if plan.kind != "hier" and queries.shape[0] >= SORTED_MIN:
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
    hierarchical plans, take fast_search.  K5 never declines a batch, so
    rmi_tpu's veto and re-probe of a declining kernel have no
    counterpart."""
    plan = get_plan(rmi)
    if not sorts(plan, queries.shape[0]):
        return fast_search(rmi, queries)
    return serve_via_sort(rmi, plan, queries)


def sorts(plan: Plan, nq: int) -> bool:
    """Does fast_search_via_sort serve a batch of nq queries through sort
    -> K5 (a packed plan, and 4 nq >= 3 ceil(n / 64)) rather than
    fast_search?"""
    return plan.kind != "hier" and 4 * nq >= 3 * -(-plan.n // STRIDE)
