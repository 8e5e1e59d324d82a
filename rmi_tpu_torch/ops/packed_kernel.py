"""The packed plan's search and K5's window bounds (csrc/packed.cu).

  packed_search        exact lower bounds of a batch through a packed or
                       packed_wide plan: one launch of rmi_packed_search
                       on the card, packed_search_plain on the CPU;
  sorted_bounds        K5's window [lo, hi] of each block of KQ queries
                       of a sorted batch: one launch of rmi_sorted_bounds,
                       or sorted_bounds_plain.

Counterparts of rmi_tpu's _fast_search_packed, _fast_search_packed_wide
(rmi_tpu/lookup_fast.py:420-521) and _sorted_stats_direct (:683), XLA
programs with no Pallas call of their own.  Both rest on LB1 of a query
(stripe_lower_limits): the query clipped to the key domain, routed
through the top to its leaf, and the count c1 of the leaf row's samples
below it, LB1 = base + (c1 - 1) F <= lb1 <= LB1 + F with lb1 =
#(stripe-first keys < q) (lookup_fast's module docstring says why).
The plain versions compare whole rows, as rmi_tpu does; the kernel
counts each sorted run by fewer reads (the leaf row whole, then 64-byte
blocks of the stripe-first keys and of the stripe placed by
interpolation between the values known on either side of q; csrc/
packed.cu's header), which gives the same counts.

The kernel routes with the top's operands of rmi_lookup_*
(eval_kernel.top_operands), but reads a hint table in place where lookup
folds it into its rows (top_operands here).  A lognormal top routes on
max(ln x, 0), which stays one torch function (eval_kernel.fused_lookup
says why): the wrapper computes those leaf ids and the kernel takes
them.
"""

from __future__ import annotations

import torch

from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.ops import _build, eval_kernel
from rmi_tpu_torch.ops.hier_kernel import WIDTH, count_from
from rmi_tpu_torch.ops.sorted_serve_kernel import ALIGN, KQ, STRIPE
from rmi_tpu_torch.train import two_layer

MAX_SAMPLES = 127       # samples a leaf row (csrc/packed.cu kMaxSamples)
PACKED_KINDS = ("packed", "packed_wide")


def sample_width(S: int) -> int:
    """Sp, the entries of a leaf row: its S samples padded to an even
    count, so that every row of plan.rows starts on an ALIGN-byte
    boundary (csrc/packed.cu reads a row in 16-byte loads)."""
    return S + (S & 1)


def _leaf_ids(rmi, plan, q):
    """The top's leaf of each query clipped to the key domain, int64 as
    the entries' leaf_ids: predict_top_assignment, the plain route."""
    mtop = get_model(rmi.top_type)
    x = two_layer.model_float_input(mtop, q.clamp(plan.kmin, plan.kmax), rmi.norm_offset,
                                    rmi.norm_scale, rmi.key_type)
    return two_layer.predict_top_assignment(mtop, rmi.device_top_params, x,
                                            rmi.branching_factor - 1)


def stripe_lower_limits(rmi, plan, q: torch.Tensor) -> torch.Tensor:
    """LB1 per query, with LB1 <= lb1(q) <= LB1 + F: route the clipped
    query to its leaf row and count the row's samples below q."""
    leaf = _leaf_ids(rmi, plan, q)
    c1 = (plan.rows[leaf] < q[:, None]).sum(1)
    return plan.base[leaf] + (c1 - 1) * plan.F


def packed_search_plain(rmi, plan, q: torch.Tensor) -> torch.Tensor:
    """Exact lower bounds (rmi_tpu's _fast_search_packed and
    _fast_search_packed_wide).  lb lies in (64 (lb1 - 1), 64 lb1], so the
    count over stripe lb1 - 1 needs its 64 keys only."""
    nrows0 = plan.stripe_first.shape[0]
    LB1 = stripe_lower_limits(rmi, plan, q)
    if plan.F == 1:
        row = LB1.clamp(0, nrows0 - 1)       # lb1 - 1 <= LB1 <= lb1
    else:
        r1 = LB1.clamp(0, nrows0) >> 6       # 64 r1 <= lb1 <= 64 r1 + 127
        lb1 = count_from(plan.stripe_first, r1 * STRIPE, q, WIDTH)
        row = (lb1.clamp(max=nrows0) - 1).clamp(0, nrows0 - 1)
    return count_from(rmi.keys, row * STRIPE, q, STRIPE).clamp(max=plan.n)


def _anchors(qs: torch.Tensor) -> torch.Tensor:
    """The first, then the last query of each KQ block of the sorted batch
    (the last block may be short)."""
    nq = qs.shape[0]
    first = torch.arange(0, nq, KQ, device=qs.device)
    return qs[torch.cat([first, (first + KQ - 1).clamp(max=nq - 1)])]


def sorted_anchors(rmi, plan, qs: torch.Tensor):
    """(LB1_f, LB1_l): LB1 of the first and of the last query of each K5
    block of the sorted batch ``qs``.  The counterpart of rmi_tpu's
    _sorted_stats_direct, which pads the batch with its last query and
    anchors every 128 queries, so LB1_f here is every KQ / 128-th of its
    LB1_f.  The top is evaluated on these 2 / KQ of the queries only: K5
    needs no per-query leaf."""
    LB1 = stripe_lower_limits(rmi, plan, _anchors(qs))
    nb = LB1.shape[0] // 2
    return LB1[:nb], LB1[nb:]


def sorted_bounds_plain(rmi, plan, qs: torch.Tensor):
    """K5's window bounds [lo, hi] per block of KQ sorted queries.  Over
    the block lb1 runs from lb1(first) >= LB1_f to lb1(last) <= LB1_l + F,
    so lo = LB1_f - 1 and hi = LB1_l + F hold every query's lb1 - 1 and
    lb1, clamped to the stripe count."""
    LB1_f, LB1_l = sorted_anchors(rmi, plan, qs)
    nrows0 = plan.stripe_first.shape[0]
    return (LB1_f - 1).clamp(0, nrows0), (LB1_l + plan.F).clamp(0, nrows0)


def top_operands(rmi):
    """(key kind, top_w, top kind, top_int, top_table, pivots, top_len,
    route): the key's decode and the top's arguments of the packed
    kernels, rmi_lookup_*'s (eval_kernel.top_operands) but for a hint
    table that lookup folds into its rows, which is read in place, since
    the plan's rows are the leaves' (route IN_PLACE)."""
    top_w, top_int, table, pivots, top_len, route = eval_kernel.top_operands(
        rmi.top_type, rmi.device_top_params, rmi.keys.device, rmi.branching_factor,
        rmi.leaf_type)
    if route == eval_kernel.FOLDED:
        route = eval_kernel.IN_PLACE
    return (eval_kernel.key_kind(rmi.key_type), top_w, eval_kernel.top_kind(rmi.top_type),
            top_int, table, pivots, top_len, route)


def _check(fn, rmi, plan, q):
    if q.dtype != torch.int64 or q.dim() != 1:
        raise ValueError(f"{fn}: queries must be 1-D int64 key images")
    if plan.kind not in PACKED_KINDS:
        raise ValueError(f"{fn}: a {plan.kind} plan has no leaf rows: want a packed one")
    if q.device != plan.rows.device or rmi.keys.device != plan.rows.device:
        raise ValueError(f"{fn}: queries on device {q.device}, the plan and keys on "
                         f"{plan.rows.device}")
    B = rmi.branching_factor
    Sp = sample_width(plan.S)
    if (plan.rows.dtype != torch.int64 or plan.rows.shape != (B, Sp)
            or not plan.rows.is_contiguous() or plan.rows.data_ptr() % ALIGN
            or plan.base is None or plan.base.dtype != torch.int64 or plan.base.shape != (B,)
            or not 1 <= plan.S <= MAX_SAMPLES):
        raise ValueError(f"{fn}: the plan's rows must be [{B}, {Sp}] int64 on a {ALIGN}-byte "
                         f"boundary beside [{B}] int64 bases, 1 <= S <= {MAX_SAMPLES}")
    if rmi.keys.shape[0] != plan.n or plan.stripe_first.shape[0] != -(-plan.n // STRIPE):
        raise ValueError(f"{fn}: the plan was not made over these {rmi.keys.shape[0]} keys")


def _launch_args(rmi, plan, q, anchored=False):
    """The arguments of either entry from the queries to F: the top's
    operands (top_operands, made on the first launch and kept on the
    plan) and, for a "raw" (lognormal) top, the leaf ids of the queries
    (``anchored``: of each KQ block's first and last), else none."""
    if plan.top_args is None:
        plan.top_args = top_operands(rmi)
    if get_model(rmi.top_type).input_domain == "raw":
        ids = _leaf_ids(rmi, plan, _anchors(q) if anchored else q)
    else:
        ids = torch.empty(0, dtype=torch.int64, device=q.device)
    return (q, *plan.top_args, ids, plan.rows, plan.base, plan.S, plan.F)


def _norm(rmi, plan):
    return (rmi.branching_factor, plan.n, float(rmi.norm_offset), float(rmi.norm_scale),
            plan.kmin, plan.kmax)


def packed_search(rmi, plan, q: torch.Tensor) -> torch.Tensor:
    """[m] int64 exact lower bounds of images ``q`` in the index's keys
    through its packed plan: on the card one launch of rmi_packed_search
    for the whole batch (a lognormal top's leaf ids from torch before
    it), on the CPU packed_search_plain."""
    _check("packed_search", rmi, plan, q)
    if q.is_cpu:
        return packed_search_plain(rmi, plan, q)
    m = q.shape[0]
    if m == 0:
        return torch.empty_like(q)
    return _build.launch("rmi_packed_search", *_launch_args(rmi, plan, q),
                         plan.stripe_first, rmi.keys, m, m, *_norm(rmi, plan))


def sorted_bounds(rmi, plan, qs: torch.Tensor):
    """(lo, hi), [ceil(nq / KQ)] int64 each: K5's window of each block of
    the sorted batch ``qs`` (sorted_bounds_plain): on the card one launch
    of rmi_sorted_bounds (a lognormal top's anchor leaf ids from torch
    before it), on the CPU the plain version."""
    _check("sorted_bounds", rmi, plan, qs)
    if qs.is_cpu:
        return sorted_bounds_plain(rmi, plan, qs)
    nq = qs.shape[0]
    if nq == 0:
        return torch.empty_like(qs), torch.empty_like(qs)
    nb = -(-nq // KQ)
    return _build.launch("rmi_sorted_bounds", *_launch_args(rmi, plan, qs, anchored=True),
                         nb, nb, nq, KQ, *_norm(rmi, plan))
